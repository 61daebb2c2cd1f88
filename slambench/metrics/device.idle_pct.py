"""device.idle_pct (%): the share of the measured window in which the
device ran nothing: 1 - (device busy seconds a frame in the device-only
profiler pass: the union of the trace's device intervals) / (wall seconds a
frame of the untraced window, host clock).  The traced pass's own wall time
is not used: the tracer lengthens each graph launch on the host."""


def read(ctx):
    t, w = ctx.get("trace"), ctx["window"]
    if not t or t["busy_s"] <= 0 or not t["frames"] or not w["frames"]:
        return None
    busy = t["busy_s"] / t["frames"]
    wall = (w["t_end"] - w["t_start"]) / w["frames"]
    return 100.0 * (1.0 - busy / wall)
