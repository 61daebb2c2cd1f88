"""graph.device_ops_per_frame (ops/frame): device kernels, copies and fills
in the device-only profiler pass, over the frames of that pass."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["device_ops"] or not t["frames"]:
        return None
    return t["device_ops"] / t["frames"]
