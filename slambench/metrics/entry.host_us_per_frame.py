"""entry.host_us_per_frame (us/frame): the program's share of each frame's
wall time: its `entry.frame` spans (a frame's own part of `process_frame`)
and `entry.chunk` spans (each `flush`: the chunk's replays and fetches),
summed over the untraced window and divided by its frames (host clock, the
program's own spans).  None where the program records no spans, or
recorded none in the window."""

import sys


def read(ctx):
    # the recorder of the program this process ran (its entry loaded it)
    timing = sys.modules.get("jetracer_orbslam2_torch.utils.timing")
    rec = getattr(timing, "RECORDER", None)
    if rec is None:
        return None
    w = ctx["window"]
    t0, t1 = int(w["t_start"] * 1e9), int(w["t_end"] * 1e9)
    frame = rec.query("entry.frame", t0, t1)
    chunk = rec.query("entry.chunk", t0, t1)
    if (not frame.count or not chunk.count or not w["frames"]
            or not (frame.complete and chunk.complete)):
        return None
    return (frame.total_ns + chunk.total_ns) / 1e3 / w["frames"]
