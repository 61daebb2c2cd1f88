"""scan.keyframe_body_ms (ms): the device time of the SLAM scheduler's
keyframe body (insert, windowed BA, loop retrieval, and the loop closure
and compactions inside it), a body taken, over the untraced window: the
`graph.body.keyframe` records made in it, one a chunk when its counts
reached the host (the frame graph's clock marks at the body's edges,
fetched with the chunk; a host branch's host time where the frames took
the host-branch route).  None where the program records no spans, or took
no keyframe body."""

import sys


def read(ctx):
    # the recorder of the program this process ran (its entry loaded it)
    timing = sys.modules.get("jetracer_orbslam2_torch.utils.timing")
    rec = getattr(timing, "RECORDER", None)
    if rec is None:
        return None
    w = ctx["window"]
    s = rec.query("graph.body.keyframe", int(w["t_start"] * 1e9),
                  int(w["t_end"] * 1e9))
    if not s.count or not s.complete:
        return None
    return s.value / 1e6 / s.count
