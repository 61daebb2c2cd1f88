"""graph.enqueue_us_per_frame (us/frame): the host's time in the frame
graph's calls (`graph.replay` spans: the copies into the graph's buffers,
the generator's hand-over, the replay's launch and the output copies),
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
    s = rec.query("graph.replay", int(w["t_start"] * 1e9),
                  int(w["t_end"] * 1e9))
    if not s.count or not s.complete or not w["frames"]:
        return None
    return s.total_ns / 1e3 / w["frames"]
