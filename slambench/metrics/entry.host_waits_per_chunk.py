"""entry.host_waits_per_chunk (waits/chunk): the program's blocking
device-to-host transfers (`entry.fetch` spans, one a wait) in the untraced
window, over its chunks (the program's own spans).  None where the program
records no spans, or recorded none in the window."""

import sys


def read(ctx):
    # the recorder of the program this process ran (its entry loaded it)
    timing = sys.modules.get("jetracer_orbslam2_torch.utils.timing")
    rec = getattr(timing, "RECORDER", None)
    if rec is None:
        return None
    w = ctx["window"]
    s = rec.query("entry.fetch", int(w["t_start"] * 1e9),
                  int(w["t_end"] * 1e9))
    if not s.count or not s.complete or not w["chunks"]:
        return None
    return s.count / len(w["chunks"])
