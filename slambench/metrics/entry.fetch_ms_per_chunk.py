"""entry.fetch_ms_per_chunk (ms/chunk): the host's time in the program's
blocking device-to-host transfers at a chunk's end (`entry.fetch` spans:
the wait for the chunk's queued work and the copy), summed over the
untraced window and divided by its chunks (host clock, the program's own
spans).  None where the program records no spans, or recorded none in the
window."""

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
    return s.total_ns / 1e6 / len(w["chunks"])
