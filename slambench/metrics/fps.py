"""fps (frames/s): every frame whose output reached the host in the
window, over the window's wall seconds (host clock)."""

from slambench.harness import stats


def read(ctx):
    w = ctx["window"]
    return stats.fps(w["chunks"], w["t_start"], w["t_end"])
