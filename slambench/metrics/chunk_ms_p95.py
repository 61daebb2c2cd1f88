"""chunk_ms_p95 (ms): the 95th percentile over all chunks of the window of
the time from the call that hands a chunk's first frame to the return of
the call that hands back its outputs on the host (host clock)."""

from slambench.harness import stats


def read(ctx):
    return stats.chunk_ms_p95(ctx["window"]["chunks"])
