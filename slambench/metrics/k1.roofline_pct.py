"""k1.roofline_pct (%): K1 (`fast_nms_pyramid_kernel`, one launch a frame
for every pyramid of the frame) against its bound: the bytes it must move,
counted from the cell's level shapes, images and thresholds, at the
device's published HBM rate, over K1's mean device time in the trace."""

from slambench.harness import trace, work

KERNEL = "fast_nms_pyramid_kernel"


def read(ctx):
    t = ctx.get("trace")
    peak = work.peaks(ctx["device"]["kind"])
    if not t or peak is None:
        return None
    launches, seconds = trace.kernel(t["kernels"], KERNEL)
    if not launches or seconds <= 0:
        return None
    bound_s = work.k1_bytes_of(ctx["config"]) / peak["hbm_bytes_per_s"]
    return 100.0 * bound_s / (seconds / launches)
