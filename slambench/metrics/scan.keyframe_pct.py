"""scan.keyframe_pct (%): the share of the window's frames whose output row
says a keyframe was inserted (the SLAM scheduler's `ScanOutput.is_kf`)."""


def read(ctx):
    w = ctx["window"]
    if not w["frames"]:
        return None
    return 100.0 * w["keyframes"] / w["frames"]
