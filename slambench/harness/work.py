"""What a kernel must move or compute, counted from the cell's shapes, and
the device's peaks it is held against.

Bytes count each input byte read once and each output byte written once,
however the kernel is built; a share of the roofline is the least time the
device could take over the time the kernel took.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def level_shapes(height: int, width: int, levels: int) -> list[tuple[int, int]]:
    """The half-sampled pyramid's level shapes (ceil halves)."""
    shapes = []
    for _ in range(levels):
        shapes.append((height, width))
        height, width = (height + 1) // 2, (width + 1) // 2
    return shapes


def k1_bytes(height: int, width: int, levels: int, images: int,
             thresholds: int) -> int:
    """K1 (FAST + 3x3 non-max suppression over a frame's pyramids, one
    launch): every float32 level of every image read once, and one float32
    response map written for each level and threshold."""
    pixels = sum(h * w for h, w in level_shapes(height, width, levels))
    return 4 * pixels * images * (1 + thresholds)


def k1_bytes_of(config: dict) -> int:
    fe = config["system"]["frontend"]
    images = 2 if config["sensor"]["kind"] == "stereo" else 1
    thresholds = 2 if fe["fast_min_threshold"] > 0 else 1
    return k1_bytes(fe["height"], fe["width"], fe["num_levels"], images,
                    thresholds)


def peaks(device_kind: str) -> dict | None:
    """The published peaks of a device by its name, or None if the table
    does not hold it."""
    return json.loads(PEAKS.read_text())["devices"].get(device_kind)
