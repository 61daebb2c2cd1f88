"""The control and the planted faults that `correct` has to catch.

- `bf16_control`: the plain front-end with its pixel arithmetic in
  bfloat16, put in the program's place (its keyframes' features), one step
  of precision below the configuration's float32;
- `frozen_state`: every chunk starts from the state the one before it
  started from (a step that returns its state unchanged);
- `half_batch`: every second frame is never handed to the program (half of
  the batch left out);
- `altered_answer`: the front-end's descriptors altered where they are made
  (bit 0 of the first word flipped, inside the captured frame).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from slambench.harness import check


def bf16_control(cell, device, pixel_dtype=torch.bfloat16):
    """An `alter` for `run`: every live keyframe's features replaced by the
    plain front-end's at `pixel_dtype`."""
    def alter(results, lap):
        feats = dict(results["features"])
        ref = check.reference_features(lap, feats["frame"], cell.config,
                                       device, pixel_dtype)
        for name in ("xy", "desc", "points", "has_point"):
            feats[name] = np.stack([r[name] for r in ref])
        return dict(results, features=feats)
    return alter


@contextlib.contextmanager
def tf32_on():
    """The reference's float32 products in TF32 (for the record: the
    front-end has no product TF32 could round)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


@contextlib.contextmanager
def frozen_state():
    from jetracer_orbslam2_torch.models.odometry import ChunkedOdometry
    from jetracer_orbslam2_torch.models.slam_scan import ChunkedSlam

    flushes = {cls: cls.flush for cls in (ChunkedSlam, ChunkedOdometry)}

    def stuck(flush):
        def run(self):
            before = self.state
            out = flush(self)
            if before is not None:
                self.state = before
            return out
        return run

    for cls, flush in flushes.items():
        cls.flush = stuck(flush)
    try:
        yield
    finally:
        for cls, flush in flushes.items():
            cls.flush = flush


@contextlib.contextmanager
def altered_answer():
    from jetracer_orbslam2_torch.models import odometry, slam_scan
    from jetracer_orbslam2_torch.utils.step_graph import clear_graph_cache

    made = {(slam_scan, "_features"): slam_scan._features,
            (odometry, "frontend_gray_depth"): odometry.frontend_gray_depth}

    def altering(features):
        def altered(*args, **kwargs):
            f = features(*args, **kwargs)
            desc = f.desc.clone()
            desc[:, 0] ^= 1
            return f._replace(desc=desc)
        return altered

    clear_graph_cache()
    for (module, name), fn in made.items():
        setattr(module, name, altering(fn))
    try:
        yield
    finally:
        for (module, name), fn in made.items():
            setattr(module, name, fn)
        clear_graph_cache()


def half_batch(cell):
    """A `make_entry` for `run` whose entry hands the program every other
    frame only."""
    base = cell.entry().Entry

    class Half:
        def __init__(self, *args):
            self.inner, self.calls = base(*args), 0

        def feed(self, first, second):
            self.calls += 1
            if self.calls > 1 and self.calls % 2 == 0:
                return None
            return self.inner.feed(first, second)

        def __getattr__(self, name):
            return getattr(self.inner, name)

    return Half


@contextlib.contextmanager
def nothing():
    yield


PLANTED = {"frozen_state": (frozen_state, None),
           "half_batch": (nothing, half_batch),
           "altered_answer": (altered_answer, None)}
