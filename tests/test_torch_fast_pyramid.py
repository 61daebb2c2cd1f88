"""The batched FAST+NMS wrapper of the PyTorch port (every pyramid level and
one or two thresholds in one kernel launch) vs the JAX package's Pallas
kernel, on the CPU.

On the CPU the wrapper runs its plain version (the loop over
`fast_nms_response_reference`), which the CUDA kernel is held to bit for bit
by `chip_smoke.py` on the card; here that plain version is held bit for bit
against the Pallas kernel in interpret mode, level by level and threshold by
threshold, and the wrapper's contract is checked.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jetracer_orbslam2_tpu.ops.pallas_fast import (
    fast_nms_response as j_fast_nms_response)

from jetracer_orbslam2_torch.config import FrontendConfig
from jetracer_orbslam2_torch.models import frontend
from jetracer_orbslam2_torch.ops import fused_fast, preprocess

from _torch_port_util import image_u8, n, t

eq = np.testing.assert_array_equal

SHAPE, LEVELS, THRESHOLDS = (96, 128), 3, (13.0, 7.0)


def _pyramid(seed=0):
    """Three levels of a blurred 8-bit image, as the front-end builds them."""
    img = t(image_u8(SHAPE, seed))
    return [lvl.contiguous() for lvl in preprocess.build_pyramid(
        preprocess.gaussian_blur_3x3(img), LEVELS)]


@pytest.mark.parametrize("arc", [9, 12])
def test_pyramid_matches_the_pallas_kernel(arc):
    levels = _pyramid()
    before = fused_fast.fast_nms_pyramid.launches
    got = fused_fast.fast_nms_pyramid(levels, THRESHOLDS, arc, 3)
    assert fused_fast.fast_nms_pyramid.launches == before   # CPU: no launch
    assert len(got) == len(THRESHOLDS)
    corners = 0
    for j, thr in enumerate(THRESHOLDS):
        assert len(got[j]) == LEVELS
        for i, lvl in enumerate(levels):
            assert got[j][i].shape == lvl.shape
            pallas = n(j_fast_nms_response(jnp.asarray(n(lvl)), thr, arc, 3,
                                           interpret=True))
            eq(n(got[j][i]), pallas, err_msg=f"threshold {thr}, level {i}")
            corners += int((pallas > 0).sum())
    assert corners > 0                  # non-degenerate fixture


def test_one_pair_call_is_an_entry_of_the_batched_call():
    levels = _pyramid(1)
    both = fused_fast.fast_nms_pyramid(levels, THRESHOLDS, 12, 19)
    for j, thr in enumerate(THRESHOLDS):
        for i, lvl in enumerate(levels):
            assert torch.equal(fused_fast.fast_nms_response(lvl, thr, 12, 19),
                               both[j][i])
    one = fused_fast.fast_nms_pyramid(levels, THRESHOLDS[:1], 12, 19)
    assert len(one) == 1 and all(torch.equal(a, b) for a, b in zip(one[0], both[0]))


@pytest.mark.parametrize("bad", ["no_levels", "nine_levels", "no_thresholds",
                                 "three_thresholds", "f64", "non_contiguous",
                                 "two_devices", "border2"])
def test_pyramid_wrapper_contract(bad):
    levels = _pyramid()
    thr, border = THRESHOLDS, 3
    err = ValueError
    if bad == "no_levels":
        levels = []
    elif bad == "nine_levels":
        levels = [levels[0]] * 9
    elif bad == "no_thresholds":
        thr = ()
    elif bad == "three_thresholds":
        thr = (13.0, 7.0, 5.0)
    elif bad == "f64":
        levels[1], err = levels[1].double(), TypeError
    elif bad == "non_contiguous":
        levels[2] = levels[2].T
    elif bad == "two_devices":
        levels[1] = levels[1].to("meta")
    else:
        border = 2
    with pytest.raises(err):
        fused_fast.fast_nms_pyramid(levels, thr, 12, border)


def test_extract_features_calls_the_kernel_once_a_frame(monkeypatch):
    calls = []
    real = fused_fast.fast_nms_pyramid

    def spy(levels, thresholds, arc_length, border):
        calls.append((len(levels), tuple(thresholds)))
        return real(levels, thresholds, arc_length, border)

    monkeypatch.setattr(fused_fast, "fast_nms_pyramid", spy)
    gray = t(image_u8(SHAPE, 2))
    for lo in (0.0, 7.0):
        calls.clear()
        cfg = FrontendConfig(height=SHAPE[0], width=SHAPE[1], num_levels=LEVELS,
                             max_keypoints=128, fast_min_threshold=lo)
        frontend.extract_features(gray, cfg)
        want = (13.0,) if lo == 0.0 else (13.0, 7.0)
        assert calls == [(LEVELS, want)]
