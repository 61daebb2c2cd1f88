"""The patch-gather kernel's plain version and wrapper (CPU) against the JAX
package's `patches.extract_patches`, bit for bit.

The TPU kernel itself (`scripts/experiment_pallas_patches.py`) runs only on a
TPU (`pltpu.roll`, scalar prefetch); that script holds it `assert_array_equal`
to `patches.extract_patches`, which therefore stands in for it here.  The
window origins are built as the script builds them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jetracer_orbslam2_tpu.config import FrontendConfig as JFrontendConfig
from jetracer_orbslam2_tpu.ops import fast as jfast
from jetracer_orbslam2_tpu.ops import nms as jnms
from jetracer_orbslam2_tpu.ops import patches as jpatches
from jetracer_orbslam2_tpu.ops import preprocess as jpre

from jetracer_orbslam2_torch.ops import fused_patches, patches as tpatches
from jetracer_orbslam2_torch.ops.nms import Keypoints

from _torch_port_util import image_u8, n, t

eq = np.testing.assert_array_equal
P = 37


def _jax_keypoints(shape, levels, k, seed):
    cfg = JFrontendConfig(height=shape[0], width=shape[1], num_levels=levels,
                          max_keypoints=k)
    lv = jpre.build_pyramid(
        jpre.gaussian_blur_3x3(jnp.asarray(image_u8(shape, seed))), levels)
    winners = [jnms.grid_nms(jfast.fast_score_map(
        im, cfg.fast_threshold, cfg.fast_arc_length, cfg.fast_border),
        cfg.cell_size) for im in lv]
    kp = jnms.select_keypoints(winners, cfg.level_shapes, cfg.max_keypoints,
                               cfg.min_score, cfg.fast_border)
    return lv, kp


def _torch_keypoints(kp):
    return Keypoints(xy=t(n(kp.xy)), xy_level=t(n(kp.xy_level)),
                     level=t(n(kp.level)), score=t(n(kp.score)),
                     valid=t(n(kp.valid)))


def _script_origins(lv, kp, offsets):
    """ys/xs as scripts/experiment_pallas_patches.py:100-108 builds them."""
    r = P // 2
    lvl_off = jnp.asarray(offsets, jnp.int32)[kp.level]
    lvl_h = jnp.asarray([im.shape[0] for im in lv], jnp.int32)[kp.level]
    lvl_w = jnp.asarray([im.shape[1] for im in lv], jnp.int32)[kp.level]
    yc = jnp.clip(kp.xy_level[:, 1], r, lvl_h - 1 - r)
    xc = jnp.clip(kp.xy_level[:, 0], r, lvl_w - 1 - r)
    return np.asarray(yc + lvl_off - r), np.asarray(xc - r)


@pytest.mark.parametrize("shape,levels,k", [
    ((240, 320), 3, 512), ((120, 160), 2, 256), ((96, 200), 1, 64)])
def test_wrapper_on_cpu_matches_jax_extract_patches(shape, levels, k):
    lv, kp = _jax_keypoints(shape, levels, k, seed=levels)
    want = np.asarray(jpatches.extract_patches(lv, kp, P))
    levels_t, kp_t = [t(n(im)) for im in lv], _torch_keypoints(kp)
    assert int(kp_t.valid.sum()) > 10
    before = fused_patches.patch_gather.launches
    got = fused_patches.extract_patches_fused(levels_t, kp_t, P)
    assert got.shape == (k, P, P) and got.dtype == torch.float32
    eq(n(got), want)
    # the plain version of the whole function agrees too
    eq(n(tpatches.extract_patches(levels_t, kp_t, P)), want)
    # on the CPU no kernel is launched, so nothing is counted
    assert fused_patches.patch_gather.launches == before


def test_pack_levels_and_origins_match_the_tpu_script():
    lv, kp = _jax_keypoints((120, 160), 2, 256, seed=5)
    j_canvas, j_offsets = jpatches.pack_levels(lv)
    levels_t, kp_t = [t(n(im)) for im in lv], _torch_keypoints(kp)
    canvas, offsets = tpatches.pack_levels(levels_t)
    assert offsets == tuple(j_offsets) == (0, 120)
    eq(n(canvas), np.asarray(j_canvas))
    ys, xs = fused_patches.patch_origins(levels_t, offsets, kp_t, P)
    want_ys, want_xs = _script_origins(lv, kp, j_offsets)
    eq(n(ys), want_ys)
    eq(n(xs), want_xs)
    assert ys.dtype == xs.dtype == torch.int32
    got = fused_patches.patch_gather(canvas, ys, xs, P)
    eq(n(got), np.asarray(jpatches.extract_patches(lv, kp, P)))


def test_patch_gather_reference_on_adversarial_origins():
    """First and last rows and columns, every keypoint on one pixel, one
    keypoint, and windows that leave the canvas (reads are clamped)."""
    rng = np.random.default_rng(0)
    canvas = t(rng.random((90, 64), np.float32))
    for ys, xs in (([0, 0, 90 - P, 90 - P], [0, 64 - P, 0, 64 - P]),
                   ([17] * 9, [5] * 9), ([40], [20]),
                   ([-3, 80, 60], [-2, 10, 50])):
        ys_t, xs_t = t(np.int32(ys)), t(np.int32(xs))
        got = n(fused_patches.patch_gather(canvas, ys_t, xs_t, P))
        for k, (y, x) in enumerate(zip(ys, xs)):
            rows = np.clip(np.arange(y, y + P), 0, 89)
            cols = np.clip(np.arange(x, x + P), 0, 63)
            eq(got[k], n(canvas)[np.ix_(rows, cols)])
    empty = fused_patches.patch_gather(
        canvas, torch.zeros(0, dtype=torch.int32),
        torch.zeros(0, dtype=torch.int32), P)
    assert empty.shape == (0, P, P)


@pytest.mark.parametrize("bad", ["dtype", "origins_dtype", "contiguous",
                                 "shape", "patch"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    canvas = torch.zeros((50, 60))
    ys = xs = torch.zeros(4, dtype=torch.int32)
    args = {
        "dtype": (canvas.double(), ys, xs, P),
        "origins_dtype": (canvas, ys.long(), xs.long(), P),
        "contiguous": (canvas.T, ys, xs, P),
        "shape": (canvas, ys, xs[:3], P),
        "patch": (canvas, ys, xs, 0),
    }[bad]
    with pytest.raises((TypeError, ValueError)):
        fused_patches.patch_gather(*args)
