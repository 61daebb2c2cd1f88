"""The patch-gather kernel's plain versions and wrappers (CPU) against the
JAX package's `patches.extract_patches`, bit for bit: the levels entry the
front-end calls (`extract_patches_fused`) and the canvas entry of the TPU
kernel's contract (`patch_gather`).

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
from jetracer_orbslam2_torch.ops import preprocess as tpre
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
    before = (fused_patches.extract_patches_fused.launches,
              fused_patches.patch_gather.launches)
    got = fused_patches.extract_patches_fused(levels_t, kp_t, P)
    assert got.shape == (k, P, P) and got.dtype == torch.float32
    eq(n(got), want)
    # the plain version of the whole function agrees too
    eq(n(tpatches.extract_patches(levels_t, kp_t, P)), want)
    # on the CPU no kernel is launched, so nothing is counted
    assert (fused_patches.extract_patches_fused.launches,
            fused_patches.patch_gather.launches) == before


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


@pytest.mark.parametrize("shape,levels,k", [
    ((240, 320), 3, 512), ((120, 160), 2, 256), ((96, 200), 1, 64)])
def test_canvas_route_on_cpu_matches_jax_extract_patches(shape, levels, k):
    """The canvas entry (the TPU kernel's contract) through pack_levels and
    patch_origins, the route the front-end took before it read the levels."""
    lv, kp = _jax_keypoints(shape, levels, k, seed=levels + 10)
    levels_t, kp_t = [t(n(im)) for im in lv], _torch_keypoints(kp)
    canvas, offsets = tpatches.pack_levels(levels_t)
    ys, xs = fused_patches.patch_origins(levels_t, offsets, kp_t, P)
    got = fused_patches.patch_gather(canvas.contiguous(), ys, xs, P)
    eq(n(got), np.asarray(jpatches.extract_patches(lv, kp, P)))


def _numpy_levels_gather(levels, level, xy, p):
    """The levels kernel's algorithm (csrc/patch_gather.cu) in numpy: the
    centre clamp, then the whole window read from the keypoint's level when
    it lies inside the level's flat range, else each pixel's flat index
    clamped into the concatenation and looked up in the prefix table."""
    r = p // 2
    flat = np.concatenate([im.reshape(-1) for im in levels])
    sizes = [im.size for im in levels]
    start = np.concatenate([[0], np.cumsum(sizes)])
    out = np.empty((len(level), p, p), np.float32)
    for k, (lvl, (x, y)) in enumerate(zip(level, xy)):
        h, w = levels[lvl].shape
        yc = min(max(int(y), r), h - 1 - r)
        xc = min(max(int(x), r), w - 1 - r)
        base = start[lvl] + (yc - r) * w + (xc - r)
        idx = base + np.arange(p)[:, None] * w + np.arange(p)[None, :]
        if base >= start[lvl] and idx[-1, -1] < start[lvl + 1]:
            out[k] = levels[lvl].reshape(-1)[idx - start[lvl]]
            continue
        idx = np.clip(idx, 0, flat.size - 1)
        m = np.searchsorted(start[1:], idx, side="right")     # level holding idx
        for mm in np.unique(m):
            sel = m == mm
            out[k][sel] = levels[mm].reshape(-1)[idx[sel] - start[mm]]
    return out


@pytest.mark.parametrize("on_level", [4, None])
def test_levels_entry_on_a_level_smaller_than_the_patch(on_level):
    """Five levels of 120x160: the last ones are smaller than the patch, so
    a keypoint there leaves its level; the levels entry (its plain version on
    the CPU) reads the clamped concatenation as the kernel's algorithm does."""
    rng = np.random.default_rng(3)
    levels_t = tpre.build_pyramid(tpre.gaussian_blur_3x3(t(image_u8((120, 160), 4))), 5)
    assert min(im.shape[0] for im in levels_t) < P
    k = 200
    lvl = (np.full(k, on_level) if on_level is not None
           else rng.integers(0, 5, k)).astype(np.int32)
    hw = np.array([tuple(im.shape) for im in levels_t])[lvl]
    xy = np.stack([rng.integers(-40, hw[:, 1] + 40),
                   rng.integers(-40, hw[:, 0] + 40)], -1).astype(np.int32)
    kp = Keypoints(xy=t(xy.astype(np.float32)), xy_level=t(xy), level=t(lvl),
                   score=torch.ones(k), valid=torch.zeros(k, dtype=torch.bool))
    got = fused_patches.extract_patches_fused(levels_t, kp, P)
    eq(n(got), n(tpatches.extract_patches(levels_t, kp, P)))
    eq(n(got), _numpy_levels_gather([n(im) for im in levels_t], lvl, xy, P))


def test_levels_entry_with_no_keypoints():
    levels_t = [t(image_u8((60, 80), 1))]
    none = Keypoints(xy=torch.zeros(0, 2), xy_level=torch.zeros(0, 2, dtype=torch.int32),
                     level=torch.zeros(0, dtype=torch.int32), score=torch.zeros(0),
                     valid=torch.zeros(0, dtype=torch.bool))
    out = fused_patches.extract_patches_fused(levels_t, none, P)
    assert out.shape == (0, P, P) and out.dtype == torch.float32


@pytest.mark.parametrize("bad", ["no_levels", "nine_levels", "level_dtype",
                                 "xy_dtype", "other_device"])
def test_levels_entry_refuses_what_the_kernel_does_not_take(bad):
    levels_t = [t(image_u8((60, 80), 1)), t(image_u8((30, 40), 2))]
    k = 4
    kp = Keypoints(xy=torch.zeros(k, 2), xy_level=torch.full((k, 2), 20, dtype=torch.int32),
                   level=torch.zeros(k, dtype=torch.int32), score=torch.zeros(k),
                   valid=torch.ones(k, dtype=torch.bool))
    args = {
        "no_levels": ([], kp),
        "nine_levels": (levels_t * 4 + levels_t[:1], kp),
        "level_dtype": ([levels_t[0].double(), levels_t[1]], kp),
        "xy_dtype": (levels_t, kp._replace(xy_level=kp.xy_level.long())),
        # one launch takes every level's pointer: they must share a device
        "other_device": ([levels_t[0], levels_t[1].to("meta")], kp),
    }[bad]
    with pytest.raises((TypeError, ValueError)):
        fused_patches.extract_patches_fused(*args, P)
