"""Front-end ops of the PyTorch port vs the JAX package, on the CPU.

Inputs are 8-bit-valued f32 images with at most two pyramid levels, where
every intermediate is exactly representable: comparisons are bit-exact
(`assert_array_equal`) unless a tolerance is stated with its reason.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jetracer_orbslam2_tpu.ops import fast as jfast
from jetracer_orbslam2_tpu.ops import match as jmatch
from jetracer_orbslam2_tpu.ops import nms as jnms
from jetracer_orbslam2_tpu.ops import orb as jorb
from jetracer_orbslam2_tpu.ops import patches as jpatches
from jetracer_orbslam2_tpu.ops import preprocess as jpre
from jetracer_orbslam2_tpu.ops.pallas_fast import (
    fast_nms_response as j_fast_nms_response)

from jetracer_orbslam2_torch.convert import desc_from_numpy, desc_to_numpy
from jetracer_orbslam2_torch.ops import fast as tfast
from jetracer_orbslam2_torch.ops import fused_fast
from jetracer_orbslam2_torch.ops import match as tmatch
from jetracer_orbslam2_torch.ops import nms as tnms
from jetracer_orbslam2_torch.ops import orb as torb
from jetracer_orbslam2_torch.ops import patches as tpatches
from jetracer_orbslam2_torch.ops import preprocess as tpre
from jetracer_orbslam2_torch.utils.ties import first_argmax, first_argmin

from _torch_port_util import image_u8, n, t

eq = np.testing.assert_array_equal


# ---------------------------------------------------------------- preprocess

def test_rgb_to_gray_matches():
    rgb = np.random.default_rng(0).integers(0, 256, (24, 32, 3)).astype(np.uint8)
    # three products and two sums of f32: the compilers may fuse a*b+c
    # differently, so allow one rounding of a value <= 255
    np.testing.assert_allclose(n(tpre.rgb_to_gray(t(rgb))),
                               n(jpre.rgb_to_gray(jnp.asarray(rgb))),
                               rtol=0, atol=3e-5)


@pytest.mark.parametrize("shape", [(60, 80), (61, 83)])
def test_gaussian_blur_bit_exact(shape):
    img = image_u8(shape, 1)
    eq(n(tpre.gaussian_blur_3x3(t(img))), n(jpre.gaussian_blur_3x3(jnp.asarray(img))))


@pytest.mark.parametrize("shape", [(60, 80), (61, 83), (60, 83), (61, 80)])
def test_halfsample_bit_exact(shape):
    img = image_u8(shape, 2)
    got = tpre.halfsample(t(img))
    assert tuple(got.shape) == ((shape[0] + 1) // 2, (shape[1] + 1) // 2)
    eq(n(got), n(jpre.halfsample(jnp.asarray(img))))


@pytest.mark.parametrize("shape", [(120, 160), (61, 83)])
def test_build_pyramid_bit_exact(shape):
    img = image_u8(shape, 3)
    got = tpre.build_pyramid(tpre.gaussian_blur_3x3(t(img)), 2)
    ref = jpre.build_pyramid(jpre.gaussian_blur_3x3(jnp.asarray(img)), 2)
    assert len(got) == len(ref) == 2
    for a, b in zip(got, ref):
        eq(n(a), n(b))


# ------------------------------------------------------------- FAST + NMS map

_FAST_CASES = [
    # (shape, seed, threshold, arc_length, border) — the Pallas kernel's own
    # fixtures (tests/test_pallas_fast.py)
    ((64, 128), 0, 13.0, 9, 3),
    ((64, 128), 0, 13.0, 12, 3),
    ((64, 128), 0, 13.0, 16, 3),
    ((52, 70), 7, 13.0, 12, 3),
    ((41, 257), 7, 13.0, 12, 3),
    ((48, 128), 3, 40.0, 12, 8),
]


@pytest.mark.parametrize("shape,seed,thr,arc,border", _FAST_CASES)
def test_fast_nms_response_bit_exact(shape, seed, thr, arc, border):
    img = image_u8(shape, seed)
    got = n(fused_fast.fast_nms_response(t(img), thr, arc, border))
    pallas = n(j_fast_nms_response(jnp.asarray(img), thr, arc, border,
                                   interpret=True))
    xla = n(jnms.local_max_3x3(
        jfast.fast_score_map(jnp.asarray(img), thr, arc, border)))
    eq(got, pallas)
    eq(got, xla)
    assert (got > 0).sum() > 0          # non-degenerate fixture


@pytest.mark.parametrize("shape,seed,thr,arc,border", _FAST_CASES[1:5:3])
def test_fast_score_map_bit_exact(shape, seed, thr, arc, border):
    img = image_u8(shape, seed)
    eq(n(tfast.fast_score_map(t(img), thr, arc, border)),
       n(jfast.fast_score_map(jnp.asarray(img), thr, arc, border)))


def test_fast_nms_response_tiny_image_is_zero():
    # smaller than 2*border in a dimension: all zero, as the oracle gives
    img = image_u8((30, 40), 5)
    got = n(fused_fast.fast_nms_response(t(img), 13.0, 12, 19))
    ref = n(jnms.local_max_3x3(jfast.fast_score_map(jnp.asarray(img), 13.0, 12, 19)))
    eq(got, ref)
    assert got.sum() == 0.0


def test_fast_nms_reference_is_what_the_cpu_wrapper_runs():
    img = t(image_u8((40, 56), 9))
    eq(n(fused_fast.fast_nms_response(img, 13.0, 12, 3)),
       n(fused_fast.fast_nms_response_reference(img, 13.0, 12, 3)))


@pytest.mark.parametrize("bad", ["border", "dtype", "layout", "ndim", "arc"])
def test_fast_nms_wrapper_contract(bad):
    img = t(image_u8((40, 56), 9))
    before = fused_fast.fast_nms_pyramid.launches
    with pytest.raises((ValueError, TypeError)):
        if bad == "border":
            fused_fast.fast_nms_response(img, 13.0, 12, 2)
        elif bad == "dtype":
            fused_fast.fast_nms_response(img.double(), 13.0, 12, 3)
        elif bad == "layout":
            fused_fast.fast_nms_response(img.T, 13.0, 12, 3)
        elif bad == "ndim":
            fused_fast.fast_nms_response(img[None], 13.0, 12, 3)
        else:
            fused_fast.fast_nms_response(img, 13.0, 17, 3)
    # the CPU path never counts as a kernel launch
    fused_fast.fast_nms_response(img, 13.0, 12, 3)
    assert fused_fast.fast_nms_pyramid.launches == before


# ------------------------------------------------------- grid NMS / selection

def _response(shape=(64, 128), seed=0):
    img = image_u8(shape, seed)
    return n(jnms.local_max_3x3(jfast.fast_score_map(jnp.asarray(img), 13.0, 9, 3)))


@pytest.mark.parametrize("kind", ["corners", "zeros", "ties", "ragged"])
def test_grid_nms_bit_exact(kind):
    if kind == "corners":
        resp = _response()
    elif kind == "zeros":
        resp = np.zeros((64, 128), np.float32)
    elif kind == "ties":
        # equal maxima inside cells: the first index must win on both sides
        resp = np.zeros((64, 128), np.float32)
        resp[::5, ::7] = 3.0
    else:
        resp = _response((52, 70), 7)      # cells hang over the edge
    got = tnms.grid_nms(t(resp), 16, suppress=False)
    ref = jnms.grid_nms(jnp.asarray(resp), 16, suppress=False)
    for a, b in zip(got, ref):
        eq(n(a), n(b))
    assert got.y.dtype == torch.int32 and got.x.dtype == torch.int32


def test_grid_nms_suppress_bit_exact():
    img = image_u8((64, 128), 0)
    pre = n(jfast.fast_score_map(jnp.asarray(img), 13.0, 9, 3))
    got = tnms.grid_nms(t(pre), 16, suppress=True)
    ref = jnms.grid_nms(jnp.asarray(pre), 16, suppress=True)
    for a, b in zip(got, ref):
        eq(n(a), n(b))


def _winners(shapes, seeds, quantize):
    out_t, out_j = [], []
    for shape, seed in zip(shapes, seeds):
        resp = _response(shape, seed)
        if quantize:
            # few distinct scores -> many ties in the top-K
            resp = np.where(resp > 0, np.ceil(resp / 200.0) * 200.0, 0.0).astype(np.float32)
        out_t.append(tnms.grid_nms(t(resp), 16, suppress=False))
        out_j.append(jnms.grid_nms(jnp.asarray(resp), 16, suppress=False))
    return out_t, out_j


@pytest.mark.parametrize("k,quantize", [(48, True), (48, False), (400, True)])
def test_select_keypoints_tie_order(k, quantize):
    shapes = [(64, 128), (32, 64)]
    wt, wj = _winners(shapes, [0, 1], quantize)
    got = tnms.select_keypoints(wt, shapes, k, 1e-3, 3)
    ref = jnms.select_keypoints(wj, shapes, k, 1e-3, 3)
    for name in got._fields:
        eq(n(getattr(got, name)), n(getattr(ref, name)), err_msg=name)
    if quantize:
        s = n(got.score)
        assert len(np.unique(s)) < len(s) // 2     # the fixture really ties


# ------------------------------------------------------------ patches and ORB

def _keypoints_and_levels():
    img = image_u8((120, 160), 11)
    levels_j = jpre.build_pyramid(jpre.gaussian_blur_3x3(jnp.asarray(img)), 2)
    shapes = [tuple(l.shape) for l in levels_j]
    winners = [jnms.grid_nms(jnms.local_max_3x3(
        jfast.fast_score_map(l, 13.0, 12, 19)), 16, suppress=False)
        for l in levels_j]
    kp_j = jnms.select_keypoints(winners, shapes, 96, 1e-3, 19)
    kp_t = tnms.Keypoints(*[t(n(f)) for f in kp_j])
    levels_t = [t(n(l)) for l in levels_j]
    return levels_j, kp_j, levels_t, kp_t


def test_extract_patches_bit_exact():
    levels_j, kp_j, levels_t, kp_t = _keypoints_and_levels()
    assert int(n(kp_j.valid).sum()) > 10
    eq(n(tpatches.extract_patches(levels_t, kp_t, 37)),
       n(jpatches.extract_patches(levels_j, kp_j, 37)))


def test_brief_tables_identical():
    eq(torb.brief_pattern(256, 37), jorb.brief_pattern(256, 37))
    eq(torb.rotated_pattern_indices(256, 37, 32),
       jorb.rotated_pattern_indices(256, 37, 32))


def test_orientation_close():
    levels_j, kp_j, _, _ = _keypoints_and_levels()
    patches = jpatches.extract_patches(levels_j, kp_j, 37)
    # XLA adds the ~700 disc terms in f32 in its own order, the port in f64
    # rounded once: the gap is XLA's rounding error, atol 1e-5 rad
    np.testing.assert_allclose(n(torb.orientation(t(n(patches)))),
                               n(jorb.orientation(patches)), rtol=0, atol=1e-5)


def test_angle_bins_bit_exact():
    edges = (np.arange(-40, 41, dtype=np.float32) + 0.5) * np.float32(np.pi / 16)
    rnd = np.random.default_rng(0).uniform(-7, 7, 400).astype(np.float32)
    ang = np.concatenate([edges, rnd, np.float32([0.0, -0.0, np.pi, -np.pi])])
    eq(n(torb.angle_bins(t(ang), 32)), n(jorb.angle_bins(jnp.asarray(ang), 32)))


def test_describe_and_unpack_bits_bit_exact():
    levels_j, kp_j, _, _ = _keypoints_and_levels()
    patches = jpatches.extract_patches(levels_j, kp_j, 37)
    angles = jorb.orientation(patches)
    ref = n(jorb.describe(patches, angles, 256, 32))           # uint32
    got = torb.describe(t(n(patches)), t(n(angles)), 256, 32)  # int32, same bits
    assert got.dtype == torch.int32
    eq(desc_to_numpy(got), ref)
    assert (ref >> 31).any()                 # bit 31 is exercised
    eq(n(torb.unpack_bits(got, 256)), n(jorb.unpack_bits(jnp.asarray(ref), 256)))


# ------------------------------------------------------------------ matching

def _descriptors(k, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2 ** 32, (k, 8), dtype=np.uint64).astype(np.uint32)
    # b: a permuted, with a few bits flipped, so real matches exist
    perm = rng.permutation(k)
    flips = np.zeros((k, 8), np.uint32)
    for _ in range(20):
        flips[np.arange(k), rng.integers(0, 8, k)] ^= (
            np.uint32(1) << rng.integers(0, 32, k).astype(np.uint32))
    b = a[perm] ^ flips
    b[: k // 8] = rng.integers(0, 2 ** 32, (k // 8, 8), dtype=np.uint64).astype(np.uint32)
    return a, b, perm


def test_hamming_matrix_bit_exact():
    a, b, _ = _descriptors(96, 0)
    got = n(tmatch.hamming_matrix(desc_from_numpy(a, "cpu"), desc_from_numpy(b, "cpu")))
    eq(got, n(jmatch.hamming_matrix(jnp.asarray(a), jnp.asarray(b))))
    # and it is XOR + popcount
    x = a[:, None, :] ^ b[None, :, :]
    pop = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)
    eq(got, pop.astype(np.float32))


@pytest.mark.parametrize("window", [0.0, 24.0])
def test_match_bit_exact(window):
    k = 128
    a, b, perm = _descriptors(k, 1)
    rng = np.random.default_rng(2)
    valid_a = rng.random(k) > 0.2
    valid_b = rng.random(k) > 0.2
    xy_b = rng.uniform(0, 160, (k, 2)).astype(np.float32)
    xy_a = np.empty_like(xy_b)
    xy_a[perm] = xy_b                                  # true partner's place
    xy_a += rng.normal(0, 10, xy_a.shape).astype(np.float32)
    got = tmatch.match(
        desc_from_numpy(a, "cpu"), desc_from_numpy(b, "cpu"), t(valid_a),
        t(valid_b), xy_a_pred=t(xy_a), xy_b=t(xy_b), window=window,
        max_hamming=64, ratio=0.9)
    ref = jmatch.match(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid_a),
        jnp.asarray(valid_b), xy_a_pred=jnp.asarray(xy_a),
        xy_b=jnp.asarray(xy_b), window=window, max_hamming=64, ratio=0.9)
    eq(n(got.idx), n(ref.idx))
    eq(n(got.dist), n(ref.dist))
    eq(n(got.valid), n(ref.valid))
    assert got.idx.dtype == torch.int32
    assert 5 < int(n(ref.valid).sum()) < k


# ---------------------------------------------------------------- tie orders

@pytest.mark.parametrize("dim", [0, 1])
def test_first_arg_reductions_take_the_first_index(dim):
    x = np.zeros((6, 7), np.float32)          # an all-equal row and column
    x[2, 3] = x[4, 3] = x[2, 5] = 1.0
    y = -x
    v, i = first_argmax(t(x), dim)
    eq(n(i), np.asarray(jnp.argmax(jnp.asarray(x), axis=dim)))
    eq(n(v), x.max(dim))
    v, i = first_argmin(t(y), dim)
    eq(n(i), np.asarray(jnp.argmin(jnp.asarray(y), axis=dim)))
    eq(n(v), y.min(dim))
