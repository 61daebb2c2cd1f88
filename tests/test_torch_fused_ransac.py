"""K7's wrapper, `fused_ransac.ransac_select`, on the CPU (its plain version)
against the JAX package's `ransac_kabsch` pieces (`kabsch_quat` on the drawn
triples, the inlier score, `argmax`, `inl[best]`), and `ransac_kabsch` on the
CPU against the body it had before K7 (bit for bit).

The draws of `jax.random` cannot be reproduced by a torch generator, so both
sides get the same sample indices, made with numpy, as
`test_torch_tracking.py` injects them.  The CUDA kernel itself is held
against the same plain version on the card by `chip_smoke.py` phase 24.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jetracer_orbslam2_tpu.ops import geometry as jgeo

from jetracer_orbslam2_torch.models import tracking as ttrack
from jetracer_orbslam2_torch.ops import fused_ransac, fused_rigid
from jetracer_orbslam2_torch.ops import geometry as tgeo
from jetracer_orbslam2_torch.utils.ties import first_argmax

from _torch_port_util import n, t

close = np.testing.assert_allclose

PORT = Path(__file__).resolve().parent.parent / "jetracer_orbslam2_torch"


def _frozen_ransac_kabsch(src, dst, weights, generator=None, iters=256,
                          thresh=0.05, min_inliers=8, depth_quad=0.0,
                          gate_cap=1e9, sample_idx=None):
    """`tracking.ransac_kabsch`'s body before K7, kept here unchanged: the
    CPU route must stay bit for bit this."""
    if sample_idx is None:
        probs = weights.clamp_min(1e-20).expand(iters, -1)
        sample_idx = torch.multinomial(probs, 3, replacement=True,
                                       generator=generator)
    sample_idx = sample_idx.long()
    s = src[sample_idx]
    d = dst[sample_idx]
    T_h = tgeo.kabsch_quat(s, d)
    src_t = src[None] @ T_h[:, :3, :3].transpose(-1, -2) + T_h[:, None, :3, 3]
    err = torch.linalg.norm(src_t - dst[None], dim=-1)
    tz = torch.clamp_max(thresh + depth_quad * dst[:, 2] ** 2, gate_cap)
    has_w = weights > 0
    inl = (err < tz[None]) & has_w
    score = torch.sum(inl, dim=1)
    _, best = first_argmax(score, 0)
    w1 = inl.index_select(0, best.reshape(1))[0].to(src.dtype)
    T2, w2, num = fused_rigid.rigid_refit(src, dst, w1, has_w.to(src.dtype), tz)
    ok = num >= min_inliers
    eye = torch.eye(4, dtype=src.dtype, device=src.device)
    return torch.where(ok, T2, eye), w2 > 0, num, ok


def _problem(seed, k=200, h=64, outliers=0.3, kind="random", depth_quad=0.0,
             gate_cap=1e9):
    """`test_torch_tracking.py`'s correspondences (a small motion, 5 mm
    noise, 30 % outliers moved, a quarter of the weights 0) and h triples
    drawn with numpy from the weighted pairs.  kind: "zero" (all weights 0,
    the draws uniform), "degenerate" (a third of the triples one index three
    times, a third two of one index), "collinear" (every src on one line).
    Returns src, dst, w, idx (int64) and the gate tz, numpy."""
    rng = np.random.default_rng(seed)
    xi = np.concatenate([rng.normal(0, 0.05, 3), rng.normal(0, 0.03, 3)]).astype(np.float32)
    T = n(jgeo.se3_exp(jnp.asarray(xi)))
    src = (rng.uniform(-1, 1, (k, 3)) * [2.0, 1.5, 0]).astype(np.float32)
    src[:, 2] = rng.uniform(0.8, 5.0, k)
    if kind == "collinear":
        src = (src[:1] + np.outer(rng.normal(0, 1.0, k), [0.6, 0.0, 0.8])).astype(np.float32)
    dst = src @ T[:3, :3].T + T[:3, 3] + rng.normal(0, 0.005, (k, 3))
    bad = rng.random(k) < outliers
    dst[bad] += rng.normal(0, 0.5, (int(bad.sum()), 3))
    w = (rng.random(k) > 0.25).astype(np.float32)
    if kind == "zero":
        w[:] = 0.0
    p = np.maximum(w, 1e-20).astype(np.float64)
    idx = rng.choice(k, size=(h, 3), p=p / p.sum()).astype(np.int64)
    if kind == "degenerate":
        third = h // 3
        idx[:third] = idx[:third, :1]
        idx[third:2 * third, 1] = idx[third:2 * third, 0]
    dst = dst.astype(np.float32)
    tz = np.minimum(np.float32(0.05) + np.float32(depth_quad) * dst[:, 2] ** 2,
                    np.float32(gate_cap)).astype(np.float32)
    return src, dst, w, idx, tz


def _jax_pieces(src, dst, w, idx, tz):
    """The JAX package's ransac_kabsch between its draw and its refit:
    (T_h, score, best, w1)."""
    js, jd = jnp.asarray(src), jnp.asarray(dst)
    T_h = jgeo.kabsch_quat(js[idx], jd[idx])
    src_t = jnp.einsum("bij,kj->bki", T_h[:, :3, :3], js) + T_h[:, None, :3, 3]
    err = jnp.linalg.norm(src_t - jd[None], axis=-1)
    inl = (err < jnp.asarray(tz)[None]) & (jnp.asarray(w) > 0)
    score = jnp.sum(inl, axis=1)
    best = jnp.argmax(score)
    return n(T_h), n(score), int(best), n(inl[best]).astype(np.float32)


def _eigengap(src, dst, idx):
    """Each triple's gap between the two largest eigenvalues of Horn's 4 x 4
    K, relative to the largest (float64): the top eigenvector, and so the
    hypothesis, moves by about rounding / gap."""
    s, d = src[idx].astype(np.float64), dst[idx].astype(np.float64)
    H = np.einsum("hki,hkj->hij", s - s.mean(1, keepdims=True),
                  d - d.mean(1, keepdims=True))
    (xx, xy, xz), (yx, yy, yz), (zx, zy, zz) = np.moveaxis(H, 0, -1)
    K = np.stack([np.stack([xx + yy + zz, yz - zy, zx - xz, xy - yx], -1),
                  np.stack([yz - zy, xx - yy - zz, xy + yx, zx + xz], -1),
                  np.stack([zx - xz, xy + yx, -xx + yy - zz, yz + zy], -1),
                  np.stack([xy - yx, zx + xz, yz + zy, -xx - yy + zz], -1)], -2)
    ev = np.sort(np.linalg.eigvalsh(K), -1)
    return (ev[:, 3] - ev[:, 2]) / np.maximum(np.abs(ev[:, 3]), 1e-30)


def _select(src, dst, w, idx, tz):
    keep = (t(w) > 0).to(torch.float32)
    return fused_ransac.ransac_select(t(src), t(dst), keep, t(idx), t(tz))


@pytest.mark.parametrize("seed,h,depth_quad,gate_cap", [
    (0, 64, 0.0, 1e9), (1, 64, 0.02, 1e9), (2, 48, 0.02, 0.08), (3, 512, 0.0, 1e9)])
def test_ransac_select_matches_jax(seed, h, depth_quad, gate_cap):
    src, dst, w, idx, tz = _problem(seed, h=h, depth_quad=depth_quad,
                                    gate_cap=gate_cap)
    before = fused_ransac.ransac_select.launches
    best, score, w1 = _select(src, dst, w, idx, tz)
    # the CPU route is the plain version: no kernel, no launch counted
    assert fused_ransac.ransac_select.launches == before
    assert best.dtype == torch.int64 and best.shape == ()
    assert score.dtype == torch.int32 and w1.dtype == torch.float32
    T_h, jscore, jbest, jw1 = _jax_pieces(src, dst, w, idx, tz)
    assert int(best) == jbest
    np.testing.assert_array_equal(n(w1), jw1)
    assert int(score) == int(jscore[jbest]) == int(jw1.sum()) > 50
    # three-point quaternion fits, 30 Newton steps in f32: 1e-5 where the
    # top eigenvalue of K stands 10 % clear of the next (a triple with an
    # outlier or near a line has a smaller gap, and both packages' f32
    # eigenvectors move apart by rounding / gap: up to 3e-3 on these draws,
    # while the winner and its mask above agree); the winner's at 1e-5
    port_T = n(tgeo.kabsch_quat(t(src)[t(idx)], t(dst)[t(idx)]))
    assert np.isfinite(port_T).all()
    clear = _eigengap(src, dst, idx) > 0.1
    assert clear.sum() >= h // 2
    close(port_T[clear], T_h[clear], rtol=0, atol=1e-5)
    close(port_T[jbest], T_h[jbest], rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["zero", "degenerate", "collinear"])
def test_ransac_select_degenerate_draws(kind):
    """All weights 0: every score 0 and the winner the first hypothesis, w1
    empty; repeated indices and collinear triples: the same winner and mask
    as the JAX package, finite scores."""
    src, dst, w, idx, tz = _problem(4, h=60, kind=kind)
    best, score, w1 = _select(src, dst, w, idx, tz)
    T_h, jscore, jbest, jw1 = _jax_pieces(src, dst, w, idx, tz)
    if kind == "zero":
        assert int(best) == 0 and int(score) == 0 and not bool(w1.any())
    assert int(best) == jbest
    np.testing.assert_array_equal(n(w1), jw1)
    assert int(score) == int(jscore[jbest])
    port_T = tgeo.kabsch_quat(t(src)[t(idx)], t(dst)[t(idx)])
    assert bool(torch.isfinite(port_T).all())


def test_ransac_select_batch_rows_equal_alone():
    """B 2 through the leading dimension: each row as its problem alone."""
    probs = [_problem(s, h=40) for s in (5, 6)]
    stack = [np.stack([p[i] for p in probs]) for i in range(5)]
    src, dst, w, idx, tz = stack
    keep = (t(w) > 0).to(torch.float32)
    best, score, w1 = fused_ransac.ransac_select(t(src), t(dst), keep, t(idx),
                                                 t(tz))
    assert best.shape == (2,) and score.shape == (2,) and w1.shape == (2, 200)
    for b, p in enumerate(probs):
        one = _select(*p)
        assert torch.equal(best[b], one[0]) and torch.equal(score[b], one[1])
        assert torch.equal(w1[b], one[2])


@pytest.mark.parametrize("seed,kind,depth_quad,gate_cap,drawn", [
    (7, "random", 0.0, 1e9, False), (8, "random", 0.02, 0.1, False),
    (9, "zero", 0.0, 1e9, False), (10, "degenerate", 0.0, 1e9, False),
    (11, "random", 0.02, 1e9, True)])
def test_ransac_kabsch_is_bitwise_the_parent_body(seed, kind, depth_quad,
                                                  gate_cap, drawn):
    """`tracking.ransac_kabsch` on the CPU, now through
    `fused_ransac.ransac_select`, gives the same bits as its body before K7:
    with injected samples, and with the draw from a seeded generator."""
    src, dst, w, idx, _ = _problem(seed, h=64, kind=kind)
    args = (t(src), t(dst), t(w))
    kw = dict(iters=64, depth_quad=depth_quad, gate_cap=gate_cap)
    if drawn:
        got = ttrack.ransac_kabsch(*args, torch.Generator().manual_seed(3), **kw)
        want = _frozen_ransac_kabsch(*args, torch.Generator().manual_seed(3), **kw)
    else:
        got = ttrack.ransac_kabsch(*args, None, sample_idx=t(idx), **kw)
        want = _frozen_ransac_kabsch(*args, None, sample_idx=t(idx), **kw)
    assert torch.equal(got.T, want[0])
    assert torch.equal(got.inliers, want[1])
    assert torch.equal(got.num_inliers, want[2])
    assert torch.equal(got.ok, want[3])


def test_ransac_select_checks_its_inputs():
    src, dst = torch.zeros(5, 3), torch.zeros(5, 3)
    keep, tz = torch.ones(5), torch.full((5,), 0.05)
    idx = torch.zeros((4, 3), dtype=torch.int64)
    sel = fused_ransac.ransac_select
    with pytest.raises(ValueError, match="src must be"):
        sel(torch.zeros(5, 2), dst, keep, idx, tz)
    with pytest.raises(ValueError, match="src must be"):
        sel(torch.zeros(0, 3), torch.zeros(0, 3), torch.ones(0), idx,
            torch.ones(0))
    with pytest.raises(ValueError, match="dst must be"):
        sel(src, torch.zeros(4, 3), keep, idx, tz)
    with pytest.raises(ValueError, match="keep must be"):
        sel(src, dst, torch.ones(4), idx, tz)
    with pytest.raises(ValueError, match="tz must be"):
        sel(src, dst, keep, idx, torch.ones(5, 1))
    with pytest.raises(ValueError, match="sample_idx must be"):
        sel(src, dst, keep, torch.zeros((4, 2), dtype=torch.int64), tz)
    with pytest.raises(ValueError, match="sample_idx must be"):
        sel(src, dst, keep, torch.zeros((0, 3), dtype=torch.int64), tz)
    with pytest.raises(ValueError, match="sample_idx must be"):
        sel(src[None], dst[None], keep[None], idx, tz[None])
    with pytest.raises(TypeError, match="integer tensor"):
        sel(src, dst, keep, idx.float(), tz)
    with pytest.raises(ValueError, match="keep must be a tensor"):
        sel(src, dst, [1.0] * 5, idx, tz)
    with pytest.raises(ValueError, match="lies on meta"):
        sel(src, dst, keep.to("meta"), idx, tz)
    with pytest.raises(ValueError, match="unsupported device"):
        sel(*(x.to("meta") for x in (src, dst, keep, idx, tz)))
    # int32 draws and float64 points are the plain version's business on the
    # CPU; the card takes float32 and int64
    best, score, w1 = sel(src.double(), dst.double(), keep, idx.int(), tz)
    assert int(best) == 0 and w1.dtype == torch.float64
    # an empty batch
    out = sel(torch.zeros(0, 5, 3), torch.zeros(0, 5, 3), torch.zeros(0, 5),
              torch.zeros((0, 4, 3), dtype=torch.int64), torch.zeros(0, 5))
    assert [tuple(x.shape) for x in out] == [(0,), (0,), (0, 5)]


def test_ransac_select_source_and_call_sites():
    """K7 is CUDA C++ with a plain C interface, built at first use; its
    counts are integers (no float atomics: a replay repeats bit for bit) and
    it calls no library; the wrapper counts its launch once, reads nothing
    back and falls back to nothing; `ransac_kabsch` goes through it once,
    with no batched Kabsch or argmax of its own."""
    src = (PORT / "csrc" / "ransac_hyp.cu").read_text()
    assert '#include "cluster.cuh"' in src
    src += (PORT / "csrc" / "cluster.cuh").read_text()
    assert 'extern "C" int ransac_hyp_launch(' in src
    for banned in ("torch/extension.h", "#include <ATen", "cublas", "cusolver",
                   "atomicCAS", "--use_fast_math"):
        assert banned not in src, banned
    # the one atomic: integer counts in shared memory
    assert re.findall(r"\batomic[A-Z]\w*\(", src) == ["atomicAdd("]
    assert "atomicAdd(&counts[" in src and "__shared__ int counts[" in src
    assert "st.async" in src and "mbarrier.try_wait" in src
    wrapper = (PORT / "ops" / "fused_ransac.py").read_text()
    assert "torch.compile" not in wrapper and "import triton" not in wrapper
    assert wrapper.count("note_launch(ransac_select)") == 1
    assert "except" not in wrapper and ".item()" not in wrapper
    tracking = (PORT / "models" / "tracking.py").read_text()
    assert tracking.count("fused_ransac.ransac_select(") == 1
    assert "kabsch_quat(" not in tracking and "first_argmax" not in tracking
    assert tracking.count("fused_rigid.rigid_refit(") == 1
    from jetracer_orbslam2_torch.utils import cuda_build

    assert re.fullmatch(r"ransac_hyp-[0-9a-f]{16}\.so",
                        cuda_build.library_path("ransac_hyp").name)
