"""K5's refit entry, `fused_rigid.rigid_refit`, on the CPU (its plain
version) against the JAX package's own refit sequence: `kabsch` with w1,
`transform_points`, the norm, the gate, `kabsch` with the kept weights.

The same numpy inputs go to both sides.  The transform is held to
`test_torch_geometry.py::test_kabsch_matches`'s bars (1e-5 against JAX, 2e-2
against the truth); the kept weights and their count must be equal.  The
CUDA kernel itself is held against the same plain version on the card by
`chip_smoke.py` phase 22 (a).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jetracer_orbslam2_tpu.ops import geometry as jgeo

from jetracer_orbslam2_torch.ops import fused_rigid
from jetracer_orbslam2_torch.ops import geometry as tgeo

from _torch_port_util import n, t

close = np.testing.assert_allclose

PORT = Path(__file__).resolve().parent.parent / "jetracer_orbslam2_torch"
GATE = 0.05


def _problem(seed, kind, count=160, batch=None):
    """src, dst (count, 3) (or (batch, count, 3)) with a quarter of dst
    moved by up to 0.5 m, 0/1 weights w1, fractional weights, a gate a
    point (GATE + 0.01 z^2) and the true transforms, from a numpy seed."""
    rng = np.random.default_rng(seed)
    shape = (batch or 1, count)
    xi = np.concatenate([rng.normal(0, 0.5, (shape[0], 3)),
                         rng.normal(0, 0.4, (shape[0], 3))], -1).astype(np.float32)
    T = np.stack([n(jgeo.se3_exp(jnp.asarray(x))) for x in xi])
    src = rng.normal(0, 1.5, shape + (3,)) + rng.normal(0, 2.0, (shape[0], 1, 3))
    if kind == "coplanar":
        src[..., 2] = 3.0
    dst = np.einsum("bij,bkj->bki", T[:, :3, :3], src) + T[:, None, :3, 3]
    dst += rng.normal(0, 0.01, dst.shape)
    moved = rng.random(shape) < 0.25
    dst += rng.uniform(-0.5, 0.5, dst.shape) * moved[..., None]
    w1 = (rng.random(shape) < 0.8).astype(np.float32)
    if kind == "zero":
        w1[:] = 0.0
    frac = (w1 * rng.uniform(0.5, 1.0, shape)).astype(np.float32)
    gate = (GATE + 0.01 * dst[..., 2] ** 2).astype(np.float32)
    out = [src.astype(np.float32), dst.astype(np.float32), w1, frac, gate, T]
    return out if batch else [x[0] for x in out]


def _jax_refit(src, dst, w1, keep, gate):
    """The JAX package's refit sequence (its `ransac_kabsch` and map refit),
    one problem: -> T2, w2, n."""
    src, dst = jnp.asarray(src), jnp.asarray(dst)
    T1 = jgeo.kabsch(src, dst, jnp.asarray(w1))
    err = jnp.linalg.norm(jgeo.transform_points(T1, src[None])[0] - dst, axis=-1)
    w2 = jnp.asarray(keep) * (err < jnp.asarray(gate))
    T2 = jgeo.kabsch(src, dst, w2)
    return n(T2), n(w2), int(jnp.count_nonzero(w2))


def _check_against_jax(got, src, dst, w1, keep, gate, T_true, kind):
    T2, w2, count = got
    ref_T, ref_w, ref_n = _jax_refit(src, dst, w1, keep, gate)
    assert T2.dtype == torch.float32 and w2.dtype == torch.float32
    assert count.dtype == torch.int32 and count.shape == ()
    # transforms (never SVD factors) compared: atol 1e-5
    close(n(T2), ref_T, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(n(w2), ref_w)
    assert int(count) == ref_n == int(np.count_nonzero(n(w2)))
    if kind == "zero":
        # w1 = 0 fits the identity; the gate then keeps whatever lies close
        assert ref_n == 0 or ref_n < len(w1)
    else:
        close(n(T2), T_true, rtol=0, atol=2e-2)
        # a fifth of the pairs kept at least (a quarter are moved, a fifth
        # unweighted, and T1 is fit with the moved ones)
        assert ref_n > len(w1) // 5


@pytest.mark.parametrize("kind", ["random", "zero", "coplanar"])
@pytest.mark.parametrize("keep_is", ["binary", "w"])
@pytest.mark.parametrize("gate_is", ["per_point", "scalar"])
def test_rigid_refit_matches_jax(kind, keep_is, gate_is):
    src, dst, w1, frac, gate_pt, T = _problem(7, kind)
    keep = (w1 > 0).astype(np.float32) if keep_is == "binary" else frac
    gate = gate_pt if gate_is == "per_point" else GATE
    tg = t(gate) if gate_is == "per_point" else gate
    before = fused_rigid.rigid_fit.launches
    got = fused_rigid.rigid_refit(t(src), t(dst), t(w1), t(keep), tg)
    # the CPU route is the plain version: no kernel, no launch counted
    assert fused_rigid.rigid_fit.launches == before
    _check_against_jax(got, src, dst, w1, keep, gate, T, kind)


def test_rigid_refit_batched_matches_jax():
    src, dst, w1, frac, gate, T = _problem(8, "random", batch=3)
    T2, w2, count = fused_rigid.rigid_refit(t(src), t(dst), t(w1), t(frac), t(gate))
    assert T2.shape == (3, 4, 4) and w2.shape == (3, 160) and count.shape == (3,)
    for b in range(3):
        _check_against_jax((T2[b], w2[b], count[b]), src[b], dst[b], w1[b],
                           frac[b], gate[b], T[b], "random")


def test_rigid_refit_many_points_matches_jax():
    """N 8,192, above the kernel's shared-memory path (MAX_POINTS): the
    wrapper takes any N, and the plain route agrees with the JAX package's
    refit sequence there too."""
    n_points = 8192
    assert n_points > fused_rigid.MAX_POINTS
    src, dst, w1, frac, gate, T = _problem(11, "random", count=n_points)
    got = fused_rigid.rigid_refit(t(src), t(dst), t(w1), t(frac), t(gate))
    assert got[1].shape == (n_points,)
    _check_against_jax(got, src, dst, w1, frac, gate, T, "random")


def test_rigid_refit_plain_route_is_the_two_call_route():
    """On the CPU the refit is bit for bit the sequence `ransac_kabsch` and
    the map refit ran before it was one call."""
    src, dst, w1, _, gate, _ = _problem(9, "random")
    s, d, w, g = t(src), t(dst), t(w1), t(gate)
    keep = (w > 0).to(torch.float32)
    T1 = tgeo.kabsch(s, d, w)
    err1 = torch.linalg.norm(tgeo.transform_points(T1, s[None])[0] - d, dim=-1)
    inl1 = (err1 < g) & (w > 0)
    T2 = tgeo.kabsch(s, d, inl1.to(torch.float32))
    got = fused_rigid.rigid_refit(s, d, w, keep, g)
    assert torch.equal(got[0], T2)
    assert torch.equal(got[1], inl1.to(torch.float32))
    assert torch.equal(got[2], torch.sum(inl1).to(torch.int32))
    # the map refit: keep = w, one gate
    w_trim = w * (err1 < 2 * GATE)
    got = fused_rigid.rigid_refit(s, d, w, w, 2 * GATE)
    assert torch.equal(got[0], tgeo.kabsch(s, d, w_trim))
    assert torch.equal(got[1], w_trim)


def test_rigid_refit_checks_its_inputs():
    src = torch.zeros(2, 5, 3)
    w = torch.ones(2, 5)
    with pytest.raises(ValueError, match="alike"):
        fused_rigid.rigid_refit(src, torch.zeros(2, 4, 3), w, w, 0.1)
    with pytest.raises(ValueError, match="w1 must be"):
        fused_rigid.rigid_refit(src, src, torch.ones(2, 4), w, 0.1)
    with pytest.raises(ValueError, match="keep must be"):
        fused_rigid.rigid_refit(src, src, w, torch.ones(5), 0.1)
    with pytest.raises(ValueError, match="gate must be"):
        fused_rigid.rigid_refit(src, src, w, w, torch.ones(2, 4))
    with pytest.raises(ValueError, match="gate must be"):
        fused_rigid.rigid_refit(src, src, w, w, torch.tensor(0.1))
    with pytest.raises(ValueError, match="gate must be a number"):
        fused_rigid.rigid_refit(src, src, w, w, "0.1")
    with pytest.raises(ValueError, match="gate must be a number"):
        fused_rigid.rigid_refit(src, src, w, w, True)
    with pytest.raises(ValueError, match="w1 and keep"):
        fused_rigid.rigid_refit(src, src, None, w, 0.1)
    meta = torch.zeros((2, 5), device="meta")
    with pytest.raises(ValueError, match="lies on meta"):
        fused_rigid.rigid_refit(src, src, meta, w, 0.1)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_rigid.rigid_refit(src.to("meta"), src.to("meta"), meta, meta, 0.1)
    # float64 is the plain version's business on the CPU; the card takes f32
    out = fused_rigid.rigid_refit(src.double(), src.double(), w.double(),
                                  w.double(), 0.1)
    assert out[0].dtype == torch.float64 and out[2].dtype == torch.int32


def test_rigid_refit_source_and_call_sites():
    """The refit is an entry of csrc/rigid_fit.cu with a plain C interface,
    counted on rigid_fit's counter; its point limit is the kernel's; the
    RANSAC and map refits go through it, ICP keeps one fit a call."""
    src = (PORT / "csrc" / "rigid_fit.cu").read_text()
    assert 'extern "C" int rigid_refit_launch(' in src
    assert "cp.async" in src and "__shfl_xor_sync" in src
    assert "SWEEPS" not in src and not re.search(r"\batomic[A-Z]", src)
    limit = int(re.search(r"constexpr int MAX_N = (\d+);", src).group(1))
    assert limit == fused_rigid.MAX_POINTS
    # src, dst and three per-point arrays in one block's shared memory,
    # beside the static 600 bytes or so, within the 227 KB a block may use
    assert 4 * (2 * 3 * limit + 3 * limit) + 1024 <= 232_448
    tracking = (PORT / "models" / "tracking.py").read_text()
    slam = (PORT / "models" / "slam.py").read_text()
    assert tracking.count("fused_rigid.rigid_refit(") == 1
    assert slam.count("fused_rigid.rigid_refit(") == 1
    assert "geo.kabsch(" not in slam
    assert tracking.count("geo.kabsch(") == 1      # tracking.icp
