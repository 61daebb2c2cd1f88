"""K6's wrapper, `fused_polish.pose_polish`, on the CPU (its plain version)
against the body `tracking.refine_pose_reprojection` had before it became
one kernel (bit for bit), and against the JAX package's
`refine_pose_reprojection` (the `lax.scan` of Gauss-Newton steps).

The same numpy inputs go to both sides, made as
`test_torch_tracking.py::test_refine_pose_reprojection_matches` makes them.
The pose is held to that test's 1e-5 against JAX.  The CUDA kernel itself
is held against the same plain version on the card by `chip_smoke.py`
phase 23.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jetracer_orbslam2_tpu.models import tracking as jtrack
from jetracer_orbslam2_tpu.ops import geometry as jgeo

from jetracer_orbslam2_torch.models import tracking as ttrack
from jetracer_orbslam2_torch.ops import fused_polish
from jetracer_orbslam2_torch.ops import geometry as tgeo

from _torch_port_util import n, t

close = np.testing.assert_allclose

PORT = Path(__file__).resolve().parent.parent / "jetracer_orbslam2_torch"
INTR = np.float32([144.0, 144.0, 79.5, 59.5])


def _frozen_refine(T0, X_src, uv_dst, z_dst, w, intrinsics, iters=5,
                   huber_px=2.0):
    """`tracking.refine_pose_reprojection`'s body before K6, kept here
    unchanged: the CPU route must stay bit for bit this."""
    fx, fy = intrinsics[0], intrinsics[1]
    zero = torch.zeros_like(z_dst)
    wz_row = torch.where(z_dst > 1e-3, fx / torch.clamp_min(z_dst, 0.1), zero)
    eye3 = torch.eye(3, dtype=X_src.dtype, device=X_src.device)
    eye6 = torch.eye(6, dtype=X_src.dtype, device=X_src.device)
    I3 = eye3.expand(X_src.shape[0], 3, 3)

    T = T0
    for _ in range(iters):
        p = tgeo.transform_points(T, X_src[None])[0]
        x, y, z = p[:, 0], p[:, 1], p[:, 2]
        iz = 1.0 / torch.clamp_min(z, 1e-6)
        u = fx * x * iz + intrinsics[2]
        v = fy * y * iz + intrinsics[3]
        r = torch.stack([u - uv_dst[:, 0], v - uv_dst[:, 1],
                         wz_row * (z - z_dst)], -1)
        wk = w * (z > 1e-3)
        nrm = torch.linalg.norm(r, dim=-1)
        wk = wk * torch.clamp_max(huber_px / torch.clamp_min(nrm, 1e-9), 1.0)
        J_proj = torch.stack([
            torch.stack([fx * iz, zero, -fx * x * iz * iz], -1),
            torch.stack([zero, fy * iz, -fy * y * iz * iz], -1),
            torch.stack([zero, zero, wz_row], -1),
        ], 1)
        J_pose = torch.cat([I3, -tgeo.hat(p)], -1)
        J = J_proj @ J_pose
        Jw = J * wk[:, None, None]
        H = torch.einsum("kri,krj->ij", Jw, J) + 1e-6 * eye6
        b = -torch.einsum("kri,kr->i", Jw, r)
        dx = torch.linalg.solve_ex(H, b).result
        T = tgeo.se3_exp(dx) @ T
    return T


def _problem(seed, k=150, kind="base"):
    """test_torch_tracking.py's polish problem (seed 5 there): points 1-5 m
    ahead, a small motion T, pixels with 0.3 px noise, ten 25 px outliers,
    every seventh depth missing, a fifth of the weights 0.  kind: "zero"
    (all weights 0), "no_depth" (every z_dst 0), "outliers" (30 % of the
    pixels moved 20-60 px).  Returns T0 (I), X, uv, z, w, T."""
    rng = np.random.default_rng(seed)
    xi = np.concatenate([rng.normal(0, 0.04, 3), rng.normal(0, 0.02, 3)]).astype(np.float32)
    T = n(jgeo.se3_exp(jnp.asarray(xi)))
    X = np.stack([rng.uniform(-1.5, 1.5, k), rng.uniform(-1, 1, k),
                  rng.uniform(1, 5, k)], -1).astype(np.float32)
    P = X @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([INTR[0] * P[:, 0] / P[:, 2] + INTR[2],
                   INTR[1] * P[:, 1] / P[:, 2] + INTR[3]], -1)
    uv = (uv + rng.normal(0, 0.3, uv.shape)).astype(np.float32)
    uv[:10] += 25.0
    z = (P[:, 2] + rng.normal(0, 0.01, k)).astype(np.float32)
    z[::7] = 0.0
    w = (rng.random(k) > 0.2).astype(np.float32)
    if kind == "zero":
        w[:] = 0.0
    elif kind == "no_depth":
        z[:] = 0.0
    elif kind == "outliers":
        bad = rng.random(k) < 0.3
        shift = rng.uniform(20.0, 60.0, (k, 2)) * rng.choice([-1.0, 1.0], (k, 2))
        uv[bad] += shift[bad].astype(np.float32)
    return np.eye(4, dtype=np.float32), X, uv, z, w, T


def _jax(T0, X, uv, z, w, iters):
    return n(jtrack.refine_pose_reprojection(
        jnp.asarray(T0), jnp.asarray(X), jnp.asarray(uv), jnp.asarray(z),
        jnp.asarray(w), jnp.asarray(INTR), iters=iters))


@pytest.mark.parametrize("kind,iters", [("base", 1), ("base", 5),
                                        ("no_depth", 5), ("outliers", 5)])
def test_pose_polish_matches_jax(kind, iters):
    T0, X, uv, z, w, T = _problem(5, kind=kind)
    before = fused_polish.pose_polish.launches
    got = fused_polish.pose_polish(t(T0), t(X), t(uv), t(z), t(w), t(INTR),
                                   iters)
    # the CPU route is the plain version: no kernel, no launch counted
    assert fused_polish.pose_polish.launches == before
    assert got.shape == (4, 4) and got.dtype == torch.float32
    # iters Gauss-Newton steps, each a 6x6 solve of ~150 summed blocks: 1e-5
    close(n(got), _jax(T0, X, uv, z, w, iters), rtol=0, atol=1e-5)
    if kind == "base" and iters == 5:
        # the tracking test's bar against the truth (with no depth the scale
        # is free, and 30 % outliers pull the Huber fit: JAX's bar only)
        close(n(got), T, rtol=0, atol=5e-3)


def test_pose_polish_zero_weights_return_t0():
    """All weights 0: H = 1e-6 I and b = 0, so every step is dx = 0 and T
    comes back exactly as given."""
    _, X, uv, z, w, _ = _problem(6, kind="zero")
    xi = np.float32([0.1, -0.2, 0.05, 0.3, -0.1, 0.2])
    T0 = n(jgeo.se3_exp(jnp.asarray(xi)))
    got = fused_polish.pose_polish(t(T0), t(X), t(uv), t(z), t(w), t(INTR))
    assert torch.equal(got, t(T0))
    close(_jax(T0, X, uv, z, w, 5), T0, rtol=0, atol=1e-5)


def test_pose_polish_batch_matches_jax():
    """B 2 through the leading dimension: each problem as alone, and within
    1e-5 of the JAX package's."""
    probs = [_problem(s, k=96, kind=kind) for s, kind in ((7, "base"),
                                                          (8, "outliers"))]
    stack = [np.stack([p[i] for p in probs]) for i in range(5)]
    got = fused_polish.pose_polish(*(t(x) for x in stack), t(INTR), 5, 2.0)
    assert got.shape == (2, 4, 4)
    for b, (T0, X, uv, z, w, T) in enumerate(probs):
        alone = fused_polish.pose_polish(t(T0), t(X), t(uv), t(z), t(w), t(INTR))
        assert torch.equal(got[b], alone)
        close(n(got[b]), _jax(T0, X, uv, z, w, 5), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind,iters,huber", [("base", 5, 2.0), ("base", 1, 2.0),
                                              ("outliers", 3, 1.5),
                                              ("no_depth", 5, 2.0),
                                              ("zero", 5, 2.0)])
def test_refine_pose_reprojection_is_bitwise_the_parent_body(kind, iters, huber):
    """`tracking.refine_pose_reprojection` on the CPU, now through
    `fused_polish.pose_polish`, gives the same bits as its body before K6."""
    T0, X, uv, z, w, _ = _problem(9, kind=kind)
    args = (t(T0), t(X), t(uv), t(z), t(w), t(INTR))
    want = _frozen_refine(*args, iters=iters, huber_px=huber)
    assert torch.equal(ttrack.refine_pose_reprojection(
        *args, iters=iters, huber_px=huber), want)
    assert torch.equal(fused_polish.pose_polish_reference(
        *args, iters=iters, huber_px=huber), want)


def test_pose_polish_checks_its_inputs():
    T0, X, uv, z, w = (torch.eye(4), torch.zeros(5, 3), torch.zeros(5, 2),
                       torch.zeros(5), torch.zeros(5))
    intr = t(INTR)
    with pytest.raises(ValueError, match="T0 must be"):
        fused_polish.pose_polish(torch.eye(3), X, uv, z, w, intr)
    with pytest.raises(ValueError, match="X_src must be"):
        fused_polish.pose_polish(T0, torch.zeros(5, 2), uv, z, w, intr)
    with pytest.raises(ValueError, match="X_src must be"):
        fused_polish.pose_polish(T0[None], X, uv, z, w, intr)
    with pytest.raises(ValueError, match="uv_dst must be"):
        fused_polish.pose_polish(T0, X, torch.zeros(4, 2), z, w, intr)
    with pytest.raises(ValueError, match="z_dst must be"):
        fused_polish.pose_polish(T0, X, uv, torch.zeros(4), w, intr)
    with pytest.raises(ValueError, match="w must be"):
        fused_polish.pose_polish(T0, X, uv, z, torch.zeros(5, 1), intr)
    with pytest.raises(ValueError, match="intrinsics must be"):
        fused_polish.pose_polish(T0, X, uv, z, w, torch.zeros(5))
    with pytest.raises(ValueError, match="intrinsics must be a tensor"):
        fused_polish.pose_polish(T0, X, uv, z, w, INTR)
    with pytest.raises(ValueError, match="iters must be"):
        fused_polish.pose_polish(T0, X, uv, z, w, intr, -1)
    with pytest.raises(ValueError, match="iters must be"):
        fused_polish.pose_polish(T0, X, uv, z, w, intr, 2.0)
    with pytest.raises(ValueError, match="huber_px must be"):
        fused_polish.pose_polish(T0, X, uv, z, w, intr, 5, "2")
    with pytest.raises(ValueError, match="singular counts"):
        fused_polish.pose_polish(T0, X, uv, z, w, intr,
                                 singular=torch.zeros((), dtype=torch.int32))
    meta = torch.zeros(5, device="meta")
    with pytest.raises(ValueError, match="lies on meta"):
        fused_polish.pose_polish(T0, X, uv, z, meta, intr)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_polish.pose_polish(*(x.to("meta") for x in (T0, X, uv, z, w, intr)))
    # float64 is the plain version's business on the CPU; the card takes f32
    out = fused_polish.pose_polish(*(x.double() for x in (T0, X, uv, z, w, intr)))
    assert out.dtype == torch.float64 and torch.equal(out, T0.double())
    # no iterations: T0 itself
    assert torch.equal(fused_polish.pose_polish(T0, X, uv, z, w, intr, 0), T0)


def test_pose_polish_source_and_call_sites():
    """K6 is CUDA C++ with a plain C interface, built at first use; its sums
    take no float atomics (a replay repeats bit for bit), it reads the
    intrinsics on the card and caps no K; a problem's blocks hand their
    partials on through distributed shared memory (st.async counted by each
    block's mbarrier); the wrapper counts its launch once and falls back to
    nothing; both polishes go through it."""
    src = (PORT / "csrc" / "pose_polish.cu").read_text()
    assert '#include "cluster.cuh"' in src
    src += (PORT / "csrc" / "cluster.cuh").read_text()
    assert 'extern "C" int pose_polish_launch(' in src
    assert "__shfl_xor_sync" in src and "block_solve" in src
    for banned in ("torch/extension.h", "#include <ATen", "cublas", "cusolver"):
        assert banned not in src, banned
    assert not re.search(r"\batomic[A-Z]", src)
    assert "MAX_K" not in src and "PER_THREAD" in src
    assert "st.async" in src and "mbarrier.try_wait" in src
    wrapper = (PORT / "ops" / "fused_polish.py").read_text()
    assert "torch.compile" not in wrapper and "import triton" not in wrapper
    assert wrapper.count("note_launch(pose_polish)") == 1
    assert "except" not in wrapper and ".item()" not in wrapper
    tracking = (PORT / "models" / "tracking.py").read_text()
    slam = (PORT / "models" / "slam.py").read_text()
    assert tracking.count("fused_polish.pose_polish(") == 1
    assert "solve_ex" not in tracking
    assert tracking.count("refine_pose_reprojection(") == 2   # def, track_rgbd
    assert slam.count("tracking.refine_pose_reprojection(") == 1
