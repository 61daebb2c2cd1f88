"""Bundle adjustment of the PyTorch port vs the JAX package (CPU, dense
routes): the same numpy problem goes through both."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jetracer_orbslam2_tpu.config import BAConfig as JBAConfig
from jetracer_orbslam2_tpu.config import SystemConfig as JSystemConfig
from jetracer_orbslam2_tpu.models.backend import ba as jba
from jetracer_orbslam2_tpu.ops import geometry as jgeo
from jetracer_orbslam2_tpu.parallel.bench_ba import make_synthetic_ba as j_make_synthetic_ba

from jetracer_orbslam2_torch import convert
from jetracer_orbslam2_torch.config import BAConfig, SystemConfig
from jetracer_orbslam2_torch.models.backend import ba as tba
from jetracer_orbslam2_torch.ops import geometry as tgeo
from jetracer_orbslam2_torch.parallel.bench_ba import make_synthetic_ba, time_ba

from _torch_port_util import n, t

close = np.testing.assert_allclose

INTR = np.float32([500.0, 500.0, 320.0, 240.0])


def ring_problem(seed, P=6, L=200, noise_px=0.5, depth=False):
    """The JAX tests' ring generator in numpy: landmarks in a box, cameras on
    an arc, every landmark seen from every pose, perturbed start.  Returns a
    dict of numpy arrays keyed by BAProblem field."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-2, -2, 4], [2, 2, 8], size=(L, 3)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
    for i in range(P):
        a = 0.08 * i
        poses[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                            [-np.sin(a), 0, np.cos(a)]]
        poses[i, :3, 3] = [0.4 * i, 0.05 * i, 0.0]
    kf, lm, uv, z = [], [], [], []
    for i in range(P):
        T_cw = np.linalg.inv(poses[i])
        pc = pts @ T_cw[:3, :3].T + T_cw[:3, 3]
        px = pc[:, :2] / pc[:, 2:3] * 500.0 + np.array([320.0, 240.0])
        kf.append(np.full(L, i))
        lm.append(np.arange(L))
        uv.append(px + rng.normal(0, noise_px, px.shape))
        z.append(pc[:, 2])
    start = poses.copy()
    for i in range(1, P):
        xi = rng.normal(0, 0.03, 6).astype(np.float32)
        start[i] = np.asarray(jgeo.se3_exp(jnp.asarray(xi))) @ start[i]
    e = P * L
    fixed = np.zeros(P, bool)
    fixed[0] = True
    return dict(
        poses=start.astype(np.float32),
        points=(pts + rng.normal(0, 0.05, pts.shape)).astype(np.float32),
        obs_kf=np.concatenate(kf).astype(np.int32),
        obs_lm=np.concatenate(lm).astype(np.int32),
        obs_uv=np.concatenate(uv).astype(np.float32),
        obs_z=(np.concatenate(z) if depth else np.zeros(e)).astype(np.float32),
        obs_z_valid=np.full(e, depth), obs_valid=np.ones(e, bool), fixed=fixed)


def both(fields):
    jprob = jba.BAProblem(**{k: jnp.asarray(v) for k, v in fields.items()})
    return jprob, convert.ba_problem_from_numpy(fields, "cpu")


def dense_inputs(fields):
    """(jax, torch) arguments of the dense-grid functions for one problem."""
    jprob, tprob = both(fields)
    P, L = fields["poses"].shape[0], fields["points"].shape[0]
    jobs, _ = jba.edges_to_dense(P, L, *jprob[2:8])
    tobs, _ = tba.edges_to_dense(P, L, *tprob[2:8])
    jcw = jax.vmap(jgeo.pose_inverse)(jprob.poses)
    tcw = tgeo.pose_inverse(tprob.poses)
    return (jcw, jprob.points.T, jobs), (tcw, tprob.points.T.contiguous(), tobs)


def test_system_config_defaults_equal():
    assert dataclasses.asdict(SystemConfig()) == dataclasses.asdict(JSystemConfig())
    cfg = SystemConfig().replace(ba=BAConfig(iters=3))
    assert cfg.ba.iters == 3 and cfg.map.max_landmarks == 16384


def test_inv3x3_ll_matches():
    rng = np.random.default_rng(0)
    B = rng.normal(size=(3, 3, 50)).astype(np.float32)
    A = np.einsum("ijl,kjl->ikl", B, B) + np.eye(3, dtype=np.float32)[:, :, None]
    want = np.asarray(jba.inv3x3_ll(jnp.asarray(A)))
    got = n(tba.inv3x3_ll(t(A)))
    # ~30 f32 operations per entry; the products reach 1e2
    close(got, want, rtol=1e-5, atol=1e-6)
    eye = np.einsum("ijl,jkl->ikl", A, got)
    close(eye, np.broadcast_to(np.eye(3)[:, :, None], eye.shape), atol=1e-4)


def test_edges_to_dense_matches_with_invalid_edges():
    f = ring_problem(0, P=4, L=30, depth=True)
    rng = np.random.default_rng(1)
    f["obs_valid"] = rng.random(120) > 0.3
    f["obs_z_valid"] = rng.random(120) > 0.5
    jprob, tprob = both(f)
    jd, jn = jba.edges_to_dense(4, 30, *jprob[2:8])
    td, tn = tba.edges_to_dense(4, 30, *tprob[2:8])
    assert int(tn) == int(jn) == 0 and tn.dtype == torch.int32
    for name in ("uv", "z", "z_valid", "w"):
        np.testing.assert_array_equal(n(getattr(td, name)),
                                      np.asarray(getattr(jd, name)), err_msg=name)
    assert int(td.w.sum()) == int(f["obs_valid"].sum())


def test_edges_to_dense_counts_collisions():
    f = ring_problem(0, P=3, L=10)
    f["obs_kf"][:4] = 0
    f["obs_lm"][:4] = 7             # (pose 0, landmark 7) five times over
    _, tprob = both(f)
    _, dropped = tba.edges_to_dense(3, 10, *tprob[2:8])
    assert int(dropped) == 4


@pytest.mark.parametrize("depth", [False, True])
def test_residuals_jacobians_and_normal_equations_match(depth):
    f = ring_problem(2, P=5, L=64, depth=depth)
    f["obs_valid"] = np.random.default_rng(3).random(320) > 0.2
    (jcw, jpts, jobs), (tcw, tpts, tobs) = dense_inputs(f)
    jout = jba._dense_residuals_and_jacobians(jcw, jpts, jobs, jnp.asarray(INTR))
    tout = tba._dense_residuals_and_jacobians(tcw, tpts, tobs, t(INTR))
    # a handful of f32 operations per entry, values up to 1e3: rtol 1e-5
    for name, a, b in zip(("r", "Jp", "Jl", "z"), tout, jout):
        close(n(a), np.asarray(b), rtol=1e-5, atol=1e-4, err_msg=name)

    huber = BAConfig().huber_delta
    jne = jba.dense_normal_equations(jcw, jpts, jobs, jobs.w, jnp.asarray(INTR), huber)
    tne = tba.dense_normal_equations(tcw, tpts, tobs, tobs.w, t(INTR), huber)
    # sums of <= 5*64*3 such terms: rtol 1e-5 of each output's scale
    for name, a, b in zip(("Hpp", "Hll", "G", "bp", "bl", "cost"), tne, jne):
        b = np.asarray(b)
        close(n(a), b, rtol=1e-5, atol=1e-5 * np.abs(b).max(), err_msg=name)


def test_solve_schur_on_fixed_inputs():
    f = ring_problem(4, P=5, L=64, depth=True)
    f["obs_valid"] = f["obs_lm"] % 9 != 0      # never seen: frozen below
    (jcw, jpts, jobs), _ = dense_inputs(f)
    Hpp, Hll, G, bp, bl, _ = jba.dense_normal_equations(
        jcw, jpts, jobs, jobs.w, jnp.asarray(INTR), BAConfig().huber_delta)
    lm_free = np.ones(64, np.float32)
    lm_free[::9] = 0.0
    free = ~f["fixed"]
    jdxp, jdxl = jba._solve_schur(Hpp, Hll, G, bp, bl, jnp.float32(1e-3),
                                  jnp.asarray(free), jnp.asarray(lm_free),
                                  lambda x: x)
    tdxp, tdxl, ok = tba._solve_schur(
        *(t(np.asarray(x)) for x in (Hpp, Hll, G, bp, bl)),
        torch.tensor(1e-3), t(free), t(lm_free))
    assert bool(ok)
    # one 30x30 Cholesky solve of a system with condition ~1e4 in f32
    close(n(tdxp), np.asarray(jdxp), rtol=0, atol=2e-4 * np.abs(jdxp).max())
    close(n(tdxl), np.asarray(jdxl), rtol=0, atol=2e-4 * np.abs(jdxl).max())
    assert float(np.abs(n(tdxp)[0]).max()) == 0.0        # the gauge pose
    assert float(np.abs(n(tdxl)[:, ::9]).max()) == 0.0   # G = 0 there


@pytest.mark.parametrize("depth", [False, True])
def test_bundle_adjust_matches_dense_route(depth):
    f = ring_problem(5 if depth else 0, P=6, L=200,
                     noise_px=0.0 if depth else 0.5, depth=depth)
    jprob, tprob = both(f)
    jp, jx, js = jba.bundle_adjust(jprob, jnp.asarray(INTR), JBAConfig(iters=8),
                                   fused=False)
    tp, tx, ts = tba.bundle_adjust(tprob, t(INTR), BAConfig(iters=8),
                                   fused=False, device="cpu")
    jt, tt = np.asarray(js.cost), n(ts.cost)
    # the trace falls by orders of magnitude; rtol 1e-3 per entry, with a
    # floor of 1e-6 of the initial cost for the converged tail
    close(tt, jt, rtol=1e-3, atol=1e-6 * jt[0])
    assert tt[-1] < 0.05 * tt[0] and (np.diff(tt) <= 0).all()
    # reprojection-only BA has a scale gauge along which the two f32
    # solutions may slide apart; with depth residuals they cannot
    close(n(tp), np.asarray(jp), rtol=0, atol=1e-4 if depth else 1e-3)
    close(n(tx), np.asarray(jx), rtol=0, atol=1e-3 if depth else 5e-3)
    # gauge pose untouched (f32 round trip through two inversions)
    close(n(tp)[0], f["poses"][0], rtol=0, atol=1e-6)
    assert int(ts.num_edges) == int(js.num_edges) == 1200
    assert ts.num_edges.dtype == torch.int32 and ts.cost.shape == (9,)


def test_bundle_adjust_ignores_invalid_observations():
    f = ring_problem(3, noise_px=0.0)
    bad = np.zeros(1200, bool)
    bad[::2] = True
    f["obs_uv"][bad] += 500.0
    f["obs_valid"] = ~bad
    jprob, tprob = both(f)
    _, _, js = jba.bundle_adjust(jprob, jnp.asarray(INTR), JBAConfig(iters=8),
                                 fused=False)
    _, _, ts = tba.bundle_adjust(tprob, t(INTR), BAConfig(iters=8), fused=False,
                                 device="cpu")
    jt, tt = np.asarray(js.cost), n(ts.cost)
    close(tt, jt, rtol=1e-3, atol=1e-6 * jt[0])
    assert tt[-1] < 1e-4 * tt[0]


def test_landmark_seen_once_stalls_both_packages():
    """A landmark with one observation is frozen, yet its cross block still
    enters the Schur complement with the identity for Hll^-1; the reduced
    system is then indefinite, the factorisation fails and every step is
    rejected.  The port keeps the JAX package's behaviour: the failure is a
    rejected step in both, never an exception."""
    f = ring_problem(0)
    f["obs_valid"] = ~((f["obs_lm"] < 5) & (f["obs_kf"] != 2))
    jprob, tprob = both(f)
    jp, _, js = jba.bundle_adjust(jprob, jnp.asarray(INTR), JBAConfig(iters=4),
                                  fused=False)
    for fused in (False, True):
        tp, _, ts = tba.bundle_adjust(tprob, t(INTR), BAConfig(iters=4),
                                      fused=fused, device="cpu")
        tt = n(ts.cost)
        close(tt, np.asarray(js.cost), rtol=1e-5)
        assert (tt == tt[0]).all() and np.isfinite(tt).all()
        close(n(tp), np.asarray(jp), rtol=0, atol=1e-6)


def test_failed_factorisation_is_a_rejected_step():
    """A reduced system that is not positive definite: no exception, no
    host-side status check, `ok` False."""
    P = 3
    Hpp = -torch.eye(6).repeat(P, 1, 1)
    zero = torch.zeros(6 * P, 6 * P)
    dxp, ok = tba._reduced_solve(Hpp, zero, torch.ones(P, 6), torch.zeros(P, 6),
                                 torch.tensor(1e-3), torch.tensor([False, True, True]))
    assert not bool(ok) and dxp.shape == (P, 6)


def test_make_synthetic_ba_equals_the_jax_arrays():
    for args in ((8, 64, 6, 0), (5, 33, 3, 2)):
        jprob, jintr = j_make_synthetic_ba(*args[:3], seed=args[3])
        tprob, tintr = make_synthetic_ba(*args[:3], seed=args[3], device="cpu")
        for name, a, b in zip(jprob._fields, tprob, jprob):
            b = np.asarray(b)
            assert n(a).dtype == b.dtype, name
            np.testing.assert_array_equal(n(a), b, err_msg=name)
        np.testing.assert_array_equal(n(tintr), np.asarray(jintr))


def test_time_ba_reports_ms_per_iter_and_cost_drop():
    prob, intr = make_synthetic_ba(4, 64, 3, device="cpu")
    out = time_ba(prob, intr, BAConfig(iters=3), reps=1, fused=False, device="cpu")
    assert set(out) == {"ms_per_iter", "cost_drop"}
    assert out["ms_per_iter"] > 0 and out["cost_drop"] > 5.0


def test_ba_convert_round_trip():
    f = ring_problem(1, P=3, L=12, depth=True)
    prob = convert.ba_problem_from_numpy(f, "cpu")
    for name, value in zip(prob._fields, prob):
        np.testing.assert_array_equal(n(value), f[name], err_msg=name)
        assert n(value).dtype == f[name].dtype, name
    # the other package's tuple is taken as it is
    jprob, _ = both(f)
    again = convert.ba_problem_from_numpy(jprob, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(prob, again))
    nd = tba.BAProblem.without_depth(prob.poses, prob.points, prob.obs_kf,
                                     prob.obs_lm, prob.obs_uv, prob.obs_valid,
                                     prob.fixed)
    assert not bool(nd.obs_z_valid.any()) and float(nd.obs_z.abs().max()) == 0.0
    poses, points, stats = tba.bundle_adjust(prob, t(INTR), BAConfig(iters=2),
                                             device="cpu")
    out = convert.ba_result_to_numpy(poses, points, stats)
    assert out["poses"].shape == (3, 4, 4) and out["points"].shape == (12, 3)
    assert out["cost"].shape == (3,) and out["num_edges"] == 36
