"""The fused BA route of the PyTorch port vs the JAX package's Pallas kernels
(interpret mode on the CPU, as the JAX package's own tests run them).

On the CPU the port's wrappers run the kernels' plain versions, so these
tests hold the plain versions (the yardstick of the CUDA kernels on the
card) and the fused LM loop around them; the CUDA kernels themselves are
held against the plain versions by `chip_smoke.py` on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jetracer_orbslam2_tpu.config import BAConfig as JBAConfig
from jetracer_orbslam2_tpu.models.backend import ba as jba
from jetracer_orbslam2_tpu.ops import geometry as jgeo
from jetracer_orbslam2_tpu.ops import pallas_ba

from jetracer_orbslam2_torch.config import BAConfig
from jetracer_orbslam2_torch.models.backend import ba as tba
from jetracer_orbslam2_torch.ops import fused_ba
from jetracer_orbslam2_torch.ops import geometry as tgeo

from _torch_port_util import n, t
from test_torch_ba import INTR, both, ring_problem

close = np.testing.assert_allclose


def kernel_inputs(seed, P, L, lam, depth, awkward=False):
    """numpy arguments of the fused kernels for a ring problem: poses_flat
    (P,12), points (3,L), obs (5,P,L), lm_free (1,L), scalars (1,8)."""
    f = ring_problem(seed, P=P, L=L, depth=depth)
    rng = np.random.default_rng(seed + 100)
    if awkward:
        f["obs_valid"] = rng.random(P * L) > 0.25
        f["obs_valid"][f["obs_lm"] % 11 == 0] = False       # never seen
        f["obs_z_valid"] = f["obs_z_valid"] & (rng.random(P * L) > 0.3)
        f["points"][3] = [0.0, 0.0, -2.0]                   # behind the cameras
    _, tprob = both(f)
    obs, _ = tba.edges_to_dense(P, L, *tprob[2:8])
    poses_flat = tba.flatten_poses(tgeo.pose_inverse(tprob.poses))
    lm_free = (obs.w.sum(0) >= 2.0).to(torch.float32)[None]
    scalars = np.float32([[*INTR, lam, BAConfig().huber_delta, 0, 0]])
    return (n(poses_flat), f["points"].T.copy(), n(tba.stack_obs(obs)),
            n(lm_free), scalars)


def unpack_il(A_il, S_il, P):
    """Undo the TPU kernels' row order i*8 + p, as the JAX solver does."""
    A4 = np.asarray(A_il).reshape(6, P, 6, P)
    Hpp = np.stack([A4[:, p, :, p] for p in range(P)])
    S = np.asarray(S_il).reshape(6, P, 6, P).transpose(1, 0, 3, 2)
    return Hpp, S.reshape(6 * P, 6 * P)


@pytest.mark.parametrize("L,lam,depth,awkward", [
    (300, 1e-3, True, True), (256, 1e3, False, False)])
def test_plain_versions_match_the_pallas_kernels(L, lam, depth, awkward):
    P = 8
    inp = kernel_inputs(L, P, L, lam, depth, awkward)
    jin = [jnp.asarray(a) for a in inp]
    A_il, S_il, jbp, jrhs, jhinv, jbl = pallas_ba.fused_normal_schur(
        *jin, interpret=True)
    jHpp, jS = unpack_il(A_il, S_il, P)
    tin = [t(a) for a in inp]
    Hpp, GhG, bp, rhs, hinv, bl = fused_ba.fused_normal_schur_reference(*tin)
    # sums over <= 300 landmarks of f32 products in another order: 1e-5 of
    # each output's scale
    for name, got, want in (("Hpp", Hpp, jHpp), ("GhG", GhG, jS), ("bp", bp, jbp),
                            ("rhs_gh", rhs, jrhs), ("hll_inv", hinv, jhinv),
                            ("bl", bl, jbl)):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape, name
        close(n(got), want, rtol=1e-5, atol=1e-5 * np.abs(want).max(),
              err_msg=name)
    if awkward:     # frozen landmarks carry the identity
        frozen = inp[3][0] == 0
        assert frozen.any()
        close(n(hinv)[:, frozen], np.eye(3).reshape(9, 1).repeat(frozen.sum(), 1))

    rng = np.random.default_rng(7)
    dxp = rng.normal(0, 1e-2, (P, 6)).astype(np.float32)
    jdxl = pallas_ba.fused_backsub(*jin, jhinv, jbl, jnp.asarray(dxp),
                                   interpret=True)
    dxl = fused_ba.fused_backsub_reference(
        *tin, t(np.asarray(jhinv)), t(np.asarray(jbl)), t(dxp))
    want = np.asarray(jdxl)
    close(n(dxl), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert float(np.abs(n(dxl)[:, inp[3][0] == 0]).max(initial=0.0)) == 0.0


def test_wrappers_run_the_plain_versions_on_cpu_tensors():
    inp = [t(a) for a in kernel_inputs(1, 6, 40, 1e-3, True)]
    before = (fused_ba.fused_normal_schur.launches, fused_ba.fused_backsub.launches)
    got = fused_ba.fused_normal_schur(*inp)
    ref = fused_ba.fused_normal_schur_reference(*inp)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert [tuple(x.shape) for x in got] == [
        (6, 6, 6), (36, 36), (6, 6), (6, 6), (9, 40), (3, 40)]
    dxp = torch.full((6, 6), 1e-3)
    dxl = fused_ba.fused_backsub(*inp, got[4], got[5], dxp)
    assert torch.equal(dxl, fused_ba.fused_backsub_reference(
        *inp, got[4], got[5], dxp))
    # a launch is counted where a kernel is launched, and nowhere else
    assert before == (fused_ba.fused_normal_schur.launches,
                      fused_ba.fused_backsub.launches)


@pytest.mark.parametrize("P,L", [(1, 40), (16, 40), (8, 1)])
def test_backsub_plain_version_matches_the_dense_back_substitution(P, L):
    """fused_backsub's plain version (the yardstick of K3 on the card) gives
    the dense route's dxl = Hll^-1 (bl - G^T dxp) of `ba._solve_schur`,
    masked by lm_free, on the pose step that solve returns.  Every landmark
    is optimised, so a single pose (where each landmark has one
    observation) still has a landmark step to compare."""
    inp = [t(a) for a in kernel_inputs(40 + P, P, L, 1.0, True)]
    inp[3] = torch.ones_like(inp[3])
    hll_inv, bl = fused_ba.fused_normal_schur_reference(*inp)[4:]
    poses_cw, dense, intr, lam, huber = fused_ba._unpack(inp[0], inp[2], inp[4])
    Hpp, Hll, G, bp, bl_dense, _ = tba.dense_normal_equations(
        poses_cw, inp[1], dense, dense.w, intr, huber)
    free = torch.ones(P, dtype=torch.bool)
    dxp, dxl, ok = tba._solve_schur(Hpp, Hll, G, bp, bl_dense, lam, free,
                                    inp[3][0])
    assert bool(ok) and float(dxp.abs().max()) > 0.0
    got = fused_ba.fused_backsub_reference(*inp, hll_inv, bl, dxp.contiguous())
    want = dxl * inp[3]
    assert got.shape == (3, L)
    close(n(got), n(want), rtol=1e-5, atol=1e-6 * float(want.abs().max()))


def test_plain_versions_run_in_float64():
    inp = [t(a).double() for a in kernel_inputs(2, 8, 50, 1e-3, True)]
    out = fused_ba.fused_normal_schur_reference(*inp)
    assert all(x.dtype == torch.float64 for x in out)
    out32 = fused_ba.fused_normal_schur_reference(*[x.float() for x in inp])
    for a, b in zip(out, out32):
        scale = float(a.abs().max())
        assert float((a - b.double()).abs().max()) <= 1e-5 * scale


def _lm_args(seed, P, L, depth):
    f = ring_problem(seed, P=P, L=L, depth=depth)
    jprob, tprob = both(f)
    jobs, _ = jba.edges_to_dense(P, L, *jprob[2:8])
    tobs, _ = tba.edges_to_dense(P, L, *tprob[2:8])
    j = (jax.vmap(jgeo.pose_inverse)(jprob.poses), jprob.points, jobs,
         jprob.fixed, jnp.ones(L, bool), jnp.asarray(INTR))
    tt = (tgeo.pose_inverse(tprob.poses), tprob.points, tobs, tprob.fixed,
          torch.ones(L, dtype=torch.bool), t(INTR))
    return j, tt


def test_fused_lm_loop_matches_jax_interpret_and_own_dense_route_p8():
    """P = 8, L = 300 (not a multiple of any tile; the port pads nothing)."""
    j, tt = _lm_args(11, 8, 300, False)
    jp, jx, jt = jba.lm_run_dense(*j, JBAConfig(iters=5), fused="interpret")
    fp, fx, ft = tba.lm_run_dense(*tt, BAConfig(iters=5), fused=True, device="cpu")
    dp, dx, dt = tba.lm_run_dense(*tt, BAConfig(iters=5), fused=False, device="cpu")
    assert fx.shape == (300, 3) and ft.shape == (6,)
    # against the JAX package's fused route, and the tolerances the JAX
    # package holds its own two routes to (trace 5e-3, poses 5e-3, points 2e-2)
    close(n(ft), np.asarray(jt), rtol=1e-3)
    assert float(np.abs(n(fp) - np.asarray(jp)).max()) < 5e-3
    assert float(np.abs(n(fx) - np.asarray(jx)).max()) < 2e-2
    close(n(ft), n(dt), rtol=5e-3)
    assert float((fp - dp).abs().max()) < 5e-3
    assert float((fx - dx).abs().max()) < 2e-2
    assert float(ft[-1]) < 0.05 * float(ft[0])


def test_fused_lm_loop_matches_dense_routes_p6():
    """P = 6: beyond the TPU kernels' reach (they need 8 poses), within the
    port's; against both packages' dense routes."""
    j, tt = _lm_args(12, 6, 200, True)
    jp, jx, jt = jba.lm_run_dense(*j, JBAConfig(iters=5), fused=False)
    fp, fx, ft = tba.lm_run_dense(*tt, BAConfig(iters=5), fused=True, device="cpu")
    dp, dx, dt = tba.lm_run_dense(*tt, BAConfig(iters=5), fused=False, device="cpu")
    for trace in (np.asarray(jt), n(dt)):
        close(n(ft), trace, rtol=5e-3, atol=1e-6 * trace[0])
    assert float(np.abs(n(fp) - np.asarray(jp)).max()) < 5e-3
    assert float(np.abs(n(fx) - np.asarray(jx)).max()) < 2e-2
    assert float((fp - dp).abs().max()) < 5e-3 and float((fx - dx).abs().max()) < 2e-2


def test_route_choice_follows_device_and_pose_count():
    _, tt = _lm_args(13, 17, 20, True)
    # beyond the cap: asking for the kernels raises, auto takes the dense route
    with pytest.raises(ValueError, match="1..16 poses"):
        tba.lm_run_dense(*tt, BAConfig(iters=1), fused=True, device="cpu")
    out = tba.lm_run_dense(*tt, BAConfig(iters=1), device="cpu")
    assert out[0].shape == (17, 4, 4)
    assert fused_ba.takes_num_poses(16) and not fused_ba.takes_num_poses(0)
    # a psum hook is called on the pose-sized sums of either route
    calls = []

    def psum(x):
        calls.append(tuple(x.shape))
        return x

    _, tt = _lm_args(14, 4, 20, True)
    tba.lm_run_dense(*tt, BAConfig(iters=1), psum=psum, fused=True, device="cpu")
    assert (4, 6, 6) in calls and (24, 24) in calls and () in calls
    calls.clear()
    tba.lm_run_dense(*tt, BAConfig(iters=1), psum=psum, device="cpu")
    assert (4, 6, 6) in calls and (24, 24) in calls       # dense on the CPU


@pytest.mark.parametrize("case", ["f64", "strided", "too_many_poses",
                                  "wrong_obs_shape", "not_a_tensor",
                                  "other_device"])
def test_wrappers_refuse_what_the_kernels_do_not_take(case):
    inp = [t(a) for a in kernel_inputs(3, 4, 16, 1e-3, True)]
    err = ValueError
    if case == "f64":
        inp[1], err = inp[1].double(), TypeError
    elif case == "strided":
        inp[2] = inp[2].transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "too_many_poses":
        inp = [t(a) for a in kernel_inputs(3, 17, 16, 1e-3, True)]
    elif case == "wrong_obs_shape":
        inp[2] = inp[2][:, :, :15].contiguous()
    elif case == "other_device":
        # one launch takes every input's pointer: they must share a device
        inp[3] = inp[3].to("meta")
    else:
        inp[4], err = inp[4].numpy(), TypeError
    with pytest.raises(err):
        fused_ba.fused_normal_schur(*inp)
    if case != "too_many_poses":
        good = [t(a) for a in kernel_inputs(3, 4, 16, 1e-3, True)]
        hinv, bl = fused_ba.fused_normal_schur(*good)[4:]
        with pytest.raises(err):
            fused_ba.fused_backsub(*inp, hinv, bl, torch.zeros(4, 6))
        with pytest.raises(ValueError):
            fused_ba.fused_backsub(*good, hinv, bl, torch.zeros(6, 4))
