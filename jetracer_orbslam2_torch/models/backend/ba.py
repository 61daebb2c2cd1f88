"""Bundle adjustment: Levenberg-Marquardt with Schur complement.

Counterpart of `jetracer_orbslam2_tpu/models/backend/ba.py`, same formulas,
guards and layouts, written with torch ops:

  1. A BA problem over P poses never observes the same (landmark, pose) pair
     twice, so observations live on a DENSE (P, L) grid whose slot index IS
     the pose index: no scatter and no atomics inside an iteration.
  2. Everything is structure-of-arrays with the LANDMARK AXIS LAST, so on the
     card consecutive threads read consecutive landmarks.
  3. Hll^-1 is a closed-form adjugate inverse on (3, 3, L) component planes.
  4. The Schur complement S = Hpp - G Hll^-1 G^T is one dense
     (P*6, 3L) x (3L, P*6) product, and the (P*6)^2 system is solved with a
     dense Cholesky factorisation.
  5. Invalid slots carry zero weight; empty landmarks are frozen and their
     Hll block is replaced by the identity before inversion.

Two routes compute one LM linear solve: the dense route below
(`dense_normal_equations` + `_solve_schur`, plain PyTorch; it is also the
yardstick of the kernels) and the fused route (`_lm_step_fused`, through the
hand-written CUDA kernels of `ops/fused_ba.py`, which never write a Jacobian
to device memory).

`lm_run_dense` is the whole LM schedule.  The loop never makes the host wait
for the device: accept/reject is a tensor (`torch.where` on poses, points,
lambda and cost), and a Cholesky factorisation that fails is a rejected
step, not an exception.  `psum` and `psum_many` are the hooks of the
landmark-sharded caller (`parallel/ba_sharded.py`): callables that reduce
pose-sized partial sums over the shards (identity when unsharded), one
tensor or several in one collective.  Both routes take them: an LM
iteration reduces its four pose-sized partials (Hpp, Gh G^T, bp, Gh bl)
with one `psum_many`, as the JAX package's "psum once per iteration", and
its cost with one `psum`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from jetracer_orbslam2_torch.config import BAConfig
from jetracer_orbslam2_torch.ops import geometry as geo
from jetracer_orbslam2_torch.utils.device import resolve_device
from jetracer_orbslam2_torch.utils.linalg import cholesky_solve
from jetracer_orbslam2_torch.utils.precision import set_exact_f32

Tensor = torch.Tensor


def _identity(x):
    return x


def _identity_many(*xs):
    return xs


def _each(psum):
    """`psum_many` from a one-tensor hook: a collective a partial."""
    return lambda *xs: tuple(psum(x) for x in xs)


class BAProblem(NamedTuple):
    """A fixed-shape BA problem instance (edge-list view; converted to the
    dense (P, L) grid by `edges_to_dense` at solve entry).

    poses:    (P, 4, 4) T_wc keyframe poses (world-from-camera).
    points:   (L, 3)    landmark world positions.
    obs_kf:   (E,) int32 pose index per observation.
    obs_lm:   (E,) int32 landmark index per observation.
    obs_uv:   (E, 2)    pixel measurements.
    obs_z:    (E,)      measured camera-frame depth (RGB-D / stereo), m.
    obs_z_valid: (E,) bool depth measurement validity.  Depth residuals
              anchor scale: reprojection-only BA over a short RGB-D window
              is near-degenerate (landmarks slide along rays).
    obs_valid:(E,) bool.
    fixed:    (P,) bool gauge-fixed poses (at least one must be True).
    """

    poses: Tensor
    points: Tensor
    obs_kf: Tensor
    obs_lm: Tensor
    obs_uv: Tensor
    obs_z: Tensor
    obs_z_valid: Tensor
    obs_valid: Tensor
    fixed: Tensor

    @classmethod
    def without_depth(cls, poses, points, obs_kf, obs_lm, obs_uv,
                      obs_valid, fixed) -> "BAProblem":
        e = obs_kf.shape[0]
        dev = obs_kf.device
        return cls(poses=poses, points=points, obs_kf=obs_kf, obs_lm=obs_lm,
                   obs_uv=obs_uv,
                   obs_z=torch.zeros(e, dtype=torch.float32, device=dev),
                   obs_z_valid=torch.zeros(e, dtype=torch.bool, device=dev),
                   obs_valid=obs_valid, fixed=fixed)


class BAStats(NamedTuple):
    cost: Tensor         # (iters+1,) robust cost trace (index 0 = initial)
    num_edges: Tensor    # () int32 effective edge count


class DenseObs(NamedTuple):
    """Observations on the dense pose-by-landmark grid, SoA landmark-last.

    uv:      (2, P, L) pixel measurements.
    z:       (P, L)    measured camera depth (0 where absent).
    z_valid: (P, L) bool.
    w:       (P, L) float32 slot validity weight (0 = empty slot).
    """

    uv: Tensor
    z: Tensor
    z_valid: Tensor
    w: Tensor


def inv3x3_ll(A: Tensor) -> Tensor:
    """Closed-form adjugate inverse for (3, 3, L) component planes."""
    a, b, c = A[0, 0], A[0, 1], A[0, 2]
    d, e, f = A[1, 0], A[1, 1], A[1, 2]
    g, h, i = A[2, 0], A[2, 1], A[2, 2]
    c11 = e * i - f * h
    c12 = c * h - b * i
    c13 = b * f - c * e
    c21 = f * g - d * i
    c22 = a * i - c * g
    c23 = c * d - a * f
    c31 = d * h - e * g
    c32 = b * g - a * h
    c33 = a * e - b * d
    det = a * c11 + b * c21 + c * c31
    inv_det = 1.0 / det
    adj = torch.stack([
        torch.stack([c11, c12, c13]),
        torch.stack([c21, c22, c23]),
        torch.stack([c31, c32, c33]),
    ])
    return adj * inv_det


def edges_to_dense(
    num_poses: int, num_landmarks: int,
    obs_kf: Tensor, obs_lm: Tensor, obs_uv: Tensor, obs_z: Tensor,
    obs_z_valid: Tensor, obs_valid: Tensor,
) -> tuple[DenseObs, Tensor]:
    """Scatter an edge list onto the (P, L) grid (one packed scatter; runs
    once per BA call, not per iteration).  Invalid edges go to one spare row
    that is sliced off.  A (landmark, pose) pair observed twice keeps one
    observation arbitrarily; returns (dense, n_dropped) where n_dropped
    counts such collisions (0 for well-formed problems).
    """
    L, P = num_landmarks, num_poses
    dest = torch.where(obs_valid, obs_kf.long() * L + obs_lm.long(), L * P)
    payload = torch.cat([
        obs_uv,
        obs_z[:, None],
        obs_z_valid.to(torch.float32)[:, None],
        torch.ones((obs_kf.shape[0], 1), dtype=torch.float32,
                   device=obs_uv.device),
    ], -1)                                               # (E, 5)
    dense = torch.zeros((L * P + 1, 5), dtype=torch.float32,
                        device=obs_uv.device)
    dense[dest] = payload
    dense = dense[:L * P].reshape(P, L, 5).permute(2, 0, 1).contiguous()
    w = dense[4]
    n_dropped = (torch.sum(obs_valid) - torch.sum(w)).to(torch.int32)
    return DenseObs(uv=dense[:2], z=dense[2], z_valid=dense[3] > 0.5,
                    w=w), n_dropped


def _dense_residuals(poses_cw: Tensor, points: Tensor, obs: DenseObs,
                     intrinsics: Tensor):
    """Residuals of every (P, L) grid slot and what the Jacobians reuse.

    Returns r (P,3,L), the camera-frame planes (x, y, z), 1/max(z, 1e-6),
    the depth-row weight wz (P,L) and the rotations R (P,3,3).
    """
    fx, fy = intrinsics[0], intrinsics[1]
    R = poses_cw[:, :3, :3]                              # (P, 3, 3)
    t = poses_cw[:, :3, 3]                               # (P, 3)
    p = torch.einsum("pcj,jl->pcl", R, points) + t[:, :, None]   # (P, 3, L)
    x, y, z = p[:, 0], p[:, 1], p[:, 2]                  # (P, L)
    iz = 1.0 / z.clamp_min(1e-6)
    u = fx * x * iz + intrinsics[2]
    v = fy * y * iz + intrinsics[3]
    wz = torch.where(obs.z_valid, fx / obs.z.clamp_min(0.1),
                     torch.zeros_like(z))
    r = torch.stack([u - obs.uv[0], v - obs.uv[1], wz * (z - obs.z)], 1)
    return r, (x, y, z), iz, wz, R


def _dense_residuals_and_jacobians(
    poses_cw: Tensor, points: Tensor, obs: DenseObs, intrinsics: Tensor,
):
    """Residual + analytic Jacobians for every (P, L) grid slot, SoA.

    Residual r = [project(T_cw X_w) - uv, wz * (z - z_meas)], with
    left-multiplicative se(3) increment on T_cw ordered (translation,
    rotation): delta_p = dt + dw x p.  The depth row (weight wz = fx / z,
    converting meters to pixel-like units) is zeroed where z_valid is False.

    points is (3, L).  Returns r (P,3,L), Jp (P,3,6,L), Jl (P,3,3,L),
    z (P,L) camera depth.
    """
    fx, fy = intrinsics[0], intrinsics[1]
    r, (x, y, z), iz, wz, R = _dense_residuals(poses_cw, points, obs,
                                               intrinsics)
    # d(u,v,wz*z)/dp  (P, 3row, 3col, L) as unrolled component planes
    zero = torch.zeros_like(iz)
    J_proj = torch.stack([
        torch.stack([fx * iz, zero, -fx * x * iz * iz], 1),
        torch.stack([zero, fy * iz, -fy * y * iz * iz], 1),
        torch.stack([zero, zero, wz], 1),
    ], 1)                                                # (P, 3, 3, L)
    # dp/dxi = [I | -hat(p)]  (P, 3, 6, L)
    one = torch.ones_like(x)
    J_pt_pose = torch.stack([
        torch.stack([one, zero, zero, zero, z, -y], 1),
        torch.stack([zero, one, zero, -z, zero, x], 1),
        torch.stack([zero, zero, one, y, -x, zero], 1),
    ], 1)                                                # (P, 3, 6, L)
    # Jp[p,r,i,l] = sum_j J_proj[p,r,j,l] J_pt_pose[p,j,i,l]
    Jp = torch.sum(J_proj[:, :, :, None] * J_pt_pose[:, None], dim=2)
    # Jl[p,r,i,l] = sum_j J_proj[p,r,j,l] R[p,j,i]
    Jl = torch.sum(J_proj[:, :, :, None] * R[:, None, :, :, None], dim=2)
    return r, Jp, Jl, z


def _residual_norm(r: Tensor) -> Tensor:
    return torch.sqrt(torch.sum(r * r, dim=1))


def _huber_weight(r: Tensor, delta) -> Tensor:
    """sqrt-weights for IRLS Huber: w = min(1, delta/|r|).  r is (P,3,L);
    the norm reduces the component axis."""
    n = _residual_norm(r)
    return torch.sqrt(torch.clamp(delta / n.clamp_min(1e-12), max=1.0))


def robust_cost(r: Tensor, w_valid: Tensor, delta) -> Tensor:
    n = _residual_norm(r)
    quad = 0.5 * n * n
    lin = delta * (n - 0.5 * delta)
    return torch.sum(torch.where(n <= delta, quad, lin) * w_valid)


def dense_normal_equations(
    poses_cw: Tensor, points: Tensor, obs: DenseObs, w_valid: Tensor,
    intrinsics: Tensor, huber_delta,
):
    """Assemble the block normal equations for one LM iteration: multiply-
    reduces over the (P, L) grid plus products contracting L; no scatter.

    Returns (Hpp (P,6,6), Hll (3,3,L), G (P,6,3,L) cross blocks,
    bp (P,6), bl (3,L), cost ()).  A landmark-sharded caller reduces
    Hpp/bp/cost over its shards.
    """
    r, Jp, Jl, z = _dense_residuals_and_jacobians(
        poses_cw, points, obs, intrinsics)
    w_valid = w_valid * (z > 1e-3)
    cost = robust_cost(r, w_valid, huber_delta)
    w = _huber_weight(r, huber_delta) * w_valid          # (P, L)
    r = r * w[:, None]
    Jp = Jp * w[:, None, None]
    Jl = Jl * w[:, None, None]

    # pose blocks: contract (row, L) in one batched (6, 3L) x (3L, 6) product
    Jp2 = Jp.permute(0, 2, 1, 3).reshape(Jp.shape[0], 6, -1)     # (P, 6, 3L)
    Hpp = Jp2 @ Jp2.transpose(1, 2)                      # (P, 6, 6)
    bp = -torch.einsum("pril,prl->pi", Jp, r)
    # landmark blocks: reduces over (p, r)
    Hll = torch.einsum("prjl,prkl->jkl", Jl, Jl)         # (3, 3, L)
    bl = -torch.einsum("prjl,prl->jl", Jl, r)            # (3, L)
    # cross blocks G[p,i,j,l] = sum_r Jp[p,r,i,l] Jl[p,r,j,l]
    G = torch.sum(Jp[:, :, :, None] * Jl[:, :, None, :], dim=1)
    return Hpp, Hll, G, bp, bl, cost


def _damped_hll_inverse(Hll: Tensor, lam, lm_free: Tensor) -> Tensor:
    """LM damping of the landmark blocks (multiplicative on the diagonal,
    with an absolute floor), the identity for frozen landmarks, then the
    adjugate inverse.  Hll (3,3,L), lm_free (L,) -> (3,3,L)."""
    diag_mask3 = torch.eye(3, dtype=Hll.dtype, device=Hll.device)[:, :, None]
    Hll_d = Hll + lam * torch.maximum(Hll * diag_mask3, 1e-6 * diag_mask3)
    # empty landmarks: identity block (their dxl is masked by lm_free, but
    # the adjugate inverse must never divide by an underflowed determinant)
    Hll_d = torch.where(lm_free > 0, Hll_d, diag_mask3)
    return inv3x3_ll(Hll_d)


def _schur_products(G: Tensor, Hll_inv: Tensor, bl: Tensor):
    """Gh = G Hll^-1, then the two contractions over (3, L):
    Gh G^T (6P, 6P) and Gh bl (P, 6)."""
    P, L = G.shape[0], G.shape[-1]
    # Gh[p,i,m,l] = sum_k G[p,i,k,l] Hll_inv[k,m,l]
    Gh = torch.sum(G[:, :, :, None] * Hll_inv[None, None], dim=2)
    G2 = G.reshape(P * 6, 3 * L)
    Gh2 = Gh.reshape(P * 6, 3 * L)
    return Gh2 @ G2.T, (Gh2 @ bl.reshape(3 * L)).reshape(P, 6)


def _reduced_solve(Hpp: Tensor, GhG: Tensor, bp: Tensor, rhs_gh: Tensor,
                   lam, free: Tensor):
    """Solve the damped, gauge-fixed reduced camera system
    (Hpp_d - Gh G^T) dxp = bp - Gh bl.  Returns (dxp (P,6), ok ()): `ok` is
    False when the matrix was not positive definite, and the caller then
    rejects the step.  No status check on the host."""
    P = Hpp.shape[0]
    eye6 = torch.eye(6, dtype=Hpp.dtype, device=Hpp.device)
    diag = torch.diagonal(Hpp, dim1=1, dim2=2)           # (P, 6)
    Hpp_d = Hpp + lam * torch.maximum(torch.diag_embed(diag), 1e-6 * eye6)
    S = (-GhG).reshape(P, 6, P, 6).clone()
    # add the (P,6,6) block-diagonal pose Hessian through the diagonal view
    S.diagonal(dim1=0, dim2=2).add_(Hpp_d.permute(1, 2, 0))
    S = S.reshape(P * 6, P * 6)
    rhs = (bp - rhs_gh).reshape(-1)

    # gauge fixing: zero rows/cols of fixed poses, identity diagonal
    free6 = torch.repeat_interleave(free.to(S.dtype), 6)
    S = S * free6[:, None] * free6[None, :] + torch.diag(1.0 - free6)
    rhs = rhs * free6
    chol, info = torch.linalg.cholesky_ex(S, check_errors=False)
    dxp = cholesky_solve(rhs[:, None], chol)[:, 0].reshape(P, 6)
    return dxp, info == 0


def _solve_schur(Hpp, Hll, G, bp, bl, lam, free, lm_free,
                 psum_many=_identity_many):
    """Damped Schur solve.  Returns (dx_pose (P,6), dx_point (3,L), ok ()).

    `psum_many` reduces the four pose-sized partials (Hpp, Gh G^T, bp,
    Gh bl) over the landmark shards in one collective (identity when
    unsharded).
    """
    P, L = G.shape[0], G.shape[-1]
    Hll_inv = _damped_hll_inverse(Hll, lam, lm_free)     # (3, 3, L)
    GhG, rhs_gh = _schur_products(G, Hll_inv, bl)
    dxp, ok = _reduced_solve(*psum_many(Hpp, GhG, bp, rhs_gh), lam, free)
    # back-substitute landmarks: dxl = Hll^-1 (bl - G^T dxp)
    Gt_dxp = (dxp.reshape(1, P * 6) @ G.reshape(P * 6, 3 * L)).reshape(3, L)
    resid = bl - Gt_dxp
    dxl = torch.sum(Hll_inv * resid[:, None], dim=0)     # (3, L)
    return dxp, dxl, ok


def flatten_poses(poses_cw: Tensor) -> Tensor:
    """(P, 4, 4) T_cw -> the fused kernels' (P, 12) [R row-major | t]."""
    P = poses_cw.shape[0]
    return torch.cat(
        [poses_cw[:, :3, :3].reshape(P, 9), poses_cw[:, :3, 3]], -1)


def stack_obs(obs: DenseObs) -> Tensor:
    """DenseObs -> the fused kernels' (5, P, L) [u, v, z, z_valid, w]."""
    return torch.cat([obs.uv, obs.z[None],
                      obs.z_valid.to(obs.z.dtype)[None], obs.w[None]], 0)


def _lm_step_fused(poses_cw, points, obs5, lm_free, free, scal_head,
                   scal_tail, lam, psum_many=_identity_many):
    """One LM linear solve via the fused kernels (ops/fused_ba): Jacobians
    never reach device memory; only Hll^-1 (9, L) and bl (3, L) round-trip
    for the back-substitution.  Same math as dense_normal_equations +
    _solve_schur.  A landmark-sharded caller runs the kernels on its local
    landmark block and reduces the four pose-sized sums in one collective
    an iteration (`psum_many`)."""
    from jetracer_orbslam2_torch.ops import fused_ba

    poses_flat = flatten_poses(poses_cw)
    scalars = torch.cat([scal_head, lam.reshape(1), scal_tail])[None]
    lm_free1 = lm_free[None]
    Hpp, GhG, bp, rhs_gh, hll_inv, bl = fused_ba.fused_normal_schur(
        poses_flat, points, obs5, lm_free1, scalars)
    dxp, ok = _reduced_solve(*psum_many(Hpp, GhG, bp, rhs_gh), lam, free)
    dxl = fused_ba.fused_backsub(
        poses_flat, points, obs5, lm_free1, scalars, hll_inv, bl, dxp)
    return dxp, dxl, ok


def lm_run_dense(
    poses_cw: Tensor, points: Tensor, obs: DenseObs, fixed: Tensor,
    lm_valid: Tensor, intrinsics: Tensor, cfg: BAConfig,
    psum: Optional[Callable[[Tensor], Tensor]] = None,
    fused: Optional[bool] = None,
    device=None,
    psum_many: Optional[Callable[..., tuple]] = None,
) -> tuple[Tensor, Tensor, Tensor]:
    """The full LM schedule on the dense grid: `cfg.iters` iterations with
    no host wait inside; rejected steps raise lambda and retry.

    points is (L, 3) at entry/exit (the public convention); internally the
    solver runs landmark-last.  psum: reduces pose-sized partial sums over
    landmark shards (None = unsharded); psum_many: several in one
    collective, the four of an LM iteration (None = `psum` on each).
    fused: route the per-iteration linear solve through the fused kernels
    (ops/fused_ba).  Default auto: on for a problem (or a landmark shard of
    one) on a CUDA device whose pose count the kernels take
    (fused_ba.MAX_POSES); True beyond that count raises; False is the dense
    route.  On the CPU `fused=True` runs the kernels' plain versions.  No
    landmark padding: the kernels take any L >= 1.
    Returns (poses_cw, points, cost trace, initial cost first).
    """
    from jetracer_orbslam2_torch.ops import fused_ba

    dev = resolve_device(device)
    set_exact_f32()
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32).to(dev)  # noqa: E731
    poses_cw, points, intrinsics = f32(poses_cw), f32(points), f32(intrinsics)
    obs = DenseObs(uv=f32(obs.uv), z=f32(obs.z),
                   z_valid=torch.as_tensor(obs.z_valid).to(dev),
                   w=f32(obs.w))
    fixed = torch.as_tensor(fixed).to(dev)
    lm_valid = torch.as_tensor(lm_valid).to(dev)

    P = poses_cw.shape[0]
    psum = psum or _identity
    psum_many = psum_many or _each(psum)
    if fused is None:
        fused = dev.type == "cuda" and fused_ba.takes_num_poses(P)
    if fused and not fused_ba.takes_num_poses(P):
        raise ValueError(
            f"fused BA path takes 1..{fused_ba.MAX_POSES} poses, got {P}")
    w_valid = obs.w                                      # (P, L)
    lm_nobs = torch.sum(w_valid, dim=0)
    lm_free = ((lm_nobs >= 2.0) & lm_valid).to(torch.float32)    # (L,)
    free = ~fixed
    huber = cfg.huber_delta
    points = points.T.contiguous()                       # (3, L)

    if fused:
        obs5 = stack_obs(obs)
        scal_head = intrinsics.reshape(-1)[:4]
        scal_tail = torch.cat([
            torch.full((1,), huber, dtype=torch.float32, device=dev),
            torch.zeros(2, dtype=torch.float32, device=dev)])

    def cost_only(poses_cw, points):
        r, (_, _, z), _, _, _ = _dense_residuals(
            poses_cw, points, obs, intrinsics)
        return psum(robust_cost(r, w_valid * (z > 1e-3), huber))

    lam = torch.full((), cfg.damping_init, dtype=torch.float32, device=dev)
    cost0 = cost_only(poses_cw, points)
    trace = [cost0]
    for _ in range(cfg.iters):
        if fused:
            dxp, dxl, ok = _lm_step_fused(
                poses_cw, points, obs5, lm_free, free, scal_head, scal_tail,
                lam, psum_many)
        else:
            Hpp_p, Hll, G, bp_p, bl, _ = dense_normal_equations(
                poses_cw, points, obs, w_valid, intrinsics, huber)
            dxp, dxl, ok = _solve_schur(
                Hpp_p, Hll, G, bp_p, bl, lam, free, lm_free, psum_many)
        new_poses = geo.se3_exp(dxp) @ poses_cw
        new_points = points + dxl * lm_free
        cost1 = cost_only(new_poses, new_points)
        # a NaN cost compares False; a failed factorisation is a rejection
        accept = (cost1 < cost0) & ok
        poses_cw = torch.where(accept, new_poses, poses_cw)
        points = torch.where(accept, new_points, points)
        lam = torch.where(accept, lam * cfg.damping_down,
                          lam * cfg.damping_up).clamp(1e-9, 1e6)
        cost0 = torch.where(accept, cost1, cost0)
        trace.append(cost0)
    return poses_cw, points.T.contiguous(), torch.stack(trace)


def bundle_adjust(
    prob: BAProblem, intrinsics: Tensor, cfg: BAConfig,
    fused: Optional[bool] = None,
    device=None,
) -> tuple[Tensor, Tensor, BAStats]:
    """Run `cfg.iters` LM iterations.  Returns (poses T_wc, points, stats).

    fused: see lm_run_dense.  device: None is cuda:0 (raises without a CUDA
    device), whatever device the problem's tensors lie on; "cpu" runs on the
    CPU.  Nothing inside reads a value back to the host."""
    dev = resolve_device(device)
    set_exact_f32()
    prob = BAProblem(*(torch.as_tensor(f).to(dev) for f in prob))
    intrinsics = torch.as_tensor(intrinsics, dtype=torch.float32).to(dev)
    P = prob.poses.shape[0]
    L = prob.points.shape[0]
    obs, _ = edges_to_dense(
        P, L, prob.obs_kf, prob.obs_lm, prob.obs_uv, prob.obs_z,
        prob.obs_z_valid, prob.obs_valid)
    poses_cw = geo.pose_inverse(prob.poses)
    lm_valid = torch.ones(L, dtype=torch.bool, device=dev)
    poses_cw, points, trace = lm_run_dense(
        poses_cw, prob.points, obs, prob.fixed, lm_valid, intrinsics, cfg,
        fused=fused, device=dev)
    stats = BAStats(
        cost=trace,
        num_edges=torch.sum(prob.obs_valid).to(torch.int32),
    )
    return geo.pose_inverse(poses_cw), points, stats
