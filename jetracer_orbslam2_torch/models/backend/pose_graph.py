"""Pose-graph optimization on SE(3): Gauss-Newton over relative-pose edges.

Counterpart of `jetracer_orbslam2_tpu/models/backend/pose_graph.py`.  After a
loop is detected and geometrically verified, the accumulated drift is spread
over the trajectory by minimizing

    sum_e || log( Z_e^-1 · T_i^-1 · T_j ) ||^2_Lambda

over keyframe poses T (T_wc), where Z_e is the measured relative pose of
edge (i, j).  Edges are a flat fixed-capacity list; the 6x6 Jacobian blocks
are built batched with an analytic right-Jacobian approximation; H assembly
is one-hot products and `index_put_(accumulate=True)` into a dense (6P, 6P)
system solved by Cholesky.  The loop never makes the host wait for the
device, and a factorisation that fails is a rejected step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from jetracer_orbslam2_torch.config import PoseGraphConfig
from jetracer_orbslam2_torch.ops import geometry as geo
from jetracer_orbslam2_torch.utils.device import resolve_device
from jetracer_orbslam2_torch.utils.linalg import cholesky_solve
from jetracer_orbslam2_torch.utils.precision import set_exact_f32

Tensor = torch.Tensor


class PoseGraphProblem(NamedTuple):
    poses: Tensor     # (P, 4, 4) T_wc initial keyframe poses
    edge_i: Tensor    # (E,) int32 from-node
    edge_j: Tensor    # (E,) int32 to-node
    edge_T: Tensor    # (E, 4, 4) measured T_ij (pose of j in frame i)
    edge_weight: Tensor  # (E,) float32 information weight (0 = invalid)
    fixed: Tensor     # (P,) bool gauge anchors


def _edge_residual(Ti: Tensor, Tj: Tensor, Zij: Tensor) -> Tensor:
    """r = log(Z^-1 · Ti^-1 · Tj) in se(3); batched (E, 4, 4) -> (E, 6)."""
    return geo.se3_log(geo.pose_inverse(Zij) @ geo.pose_inverse(Ti) @ Tj)


def _adjoint(T: Tensor) -> Tensor:
    """(E, 4, 4) -> (E, 6, 6) adjoint [[R, hat(t) R], [0, R]]."""
    R = T[:, :3, :3]
    t = T[:, :3, 3]
    top = torch.cat([R, geo.hat(t) @ R], dim=2)
    bot = torch.cat([torch.zeros_like(R), R], dim=2)
    return torch.cat([top, bot], dim=1)


def optimize_pose_graph(
    prob: PoseGraphProblem, cfg: PoseGraphConfig, device=None,
) -> tuple[Tensor, Tensor]:
    """Damped Gauss-Newton.  Returns (poses T_wc, cost trace).

    Jacobians use the standard small-residual approximation
    J_j = I, J_i = -Ad(T_j^-1 T_i)  (right perturbation on nodes:
    T <- T · exp(xi)), exact at convergence.  device: None is cuda:0 (raises
    without a CUDA device); "cpu" runs on the CPU.
    """
    dev = resolve_device(device)
    set_exact_f32()
    prob = PoseGraphProblem(*(torch.as_tensor(f).to(dev) for f in prob))
    P = prob.poses.shape[0]
    E = prob.edge_i.shape[0]
    w = prob.edge_weight
    ei, ej = prob.edge_i.long(), prob.edge_j.long()
    free6 = torch.repeat_interleave((~prob.fixed).to(torch.float32), 6)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    eye6P = torch.eye(6 * P, dtype=torch.float32, device=dev)
    gauge = torch.diag(1.0 - free6)

    def build(poses):
        Ti = poses[ei]
        Tj = poses[ej]
        r = _edge_residual(Ti, Tj, prob.edge_T)                 # (E, 6)
        cost = torch.sum(torch.sum(r * r, -1) * w)
        return r, Ti, Tj, cost

    # segment sums as products with a (P, E) one-hot matrix: `index_add_`
    # adds with float atomics on the card, in an order that changes from run
    # to run; a product gives the same poses every time
    nodes = torch.arange(P, device=dev)[:, None]
    onehot_i = (ei[None, :] == nodes).to(torch.float32)
    onehot_j = (ej[None, :] == nodes).to(torch.float32)

    def seg(values, onehot):
        """Sum `values` (E, ...) into P segments."""
        flat = onehot @ values.reshape(E, -1)
        return flat.reshape((P,) + values.shape[1:])

    poses = prob.poses
    lam = torch.full((), cfg.damping, dtype=torch.float32, device=dev)
    trace = []
    cost_fin = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in range(cfg.iters):
        r, Ti, Tj, cost = build(poses)
        # J wrt right-perturbation of node j is ~I; of node i is -Ad(Tj^-1 Ti)
        Ji = -_adjoint(geo.pose_inverse(Tj) @ Ti)               # (E, 6, 6)
        Jj = eye6.expand(E, 6, 6)
        wr = r * w[:, None]
        w3 = w[:, None, None]
        # block H assembly: segment sums over the 4 block positions
        Hii = seg(w3 * (Ji.transpose(1, 2) @ Ji), onehot_i)
        Hjj = seg(w3 * Jj, onehot_j)                            # Jj^T Jj = I
        bi = seg(-(Ji.transpose(1, 2) @ wr[:, :, None])[:, :, 0], onehot_i)
        bj = seg(-wr, onehot_j)
        Hij = w3 * Ji.transpose(1, 2)                           # Ji^T Jj

        H = torch.zeros((P, 6, P, 6), dtype=torch.float32, device=dev)
        H.diagonal(dim1=0, dim2=2).add_((Hii + Hjj).permute(1, 2, 0))
        # two edges may join the same pair of nodes: accumulate, not assign
        H4 = H.permute(0, 2, 1, 3)                              # (P, P, 6, 6)
        H4.index_put_((ei, ej), Hij, accumulate=True)
        H4.index_put_((ej, ei), Hij.transpose(1, 2), accumulate=True)
        H = H.reshape(6 * P, 6 * P)
        b = (bi + bj).reshape(-1)

        # damping + gauge
        H = H + lam * eye6P
        H = H * free6[:, None] * free6[None, :] + gauge
        b = b * free6
        chol, info = torch.linalg.cholesky_ex(H, check_errors=False)
        dx = cholesky_solve(b[:, None], chol)[:, 0].reshape(P, 6)
        new_poses = poses @ geo.se3_exp(dx)
        _, _, _, cost1 = build(new_poses)
        # a NaN cost compares False; a failed factorisation is a rejection
        accept = (cost1 < cost) & (info == 0)
        poses = torch.where(accept, new_poses, poses)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
        cost_fin = torch.where(accept, cost1, cost)
        trace.append(cost)
    return poses, torch.stack(trace + [cost_fin])
