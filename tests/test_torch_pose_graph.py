"""Pose-graph optimisation of the PyTorch port vs the JAX package (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jetracer_orbslam2_tpu.config import PoseGraphConfig as JPoseGraphConfig
from jetracer_orbslam2_tpu.models.backend import pose_graph as jpg
from jetracer_orbslam2_tpu.ops import geometry as jgeo

from jetracer_orbslam2_torch import convert
from jetracer_orbslam2_torch.config import PoseGraphConfig
from jetracer_orbslam2_torch.models.backend import pose_graph as tpg

from _torch_port_util import n, t

close = np.testing.assert_allclose


def make_ring(P=12, radius=2.0, drift=0.02, seed=0):
    """Ground-truth poses on a closed ring, drifted odometry estimates and
    the true relative poses of the chain (numpy)."""
    gt = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
    for k in range(P):
        th = 2 * np.pi * k / P
        gt[k, 0, 0] = gt[k, 2, 2] = np.cos(th)
        gt[k, 0, 2], gt[k, 2, 0] = np.sin(th), -np.sin(th)
        gt[k, 0, 3], gt[k, 2, 3] = radius * np.sin(th), radius * (1 - np.cos(th))
    rel = np.stack([np.linalg.inv(gt[k]) @ gt[k + 1] for k in range(P - 1)])
    rng = np.random.default_rng(seed)
    est = [gt[0]]
    for k in range(P - 1):
        noise = jgeo.se3_exp(jnp.asarray(rng.normal(0, drift, 6).astype(np.float32)))
        est.append(est[-1] @ rel[k] @ np.asarray(noise))
    return gt, np.stack(est).astype(np.float32), rel.astype(np.float32)


def ring_fields(gt, est, rel, loop=True, extra=()):
    """Chain edges with the true relative measurements, a loop edge from the
    last node to the first, and any `extra` (i, j) edges, also true."""
    P = len(gt)
    ei, ej = list(range(P - 1)), list(range(1, P))
    T = list(rel)
    for i, j in ([(P - 1, 0)] if loop else []) + list(extra):
        ei.append(i)
        ej.append(j)
        T.append(np.linalg.inv(gt[i]) @ gt[j])
    return dict(poses=est, edge_i=np.int32(ei), edge_j=np.int32(ej),
                edge_T=np.stack(T).astype(np.float32),
                edge_weight=np.ones(len(ei), np.float32),
                fixed=np.arange(P) == 0)


def run_both(fields, iters):
    jprob = jpg.PoseGraphProblem(**{k: jnp.asarray(v) for k, v in fields.items()})
    jposes, jtrace = jpg.optimize_pose_graph(jprob, JPoseGraphConfig(iters=iters))
    tprob = convert.pose_graph_problem_from_numpy(fields, "cpu")
    tposes, ttrace = tpg.optimize_pose_graph(tprob, PoseGraphConfig(iters=iters),
                                             device="cpu")
    return (np.asarray(jposes), np.asarray(jtrace)), (n(tposes), n(ttrace))


def test_edge_residual_matches():
    gt, est, rel = make_ring()
    want = np.stack([np.asarray(jpg._edge_residual(
        jnp.asarray(est[k]), jnp.asarray(est[k + 1]), jnp.asarray(rel[k])))
        for k in range(11)])
    got = tpg._edge_residual(t(est[:-1]), t(est[1:]), t(rel))
    # se3_log of a near-identity product of three f32 poses
    close(n(got), want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("extra", [(), ((11, 0), (3, 7), (7, 3))])
def test_pose_graph_closes_ring(extra):
    """The ring of the JAX package's own test; with `extra`, a second edge
    between the loop's two nodes and a pair of opposite edges, so that
    several edges add into the same off-diagonal blocks."""
    gt, est, rel = make_ring()
    (jposes, jtrace), (tposes, ttrace) = run_both(
        ring_fields(gt, est, rel, extra=extra), 20)
    assert ttrace.shape == jtrace.shape == (21,)
    assert ttrace[-1] < 1e-5 * ttrace[0] + 1e-8
    before = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1).max()
    after = np.linalg.norm(tposes[:, :3, 3] - gt[:, :3, 3], axis=1).max()
    assert after < 0.3 * before
    # the cost falls by twelve orders of magnitude, and after one accepted
    # step it is a second-order remainder of the step's f32 rounding: the
    # trace is held to 1e-4 of the initial cost, the poses to 5e-6
    close(ttrace, jtrace, rtol=1e-3, atol=1e-4 * jtrace[0])
    close(tposes, jposes, rtol=0, atol=5e-6)
    close(tposes[0], est[0], rtol=0, atol=0)           # the anchor


def test_pose_graph_identity_when_consistent():
    gt, _, rel = make_ring(drift=0.0)
    (jposes, _), (tposes, ttrace) = run_both(
        ring_fields(gt, gt, rel, loop=False), 5)
    close(tposes, gt, rtol=0, atol=1e-4)
    close(tposes, jposes, rtol=0, atol=1e-5)
    assert np.isfinite(ttrace).all()


def test_zero_weight_edges_are_ignored():
    gt, est, rel = make_ring()
    f = ring_fields(gt, est, rel, extra=((2, 9),))
    f["edge_T"][-1] = np.eye(4)                  # a wrong measurement ...
    f["edge_weight"][-1] = 0.0                   # ... marked invalid
    (jposes, _), (tposes, ttrace) = run_both(f, 20)
    close(tposes, jposes, rtol=0, atol=5e-6)
    assert ttrace[-1] < 1e-5 * ttrace[0] + 1e-8


def test_failed_factorisation_is_a_rejected_step():
    """A negative weight makes the system indefinite: the poses stay where
    they were, nothing raises, the trace stays finite."""
    gt, est, rel = make_ring(P=5)
    f = ring_fields(gt, est, rel)
    f["edge_weight"][:] = -1.0
    prob = convert.pose_graph_problem_from_numpy(f, "cpu")
    poses, trace = tpg.optimize_pose_graph(prob, PoseGraphConfig(iters=3),
                                           device="cpu")
    assert torch.equal(poses, prob.poses)
    assert bool(torch.isfinite(trace).all()) and trace.shape == (4,)


def test_pose_graph_convert_round_trip():
    gt, est, rel = make_ring(P=4)
    f = ring_fields(gt, est, rel)
    prob = convert.pose_graph_problem_from_numpy(f, "cpu")
    assert prob._fields == jpg.PoseGraphProblem._fields
    for name, value in zip(prob._fields, prob):
        np.testing.assert_array_equal(n(value), f[name], err_msg=name)
        assert n(value).dtype == f[name].dtype, name
