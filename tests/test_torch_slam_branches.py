"""The SLAM frame's branches in the PyTorch port (CPU): the relocalization and
keyframe branches through `utils/step_graph.cond`, the top-n loop
verifications as one RANSAC batch, and the draws that do not depend on which
branches ran.

On a CUDA device `models/slam_scan.py` captures a frame with its branches as
conditional nodes of one graph (held against the host-branch step on the
card by `chip_smoke.py` phase 25); on the CPU the same code runs each branch
as a host `if`.  These tests hold what the CPU can show: the batched
verification is the per-candidate loop bit for bit and the JAX package's
`vmap` within its bars, `keyframe_update` is its body before the branches
became `cond`s, `cond` runs only the body taken and a body's writes land in
the carried state, the generator's state after N frames does not depend on
the branches taken, and the frame step reads nothing back to the host.
"""

import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jetracer_orbslam2_tpu.config import LoopClosureConfig as JLoopConfig
from jetracer_orbslam2_tpu.io import synthetic as jsyn
from jetracer_orbslam2_tpu.models.backend import loop as jloop

from jetracer_orbslam2_torch import convert
from jetracer_orbslam2_torch.config import (
    FrontendConfig, LoopClosureConfig, MapConfig, SystemConfig)
from jetracer_orbslam2_torch.models import slam as tslam
from jetracer_orbslam2_torch.models import slam_scan as ss
from jetracer_orbslam2_torch.models import tracking
from jetracer_orbslam2_torch.models.backend import loop as tloop
from jetracer_orbslam2_torch.models.backend import map as tmap
from jetracer_orbslam2_torch.utils import step_graph
from jetracer_orbslam2_torch.utils.ties import first_argmax

from _torch_port_util import INTR, K, build_maps, frame, n, pose, t, world

close = np.testing.assert_allclose

LOOP = dict(min_sim=0.2, min_kf_gap=3, min_inliers=12, world_min_inliers=6)
N_KF = 12
H, W = 120, 160
SCAN_CFG = SystemConfig(
    frontend=FrontendConfig(height=H, width=W, num_levels=2, max_keypoints=256),
    map=MapConfig(max_keyframes=16, max_landmarks=2048, max_obs=8192,
                  kf_min_gap=2, kf_max_gap=4, window_size=4))


@pytest.fixture(scope="module")
def maps():
    """Twelve keyframes of one synthetic world in both packages' maps (the
    shapes of tests/test_torch_loop.py: no new JAX compile)."""
    return build_maps(dict(max_keyframes=16, max_landmarks=512, max_obs=4096),
                      N_KF, check=False)


def _samples(seed, topn=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, K, (topn, tloop.VERIFY_RANSAC_ITERS, 3), generator=g)


def _per_candidate(m, slot, cfg, intr, prev_uid, consist, sample_idx):
    """`loop.retrieve_and_verify` as it was before the batch: one
    verification a shortlisted candidate, in shortlist order."""
    m, slot, intr, prev_uid, consist = tloop._entry(
        torch.device("cpu"), m, slot, intr, prev_uid, consist)
    cands = tloop.retrieve_topn(m, slot, cfg.min_sim, cfg.min_kf_gap, cfg.topn,
                                device="cpu")
    query = tloop._kf_features(m, slot)
    ver = [tloop._verify_pair(
        *query, *tloop._kf_features(m, cands.kf_idx[c]), None,
        cfg.ransac_inlier_thresh, cfg.min_inliers, cfg.ransac_depth_quad,
        sample_idx=sample_idx[c]) for c in range(cfg.topn)]
    ver_ok = torch.stack([v.ok for v in ver])
    ver_inl = torch.stack([v.num_inliers for v in ver])
    ver_T = torch.stack([v.T_ab for v in ver])
    score = torch.where(cands.ok & ver_ok, ver_inl, torch.full_like(ver_inl, -1))
    best_score, best = first_argmax(score, 0)
    cand_idx = tloop._row(cands.kf_idx, best)
    T_ab = tloop._row(ver_T, best)
    geom_ok = best_score > 0
    n_world = tloop._verify_world(
        m, query[0], tloop._row(m.kf_xy, slot), query[1], cand_idx, T_ab, intr,
        cfg.world_window, cfg.world_max_obs)
    retrieved_any = torch.any(cands.ok)
    track_uid = torch.where(geom_ok, tloop._row(m.kf_frame_id, cand_idx),
                            tloop._row(m.kf_frame_id, cands.kf_idx[0]))
    near_prev = torch.abs(track_uid - prev_uid) <= cfg.consistency_window
    one = torch.ones_like(consist)
    consist = torch.where(retrieved_any, torch.where(near_prev, consist + 1, one),
                          torch.zeros_like(consist)).to(torch.int32)
    prev_uid = torch.where(retrieved_any, track_uid,
                           torch.full_like(track_uid, tloop.NO_CANDIDATE_UID)
                           ).to(torch.int32)
    ok = (geom_ok & (n_world >= cfg.world_min_inliers)
          & (consist >= cfg.min_consistency))
    return cand_idx, T_ab, ok, prev_uid, consist


@pytest.mark.parametrize("slot", [5, 8, 11])
def test_batched_verification_is_the_per_candidate_loop(maps, slot):
    tm, _ = maps
    cfg = LoopClosureConfig(**LOOP)
    idx = _samples(slot)
    got = tloop.retrieve_and_verify(tm, slot, None, cfg, t(INTR), 10 * 2, 1,
                                    sample_idx=idx, device="cpu")
    want = _per_candidate(tm, slot, cfg, t(INTR), 10 * 2, 1, idx)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the uniforms' route: the samples they give, injected, give the same
    u = torch.rand((cfg.topn, tloop.VERIFY_RANSAC_ITERS, 3),
                   generator=torch.Generator().manual_seed(slot))
    by_u = tloop.retrieve_and_verify(tm, slot, None, cfg, t(INTR), 10 * 2, 1,
                                     uniforms=u, device="cpu")
    assert bool(by_u[2]) == bool(got[2]) or not bool(want[2])


def test_batched_verification_matches_the_jax_vmap(maps):
    """The JAX package verifies the shortlist with `vmap`; the port's batch,
    with the JAX package's own samples injected, gives its decision."""
    tm, jm = maps
    jcfg, tcfg = JLoopConfig(**LOOP), LoopClosureConfig(**LOOP)
    slot = 11
    key = jax.random.PRNGKey(100 + slot)
    want = jloop.retrieve_and_verify(jm, jnp.int32(slot), key, jcfg,
                                     jnp.asarray(INTR), jnp.int32(20),
                                     jnp.int32(1))
    cands = jloop.retrieve_topn(jm, jnp.int32(slot), jcfg.min_sim,
                                jcfg.min_kf_gap, jcfg.topn)
    keys = jax.random.split(key, jcfg.topn)
    idx = []
    for c in range(jcfg.topn):
        b = int(cands.kf_idx[c])
        from jetracer_orbslam2_tpu.ops import match as jmatch
        res = jmatch.match(jm.kf_desc[slot], jm.kf_desc[b], jm.kf_has_point[slot],
                           jm.kf_has_point[b], xy_a_pred=None, xy_b=None,
                           window=0.0, max_hamming=80.0, mutual=True)
        w = np.asarray(res.valid & jm.kf_has_point[b][res.idx])
        logits = jnp.log(jnp.maximum(jnp.asarray(w, jnp.float32), 1e-20))
        idx.append(np.asarray(jax.random.categorical(
            keys[c], logits, shape=(tloop.VERIFY_RANSAC_ITERS, 3))))
    got = tloop.retrieve_and_verify(tm, slot, None, tcfg, t(INTR), 20, 1,
                                    sample_idx=t(np.stack(idx)), device="cpu")
    assert int(got[0]) == int(want[0])
    close(n(got[1]), n(want[1]), rtol=0, atol=1e-4)
    assert bool(got[2]) == bool(want[2])
    assert (int(got[3]), int(got[4])) == (int(want[3]), int(want[4]))


def _old_keyframe_update(m, feats, T_wc, frame_idx, lm_idx, lm_ok, intr, cfg,
                         prev_uid, consist, sample_idx):
    """`slam.keyframe_update` before its branches became `cond`s: the verdict
    and the counters in one packed fetch, then host branches."""
    new_mask = feats.has_point & ~lm_ok
    m, slot = tmap.insert_keyframe(m, feats, T_wc, frame_idx, new_mask, lm_idx,
                                   lm_ok, device="cpu")
    m = tslam.local_ba(m, intr, cfg.map.window_size, cfg, device="cpu")
    cand_idx, T_ab, loop_ok, lp_uid, lp_cons = _per_candidate(
        m, slot, cfg.loop, intr, prev_uid, consist, sample_idx)
    num_obs, num_lm, num_kf, looped = torch.stack(
        [m.num_obs, m.num_lm, m.num_kf, loop_ok.to(torch.int32)]).tolist()
    if looped:
        m = tloop.close(m, slot, cand_idx, T_ab, cfg.pose_graph, device="cpu")
    T_wc = tloop._row(m.kf_pose, slot)
    mc = cfg.map
    kf_cap = m.kf_valid.shape[0]
    kf_full = num_kf > mc.compact_at * kf_cap
    if kf_full:
        m = tmap.compact_keyframes(
            m, mc.kf_cull_redundancy, mc.kf_cull_min_covisible,
            mc.kf_protect_recent, round(mc.kf_target_fill * kf_cap),
            mc.kf_protect_loop_recent, device="cpu")
    compacted = (kf_full or num_obs > mc.compact_at * m.obs_valid.shape[0]
                 or num_lm > mc.compact_at * m.lm_valid.shape[0])
    if compacted:
        m = tmap.compact_map(m, mc.cull_min_obs, mc.cull_min_age_kf,
                             device="cpu")
    return m, T_wc, m.num_kf - 1, looped, compacted, lp_uid, lp_cons


def test_keyframe_update_is_its_body_before_the_branches(maps):
    """A revisit of keyframe 2's view with the consistency gate one keyframe
    from open: the loop closes and the keyframe table (13 of 16 slots, over
    compact_at) is compacted; the branches on host values give what the old
    body gave, bit for bit."""
    tm, _ = maps
    cfg = SystemConfig(map=MapConfig(max_keyframes=16, max_landmarks=512,
                                     max_obs=4096, window_size=4),
                       loop=LoopClosureConfig(**LOOP))
    feats = convert.features_from_numpy(frame(world(0), 2, 7), "cpu")
    T = torch.from_numpy(pose(2))
    lm_idx, lm_ok = tmap.associate_landmarks(tm, feats, T, t(INTR), device="cpu")
    idx = _samples(3)
    up = tslam.keyframe_update(tm, feats, T, 120, lm_idx, lm_ok, t(INTR), cfg,
                               None, 20, 1, sample_idx=idx, device="cpu")
    m, T_wc, slot, looped, compacted, lp_uid, lp_cons = _old_keyframe_update(
        tm, feats, T, 120, lm_idx, lm_ok, t(INTR), cfg, t(20), t(1), idx)
    assert looped and compacted
    assert up.looped == looped and up.compacted == compacted
    for f, a, b in zip(tmap.MapState._fields, up.m, m):
        assert torch.equal(a, b), f
    for a, b in ((up.T_wc, T_wc), (up.slot, slot), (up.loop_prev_uid, lp_uid),
                 (up.loop_consist, lp_cons)):
        assert torch.equal(a, b)


def test_cond_runs_only_the_body_taken_and_writes_back():
    ran = []
    step_graph.cond(torch.tensor(False), lambda: ran.append("no"))
    step_graph.cond(0, lambda: ran.append("no"))
    step_graph.cond(torch.tensor(True), lambda: ran.append("yes"))
    step_graph.cond(1, lambda: ran.append("yes"))
    assert ran == ["yes", "yes"]
    assert step_graph.branch_values(torch.tensor(True), torch.tensor(5),
                                    torch.tensor(0, dtype=torch.int32)) == [1, 5, 0]

    def fn(gen, carry, flag, x):
        def body():
            carry[0].copy_(carry[0] + x)
            carry[1].add_(1)
        step_graph.cond(*step_graph.branch_values(flag), body)
        return carry[0] * 2

    g = step_graph.FrameGraph(fn, None)
    state = (torch.zeros(3), torch.zeros((), dtype=torch.int32))
    x = torch.ones(3)
    outs, carry = [], state
    for v in (True, False, True):
        outs.append(g(carry, torch.tensor(v), x))
        carry = g.carry()                 # the buffers: not copied again
    assert [o.tolist() for o in outs] == [[2.0] * 3, [2.0] * 3, [4.0] * 3]
    # the state lives in the graph's buffers: the argument is untouched
    assert torch.equal(state[0], torch.zeros(3)) and int(state[1]) == 0
    held = g.export()
    assert torch.equal(held[0], torch.full((3,), 2.0)) and int(held[1]) == 2
    # handing the exported state back copies nothing; another state is loaded
    g(held, torch.tensor(False), x)
    assert g._carry_copied[0][0] is g._carry[0]
    out = g(state, torch.tensor(True), x)
    assert torch.equal(out, torch.full((3,), 2.0)) and g.eager_calls == 5
    with pytest.raises(ValueError):
        g((torch.zeros(4), state[1]), torch.tensor(True), x)


def test_uniforms_become_samples_of_the_weighted_pairs():
    w = torch.tensor([0.0, 1.0, 0.0, 1.0, 1.0, 0.0])
    u = torch.rand((2, 64, 3), generator=torch.Generator().manual_seed(0))
    idx = tracking.samples_from_uniforms(w.expand(2, -1), u)
    assert idx.shape == (2, 64, 3) and idx.dtype == torch.int64
    assert set(idx.unique().tolist()) == {1, 3, 4}
    # inverse CDF: [0, 1/3) -> 1, [1/3, 2/3) -> 3, [2/3, 1) -> 4
    edge = torch.tensor([[[0.0, 0.34, 0.99]]])
    assert tracking.samples_from_uniforms(w[None], edge).tolist() == [[[1, 3, 4]]]
    # no weight at all: every index alike, as torch.multinomial draws it
    flat = tracking.samples_from_uniforms(torch.zeros(4), torch.tensor(
        [[0.1, 0.3, 0.6], [0.9, 0.0, 0.26]]))
    assert flat.tolist() == [[0, 1, 2], [3, 0, 1]]


@pytest.fixture(scope="module")
def arc():
    seq = jsyn.generate_sequence(n_frames=16, shape=(H, W))
    return np.asarray(seq.gray), np.asarray(seq.depth), np.asarray(seq.intrinsics)


def test_draws_do_not_depend_on_the_branches_taken(arc):
    """Two runs of 15 frames whose branches differ (frames 8-11 blank: the
    tracker loses them and relocalizes, and keyframes fall elsewhere) leave
    the generator where 15 frames leave it, in slam_scan and in Slam."""
    gray, depth, intr = arc
    blank = gray.copy()
    blank[8:12] = 0
    states, relocs, kfs = [], [], []
    for g in (gray, blank):
        st = ss.init_scan_state(g[0], depth[0], intr, SCAN_CFG, device="cpu")
        final, out = ss.slam_scan(st, g[1:], depth[1:], intr, SCAN_CFG)
        states.append(final.generator.get_state())
        relocs.append(int(final.num_relocs))
        kfs.append(n(out.is_kf).tolist())
    assert relocs[0] == 0 and relocs[1] >= 1 and kfs[0] != kfs[1]
    assert torch.equal(states[0], states[1])
    slam = tslam.Slam(SCAN_CFG, intr, device="cpu")
    for i in range(blank.shape[0]):
        slam.process_frame(blank[i], depth[i])
    assert slam.num_relocs == relocs[1]
    assert torch.equal(slam.generator.get_state(), states[0])


def _no_host_read(fn) -> list:
    src = inspect.getsource(fn)
    src = "\n".join(line.split("#")[0] for line in src.splitlines())
    return re.findall(r"\.cpu\(|\.tolist\(|\.item\(|\bbool\(", src)


@pytest.mark.parametrize("fn", [ss._step, ss._frame, tslam.keyframe_update,
                                tslam.compact_if_full, tslam.relocalize],
                         ids=lambda f: f.__name__)
def test_the_frame_step_reads_nothing_back(fn):
    """The frame's branches read their predicates through
    `step_graph.branch_values` (the device tensors inside a frame graph),
    never from the host themselves."""
    assert _no_host_read(fn) == []
