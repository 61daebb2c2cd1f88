#!/usr/bin/env python3
"""The port's landmark-sharded BA across the cards of one host.

    python3 scripts/bench_torch_ba_scaling.py [--landmarks 8192] [--sizes 1,2,4,8]
        [--parts 1,2,3]

Counterpart of `scripts/bench_ba_scaling.py` for `jetracer_orbslam2_torch`.
Needs CUDA cards; NCCL; rank r on cuda:r; one process a rank.  Three parts:

  1. strong scaling: `parallel.bench_ba.measure_scaling` over the mesh sizes
     up to the card count (ms per LM iteration, efficiency t(1) / (n t(n)));
  2. the standalone solve on every card against one rank: the distributed
     worker started once per card and once alone on cuda:0 (8 x 4,096, 10
     iterations): the ranks must agree bit for bit and stay within poses
     5e-3 and points 2e-2 of the one-rank solve;
  3. the SLAM system across the cards: `python -m torch.distributed.run
     --nproc-per-node N -m jetracer_orbslam2_torch.run --synthetic 120
     --mesh N --distributed`, whole and `--chunked 8`, against the meshless
     CLI runs (every rank's report; keyframes, loops and relocs must equal
     the meshless run's, ATE below 10 cm); then this script's own ranks
     (`--chunked-rank DIR` under `torch.distributed.run`) run the CLI's
     frames, and `chip_smoke.py` phase 25's 32-slot lifecycle (it closes
     loops and compacts), through `ChunkedSlam(mesh=...)`, whose frame
     graph holds the sharded BA's all-reduces (K8) in its keyframe body,
     and through the host-branch step `_step` with the same mesh (K8, and
     the group's own all-reduce), each on its map and on one of 2,048
     landmark slots (over whose four blocks the landmarks spread): the
     ranks' poses, flags and counters must be bit-identical, keyframes,
     loops and relocs those of the meshless ChunkedSlam, keyframe poses
     within 2e-3 and the trajectory within 5e-3 of it (the bars of
     `tests/test_torch_distributed.py`: the all-reduce sums in another
     order), the graph bit-equal to `_step` with K8, and the chunked run
     must make no host wait but one a chunk, in the call that returns it
     (sync debug "warn", after a meshless run in the same process).
     Whether the graph is bit-equal to `_step` with the group's all-reduce
     is reported, with, for one windowed BA on each final map, how many
     elements of the all-reduced partials 0, 1, ... ranks hold non-zero
     (with at most two the order of the sum leaves no trace).  Last, K8
     against NCCL's all-reduce at the body's payloads (Gh G^T, an LM
     iteration's packed partials, the same in the JAX package's layout,
     the gather), eager and as a replayed graph, beside K8's bound.

Prints the cards' names and power limits first, one line a part, and a JSON
summary last.  Exits non-zero if a part fails.  Every subprocess has a
timeout, every group a 5-minute one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 600


def _run(cmd, **kw) -> subprocess.CompletedProcess:
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                         timeout=TIMEOUT_S, **kw)
    if out.returncode != 0:
        raise SystemExit(f"FAIL: {' '.join(cmd)} exited {out.returncode}:\n"
                         + out.stderr[-3000:])
    return out


def _json_lines(text: str) -> list:
    """Every JSON object printed in `text`, in order.  The ranks under
    `torch.distributed.run` share one stdout, and ranks that finish in
    lockstep can print two objects on one line."""
    decoder, out, i = json.JSONDecoder(), [], 0
    while (i := text.find("{", i)) >= 0:
        try:
            obj, i = decoder.raw_decode(text, i)
        except json.JSONDecodeError:
            i += 1
            continue
        out.append(obj)
    return out


def solve_on_every_card(n: int, tmp: str) -> tuple[dict, bool]:
    """Part 2: n ranks (one a card) against one rank on cuda:0."""
    import numpy as np

    worker = [sys.executable, "-m",
              "jetracer_orbslam2_torch.parallel.distributed_worker"]
    common = ["--problem", "8,4096,6", "--iters", "10", "--time", "3"]
    procs = [subprocess.Popen(
        worker + [f"file://{tmp}/store_n", str(n), str(r), "--device",
                  f"cuda:{r}", "--save", f"{tmp}/rank{r}.npz"] + common,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
        for r in range(n)]
    outs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=TIMEOUT_S)
            if p.returncode != 0:
                raise SystemExit(f"FAIL: a rank exited {p.returncode}:\n{e[-3000:]}")
            outs.append(_json_lines(o)[-1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    one = _json_lines(_run(worker + [f"file://{tmp}/store_1", "1", "0",
                                     "--device", "cuda:0", "--save",
                                     f"{tmp}/one.npz"] + common).stdout)[-1]
    got = [np.load(f"{tmp}/rank{r}.npz") for r in range(n)]
    ref = np.load(f"{tmp}/one.npz")
    same = all(np.array_equal(g[k], got[0][k]) for g in got
               for k in ("poses", "points", "trace"))
    dp = float(np.abs(got[0]["poses"] - ref["poses"]).max())
    dx = float(np.abs(got[0]["points"] - ref["points"]).max())
    row = {"ranks": n, "ranks_equal": same, "max_pose_diff": dp,
           "max_point_diff": dx, "cost": [outs[0]["cost0"], outs[0]["cost_final"]],
           "ms_per_iter": outs[0]["timing"]["ms_per_iter"],
           "one_rank_ms_per_iter": one["timing"]["ms_per_iter"],
           "launches": [o["launches"] for o in outs], "backend": outs[0]["backend"]}
    ok = same and dp < 5e-3 and dx < 2e-2 and all(
        o["launches"] == {"fused_normal_schur": 10, "fused_backsub": 10}
        for o in outs)
    return row, ok


def slam_across_cards(n: int, extra=()) -> tuple[dict, bool]:
    """Part 3: the CLI with --mesh n under torch.distributed.run against the
    meshless run (extra: more CLI arguments for both, as --chunked 8)."""
    cli = ["-m", "jetracer_orbslam2_torch.run", "--synthetic", "120",
           "--json", "--log-level", "warning", *extra]
    meshless = _json_lines(_run([sys.executable] + cli).stdout)[-1]
    ranks = _json_lines(_run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         str(n), "--master-port", "29517"] + cli
        + ["--mesh", str(n), "--distributed"]).stdout)
    keys = ("keyframes", "loops", "relocs")
    ok = (len(ranks) == n and all(
        r["mesh_devices"] == n and r["ba_edges_dropped"] == 0
        and r["ate_rmse_m"] < 0.10 and all(r[k] == meshless[k] for k in keys)
        for r in ranks)
        and sorted(r["device"] for r in ranks) == [f"cuda:{i}" for i in range(n)])
    return {"meshless": meshless, "ranks": ranks}, ok


CHUNK = 8
# ChunkedSlam against its meshless run (tests/test_torch_distributed.py)
KF_POSE_ATOL, TRAJ_ATOL = 2e-3, 5e-3


def _count_waits(fn):
    """(fn(), host waits inside it) under sync-debug "warn"."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing" in str(w.message) for w in caught)


# the sequences of part 3's ChunkedSlam check: the CLI's 120 frames on its
# map (16,384 landmark slots, which the run's ~1,300 landmarks fill from
# slot 0, so they all lie in rank 0's block and the other ranks add zeros)
# and on one of 2,048 slots (over whose blocks the same landmarks spread);
# then chip_smoke.py phase 25's 32-keyframe-slot lifecycle (three laps and
# 16 frames of a 110-frame lap at 240x180: it closes loops and compacts) on
# its map and on one of 2,048 slots
CHUNKED_MAPS = (("cli", None), ("2048_slots", 2048), ("lifecycle", None),
                ("lifecycle_2048_slots", 2048))


def _sequence(label: str, slots, args, src, dev):
    """(frames [(gray, depth)], intrinsics, SystemConfig) of a map of
    CHUNKED_MAPS."""
    from jetracer_orbslam2_torch import run
    from jetracer_orbslam2_torch.config import (
        FrontendConfig, MapConfig, SystemConfig, TrackingConfig)

    if label.startswith("lifecycle"):
        sys.path.insert(0, ROOT)
        import chip_smoke as cs

        h, w = cs.LAP_SHAPE
        n = 3 * cs.LAP_LENGTH + 16
        seq, depth = cs._lap(cs.LAP_SHAPE, n, cs.LAP_LENGTH, cs.LAP_NOISE, 0,
                             dev)
        cfg = SystemConfig(
            frontend=FrontendConfig(height=h, width=w, num_levels=3,
                                    max_keypoints=512),
            tracking=TrackingConfig(match_window=16.0),
            map=MapConfig(max_keyframes=32))
        frames = [(seq.gray[i], depth[i]) for i in range(n)]
        intr = seq.intrinsics
    else:
        cfg = SystemConfig(frontend=run._frontend_cfg(args, src.hw, src.cal))
        frames = [(g, d) for g, d, _, _ in src.frames()]
        intr = src.intr
    if slots is not None:
        cfg = cfg.replace(map=dataclasses.replace(cfg.map,
                                                  max_landmarks=slots))
    return frames, intr, cfg


class _CountingMesh:
    """A mesh whose psum and psum_many also count, for every element of
    every partial, how many ranks' partials are non-zero there (an
    all-gather beside the all-reduce): the terms whose order the sum can
    feel.  With at most two non-zero terms every order gives the same bits
    (a + b = b + a, x + 0 = x)."""

    def __init__(self, mesh):
        import torch

        self.mesh = mesh
        self.hist = torch.zeros(mesh.size + 1, dtype=torch.int64)

    def __getattr__(self, name):
        return getattr(self.mesh, name)

    def _count(self, x):
        import torch
        import torch.distributed as dist

        parts = [torch.empty_like(x) for _ in range(self.mesh.size)]
        dist.all_gather(parts, x.contiguous())
        nonzero = (torch.stack(parts) != 0).sum(0).flatten()
        self.hist += torch.bincount(nonzero, minlength=self.mesh.size + 1).cpu()

    def psum(self, x):
        self._count(x)
        return self.mesh.psum(x)

    def psum_many(self, *xs):
        import torch

        self._count(torch.cat([x.reshape(-1) for x in xs]))
        return self.mesh.psum_many(*xs)


def _contributors(m, intr, cfg, mesh) -> list:
    """For one windowed BA on map m (the run's last window), the number of
    elements of the all-reduced partials that 0, 1, ... size ranks'
    partials hold non-zero."""
    from jetracer_orbslam2_torch.parallel import ba_sharded

    counting = _CountingMesh(mesh)
    ba_sharded.sharded_local_ba(m, intr, cfg.map.window_size, cfg, counting)
    return counting.hist.tolist()


# K8's payloads timed against NCCL: Gh G^T (6P x 6P at P 8), an LM
# iteration's four partials packed (Hpp (P, 6, 6), Gh G^T, bp, Gh bl), the
# same four in the JAX package's layout (its Hpp 6P x 6P as well), and the
# gather of the 16,384 x 3 landmark coordinates
K8_TIMED = (("GhG", 48 * 48), ("packed", 8 * 36 + 48 * 48 + 2 * 48),
            ("packed_jax_layout", 2 * 48 * 48 + 2 * 48),
            ("gather", 16384 * 3))


def _k8_times(mesh, dev) -> dict:
    """µs a call of K8 and of its plain version (NCCL's all-reduce) at
    K8_TIMED's payloads, every rank in lockstep: eager (CUDA events around
    100 calls after 10) and graphed (a captured graph of 20 calls, replayed
    20 times after a warm-up replay; the median replay over 20), K8's bound
    beside them (`fused_allreduce.bound_seconds`)."""
    import statistics

    import torch
    import torch.distributed as dist

    from jetracer_orbslam2_torch.ops import fused_allreduce

    out = {}
    for name, n in K8_TIMED:
        x = torch.randn(n, device=dev)
        out[f"bound_us_{name}"] = fused_allreduce.bound_seconds(n, mesh.size) * 1e6
        for route, fn in (
                ("k8", lambda: fused_allreduce.peer_allreduce(x, mesh.peers)),
                ("nccl", lambda: fused_allreduce.peer_allreduce_reference(x))):
            for _ in range(10):
                fn()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(100):
                fn()
            stop.record()
            stop.synchronize()
            out[f"{route}_us_{name}"] = start.elapsed_time(stop) * 10
            dist.barrier()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(20):
                    fn()
            graph.replay()
            times = []
            for _ in range(20):
                start.record()
                graph.replay()
                stop.record()
                stop.synchronize()
                times.append(start.elapsed_time(stop) * 1e3 / 20)
            out[f"{route}_graphed_us_{name}"] = statistics.median(times)
            del graph
            torch.cuda.synchronize()
            dist.barrier()
    return out


def chunked_rank(out_dir: str) -> int:
    """One rank of part 3's ChunkedSlam check (run under
    `torch.distributed.run`): for each map of CHUNKED_MAPS, its frames
    through the meshless ChunkedSlam (first: it also uploads the process's
    cached constants), through `ChunkedSlam(mesh=...)` with every call's
    host waits counted, and through the host-branch step with the same mesh,
    once with K8 (the mesh's collectives) and once with the group's own
    all-reduce (`plain_collectives`); then one windowed BA on the final map
    with its partials' non-zero terms counted.  Writes rank<r>.npz and
    rank<r>.json (one object a map)."""
    import numpy as np
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from jetracer_orbslam2_torch import run
    from jetracer_orbslam2_torch.models import slam_scan as ss
    from jetracer_orbslam2_torch.parallel import mesh as mesh_mod
    from jetracer_orbslam2_torch.utils.precision import set_exact_f32

    set_exact_f32()
    mesh_mod.init_distributed()
    dev = mesh_mod.rank_device()
    mesh = mesh_mod.make_mesh(dist.get_world_size(), device=dev)
    saved, lines = {}, []
    try:
        args = run.build_argparser().parse_args(
            ["--synthetic", "120", "--chunked", str(CHUNK)])
        src = run._open_source(args, dev)
        for label, slots in CHUNKED_MAPS:
            frames, intr, cfg = _sequence(label, slots, args, src, dev)
            result = {}
            for name, m in (("meshless", None), ("graph", mesh)):
                ch = ss.ChunkedSlam(cfg, intr, chunk_size=CHUNK, mesh=m,
                                    device=dev)
                waits = []
                for g, d in frames:
                    out, k = _count_waits(lambda: ch.process_frame(g, d))
                    waits.append((k, out is not None))
                out, k = _count_waits(ch.flush)
                if out is not None:
                    waits.append((k, True))
                outs = [np.concatenate([getattr(o, f) for o in ch._outs])
                        for f in ss.ScanOutput._fields]
                result[name] = dict(
                    poses=ch.result(), kf_pose=ch.state.m.kf_pose.cpu().numpy(),
                    tracked=ch.tracked(), is_kf=outs[4], T_rel=outs[1],
                    counters=np.array([int(ch.state.m.num_kf),
                                       int(ch.state.num_loops),
                                       int(ch.state.num_relocs),
                                       int(ch.state.ba_edges_dropped)]),
                    waits=np.array(waits, np.int64),
                    captures=ch.state.graph.captures,
                    replays=ch.state.graph.replays,
                    cache_hits=ch.state.graph.cache_hits,
                    landmarks=int(ch.state.m.num_lm), final_map=ch.state.m)
            # the host-branch step with the same mesh, from the same start:
            # K8's collectives, then the group's own
            host = {}
            for plain in (False, True):
                state = ss.init_scan_state(frames[0][0], frames[0][1], intr,
                                           cfg, device=dev)
                rows = []
                for g, d in frames[1:]:
                    state, row = ss._step(state, g, d, (None, False), intr,
                                          cfg, mesh, plain_collectives=plain)
                    rows.append(row[1].cpu().numpy())
                host["plain" if plain else "k8"] = (
                    np.stack(rows), state.m.kf_pose.cpu().numpy())
            gr, m0 = result["graph"], result["meshless"]
            contributors = _contributors(gr.pop("final_map"), intr, cfg, mesh)
            m0.pop("final_map")
            saved.update({f"{label}_{k}_{f}": v for k, r in result.items()
                          for f, v in r.items() if isinstance(v, np.ndarray)})
            chunk_calls = gr["waits"][:, 1] == 1
            lb = cfg.map.max_landmarks // mesh.size
            lines.append({
                "map": label, "rank": mesh.rank, "device": str(dev),
                "world": mesh.size, "frames": len(frames),
                "landmark_slots": cfg.map.max_landmarks,
                "landmarks": gr["landmarks"],
                "blocks_holding_landmarks": -(-gr["landmarks"] // lb),
                "counters": gr["counters"].tolist(),
                "meshless_counters": m0["counters"].tolist(),
                "chunks": int(chunk_calls.sum()),
                "waits_in_chunk_calls": gr["waits"][chunk_calls, 0].tolist(),
                "calls_with_other_waits": [
                    [i, int(k)] for i, (k, c) in enumerate(gr["waits"].tolist())
                    if k and not c],
                "meshless_calls_with_other_waits": [
                    [i, int(k)] for i, (k, c) in enumerate(m0["waits"].tolist())
                    if k and not c],
                "captures": gr["captures"], "replays": gr["replays"],
                "cache_hits": gr["cache_hits"],
                "graph_equals_host_branch": {
                    route: bool(np.array_equal(gr["T_rel"], t_rel)
                                and np.array_equal(gr["kf_pose"], kf_pose))
                    for route, (t_rel, kf_pose) in host.items()},
                "last_window_nonzero_partials_histogram": contributors,
                "max_kf_pose_diff_to_meshless": float(
                    np.abs(gr["kf_pose"] - m0["kf_pose"]).max()),
                "max_pose_diff_to_meshless": float(
                    np.abs(gr["poses"] - m0["poses"]).max())})
        lines.append({"map": "k8_times", "rank": mesh.rank,
                      **_k8_times(mesh, dev)})
    finally:
        mesh.close()
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **saved)
    with open(os.path.join(out_dir, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(lines, f)
    return 0


def chunked_across_cards(n: int, tmp: str) -> tuple[dict, bool]:
    """Part 3's ChunkedSlam check: n ranks of `chunked_rank`; one row a map
    of CHUNKED_MAPS."""
    import numpy as np

    _run([sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
          str(n), "--master-port", "29518", os.path.abspath(__file__),
          "--chunked-rank", tmp])
    lines = []
    for r in range(n):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            lines += json.load(f)
    got = [np.load(os.path.join(tmp, f"rank{r}.npz")) for r in range(n)]
    rows = {"k8_times": [r for r in lines if r["map"] == "k8_times"]}
    ok = True
    for label, _ in CHUNKED_MAPS:
        ranks = [r for r in lines if r["map"] == label]
        key = lambda f: f"{label}_graph_{f}"  # noqa: E731
        same = all(np.array_equal(g[key(f)], got[0][key(f)]) for g in got
                   for f in ("poses", "tracked", "is_kf", "counters", "kf_pose"))
        r0 = got[0]
        graph_c = r0[key("counters")]
        meshless_c = r0[f"{label}_meshless_counters"]
        # counters: keyframes, loops, relocs, dropped edges
        outcome = (graph_c[:3].tolist() == meshless_c[:3].tolist()
                   and int(graph_c[3]) == 0)
        close = (np.abs(r0[key("kf_pose")] - r0[f"{label}_meshless_kf_pose"]).max()
                 <= KF_POSE_ATOL
                 and np.abs(r0[key("poses")] - r0[f"{label}_meshless_poses"]).max()
                 <= TRAJ_ATOL)
        waits = all(not r["calls_with_other_waits"] and r["chunks"] > 0
                    and all(k == 1 for k in r["waits_in_chunk_calls"])
                    and (r["captures"], r["replays"], r["cache_hits"])
                    == (1, r["frames"] - 1, 0)
                    for r in ranks)
        # K8 in the graph and K8 eagerly: the same sums in the same order
        same_k8 = all(r["graph_equals_host_branch"]["k8"] for r in ranks)
        rows[label] = {"ranks": ranks, "ranks_bit_identical": same,
                       "outcome_equals_meshless": outcome,
                       "within_bars": bool(close), "one_wait_a_chunk": waits,
                       "graph_equals_host_branch_k8": same_k8,
                       "graph_equals_host_branch_plain": [
                           r["graph_equals_host_branch"]["plain"]
                           for r in ranks],
                       "last_window_nonzero_partials_histogram":
                           ranks[0]["last_window_nonzero_partials_histogram"]}
        ok = (ok and len(ranks) == n and same and outcome and close and waits
              and same_k8)
    return rows, bool(ok)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--poses", type=int, default=8)
    ap.add_argument("--landmarks", type=int, default=8192)
    ap.add_argument("--obs-per-lm", type=int, default=6)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--sizes", default="1,2,4,8")
    ap.add_argument("--parts", default="1,2,3",
                    help="the parts to run (see above)")
    ap.add_argument("--chunked-rank", metavar="DIR", default=None,
                    help=argparse.SUPPRESS)   # one rank of part 3 (internal)
    args = ap.parse_args()
    if args.chunked_rank:
        return chunked_rank(args.chunked_rank)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from jetracer_orbslam2_torch.parallel.bench_ba import measure_scaling
    from jetracer_orbslam2_torch.utils import cuda_build

    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(cards, flush=True)
    # every library the ranks load, built once before they start
    cuda_build.build_libraries(["fast_nms", "ba_fused", "patch_gather",
                                "rigid_fit", "pose_polish", "ransac_hyp",
                                "peer_allreduce", "graph_cond"])
    n_cards = torch.cuda.device_count()

    parts = {int(p) for p in args.parts.split(",")}
    summary = {"cards": cards}
    if 1 in parts:
        rows = measure_scaling(
            tuple(int(s) for s in args.sizes.split(",")), args.poses,
            args.landmarks, args.obs_per_lm, args.iters)
        print(f"# BA scaling: P={args.poses} L={args.landmarks} "
              f"obs/lm={args.obs_per_lm} iters={args.iters}, {n_cards} card(s)")
        for r in rows:
            print(f"{r['n']:>3} {r['ms_per_iter']:>10.3f} ms/iter  efficiency "
                  f"{r['efficiency']:.3f}  cost drop {r['cost_drop']:.1f}",
                  flush=True)
        summary["scaling"] = rows
    failed = []
    if n_cards > 1 and 2 in parts:
        with tempfile.TemporaryDirectory(prefix="jetracer_cards_") as tmp:
            summary["solve"], ok = solve_on_every_card(n_cards, tmp)
        print("solve on every card: " + json.dumps(summary["solve"]), flush=True)
        if not ok:
            failed.append("solve")
    if n_cards > 1 and 3 in parts:
        summary["slam"], ok = slam_across_cards(n_cards)
        print("SLAM across the cards: " + json.dumps(summary["slam"]), flush=True)
        if not ok:
            failed.append("slam")
        summary["slam_chunked"], ok = slam_across_cards(
            n_cards, ["--chunked", str(CHUNK)])
        print(f"SLAM across the cards, --chunked {CHUNK}: "
              + json.dumps(summary["slam_chunked"]), flush=True)
        if not ok:
            failed.append("slam_chunked")
        with tempfile.TemporaryDirectory(prefix="jetracer_chunked_") as tmp:
            summary["chunked_graph"], ok = chunked_across_cards(n_cards, tmp)
        print("ChunkedSlam's frame graph across the cards: "
              + json.dumps(summary["chunked_graph"]), flush=True)
        if not ok:
            failed.append("chunked_graph")
    print(json.dumps(summary))
    if failed:
        print(f"FAIL: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
