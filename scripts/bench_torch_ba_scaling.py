#!/usr/bin/env python3
"""The port's landmark-sharded BA across the cards of one host.

    python3 scripts/bench_torch_ba_scaling.py [--landmarks 8192] [--sizes 1,2,4,8]

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
     --mesh N --distributed` against the meshless CLI run (every rank's
     report; keyframes, loops and relocs must equal the meshless run's, ATE
     below 10 cm).

Prints the cards' names and power limits first, one line a part, and a JSON
summary last.  Exits non-zero if a part fails.  Every subprocess has a
timeout, every group a 5-minute one.
"""

from __future__ import annotations

import argparse
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
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


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


def slam_across_cards(n: int) -> tuple[dict, bool]:
    """Part 3: the CLI with --mesh n under torch.distributed.run against the
    meshless run."""
    cli = ["-m", "jetracer_orbslam2_torch.run", "--synthetic", "120",
           "--json", "--log-level", "warning"]
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--poses", type=int, default=8)
    ap.add_argument("--landmarks", type=int, default=8192)
    ap.add_argument("--obs-per-lm", type=int, default=6)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--sizes", default="1,2,4,8")
    args = ap.parse_args()

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
    cuda_build.build_libraries(["fast_nms", "ba_fused", "patch_gather"])
    n_cards = torch.cuda.device_count()

    rows = measure_scaling(
        tuple(int(s) for s in args.sizes.split(",")), args.poses,
        args.landmarks, args.obs_per_lm, args.iters)
    print(f"# BA scaling: P={args.poses} L={args.landmarks} "
          f"obs/lm={args.obs_per_lm} iters={args.iters}, {n_cards} card(s)")
    for r in rows:
        print(f"{r['n']:>3} {r['ms_per_iter']:>10.3f} ms/iter  efficiency "
              f"{r['efficiency']:.3f}  cost drop {r['cost_drop']:.1f}", flush=True)
    summary = {"cards": cards, "scaling": rows}
    failed = []
    if n_cards > 1:
        with tempfile.TemporaryDirectory(prefix="jetracer_cards_") as tmp:
            summary["solve"], ok = solve_on_every_card(n_cards, tmp)
        print("solve on every card: " + json.dumps(summary["solve"]), flush=True)
        if not ok:
            failed.append("solve")
        summary["slam"], ok = slam_across_cards(n_cards)
        print("SLAM across the cards: " + json.dumps(summary["slam"]), flush=True)
        if not ok:
            failed.append("slam")
    print(json.dumps(summary))
    if failed:
        print(f"FAIL: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
