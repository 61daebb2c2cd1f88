"""A tiny cell for CPU runs of the harness: the real metrics and entries,
with a 160x120 rig, a 2-level pyramid, a small map and a gentle lap."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from slambench.harness import spec

BENCH = spec.BENCH_DIR


def make(tmp: Path, stereo: bool = False, entry: str = "chunked_odometry") -> spec.Cell:
    bench = tmp / "bench"
    for kind in ("metrics", "entries"):
        shutil.copytree(BENCH / kind, bench / kind, dirs_exist_ok=True)
    for kind in ("configs", "traffic", "limits"):
        (bench / kind).mkdir(parents=True, exist_ok=True)
    src = "euroc-stereo-752x480" if stereo else "tum-rgbd-640x480"
    cfg = json.loads((BENCH / "configs" / f"{src}.json").read_text())
    cfg["name"] = "tiny-rig"
    cfg["sensor"].update(height=120, width=160,
                         intrinsics=[144.0, 144.0, 79.5, 59.5])
    cfg["system"]["frontend"].update(height=120, width=160, num_levels=2,
                                     max_keypoints=256)
    cfg["system"]["map"].update(max_keyframes=32, max_landmarks=2048,
                                max_obs=8192)
    tr = json.loads((BENCH / "traffic" / "desk-lap.json").read_text())
    tr.update(name="tiny-lap", lap_frames=120, check_frames=4, entry=entry,
              check_every_chunks=2)
    numbers = {"fe_kp_differ_pct": {"max": 0.0}, "fe_desc_bits_pct": {"max": 0.0},
               "untracked_pct": {"max": 10.0}, "missing_frames": {"max": 0.0}}
    if entry == "chunked_slam":
        numbers.update({"track_rmse_cm": {"max": 25.0},
                        "kf_rmse_cm": {"max": 25.0}})
    else:
        numbers["rpe_rmse_mm"] = {"max": 80.0}
    limits = {"workload": "tiny.cell", "numbers": numbers}
    for kind, name, doc in (("configs", "tiny-rig", cfg),
                            ("traffic", "tiny-lap", tr),
                            ("limits", "tiny.cell", limits)):
        (bench / kind / f"{name}.json").write_text(json.dumps(doc))
    real = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    benchmark = {"run_seconds": 1,
                 "workloads": [{"name": "tiny.cell", "config": "tiny-rig",
                                "traffic": "tiny-lap", "chips": 1}],
                 "end_to_end": real["end_to_end"],
                 "per_layer": [dict(m, workloads=["tiny.cell"])
                               for m in real["per_layer"]]}
    (bench / "BENCHMARK.json").write_text(json.dumps(benchmark))
    return spec.Cell("tiny.cell", benchmark, bench)
