"""A cell, found by name: `BENCHMARK.json` names the workload, its
configuration and its traffic mix; each of those, each per-layer metric's
reader and each program entry sits in a file of its own under `slambench/`:

    configs/<config>.json      the deployment as it is run
    traffic/<mix>.json         the trajectory, chunking and trace lengths
    limits/<workload>.json     the limits `correct` holds the cell to
    metrics/<metric>.py        `read(ctx)` -> a number, or None
    entries/<entry>.py         `Entry`: the adapter around a program entry

Adding a cell, a mix, a metric or an entry adds files and entries; no file
here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def path_of(kind: str, name: str, bench_dir: Path = BENCH_DIR) -> Path:
    """The file of `name` in `kind` (configs, traffic, limits: `.json`;
    metrics, entries: `.py`)."""
    suffix = ".py" if kind in ("metrics", "entries") else ".json"
    path = bench_dir / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} "
                                f"named {name!r}: {path} is missing")
    return path


def read_json(kind: str, name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return json.loads(path_of(kind, name, bench_dir).read_text())


def load_module(kind: str, name: str, bench_dir: Path = BENCH_DIR):
    """Import `metrics/<name>.py` or `entries/<name>.py` by its path (a
    metric's name may hold dots)."""
    path = path_of(kind, name, bench_dir)
    mod_name = "slambench_" + kind + "_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of the benchmark with everything it names."""

    def __init__(self, workload: str, benchmark: dict,
                 bench_dir: Path = BENCH_DIR):
        cells = {w["name"]: w for w in benchmark["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.name = workload
        self.bench_dir = bench_dir
        self.workload = cells[workload]
        self.chips = int(self.workload["chips"])
        self.config = read_json("configs", self.workload["config"], bench_dir)
        self.traffic = read_json("traffic", self.workload["traffic"], bench_dir)
        self.limits = read_json("limits", workload, bench_dir)
        self.run_seconds = int(benchmark["run_seconds"])

        def mine(metric: dict) -> bool:
            return workload in metric.get("workloads", [workload])

        self.end_to_end = [m for m in benchmark["end_to_end"] if mine(m)]
        self.per_layer = [m for m in benchmark["per_layer"] if mine(m)]

    def entry(self):
        return load_module("entries", self.traffic["entry"], self.bench_dir)

    def read_metrics(self, metrics: list, ctx: dict) -> dict:
        """{name: {"value", "unit"}} of every metric whose reader finds
        something to read; a reader that finds nothing returns None and its
        metric is left out."""
        out = {}
        for m in metrics:
            value = load_module("metrics", m["name"], self.bench_dir).read(ctx)
            if value is not None:
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out


def load(workload: str, root: Path = ROOT, bench_dir: Path = BENCH_DIR) -> Cell:
    benchmark = json.loads((root / "BENCHMARK.json").read_text())
    return Cell(workload, benchmark, bench_dir)
