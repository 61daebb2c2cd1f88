"""Everything a cell names is found by name, and a new file is picked up
without an edit to any file that is there."""

import json
import shutil

import pytest

from slambench.harness import spec
from slambench.tests import tiny

BENCH = spec.BENCH_DIR
BENCHMARK = json.loads((spec.ROOT / "BENCHMARK.json").read_text())


def _names(kind: str, suffix: str) -> list[str]:
    return sorted(p.name[:-len(suffix)] for p in (BENCH / kind).glob("*" + suffix))


@pytest.mark.parametrize("kind,suffix", [("configs", ".json"),
                                         ("traffic", ".json"),
                                         ("limits", ".json"),
                                         ("metrics", ".py"),
                                         ("entries", ".py")])
def test_every_file_is_found_by_its_name(kind, suffix):
    names = _names(kind, suffix)
    assert names
    for name in names:
        assert spec.path_of(kind, name).name == name + suffix
        if suffix == ".json":
            doc = spec.read_json(kind, name)
            assert doc.get("name", doc.get("workload")) == name
        elif kind == "metrics":
            assert callable(spec.load_module(kind, name).read)
        else:
            assert hasattr(spec.load_module(kind, name), "Entry")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCHMARK["workloads"]])
def test_every_cell_resolves(workload):
    cell = spec.load(workload)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.traffic["name"] == cell.workload["traffic"]
    assert {m["name"] for m in cell.end_to_end} == {"fps", "chunk_ms_p95",
                                                    "setup_s"}
    assert cell.per_layer
    assert hasattr(cell.entry(), "Entry")


def test_every_named_file_exists():
    for c in BENCHMARK["configs"]:
        assert (spec.ROOT / c["file"]).is_file()
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert spec.path_of("metrics", m["name"]).is_file()


def test_a_new_metric_file_is_picked_up(tmp_path):
    """A later change adds a reader and an entry of BENCHMARK.json: no file
    that is there changes."""
    cell = tiny.make(tmp_path)
    bench = cell.bench_dir
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()
              and p.name != "BENCHMARK.json"}
    (bench / "metrics" / "window.chunks_seen.py").write_text(
        "def read(ctx):\n    return len(ctx['window']['chunks'])\n")
    benchmark = json.loads((bench / "BENCHMARK.json").read_text())
    benchmark["per_layer"].append(
        {"name": "window.chunks_seen", "unit": "chunks", "better": "higher",
         "source": "host_clock", "layer": "SLAM scheduler", "moves": "fps"})
    cell = spec.Cell("tiny.cell", benchmark, bench)
    ctx = {"window": {"chunks": [(0.0, 1.0, 8)] * 3, "t_start": 0.0,
                      "t_end": 3.0, "frames": 24, "keyframes": 1},
           "trace": None, "config": cell.config, "device": {"kind": "cpu"}}
    got = cell.read_metrics(cell.per_layer, ctx)
    assert got["window.chunks_seen"] == {"value": 3.0, "unit": "chunks"}
    # readers that find nothing to read (no trace here) leave their metric out
    assert set(got) == {"window.chunks_seen"}
    keyframes = spec.load_module("metrics", "scan.keyframe_pct", bench).read(ctx)
    assert keyframes == pytest.approx(100 / 24)
    assert all(p.read_bytes() == b for p, b in before.items())


def test_a_new_traffic_and_cell_are_picked_up(tmp_path):
    cell = tiny.make(tmp_path)
    bench = cell.bench_dir
    shutil.copy(bench / "traffic" / "tiny-lap.json",
                bench / "traffic" / "tiny-fast.json")
    doc = json.loads((bench / "traffic" / "tiny-fast.json").read_text())
    doc.update(name="tiny-fast", lap_frames=60)
    (bench / "traffic" / "tiny-fast.json").write_text(json.dumps(doc))
    shutil.copy(bench / "limits" / "tiny.cell.json",
                bench / "limits" / "tiny.fast.json")
    benchmark = json.loads((bench / "BENCHMARK.json").read_text())
    benchmark["workloads"].append({"name": "tiny.fast", "config": "tiny-rig",
                                   "traffic": "tiny-fast", "chips": 1})
    fast = spec.Cell("tiny.fast", benchmark, bench)
    assert fast.traffic["lap_frames"] == 60
    assert fast.end_to_end == benchmark["end_to_end"]
    assert fast.per_layer == []     # the per-layer metrics list their cells


def test_an_unknown_name_is_refused():
    with pytest.raises(FileNotFoundError):
        spec.path_of("traffic", "no-such-mix")
    with pytest.raises(KeyError):
        spec.load("no.such.cell")
