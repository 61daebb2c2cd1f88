"""`correct` on a run's own path: a sound run passes, and the control and
each planted fault fail it.  On the CPU at a tiny size; at the cells' own
sizes on the card (`-m card`)."""

import json

import pytest
import torch

from slambench import run as run_mod
from slambench.harness import spec
from slambench.tests import faults, tiny

CELLS = [w["name"] for w in json.loads(
    (spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]
CARD_SEEDS = (3_100_000_019, 3_100_000_043, 3_100_000_067)
CARD_SECONDS = 4.0
# the window closes at the first chunk back: one chunk, the same frames on
# any CPU (a window of seconds would cover as many frames as the CPU's speed
# gives, and a 160x120 frame tracks too unevenly for that to hold still)
TINY_SECONDS = 1e-3


def _run(cell, seed, seconds, device, fault=None, alter=None):
    context, make_entry = faults.PLANTED.get(fault, (faults.nothing, None))
    with context():
        out = run_mod.run(cell, seed, seconds, False, device,
                          make_entry=make_entry and make_entry(cell),
                          alter=alter)
    print(json.dumps({"cell": cell.name, "seed": seed,
                      "case": fault or ("control" if alter else "sound"),
                      "numbers": {k: v["value"] for k, v in
                                  out["result"]["checks"].items()}}))
    return out["result"]


@pytest.fixture(scope="module")
def tiny_cell(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("tiny"))


def test_a_sound_tiny_run_is_correct(tiny_cell):
    assert _run(tiny_cell, 2 ** 31 + 11, TINY_SECONDS,
                torch.device("cpu"))["correct"]


@pytest.mark.parametrize("fault", sorted(faults.PLANTED))
def test_a_planted_fault_fails_a_tiny_run(tiny_cell, fault):
    assert not _run(tiny_cell, 2 ** 31 + 11, TINY_SECONDS, torch.device("cpu"),
                    fault=fault)["correct"]


def test_the_control_fails_a_tiny_run(tiny_cell):
    alter = faults.bf16_control(tiny_cell, torch.device("cpu"))
    assert not _run(tiny_cell, 2 ** 31 + 11, TINY_SECONDS, torch.device("cpu"),
                    alter=alter)["correct"]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_every_cell(card, workload):
    cell = spec.load(workload)
    for seed in CARD_SEEDS:
        result = _run(cell, seed, CARD_SECONDS, card,
                      alter=faults.bf16_control(cell, card))
        assert not result["correct"]
    with faults.tf32_on():
        _run(cell, CARD_SEEDS[0], CARD_SECONDS, card,
             alter=faults.bf16_control(cell, card, torch.float32))


@pytest.mark.card
@pytest.mark.parametrize("fault", sorted(faults.PLANTED))
@pytest.mark.parametrize("workload", CELLS)
def test_a_planted_fault_fails_every_cell(card, workload, fault):
    cell = spec.load(workload)
    assert not _run(cell, CARD_SEEDS[0], CARD_SECONDS, card,
                    fault=fault)["correct"]
