"""On the card, at each cell's own size, over three seeds: the control
(the plain reference in TF32, one precision step below the configuration's
float32, put in the program's place) fails the cell's check, and the
program passes it. Run on a machine with the card:

    python -m pytest portbench/test_portbench_card.py -q

(~2 min a cell). On the CPU these tests skip."""

import json
from pathlib import Path

import pytest

from portbench import calibrate, harness

ROOT = Path(__file__).resolve().parent.parent
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = [2**31 + 104729 * k for k in (1, 2, 3)]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(card, cell):
    limits = harness.resolve(cell).limits
    for seed in SEEDS:
        reading = calibrate.reading(cell, seed, 3.0, "control", device=card)
        assert all(reading["program"][k] <= limits[k] for k in limits), reading
        assert any(reading["control"][k] > limits[k] for k in limits), reading
