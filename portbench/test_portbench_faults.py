"""The whole run, on the CPU at a tiny size with the card's check skipped,
comes out correct when the program is sound and not correct with each
fault that the cell can have planted underneath (``faults.py``): an answer
altered where it is produced, a step that returns its state unchanged,
half of a training batch left out."""

import pytest

from portbench import faults, harness
from portbench.conftest import tiny

CASES = [("mp-factorized.screen", "answer_altered"), ("mp-fused.screen", "answer_altered"),
         ("mp-factorized.md", "state_unchanged"), ("mp-factorized.train", "state_unchanged"),
         ("mp-factorized.train", "half_batch")]


@pytest.mark.parametrize("cell", sorted({c for c, _ in CASES}))
def test_sound_run_is_correct(cell):
    result = harness.run(cell, 2**31 + 21, 0.5, False, device="cpu", patch=tiny)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_caught(cell, fault):
    kind = harness.resolve(cell).traffic["kind"]
    with faults.FAULTS[fault](kind):
        result = harness.run(cell, 2**31 + 21, 0.5, False, device="cpu", patch=tiny)
    assert not result["correct"], result["checks"]
