"""The step checks of ``chip_smoke.py`` phase 9 (``workflow_step_checks``)
on the CPU at small widths. With both sides on the CPU every gradient and
update agrees exactly, and each control that the checks assert to fail does
fail: the gradient negated, the update skipped, ``r1_gather`` off by
``CONTROL_SCALE``. A step whose ``r1_gather`` is off on the checked side
only fails the check. On the card the same function holds the card's step
against the CPU's."""

import pytest

import chip_smoke
from torch_m3gnet_tpu_torch.config import M3GNetConfig
from torch_m3gnet_tpu_torch.data.dataset import build_graphs
from torch_m3gnet_tpu_torch.ops import factorized_stage

CFG = M3GNetConfig(l_max=2, n_max=2, embedding_dim=8, num_blocks=1, cutoff=4.0,
                   threebody_cutoff=3.0, pad_multiple=32, batch_size=4, stress_weight=0.0)


@pytest.fixture(scope="module")
def graphs():
    """Eight labelled 32-atom cells of phase 9's kind, as graphs."""
    structures = [s for s in chip_smoke.workflow_structures(16) if len(s) == 32]
    chip_smoke.label_structures(CFG, structures, "cpu", chunk=4)
    return list(build_graphs(structures, CFG.cutoff, CFG.threebody_cutoff))


def test_step_checks_agree_and_controls_fail(graphs):
    out = chip_smoke.workflow_step_checks(CFG, graphs, device="cpu")
    assert set(out["shapes"]) == {"bucket", "ladder class 0"}
    assert [(r["mode"], r["batch"]) for r in out["steps"]] == [
        ("factorized", "bucket"), ("fused", "bucket"), ("factorized", "ladder class 0")]
    for row in out["steps"]:
        assert row["grad_err"] == 0.0 and row["update_err"] == 0.0
        assert row["loss"] == row["loss_cpu"]
        assert row["control_negated_grad"] == pytest.approx(2.0)
        assert row["control_skipped_update"] > chip_smoke.UPDATE_TOL
    assert out["steps"][0]["control_r1_off"] > chip_smoke.TRAIN_TOL


def test_a_wrong_kernel_on_the_checked_side_fails(graphs, monkeypatch):
    step = chip_smoke.trainer_step
    saved = factorized_stage._r_forward

    def wrong_step(pot, cfg, batch):
        factorized_stage._r_forward = chip_smoke.scaled_r_gather(
            saved, "r1_gather", 1 + chip_smoke.CONTROL_SCALE)
        try:
            return step(pot, cfg, batch)
        finally:
            factorized_stage._r_forward = saved

    monkeypatch.setattr(chip_smoke, "trainer_step", wrong_step)
    with pytest.raises(AssertionError, match="factorized step, bucket: gradient"):
        chip_smoke.workflow_step_checks(CFG, graphs, device="cpu")
