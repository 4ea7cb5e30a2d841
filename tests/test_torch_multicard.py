"""A CPU rehearsal of ``multicard_smoke.py``: its rank code (``rank_job``)
on four gloo ranks through ``parallel.launch``, at a small size, held to
one device by the script's own checks.

One job (a module fixture) runs the parts ``gp_eval``, ``gp_train`` and
``dp``: gp at S = 4 of a 4x4x4 fcc-Cu cell (256 atoms, ``chip_smoke.gp_cell``
at ``GP_REPS`` 4) cut into four slabs, two ring offsets at the 3.5 A
cutoff, a narrow model (``l_max = n_max = 2``, width 8, two blocks); then
one ``GraphParallelTrainer`` step and one ``DataParallel`` step with a tail
that leaves the last three ranks fully padded. The one-device references
come from the script's own data functions in this process. The checks are
the script's (``chip_smoke.py``'s tolerances): E/F/S within ``MODEL_TOL``,
the exchange exactly equal to its index reference, the gp step's loss,
gradient and update, the dp step against the weighted gradient with the
unweighted-mean control failing. On the CPU the ranks bind no card and no
launch is counted (the kernels' plain versions run).

The JAX package's parity of gp and dp at S = 4 stays with
``test_torch_parallel_gp.py``, ``_train.py`` and ``_dp.py``.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke as cs
import multicard_smoke as mc
from torch_m3gnet_tpu_torch.config import M3GNetConfig

ROOT = Path(__file__).resolve().parent.parent
SETTINGS = dict(l_max=2, n_max=2, embedding_dim=8, num_blocks=2, cutoff=3.5,
                threebody_cutoff=3.0)
S, REPS = 4, 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("multicard"))
    gp = mc.gp4000_data(tmp, (S,), "cpu", SETTINGS, REPS)
    structures = cs.workflow_structures(cs.DP_PER_RANK * S + cs.DP_TAIL)
    cs.label_structures(M3GNetConfig(**SETTINGS), structures, "cpu")
    dp = mc.dp_data(tmp, (S,), "cpu", mc.dp_config(SETTINGS), structures)
    files = gp["sizes"][S]["files"]
    ranks = mc.run_job(("gp_eval", "gp_train", "dp"), S, {
        "settings": SETTINGS, "gp_eval": {"files": files}, "gp_train": {"files": files},
        "dp": {"config": dp["cfg"], "stacks": dp["stacks"][S]}}, platform="cpu", timeout_s=300)
    return dict(gp=gp, ranks=ranks)


def test_gloo_ranks_bind_no_card(runs):
    info = mc.check_binding(runs["ranks"], "cpu")
    assert [r["backend"] for r in info["ranks"]] == ["gloo"] * S
    assert [r["bound_device"] for r in info["ranks"]] == ["None"] * S


def test_gp_eval_at_four_ranks_matches_one_device(runs):
    """Both modes' E/F/S against the whole cell on one device; the halo
    exchange (two ring offsets) equal to its index reference on every
    rank."""
    info = mc.check_gp_eval(runs["ranks"], runs["gp"], S)
    assert info["halo_stats"]["n_shards"] == S and info["halo_stats"]["n_offsets"] == 2
    assert [e["offsets"] for e in info["exchange"]] == [[1, 3]] * S
    assert all(e["index_check_max_abs"] == 0.0 and e["edges_checked"] > 0
               for e in info["exchange"])


def test_gp_train_step_matches_one_device(runs):
    info = mc.check_gp_train(runs["ranks"], runs["gp"], S)
    assert info["weights_bitwise_equal_across_ranks"] == [True] * S
    assert np.isfinite(info["loss"])


def test_dp_step_with_padded_tail_matches_weighted_gradient(runs):
    info = cs.check_dp(runs["ranks"][0]["dp"])
    assert info["tail"]["real_graphs_per_rank"] == [3.0, 0.0, 0.0, 0.0]
    assert info["full"]["real_graphs_per_rank"] == [4.0] * S


def test_script_refuses_without_two_cards():
    """``python multicard_smoke.py`` with no card exits non-zero, prints
    no result, and imports nothing of JAX or the JAX package."""
    code = """
import runpy, sys
sys.argv = ["multicard_smoke.py"]
try:
    runpy.run_path("multicard_smoke.py", run_name="__main__")
    code = 0
except SystemExit as exc:
    code = exc.code
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "torch_m3gnet_tpu"))
print("EXIT", code, bad)
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines() == ["EXIT 1 []"], proc.stdout
    assert "needs two or more CUDA devices" in proc.stderr
