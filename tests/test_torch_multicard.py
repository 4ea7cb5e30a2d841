"""A CPU rehearsal of ``multicard_smoke.py``: its rank code (``rank_job``)
on four gloo ranks through ``parallel.launch``, at a small size, held to
one device by the script's own checks.

One job (a module fixture) runs the parts ``gp_eval``, ``gp_train``,
``dp`` and ``dp_gp``: gp at S = 4 of a 4x4x4 fcc-Cu cell (256 atoms,
``chip_smoke.gp_cell`` at ``GP_REPS`` 4) cut into four slabs, two ring
offsets at the 3.5 A cutoff, a narrow model (``l_max = n_max = 2``, width
8, two blocks); then one ``GraphParallelTrainer`` step in the factorized
and one in the fused mode, one ``DataParallel`` step with a tail that
leaves the last three ranks fully padded, and on a 2 x 2 ("dp", "gp") mesh
the cell and its second jitter, one a dp row: their eval and one dp x gp
``GraphParallelTrainer`` step. The one-device references come from the
script's own data functions in this process. The checks are the script's
(``chip_smoke.py``'s tolerances): E/F/S within ``MODEL_TOL``, the exchange
exactly equal to its index reference, the gp steps' loss, gradient and
update, the dp step against the weighted gradient with the unweighted-mean
control failing, the dp x gp step against the mean of the two cells' steps
with its two controls (the first row alone, the sum of the rows) failing.
On the CPU the ranks bind no card and no launch is counted (the kernels'
plain versions run).

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
    dp_gp = mc.dp_gp_data(tmp, gp, "cpu", REPS)
    files = gp["sizes"][S]["files"]
    ranks = mc.run_job(("gp_eval", "gp_train", "dp", "dp_gp"), S, {
        "settings": SETTINGS, "gp_eval": {"files": files}, "gp_train": {"files": files},
        "dp": {"config": dp["cfg"], "stacks": dp["stacks"][S]},
        "dp_gp": {"files": dp_gp["files"]}}, platform="cpu", timeout_s=300)
    return dict(gp=gp, dp_gp=dp_gp, ranks=ranks)


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
    """One step in each mode (the fused one through B4-B7's double
    backward) against one device's ``Trainer`` step in that mode."""
    info = mc.check_gp_train(runs["ranks"], runs["gp"], S)
    assert sorted(info) == sorted(mc.MODES)
    for mode in mc.MODES:
        assert info[mode]["weights_bitwise_equal_across_ranks"] == [True] * S
        assert np.isfinite(info[mode]["loss"])


def test_dp_gp_eval_and_train_step_match_one_device(runs):
    """The 2 x 2 (dp, gp) mesh: each row's E/F/S against its cell, the
    step against the mean of the two cells' one-device steps, the weights
    bitwise equal on all four ranks, and both controls failing."""
    ranks = [r["dp_gp"] for r in runs["ranks"]]
    info = cs.check_dp_gp(ranks, runs["dp_gp"]["evals"], runs["dp_gp"]["steps"])
    assert sorted((r["dp_row"], r["gp_rank"]) for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    train = info["train"]
    assert train["weights_bitwise_equal_across_ranks"] == [True] * S
    assert train["grad_rel_err"] <= cs.TRAIN_TOL
    assert sorted(train["control_grad_rel_err"]) == ["first_row_alone", "sum_of_rows"]
    assert min(train["control_grad_rel_err"].values()) > cs.TRAIN_TOL


def test_dp_gp_check_fails_on_one_row_alone(runs):
    """The check itself: the step held to the first cell's one-device step
    alone (the dp mean dropped) fails."""
    ranks = [r["dp_gp"] for r in runs["ranks"]]
    steps = runs["dp_gp"]["steps"]
    with pytest.raises(AssertionError):
        cs.check_dp_gp(ranks, runs["dp_gp"]["evals"], [steps[0], steps[0]])


def test_dp_step_with_padded_tail_matches_weighted_gradient(runs):
    info = cs.check_dp(runs["ranks"][0]["dp"])
    assert info["tail"]["real_graphs_per_rank"] == [3.0, 0.0, 0.0, 0.0]
    assert info["full"]["real_graphs_per_rank"] == [4.0] * S


def test_parts_runs_only_the_named_parts(monkeypatch, capsys):
    """``--parts`` parses to the parts named (every part without it, an
    unknown part refused); ``run_parts(..., only=...)`` starts only their
    jobs, and a shared gp job runs only the named one of its parts."""
    assert mc.parse_parts(["--parts", "gp_eval,dp_gp"]) == ["gp_eval", "dp_gp"]
    assert mc.parse_parts([]) == list(mc.PART_NAMES)
    with pytest.raises(SystemExit):
        mc.parse_parts(["--parts", "gp_eval,nope"])
    jobs = []

    def run_job(parts, size, inputs, platform="cuda", timeout_s=None):
        jobs.append((list(parts), size))
        raise RuntimeError("not run")

    monkeypatch.setattr(mc, "run_job", run_job)
    monkeypatch.setattr(mc, "gp4000_data", lambda *a, **k: {"sizes": {2: {"files": []}}})
    monkeypatch.setattr(mc, "dp_data", lambda *a, **k: {"cfg": None, "stacks": {2: None}})
    failed = mc.run_parts(2, {}, platform="cpu", only=["gp_train", "dp"])
    assert jobs == [(["gp_train"], 2), (["dp"], 2)]
    assert failed == ["gp_train", "dp"]
    heads = [x for x in capsys.readouterr().out.splitlines() if x.startswith("== ")]
    assert heads == ["== gp_train", "== dp"]


def test_nccl_transports_counts_each_channel(tmp_path):
    """The transports NCCL's INFO logs name (one file a process), counted,
    with its version."""
    (tmp_path / "nccl.host.1").write_text(
        "host:1:1 [0] NCCL INFO NCCL version 2.28.9+cuda12.9\n"
        "host:1:9 [0] NCCL INFO Channel 00/0 : 0[0] -> 1[1] via P2P/CUMEM\n"
        "host:1:9 [0] NCCL INFO Channel 01/0 : 0[0] -> 1[1] via P2P/CUMEM\n")
    (tmp_path / "nccl.host.2").write_text(
        "host:2:9 [1] NCCL INFO Channel 00/0 : 1[1] -> 0[0] via SHM/direct/direct\n")
    (tmp_path / "other.log").write_text("x via NET/Socket\n")
    assert mc.nccl_transports(str(tmp_path)) == {
        "versions": ["2.28.9+cuda12.9"], "transports": {"P2P/CUMEM": 2, "SHM/direct/direct": 1}}


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
