"""The reader of ``norm_gate_roofline`` on device records added by hand to a
request, whose arithmetic is known."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.test_portbench_metrics import synthetic

HERE = Path(__file__).resolve().parent


def ctx():
    cfg = json.loads((HERE / "configs" / "chgnet-mptrj.json").read_text())
    return SimpleNamespace(config=cfg, device="cpu")


def request(calls: int, bwd_ns: int = 3000):
    """One request of ``calls`` forward and ``calls`` backward calls (each
    backward with its second pass), and one kernel of another op."""
    names, durations = ["aten_add_kernel"], [50_000]
    for _ in range(calls):
        names += ["norm_gate_fwd_kernel<4, true>"]
        durations += [2000]
    for _ in range(calls):
        names += ["norm_gate_bwd_kernel<4, true>", "norm_gate_param_sums"]
        durations += [bwd_ns, 10]
    return synthetic(ctx().config, names, durations)


def test_norm_gate_roofline_arithmetic():
    c = ctx()
    tr = request(9)
    f, e, t = 64, 4096, 8192  # synthetic()'s padded edges and triplets
    want = 32 * f * (4 * e + 5 * t) / 3.35e12 / (9 * (2000 + 3000 + 10) / 1e9)
    assert harness.reader("norm_gate_roofline")(tr, c) == pytest.approx(100 * want, rel=1e-12)


def test_norm_gate_roofline_needs_whole_requests():
    c = ctx()
    assert harness.reader("norm_gate_roofline")(request(8), c) is None  # a call short
    tr = request(9)
    tr.records = [r for r in tr.records if not (r.kind == "kernel" and r.corr == 3)]
    assert harness.reader("norm_gate_roofline")(tr, c) is None  # a record dropped
