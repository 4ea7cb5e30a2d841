"""The readers of the program's own spans and counters (``program.py`` and
the seven metrics that use it): on records made by hand, whose arithmetic
is known; silent on the CPU and with a program that keeps no counters; and
on a recorded tiny CPU run of each kind, the program's ``m3gnet.*`` spans
lie inside the benchmark's spans."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.conftest import tiny
from portbench.trace import Record, Trace

HERE = Path(__file__).resolve().parent
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
SPAN_READERS = {"batch_check_ms.efs": "m3gnet.to_torch.check",
                "batch_copy_ms.efs": "m3gnet.to_torch.copy",
                "rebuild_ms.md": "m3gnet.md.rebuild",
                "grad_host_ms.train": "m3gnet.train.grad"}
DEVICE_READERS = {"threebody_fwd_ms.efs": "m3gnet.threebody",
                  "adam_ms.train": "m3gnet.train.adam"}
PROGRAM = [*SPAN_READERS, *DEVICE_READERS, "batch_host_mb.efs"]
MS = 1_000_000  # ns


def hand_made(name):
    """Two requests of 100 ms. The first holds a parent span with two spans
    ``name`` inside it (3 and 5 ms), each launching two kernels (1 + 2 and
    4 + 8 us on the device), and one launch outside them; the second holds
    one span ``name`` of 7 ms whose second launch lost its device record,
    and a span ``name`` outside every request."""
    recs = [Record("span", "portbench.span", 0, 100 * MS),
            Record("span", "portbench.span", 200 * MS, 300 * MS),
            Record("span", "m3gnet.parent", 5 * MS, 50 * MS),
            Record("span", name, 10 * MS, 13 * MS), Record("span", name, 20 * MS, 25 * MS),
            Record("span", name, 210 * MS, 217 * MS), Record("span", name, 400 * MS, 409 * MS)]
    corr = iter(range(1, 100))

    def launch(t, device_ns):
        k = next(corr)
        recs.append(Record("launch", "cudaLaunchKernel", t, t + 1000, k))
        if device_ns is not None:
            recs.append(Record("kernel", f"void k{k}()", t + 5000, t + 5000 + device_ns, k))

    for t, dur in ((11, 1000), (12, 2000), (21, 4000), (22, 8000), (30, 16000), (211, 500),
                   (212, None), (401, 300)):
        launch(t * MS, dur)
    return Trace(records=recs, work=[{"steps": 1}, {"steps": 1}])


def cuda():
    return SimpleNamespace(device="cuda", config={})


@pytest.mark.parametrize("metric", SPAN_READERS)
def test_host_ms_per_request(metric):
    trace = hand_made(SPAN_READERS[metric])
    # (3 + 5) ms in the first request, 7 in the second; the stray span is outside both
    assert harness.reader(metric)(trace, cuda()) == pytest.approx((3 + 5 + 7) / 2)


@pytest.mark.parametrize("metric", DEVICE_READERS)
def test_device_ms_over_complete_requests(metric):
    trace = hand_made(DEVICE_READERS[metric])
    # the first request alone: its second is missing a record; the launch at
    # 30 ms lies outside the spans
    assert harness.reader(metric)(trace, cuda()) == pytest.approx((1 + 2 + 4 + 8) / 1000)
    trace.records = [r for r in trace.records if not (r.kind == "kernel" and r.corr == 2)]
    assert harness.reader(metric)(trace, cuda()) is None


def test_host_mb_from_the_counters(monkeypatch):
    from torch_m3gnet_tpu_torch.utils import profiling

    read = harness.reader("batch_host_mb.efs")
    monkeypatch.setattr(profiling, "_COUNTS", {})
    assert read(Trace(), cuda()) is None  # no host batch yet
    profiling.count("to_torch.host_batches", 4)
    profiling.count("to_torch.host_bytes", 440_000_000)
    profiling.count("launch.q_scatter", 7)
    assert read(Trace(), cuda()) == pytest.approx(110.0)
    monkeypatch.delattr(profiling, "counts")  # a program that keeps no counters
    assert read(Trace(), cuda()) is None


@pytest.mark.parametrize("metric", PROGRAM)
def test_silent_on_the_cpu_and_without_program_spans(metric):
    name = {**SPAN_READERS, **DEVICE_READERS}.get(metric, "m3gnet.threebody")
    read = harness.reader(metric)
    assert read(hand_made(name), SimpleNamespace(device="cpu", config={})) is None
    if metric != "batch_host_mb.efs":  # an older program records no spans
        assert read(hand_made("m3gnet.renamed"), cuda()) is None


def test_manifest_lists_the_program_readers_where_they_read():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for metric in PROGRAM:
        m = entries[metric]
        assert m["better"] == "lower"
        kind = metric.split(".")[-1]
        assert all(w.endswith({"efs": ".screen", "md": ".md", "train": ".train"}[kind])
                   for w in m["workloads"])
    assert entries["batch_host_mb.efs"]["source"] == "program_counter"
    assert {entries[m]["source"] for m in SPAN_READERS} == {"program_span"}
    assert {entries[m]["source"] for m in DEVICE_READERS} == {"device_trace"}


EXPECTED = {
    "mp-factorized.screen": {"m3gnet.to_torch", "m3gnet.to_torch.check", "m3gnet.to_torch.copy",
                             "m3gnet.to_torch.index", "m3gnet.threebody"},
    "mp-factorized.md": {"m3gnet.md.rebuild", "m3gnet.build_batch.graphs",
                         "m3gnet.build_batch.pad", "m3gnet.to_torch", "m3gnet.threebody"},
    "mp-factorized.train": {"m3gnet.train.loss", "m3gnet.train.grad", "m3gnet.train.adam",
                            "m3gnet.to_torch.check", "m3gnet.threebody"},
}


@pytest.mark.parametrize("cell", EXPECTED)
def test_program_spans_lie_inside_the_benchmark_spans(cell):
    ctx, spec = harness.prepare(cell, 2**31 + 11, "cpu", patch=tiny)
    spec.kind.setup(ctx)
    trace = spec.kind.traced(ctx)
    requests = trace.spans()
    program = [r for r in trace.of("span") if r.name.startswith("m3gnet.")]
    assert EXPECTED[cell] <= {r.name for r in program}
    for r in program:
        assert any(q.start <= r.start and r.end <= q.end for q in requests), r
    # every request holds the program's work
    for q in requests:
        assert any(q.start <= r.start and r.end <= q.end for r in program)
