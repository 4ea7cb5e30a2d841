"""Each per-layer reader on a recorded CPU profile (where the device
metrics find nothing to read and return nothing), and on device records
added to it by hand, whose arithmetic is known."""

import json
from pathlib import Path

import pytest

from portbench import harness, roofline
from portbench.conftest import tiny
from portbench.trace import Record, Trace

HERE = Path(__file__).resolve().parent
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
METRICS = [m["name"] for m in BENCH["per_layer"]]


@pytest.fixture(scope="module")
def recorded():
    ctx, spec = harness.prepare("mp-factorized.screen", 2**31 + 3, "cpu", patch=tiny)
    spec.kind.setup(ctx)
    return spec.kind.traced(ctx), ctx


@pytest.mark.parametrize("metric", METRICS)
def test_reader_on_a_cpu_profile(recorded, metric):
    trace, ctx = recorded
    value = harness.reader(metric)(trace, ctx)
    if metric == "batch_to_device_ms.efs":
        assert value > 0
    else:  # no device records, no launches: nothing to read
        assert value is None


def synthetic(ctx_config, names, durations):
    """One span holding one launch and one kernel record per name."""
    recs = [Record("span", "portbench.span", 0, 10_000_000)]
    t = 100
    for k, (name, dur) in enumerate(zip(names, durations), start=1):
        recs.append(Record("launch", "cudaLaunchKernel", t, t + 10, k))
        recs.append(Record("kernel", f"void {name}(float const*)", t + 50, t + 50 + dur, k))
        t += 1000
    return Trace(records=recs, work=[{"nodes": 1024, "edges_pad": 4096, "triplets_pad": 8192,
                                      "graphs_pad": 4, "atoms": 1000, "edges": 4000,
                                      "triplets": 8000, "graphs": 4, "steps": 1}])


def ctx_of(mode):
    from types import SimpleNamespace

    cfg = json.loads((HERE / "configs" / f"m3gnet-mp-{mode}.json").read_text())
    return SimpleNamespace(config=cfg, device="cpu")


def test_factorized_roofline_arithmetic():
    ctx = ctx_of("factorized")
    tr = synthetic(ctx.config, ["segment_offsets", "q_scatter_kernel", "r1_gather_kernel",
                                "aten_add_kernel"], [1000, 9000, 5000, 7000])
    m, ln, mn, n, e = 9, 9, 27, 1024, 4096
    q = 4 * (m + ln) * e + 4 * e + 4 * mn * n
    g = 4 * mn * n + 4 * (m + ln) * e + 4 * e
    want = 100 * (q + g) / 3.35e12 / ((1000 + 9000 + 5000) / 1e9)
    got = harness.reader("factorized_stage_roofline")(tr, ctx)
    assert got == pytest.approx(want, rel=1e-12)


def test_launches_idle_and_mfu_arithmetic():
    ctx = ctx_of("factorized")
    tr = synthetic(ctx.config, ["a", "b", "c"], [1_000_000, 1_000_000, 500_000])
    assert harness.reader("launches_per_batch.efs")(tr, ctx) == 3
    busy = 1_001_150 - 150  # the three records overlap: their union
    assert harness.reader("device_idle_share.efs")(tr, ctx) == pytest.approx(100 * (1 - busy / 1e7))
    flops = roofline.model_flops(ctx.config, tr.work[0]) * 2
    want = 100 * flops / 0.01 / 67e12
    assert harness.reader("mfu.efs")(tr, ctx) == pytest.approx(want, rel=1e-12)


def test_segment_sum_roofline_needs_whole_requests():
    ctx = ctx_of("factorized")
    names = ["segment_sum_tiled"] * 4 + ["segment_offsets", "segment_sum_block"]
    tr = synthetic(ctx.config, names, [1000] * 6)
    d, n, e, b = 64, 1024, 4096, 4
    by_offsets = lambda r, s: 4 * r * e + 4 * (s + 1) + 4 * r * s
    want = (3 * by_offsets(d, n) + by_offsets(3, n) + 4 * 9 * e + 4 * e + 4 * 9 * b) / 3.35e12
    assert harness.reader("segment_sum_roofline")(tr, ctx) == pytest.approx(
        100 * want / 6e-6, rel=1e-12)
    tr.records = [r for r in tr.records if not (r.kind == "kernel" and r.corr == 2)]
    assert harness.reader("segment_sum_roofline")(tr, ctx) is None  # a record dropped


def test_breakdown_names_device_ops_and_host_gaps():
    ctx = ctx_of("factorized")
    tr = synthetic(ctx.config, ["a", "b"], [1000, 2000])
    tr.records.append(Record("op", "aten::index_select", 2000, 9_000_000))
    out = tr.breakdown()
    assert [name for name, _ in out["device_ops"]] == ["void b(float const*)",
                                                      "void a(float const*)"]
    assert out["idle_gaps"][0][0] == "aten::index_select"
