"""The port's spans and counters (``utils/profiling.py``), on the CPU.

- with no profiler running, ``span`` is one shared null context and never
  enters ``record_function``;
- under ``torch.profiler.profile`` the potential, ``run_md`` and
  ``Trainer.train_step`` record their ``m3gnet.*`` spans, nested and in
  order: ``to_torch`` split into copies, checks and index; 1 + num_blocks
  three-body spans a forward; each MD rebuild with its graphs, padding and
  ``to_torch``; the train step's loss, gradient and Adam phases;
- ``to_torch`` counts the host bytes it converts and the host batches;
- ``ops._cuda.launch`` counts ``launch.<op>``, which ``chip_smoke.py``
  reads;
- a committee (``torch.func.vmap``) under the profiler gives the energies
  it gives without one.
"""

import sys
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from torch_m3gnet_tpu_torch.config import M3GNetConfig
from torch_m3gnet_tpu_torch.data import Structure, pack_structures, to_torch
from torch_m3gnet_tpu_torch.data.graph import BATCH_INDEX_FIELDS, STATIC_FIELDS
from torch_m3gnet_tpu_torch.models import EnsemblePotential, build_model, stack_params
from torch_m3gnet_tpu_torch.ops import _cuda
from torch_m3gnet_tpu_torch.simulate.md import MDConfig, run_md
from torch_m3gnet_tpu_torch.train import Trainer
from torch_m3gnet_tpu_torch.utils import profiling

FCC = [[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]
NUM_BLOCKS = 2


def cells(n=2, seed=0):
    rng = np.random.default_rng(seed)
    base = Structure.from_frac_coords(np.eye(3) * 3.62, FCC, [29] * 4)
    return [Structure(base.lattice, base.cart_coords + 0.05 * rng.standard_normal((4, 3)),
                      base.atomic_numbers) for _ in range(n)]


def host_batch(labelled=False):
    batch = pack_structures(cells(), 5.0, 4.0, pad_multiple=64)
    if labelled:
        batch = batch.replace(energy=np.array([-12.0, -12.1], np.float32),
                              forces=np.zeros((batch.num_nodes, 3), np.float32),
                              stress=np.zeros((2, 6), np.float32))
    return batch


def potential(mode="factorized", dtype=torch.float32):
    cfg = M3GNetConfig(threebody_mode=mode, embedding_dim=8, num_blocks=NUM_BLOCKS)
    pot = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    return pot.to(dtype), cfg


def recorded(fn):
    """The ``m3gnet.*`` spans that ``fn`` records under the profiler, as
    (name, start ns, end ns) in order of their start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = [(e.name(), int(e.start_ns()), int(e.start_ns() + e.duration_ns()))
           for e in prof.profiler.kineto_results.events() if e.name().startswith("m3gnet.")]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


def names(spans):
    return [s[0] for s in spans]


def test_span_off_is_the_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(profiling, "record_function", refuse)
    first, second = profiling.span("m3gnet.a"), profiling.span("m3gnet.b")
    assert first is second
    with first, second:  # reentrant
        pass
    pot, _ = potential()
    pot(host_batch())  # every span of a forward, off


def test_span_on_records_in_the_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ctx = profiling.span("m3gnet.probe")
        assert isinstance(ctx, torch.autograd.profiler.record_function)
        with ctx:
            pass
    assert [e.name for e in prof.events() if e.name.startswith("m3gnet.")] == ["m3gnet.probe"]
    assert profiling.span("m3gnet.probe") is not ctx  # off again


@pytest.mark.parametrize("mode", ["factorized", "fused"])
def test_potential_spans(mode):
    pot, _ = potential(mode)
    spans = recorded(lambda: pot(host_batch()))
    (whole,) = [s for s in spans if s[0] == "m3gnet.to_torch"]
    parts = [s for s in spans if s[0].startswith("m3gnet.to_torch.")]
    assert names(parts) == ["m3gnet.to_torch.copy", "m3gnet.to_torch.check",
                            "m3gnet.to_torch.index"]  # checked on the device, after the copy
    assert all(inside(p, whole) for p in parts)
    assert all(a[2] <= b[1] for a, b in zip(parts, parts[1:]))  # in turn, no overlap
    threebody = [s for s in spans if s[0] == "m3gnet.threebody"]
    assert len(threebody) == 1 + NUM_BLOCKS
    assert all(whole[2] <= s[1] for s in threebody)  # after the batch is on the device
    assert all(a[2] <= b[1] for a, b in zip(threebody, threebody[1:]))


def test_run_md_spans():
    pot, _ = potential(dtype=torch.float64)
    cfg = MDConfig(dt=1.0, n_steps=4, ensemble="nve", temperature=300.0, rebuild_every=2)
    spans = recorded(lambda: run_md(pot, cells(1), 5.0, 4.0, cfg, pad_multiple=64,
                                    dtype=np.float64))
    rebuilds = [s for s in spans if s[0] == "m3gnet.md.rebuild"]
    assert len(rebuilds) == 2
    for rebuild in rebuilds:
        held = names(s for s in spans if s is not rebuild and inside(s, rebuild))
        assert held[:2] == ["m3gnet.build_batch.graphs", "m3gnet.build_batch.pad"]
        assert held[2:6] == ["m3gnet.to_torch", "m3gnet.to_torch.copy", "m3gnet.to_torch.check",
                             "m3gnet.to_torch.index"]
        assert "m3gnet.threebody" not in held  # the steps run outside the rebuild
    # each step's force evaluation: one to_torch of a tensor batch, no check
    steps = [s for s in spans if s[0] == "m3gnet.to_torch"
             and not any(inside(s, r) for r in rebuilds)]
    assert len(steps) == 4 + 2  # NVE: one evaluation per step and one per rebuild


def test_train_step_spans():
    pot, cfg = potential()
    trainer = Trainer(pot, cfg)
    batch = host_batch(labelled=True)
    spans = recorded(lambda: trainer.train_step(batch))
    phases = [s for s in spans if s[0].startswith("m3gnet.train.")]
    assert names(phases) == ["m3gnet.train.loss", "m3gnet.train.grad", "m3gnet.train.adam"]
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))
    held = names(s for s in spans if inside(s, phases[0]) and s is not phases[0])
    assert held.count("m3gnet.to_torch.check") == 1  # the host batch, checked once
    assert held.count("m3gnet.threebody") == 1 + NUM_BLOCKS  # the forward is the loss's


def test_to_torch_counts_host_bytes_and_batches():
    batch = host_batch()
    converted = [getattr(batch, f) for f in vars(batch)
                 if f not in STATIC_FIELDS and f not in BATCH_INDEX_FIELDS
                 and getattr(batch, f) is not None]
    before = profiling.counts()
    graph = to_torch(batch, "cpu", torch.float32)
    after = profiling.counts()
    gained = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    assert gained["to_torch.host_batches"] == 1
    assert gained["to_torch.host_bytes"] == sum(np.asarray(a).nbytes for a in converted) > 0
    again = profiling.counts()
    to_torch(graph, "cpu", torch.float32)  # a tensor batch adds nothing
    assert profiling.counts() == again


def test_launch_counter_registry(monkeypatch):
    """``ops._cuda.launch`` adds one to ``launch.<op>`` for each launch that
    succeeds (the library and the stream stubbed: no card here);
    ``chip_smoke.py`` reads every hand kernel's count from the registry and
    resets only the launch counters."""
    lib = types.SimpleNamespace(m3g_ok=lambda *args: 0, m3g_bad=lambda *args: 2)
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: profiling.span("m3gnet.none"))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    profiling.count("to_torch.host_batches", 0)
    chip_smoke.reset_launches()
    _cuda.launch("q_scatter", "m3g_ok", "cpu", 1, 2)
    _cuda.launch("q_scatter", "m3g_ok", "cpu")
    _cuda.launch("sorted_segment_sum", "m3g_ok", "cpu")
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        _cuda.launch("r1_gather", "m3g_bad", "cpu")
    launches = chip_smoke.all_launches()
    assert list(launches) == list(chip_smoke.KERNEL_OPS)
    assert launches == {**{name: 0 for name in chip_smoke.KERNEL_OPS}, "q_scatter": 2,
                        "sorted_segment_sum": 1}
    snapshot = profiling.counts()
    snapshot["launch.q_scatter"] = 99  # a copy
    assert profiling.counts()["launch.q_scatter"] == 2
    chip_smoke.reset_launches()
    assert not [k for k in profiling.counts() if k.startswith("launch.")]
    assert "to_torch.host_batches" in profiling.counts()


def test_counters_lose_no_update_across_threads(monkeypatch):
    """More threads than cores add to one counter, switching every few
    microseconds: the total is exact (the prefetch producer and the
    autograd engine's threads count beside the caller's)."""
    monkeypatch.setattr(profiling, "_COUNTS", {})
    threads, adds = 32, 2000
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [profiling.count("stress") for _ in range(adds)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(saved)
    assert profiling.counts() == {"stress": threads * adds}


@pytest.mark.parametrize("mode", ["factorized", "fused"])
def test_committee_under_the_profiler(mode):
    pot, _ = potential(mode, torch.float64)
    members = [potential(mode, torch.float64)[0].state_dict() for _ in range(2)]
    members[1] = {k: v * 1.01 for k, v in members[1].items()}
    stacked = stack_params(members)
    committee = EnsemblePotential(pot)
    batch = host_batch()
    plain_mean, plain_std = committee.apply(stacked, batch)
    holder = {}
    spans = recorded(lambda: holder.update(out=committee.apply(stacked, batch)))
    mean, std = holder["out"]
    assert names(s for s in spans if s[0] == "m3gnet.threebody") == [
        "m3gnet.threebody"] * (1 + NUM_BLOCKS)
    torch.testing.assert_close(mean.energy, plain_mean.energy, rtol=0, atol=0)
    torch.testing.assert_close(std.energy, plain_std.energy, rtol=0, atol=0)
    torch.testing.assert_close(mean.forces, plain_mean.forces, rtol=0, atol=0)
