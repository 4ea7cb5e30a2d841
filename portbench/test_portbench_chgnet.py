"""The CHGNet cell's kind on the CPU, at the rehearsal's size: the whole
run (the window and the traced run) correct, an altered answer that the
check catches, the reference it compares with against the program, and
the new readers on device records made by hand."""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import faults, harness, mpmix, weights
from portbench.conftest import tiny
from portbench.kinds import chgnet_screen
from portbench.reference import chgnet as chgnet_reference
from portbench.trace import Record, Trace

HERE = Path(__file__).resolve().parent
CELL = "chgnet-mptrj.screen"


@pytest.mark.parametrize("trace", [False, True], ids=["window", "traced"])
def test_sound_run_is_correct(trace):
    """The run at the rehearsal's size (``conftest.tiny``, which this kind
    reads as the screen kinds' cut) comes out correct; the rehearsal in a
    fresh process that loads no JAX is ``test_portbench_imports``."""
    result = harness.run(CELL, 2**31 + 9, 0.5, trace, device="cpu", patch=tiny)
    assert result["correct"], result["checks"]


def test_altered_answer_is_caught():
    with faults.FAULTS["answer_altered"](harness.resolve(CELL).traffic["kind"]):
        result = harness.run(CELL, 2**31 + 21, 0.5, False, device="cpu", patch=tiny)
    assert not result["correct"], result["checks"]
    assert result["checks"]["forces_err"]["value"] > result["checks"]["forces_err"]["limit"]


def test_chgnet_reference_matches_the_program():
    """The benchmark's CHGNet reference and the program's CPU path, both in
    float64, agree to rounding on a tiny mp-mix batch."""
    from torch_m3gnet_tpu_torch import build_model
    from torch_m3gnet_tpu_torch.data import Structure, pack_structures

    cfg = json.loads((HERE / "configs" / "chgnet-mptrj.json").read_text())
    cfg["embedding_dim"] = 16
    w = chgnet_screen.make_weights(cfg, 11, "cpu", torch.float64)
    elem = weights.elemental_energies(cfg, 11)
    pot = build_model(harness.model_config(cfg), elemental_energies=list(elem),
                      device="cpu").double()
    pot.load_state_dict(w)
    structs = mpmix.batches([["Cu", 2, 2, 2], ["NaCl", 1, 1, 2], ["SrTiO3", 2, 2, 2]], 1, 11,
                            0.02, 0.05)[0]
    out = pot(pack_structures([Structure(*s) for s in structs], cfg["cutoff"],
                              cfg["threebody_cutoff"], pad_multiple=64, dtype=np.float64,
                              bond_pairs=True))
    ref = chgnet_reference.efs(w, cfg, structs, elem, block_atoms=40)  # a block a structure
    n = sum(len(s[2]) for s in structs)
    for got, want in ((out.energy[: len(structs)], [r[0] for r in ref]),
                      (out.forces[:n], np.concatenate([r[1] for r in ref])),
                      (out.stress[: len(structs)], np.stack([r[2] for r in ref])),
                      (out.magmom[:n], np.concatenate([r[3] for r in ref]))):
        got, want = got.detach().numpy(), np.asarray(want)
        assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


def records(span_name, durations):
    """One request holding one program span, which holds one launch and
    one kernel record per duration; one more kernel outside the span."""
    recs = [Record("span", "portbench.span", 0, 10_000_000),
            Record("span", span_name, 50, 5_000_000)]
    t = 100
    for k, dur in enumerate(list(durations) + [2_000_000], start=1):
        if k == len(durations) + 1:
            t = 6_000_000
        recs.append(Record("launch", "cudaLaunchKernel", t, t + 10, k))
        recs.append(Record("kernel", f"void kernel_{k}(float const*)", t + 50, t + 50 + dur, k))
        t += 1_000_000
    return Trace(records=recs, work=[{"nodes": 1024, "edges_pad": 4096, "triplets_pad": 8192,
                                      "graphs_pad": 4, "atoms": 1000, "edges": 4000,
                                      "triplets": 8000, "graphs": 4, "steps": 1}])


def ctx_of():
    """The CHGNet configuration, and the program's counts of the traced
    request: 8000 angles, 2000 bonds (4000 edges)."""
    cfg = json.loads((HERE / "configs" / "chgnet-mptrj.json").read_text())
    return SimpleNamespace(config=cfg, device="cuda",
                           counted={"chgnet.angles": 8000, "chgnet.bonds": 2000})


def test_bondgraph_ms_mfu_and_idle_on_records_made_by_hand(monkeypatch):
    from portbench import roofline

    monkeypatch.setattr(roofline, "peaks", lambda ctx: {"float32_flops_per_s": 67e12})
    ctx = ctx_of()
    tr = records("chgnet.bond_graph", [300_000, 700_000])
    assert harness.reader("bondgraph_fwd_ms.chgnet")(tr, ctx) == pytest.approx(1.0)
    d, r, a = 64, 31, 31
    twin = lambda n_in, hidden: 4 * (n_in * hidden + hidden * d if hidden else n_in * d)
    per_angle = 2 * a * d + 3 * twin(4 * d, d) + 2 * twin(4 * d, 0)
    per_edge = 6 * r * d + 4 * twin(3 * d, d) + 3 * 2 * d * d
    per_node = 4 * 2 * d * d + 2 * d + 2 * (3 * d * d + d)
    flops = 8000 * per_angle + 4000 * per_edge + 1000 * per_node
    assert chgnet_screen.model_flops(ctx.config, {"atoms": 1000, "bonds": 2000,
                                                  "angles": 8000}) == flops
    want = 100 * 2 * flops / 0.01 / 67e12
    assert harness.reader("mfu.chgnet")(tr, ctx) == pytest.approx(want, rel=1e-12)
    uncounted = SimpleNamespace(config=ctx.config, device="cuda")  # a program without counters
    assert harness.reader("mfu.chgnet")(tr, uncounted) is None
    busy = 300_000 + 700_000 + 2_000_000
    assert harness.reader("device_idle_share.chgnet")(tr, ctx) == pytest.approx(
        100 * (1 - busy / 1e7))
    tr.records = [x for x in tr.records if not (x.kind == "kernel" and x.corr == 2)]
    assert harness.reader("bondgraph_fwd_ms.chgnet")(tr, ctx) is None  # a record dropped


def test_flops_count_every_matrix_product_of_the_program():
    """``model_flops`` at one atom, bond (two edges) and angle equals 2 x
    the in x out of every dense layer the program applies at each (the
    angle update after the last bond conv is not applied)."""
    from torch_m3gnet_tpu_torch import build_model

    cfg = json.loads((HERE / "configs" / "chgnet-mptrj.json").read_text())
    pot = build_model(harness.model_config(cfg), device="cpu")
    per = {"edge": 0, "angle": 0, "node": 0}
    for name, p in pot.named_parameters():
        if not name.endswith("kernel"):
            continue
        if name.startswith("model.angle_") or (name.startswith("model.bond_conv")
                                                and ".phi." in name):
            scale = "angle"  # the angle embedding, the bond convs' and angle updates' phi
        elif name.startswith("model.bond_") or (name.startswith("model.atom_conv")
                                                and ".phi." in name):
            scale = "edge"  # the bond embedding and weights, the atom convs' phi, bond_conv out
        else:
            scale = "node"  # the atom convs' out, the magnetic moment, the readout
        per[scale] += 2 * p.numel()
    work = lambda atoms, bonds, angles: {"atoms": atoms, "bonds": bonds, "angles": angles}
    assert chgnet_screen.model_flops(cfg, work(0, 0, 1)) == per["angle"]
    assert chgnet_screen.model_flops(cfg, work(0, 1, 0)) == 2 * per["edge"]
    assert chgnet_screen.model_flops(cfg, work(1, 0, 0)) == per["node"]
