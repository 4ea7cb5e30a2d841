"""The port's ``utils/`` against the JAX package's, on the CPU.

- ``cells``: the same maps, exactly;
- ``debug.check_batch``: the same violations on a good batch and on four
  broken ones; ``enable_nan_checks`` turns torch's anomaly mode on and off;
- ``profiling``: ``device_trace`` writes a Chrome trace (the spans and
  counters are tested in ``test_torch_tracing.py``);
- ``oracle``: the port's copy against JAX's on the same inputs (rtol
  1e-12: the same numpy arithmetic), and the port's float64 model against
  the port's oracle at rtol 1e-10, as ``tests/test_parity.py`` holds JAX's
  model, with the weights nested back by ``flax_from_params``.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from torch_m3gnet_tpu.config import M3GNetConfig as JaxConfig
from torch_m3gnet_tpu.data.graph import graph_from_structure as jax_graph
from torch_m3gnet_tpu.data.graph import pack_structures as jax_pack
from torch_m3gnet_tpu.data.structure import Structure as JaxStructure
from torch_m3gnet_tpu.models import build_model as jax_build_model
from torch_m3gnet_tpu.utils import cells as jax_cells
from torch_m3gnet_tpu.utils import debug as jax_debug
from torch_m3gnet_tpu.utils import oracle as jax_oracle
from torch_m3gnet_tpu_torch.config import M3GNetConfig
from torch_m3gnet_tpu_torch.data import Structure, graph_from_structure, pack_structures, pad_batch
from torch_m3gnet_tpu_torch.models import build_model, flax_from_params, params_from_flax
from torch_m3gnet_tpu_torch.utils import cells, debug, oracle, profiling

jax.config.update("jax_enable_x64", True)

FCC = [[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]


def _port(s: JaxStructure) -> Structure:
    return Structure(s.lattice, s.cart_coords, s.atomic_numbers)


def _rattled(n: int = 2, seed: int = 0):
    """``n`` rattled 4-atom fcc Cu cells as (JAX, port) Structure lists."""
    rng = np.random.default_rng(seed)
    base = JaxStructure.from_frac_coords(np.eye(3) * 3.62, FCC, [29] * 4)
    js = [JaxStructure(base.lattice, base.cart_coords + 0.1 * rng.standard_normal((4, 3)),
                       base.atomic_numbers) for _ in range(n)]
    return js, [_port(s) for s in js]


def test_cells_match_jax(tio2_rutile):
    rng = np.random.default_rng(1)
    rot, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    eps = 0.02 * rng.standard_normal((3, 3))
    port = _port(tio2_rutile)
    for got, want in ((cells.rotate_cell(port, rot), jax_cells.rotate_cell(tio2_rutile, rot)),
                      (cells.strain_cell(port, eps), jax_cells.strain_cell(tio2_rutile, eps))):
        assert isinstance(got, Structure)
        np.testing.assert_array_equal(got.lattice, want.lattice)
        np.testing.assert_array_equal(got.cart_coords, want.cart_coords)
        np.testing.assert_array_equal(got.atomic_numbers, want.atomic_numbers)


def _broken(b, n):
    """The good batch and four broken copies (by name) of a host batch ``b``
    with ``n`` padded nodes; the same edits on a JAX or a port batch."""
    src, t1 = np.array(b.edge_src), np.array(b.triplet_e1)
    last = int(np.asarray(b.edge_mask).sum()) - 1  # the last real edge: the last node's
    unsorted = src.copy()
    unsorted[[0, last]] = unsorted[[last, 0]]
    dst = np.array(b.edge_dst)
    dst[3] = n
    t2 = np.array(b.triplet_e2)
    t2[5] = t1[5]
    return {
        "good": b,
        "unsorted src": b.replace(edge_src=unsorted),
        "out-of-range ids": b.replace(edge_dst=dst),
        "degenerate triplet": b.replace(triplet_e2=t2),
        "forces length": b.replace(forces=np.zeros((n - 1, 3), np.float32)),
    }


def test_check_batch_matches_jax():
    js, ps = _rattled()
    jb = jax_pack(js, 5.0, 4.0, pad_multiple=64)
    pb = pack_structures(ps, 5.0, 4.0, pad_multiple=64)
    want = {k: jax_debug.check_batch(v) for k, v in _broken(jb, jb.num_nodes).items()}
    got = {k: debug.check_batch(v) for k, v in _broken(pb, pb.num_nodes).items()}
    assert got == want
    assert got["good"] == []
    assert "real edges not sorted by source" in got["unsorted src"]
    assert got["out-of-range ids"] == ["edge_dst out of node range"]
    assert got["degenerate triplet"] == ["degenerate triplet (e1 == e2)"]
    assert got["forces length"] == ["forces length != num_nodes"]
    # the same verdicts on a batch whose fields are CPU tensors
    assert {k: debug.check_batch(_tensors(v)) for k, v in _broken(pb, pb.num_nodes).items()} \
        == got


def _tensors(b):
    """``b`` with every array field a CPU tensor, unchecked (``to_torch``
    refuses the broken batches)."""
    return b.replace(**{f.name: torch.as_tensor(getattr(b, f.name))
                        for f in dataclasses.fields(b) if isinstance(getattr(b, f.name), np.ndarray)})


def test_enable_nan_checks_toggles_anomaly_mode():
    saved = torch.is_anomaly_enabled()
    try:
        debug.enable_nan_checks()
        assert torch.is_anomaly_enabled()
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x * 0 - 1).sum().backward()
        debug.enable_nan_checks(False)
        assert not torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(saved)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (trace,) = tmp_path.glob("*.pt.trace.json")
    assert json.loads(trace.read_text())["traceEvents"]


def _jax_params(cfg_kw, batch, seed):
    pot = jax_build_model(JaxConfig(**cfg_kw))
    params = jax.jit(pot.init)(jax.random.PRNGKey(seed), batch)
    return jax.tree.map(lambda x: np.asarray(x, dtype=np.float64), params["params"])


@pytest.mark.parametrize("seed", [0, 1])
def test_oracle_matches_jax(tio2_rutile, seed):
    kw = dict(l_max=3, n_max=3, embedding_dim=16, num_blocks=2)
    cfg = M3GNetConfig(**kw)
    jg = jax_graph(tio2_rutile, cfg.cutoff, cfg.threebody_cutoff, dtype=np.float64)
    pg = graph_from_structure(_port(tio2_rutile), cfg.cutoff, cfg.threebody_cutoff,
                              dtype=np.float64)
    p = _jax_params(kw, jg, seed)
    elemental = np.zeros(cfg.num_types)
    elemental[21], elemental[7] = -1.5, -0.7
    want, want_inter = jax_oracle.reference_energy_numpy(p, jg, cfg, elemental, 1.37,
                                                          return_intermediates=True)
    got, got_inter = oracle.reference_energy_numpy(p, pg, cfg, elemental, 1.37,
                                                   return_intermediates=True)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert set(got_inter) == set(want_inter)
    for k in want_inter:
        np.testing.assert_allclose(got_inter[k], want_inter[k], rtol=1e-12, atol=1e-14,
                                   err_msg=k)
    # the state_dict of those weights, nested back, is the same tree
    back = flax_from_params(params_from_flax(p, dtype=torch.float64))
    assert jax.tree.structure(back) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["factorized", "fused"])
def test_f64_model_matches_port_oracle(tio2_rutile, mode):
    """The port's own weights (a seeded ``build_model``) through its f64
    model, padded, against its oracle on the unpadded graph."""
    cfg = M3GNetConfig(l_max=3, n_max=3, embedding_dim=16, num_blocks=2, threebody_mode=mode)
    elemental = np.zeros(cfg.num_types)
    elemental[21], elemental[7] = -1.5, -0.7
    scale = 1.37
    g = graph_from_structure(_port(tio2_rutile), cfg.cutoff, cfg.threebody_cutoff,
                             dtype=np.float64)
    padded = pad_batch(g, g.num_nodes + 5, g.num_edges + 7, g.num_triplets + 9, 2)
    pot = build_model(cfg, elemental_energies=list(map(float, elemental)), energy_scale=scale,
                      device="cpu", generator=torch.Generator().manual_seed(4)).double()
    got = float(pot(padded).energy[0].detach())
    want = oracle.reference_energy_numpy(flax_from_params(pot.state_dict()), g, cfg,
                                         elemental, scale)
    np.testing.assert_allclose(got, want, rtol=1e-10)
