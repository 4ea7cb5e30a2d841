"""The port's relaxation (torch_m3gnet_tpu_torch.simulate.relax) against the
JAX package's ``relax_structures``, with the same weights.

A small model (2 blocks, width 8, l_max = n_max = 2) in float64 on both
sides. JAX's ``relax_structures`` builds its graphs in float32; here it builds them in
float64 (its ``graph_from_structure`` is wrapped for the test, nothing in
the package changes), so both run the same f64 arithmetic and differ only by
summation order inside the potential (1e-9 relative, test_torch_model.py):
final positions, lattices, energies and max forces within rtol 1e-7, atol
1e-9 after 12 steps over two rebuilds.

L-BFGS is compared at ``history=1``. At a longer history the JAX two-loop
recursion zeroes the alpha of ring slot 0 while fewer than ``history`` pairs
are stored (its scan over the not-yet-stored slots writes alpha 0 to slot 0
after the stored pair there), which the port does not copy; the port's
recursion is held instead to the dense BFGS inverse-Hessian update it
stands for.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from torch_m3gnet_tpu.config import M3GNetConfig as JaxConfig
from torch_m3gnet_tpu.data.graph import graph_from_structure as jax_graph_from_structure
from torch_m3gnet_tpu.data.graph import pack_structures as jax_pack
from torch_m3gnet_tpu.data.structure import Structure as JaxStructure
from torch_m3gnet_tpu.models import build_model as jax_build_model
from torch_m3gnet_tpu.simulate import relax as jax_relax
from torch_m3gnet_tpu_torch.config import M3GNetConfig
from torch_m3gnet_tpu_torch.data import Structure
from torch_m3gnet_tpu_torch.models import build_model, params_from_flax
from torch_m3gnet_tpu_torch.simulate import relax

jax.config.update("jax_enable_x64", True)

SMALL = dict(l_max=2, n_max=2, embedding_dim=8, num_blocks=2)
# The port's default three-body mode on both sides: the per-triplet modes
# read a triplet list built at the 3-body cutoff at each rebuild, so they
# drop the triplets of an edge that moves inside that cutoff between
# rebuilds, where the factorized stage sees every edge.
FACTORIZED = dict(threebody_mode="factorized", layout="fm")
FCC = [[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]]


def _cells():
    """A rattled and a plane-strained 4-atom fcc Cu cell, as (JAX, port)."""
    rng = np.random.default_rng(3)
    base = JaxStructure.from_frac_coords(np.eye(3) * 3.62, FCC, [29] * 4)
    strain = np.diag([1.04, 0.97, 1.0])
    cells = [(base.lattice, base.cart_coords + 0.12 * rng.standard_normal((4, 3))),
             (base.lattice @ strain.T,
              base.cart_coords @ strain.T + 0.03 * rng.standard_normal((4, 3)))]
    return ([JaxStructure(lat, p, base.atomic_numbers) for lat, p in cells],
            [Structure(lat, p, base.atomic_numbers) for lat, p in cells])


@pytest.fixture(scope="module")
def pots():
    """Weights of seed 1, on which L-BFGS accepts curvature pairs (s.y > 0)
    from its second step in both runs."""
    jstructs, _ = _cells()
    batch = jax_pack(jstructs, 5.0, 4.0, pad_multiple=64, dtype=np.float64)
    jpot = jax_build_model(JaxConfig(**FACTORIZED, **SMALL))
    params = jpot.init(jax.random.PRNGKey(1), batch)
    pot = build_model(M3GNetConfig(**SMALL), device="cpu").double()
    pot.model.load_state_dict(
        params_from_flax(jax.tree.map(np.asarray, params), dtype=torch.float64))
    return jpot, params, pot


@pytest.mark.parametrize("relax_cell", [False, True], ids=["positions", "cell"])
@pytest.mark.parametrize("method", ["fire", "lbfgs"])
def test_relax_matches_jax(pots, monkeypatch, method, relax_cell):
    """FIRE and L-BFGS (history 1), with and without cell relaxation:
    relaxed positions, lattices, energies and max forces against JAX's
    (tolerances in the module docstring)."""
    jpot, params, pot = pots
    monkeypatch.setattr(jax_relax, "graph_from_structure",
                        functools.partial(jax_graph_from_structure, dtype=np.float64))
    jstructs, structs = _cells()
    kw = dict(max_steps=12, rebuild_every=6, fmax=1e-6, relax_cell=relax_cell)
    if method == "fire":
        jcfg, cfg = jax_relax.FireConfig(**kw), relax.FireConfig(**kw)
    else:
        jcfg, cfg = (jax_relax.LbfgsConfig(history=1, **kw),
                     relax.LbfgsConfig(history=1, **kw))
    want = jax_relax.relax_structures(jpot, params, jstructs, 5.0, 4.0, jcfg, pad_multiple=64)
    pairs = []  # stored curvature pairs (rho > 0) that each L-BFGS step used
    two_loop = relax._two_loop
    monkeypatch.setattr(relax, "_two_loop", lambda g, gc, hist, *a, **k: (
        pairs.append(int((hist[4] > 0).sum())), two_loop(g, gc, hist, *a, **k))[1])
    got = relax.relax_structures(pot, structs, 5.0, 4.0, cfg, pad_multiple=64)
    if method == "lbfgs":  # the recursion ran on accepted pairs, not only H0
        assert max(pairs) > 0
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g.cart_coords, w.cart_coords, rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(g.lattice, w.lattice, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-7, atol=1e-9)
    if relax_cell:
        assert not np.allclose(got[0][1].lattice, structs[1].lattice)


def _dense_bfgs_direction(g, pairs, gamma):
    """H g for the BFGS inverse Hessian built from H0 = gamma I by the
    pairs (s, y), oldest first: H <- (I - rho s y^T) H (I - rho y s^T)
    + rho s s^T."""
    n = g.size
    h = gamma * np.eye(n)
    for s, y in pairs:
        rho = 1.0 / (s @ y)
        v = np.eye(n) - rho * np.outer(y, s)
        h = v.T @ h @ v + rho * np.outer(s, s)
    return h @ g


@pytest.mark.parametrize("count", [1, 3, 5])
def test_lbfgs_two_loop_is_the_bfgs_update(count):
    """The port's two-loop recursion (ring of m = 3 pairs; count 1 and 3
    fill it, 5 has wrapped) equals the dense BFGS inverse Hessian of the
    min(count, m) newest pairs applied to g, per graph, at f64: rtol 1e-10.
    Two graphs with 3 and 2 atoms."""
    rng = np.random.default_rng(count)
    m, node_graph = 3, torch.tensor([0, 0, 0, 1, 1])
    n = node_graph.numel()
    s_all = [rng.standard_normal((n, 3)) for _ in range(count)]
    # y = A s with A symmetric positive definite keeps s.y > 0
    a = rng.standard_normal((3 * n, 3 * n))
    a = a @ a.T + 3 * n * np.eye(3 * n)
    y_all = [(a @ s.reshape(-1)).reshape(n, 3) for s in s_all]
    g = rng.standard_normal((n, 3))

    def gdot(x, _xc, y, _yc):
        return torch.zeros(2, dtype=torch.float64).index_add_(0, node_graph, (x * y).sum(-1))

    hist = [torch.zeros((m, n, 3), dtype=torch.float64) for _ in range(2)]
    hist += [torch.zeros((m, 2, 3, 3), dtype=torch.float64) for _ in range(2)]
    hist.append(torch.zeros((2, m), dtype=torch.float64))
    for k, (s, y) in enumerate(zip(s_all, y_all)):
        hist[0][k % m], hist[1][k % m] = torch.as_tensor(s), torch.as_tensor(y)
        hist[4][:, k % m] = 1.0 / gdot(hist[0][k % m], None, hist[1][k % m], None)
    z, _ = relax._two_loop(torch.as_tensor(g), torch.zeros((2, 3, 3), dtype=torch.float64),
                           tuple(hist), count, m, gdot, node_graph, alpha0=70.0)
    for graph, rows in ((0, slice(0, 3)), (1, slice(3, 5))):
        pairs = [(s[rows].reshape(-1), y[rows].reshape(-1))
                 for s, y in zip(s_all[-m:], y_all[-m:])]
        s_new, y_new = pairs[-1]
        want = _dense_bfgs_direction(g[rows].reshape(-1), pairs, (s_new @ y_new) / (y_new @ y_new))
        np.testing.assert_allclose(z[rows].numpy().reshape(-1), want, rtol=1e-10)


@pytest.mark.parametrize("method", ["fire", "lbfgs"])
def test_steps_build_no_index(pots, monkeypatch, method):
    """The kernel index (the ``edge_src`` offsets the factorized mode reads)
    is built once per rebuild, by ``to_torch``; the steps between reuse the
    batch's (``GraphBatch.replace`` of positions and lattice keeps it)."""
    import torch_m3gnet_tpu_torch.ops.sorted_segment as ss

    _, _, pot = pots
    calls = []
    build = ss.sorted_segment_offsets
    monkeypatch.setattr(ss, "sorted_segment_offsets",
                        lambda *a: calls.append(a[1]) or build(*a))
    _, structs = _cells()
    kw = dict(max_steps=8, rebuild_every=4, fmax=1e-9, relax_cell=True)
    cfg = relax.FireConfig(**kw) if method == "fire" else relax.LbfgsConfig(**kw)
    relax.relax_structures(pot, structs, 5.0, 4.0, cfg, pad_multiple=64)
    assert len(calls) == 2  # one per rebuild, for the batch's node count
