"""CHGNet on the port (``models.chgnet``, ``build_model`` with
``architecture="chgnet"``) against the plain reference ``plain_chgnet.py``,
both in float64 on the CPU: E/F/S and magnetic moments on the small test
crystals and on one padded batch of all three, the weights' gradient of a
loss on forces and stress, the bond graph against the reference's own
angle enumeration, and the pairs of directed edges that carry one bond's
feature.

Tolerances: the two compute the same function in float64 by different
arithmetic (feature-major kernels' plain versions and per-edge bond lengths
against row-major ``index_add`` and a bond table), so they agree to
~1e-14 relative; the limits leave a factor of ~1e4 (energies, forces,
stresses, moments) and ~1e4 (weight gradients) for the sums' order.
"""

import numpy as np
import pytest
import torch

from torch_m3gnet_tpu_torch import M3GNetConfig
from torch_m3gnet_tpu_torch.data import Structure
from torch_m3gnet_tpu_torch.data.graph import pack_structures, reverse_edges, to_torch
from torch_m3gnet_tpu_torch.models import M3GNetPotential, Potential, build_model

import plain_chgnet

CUTOFF, BOND_CUTOFF = 5.0, 3.0
CFG = {"cutoff": CUTOFF, "threebody_cutoff": BOND_CUTOFF, "num_angular": 31, "num_blocks": 4}
# float64, summed in another order: relative agreement of energies, forces,
# stresses and moments (measured 1.4e-14 on the batch of all three crystals;
# the weight gradients 6.8e-14)
RTOL = 1e-10
CRYSTALS = ["al_fcc", "na_bcc", "tio2_rutile"]


def rattled(structure, seed):
    """The crystal with its atoms moved by 0.05 A from the seed: no angle
    exactly 0 or pi, where acos (the reference) has no derivative."""
    rng = np.random.default_rng(seed)
    pos = np.asarray(structure.cart_coords) + rng.normal(0.0, 0.05, (len(structure), 3))
    return (np.asarray(structure.lattice, np.float64), pos, np.asarray(structure.atomic_numbers))


def potential(seed=3):
    config = M3GNetConfig(architecture="chgnet", cutoff=CUTOFF, threebody_cutoff=BOND_CUTOFF,
                          num_types=94, embedding_dim=8, num_blocks=4)
    rng = np.random.default_rng(seed)
    pot = build_model(config, elemental_energies=list(rng.uniform(-8, -2, 94)), device="cpu",
                      generator=torch.Generator().manual_seed(seed)).double()
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():  # biases, norms and frequencies off their starting values
        for name, p in pot.named_parameters():
            if not name.endswith("kernel") and not name.endswith("embedding"):
                p.add_(0.1 * torch.randn(p.shape, generator=gen, dtype=p.dtype))
    return pot


def structures_of(request, names):
    return [rattled(request.getfixturevalue(n), k) for k, n in enumerate(names)]


def pack(structs, **kw):
    return pack_structures([Structure(*s) for s in structs], CUTOFF, BOND_CUTOFF,
                           dtype=np.float64, bond_pairs=True, **kw)


def close(got, want, rtol=RTOL):
    got, want = (np.asarray(x.detach() if isinstance(x, torch.Tensor) else x, float)
                 for x in (got, want))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-300)


@pytest.mark.parametrize("names", [[n] for n in CRYSTALS] + [CRYSTALS],
                         ids=CRYSTALS + ["batch"])
def test_efs_and_magmom_match_plain(request, names):
    structs = structures_of(request, names)
    pot = potential()
    batch = pack(structs, pad_multiple=32)  # padding on every axis
    out = pot(batch)
    elem = pot.model.elemental_energies
    ref = plain_chgnet.efs(pot.state_dict(), CFG, structs, elem)
    off = 0
    for b, (e, f, s, m) in enumerate(ref):
        n = len(structs[b][2])
        close(out.energy[b].detach(), e.detach())
        close(out.forces[off:off + n], f.detach())
        close(out.stress[b], s.detach())
        close(out.magmom[off:off + n].detach(), m.detach())
        off += n
    assert not out.forces[off:].any() and not out.magmom[off:].any()  # padded atoms


def test_force_loss_weight_gradients_match_plain(request):
    """The force backward kept (``create_graph=True``): a loss on energies,
    forces, stresses and moments differentiates to every weight as the
    reference's does."""
    structs = structures_of(request, CRYSTALS)
    pot = potential(5)
    out = pot(pack(structs, pad_multiple=32), create_graph=True)
    n = sum(len(s[2]) for s in structs)
    loss = (out.forces[:n] ** 2).sum() + (out.stress[: len(structs)] ** 2).sum() + (
        out.energy[: len(structs)] ** 2).sum() + (out.magmom ** 2).sum()
    params = dict(pot.named_parameters())
    got = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    weights = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    ref = plain_chgnet.efs(weights, CFG, structs, pot.model.elemental_energies,
                           create_graph=True)
    ref_loss = sum((f ** 2).sum() + (s ** 2).sum() + e ** 2 + (m ** 2).sum()
                   for e, f, s, m in ref)
    close(loss.detach(), ref_loss.detach())
    want = dict(zip(weights, torch.autograd.grad(ref_loss, list(weights.values()))))
    for name in params:
        close(got[name], want[name], 1e-9)


def test_bond_graph_is_the_plain_angle_list(request):
    """The packed triplets at the bond-graph cutoff are the reference's
    angles: the same (centre, bond, bond) set, bonds named by their
    destination and image."""
    structs = structures_of(request, ["al_fcc", "tio2_rutile"])
    batch = pack(structs, pad_multiple=32)
    for b, s in enumerate(structs):
        src, dst, shift = plain_chgnet.neighbor_list(torch.as_tensor(s[1]),
                                                     torch.as_tensor(s[0]), CUTOFF)
        r = torch.as_tensor(s[1])[dst] + shift @ torch.as_tensor(s[0]) - torch.as_tensor(s[1])[src]
        e1, e2 = plain_chgnet.angles(src, torch.linalg.vector_norm(r, dim=1), BOND_CUTOFF)
        key = lambda e: (int(dst[e]), *np.rint(shift[e].numpy()).astype(int).tolist())
        want = sorted((int(src[a]), key(a), key(c)) for a, c in zip(e1.tolist(), e2.tolist()))
        off = int(np.sum(batch.n_node[:b]))
        mask = np.asarray(batch.triplet_mask, bool)
        bsrc, bdst = np.asarray(batch.edge_src), np.asarray(batch.edge_dst)
        bshift = np.rint(np.asarray(batch.edge_cell_shift)).astype(int)
        mine = np.asarray(batch.node_graph)[bsrc[np.asarray(batch.triplet_e1)]] == b
        bkey = lambda e: (int(bdst[e]) - off, *bshift[e].tolist())
        got = sorted((int(bsrc[a]) - off, bkey(a), bkey(c)) for a, c in zip(
            np.asarray(batch.triplet_e1)[mask & mine], np.asarray(batch.triplet_e2)[mask & mine]))
        assert len(got) > 0 or b == 1
        assert got == want


def test_edge_reverse_pairs_every_edge_with_its_reverse(request):
    batch = pack(structures_of(request, CRYSTALS), pad_multiple=32)
    rev, mask = np.asarray(batch.edge_reverse), np.asarray(batch.edge_mask, bool)
    src, dst = np.asarray(batch.edge_src), np.asarray(batch.edge_dst)
    shift = np.asarray(batch.edge_cell_shift)
    assert rev.dtype == np.int32
    assert np.array_equal(rev[rev], np.arange(len(rev)))  # an involution
    assert np.all(mask[rev] == mask)
    assert np.array_equal(src[rev][mask], dst[mask]) and np.array_equal(dst[rev][mask], src[mask])
    assert np.array_equal(shift[rev][mask], -shift[mask])
    assert np.all(rev[rev != np.arange(len(rev))] != np.nonzero(~mask)[0][:1])
    assert np.array_equal(rev[~mask], np.nonzero(~mask)[0])  # a padded edge is its own
    with pytest.raises(ValueError, match="no reverse edge"):
        reverse_edges(src[mask][:-1], dst[mask][:-1], shift[mask][:-1])
    assert pack_structures([Structure(*structures_of(request, ["al_fcc"])[0])], CUTOFF,
                           BOND_CUTOFF).edge_reverse is None  # M3GNet's batches: unchanged


def test_to_torch_copies_and_checks_edge_reverse(request):
    batch = pack(structures_of(request, ["al_fcc"]))
    t = to_torch(batch, "cpu", torch.float64)
    assert t.edge_reverse.dtype == torch.int32
    bad = np.asarray(batch.edge_reverse).copy()
    bad[0] = batch.num_edges
    with pytest.raises(ValueError, match="edge_reverse holds an edge index outside"):
        to_torch(batch.replace(edge_reverse=bad), "cpu")


def test_functional_path_matches_eager(request):
    structs = structures_of(request, ["tio2_rutile"])
    pot = potential(7)
    batch = pack(structs, pad_multiple=32)
    eager, func = pot(batch), pot(batch, functional=True)
    for field in ("energy", "forces", "stress", "magmom"):
        close(getattr(func, field).detach(), getattr(eager, field).detach(), 1e-12)


def test_build_and_call_refuse_what_chgnet_lacks(request):
    config = M3GNetConfig(architecture="chgnet", embedding_dim=8)
    with pytest.raises(ValueError, match="float32"):
        build_model(config.replace(compute_dtype="bfloat16"), device="cpu")
    with pytest.raises(ValueError, match="no energy or length scale"):
        build_model(config, energy_scale=20.0, device="cpu")
    with pytest.raises(ValueError, match="unknown architecture"):
        build_model(config.replace(architecture="schnet"), device="cpu")
    pot = build_model(config, device="cpu").double()
    plain = pack_structures([Structure(*structures_of(request, ["al_fcc"])[0])], CUTOFF,
                            BOND_CUTOFF, dtype=np.float64)
    with pytest.raises(ValueError, match="bond_pairs=True"):
        pot(plain)


def test_m3gnet_through_the_generalised_potential(request):
    """M3GNet's potential is the generalised one under its old name and
    predicts no magnetic moments."""
    assert M3GNetPotential is Potential
    pot = build_model(M3GNetConfig(embedding_dim=8), device="cpu",
                      generator=torch.Generator().manual_seed(0)).double()
    out = pot(pack_structures([Structure(*structures_of(request, ["al_fcc"])[0])], CUTOFF, 4.0,
                              dtype=np.float64))
    assert out.magmom is None and out.energy.shape == (1,)


def test_spans_and_counters(request):
    """Under a profiler the forward records one ``chgnet.atom_conv`` span an
    atom conv and one ``chgnet.bond_graph`` span for the angles' set-up and
    one a bond conv; every forward adds the batch's real angles and bonds
    (undirected) to the counters, whether a profiler records or not."""
    from torch.profiler import ProfilerActivity, profile

    from torch_m3gnet_tpu_torch.utils import profiling

    batch = pack(structures_of(request, CRYSTALS), pad_multiple=32)
    pot = potential()
    profiling.reset_counts("chgnet.")
    pot(batch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pot(batch)
    names = [e.name for e in prof.events()]
    assert names.count("chgnet.atom_conv") == 4
    assert names.count("chgnet.bond_graph") == 1 + 3
    got = profiling.counts()
    assert got["chgnet.angles"] == 2 * int(np.sum(batch.triplet_mask))
    assert got["chgnet.bonds"] == 2 * int(np.sum(batch.edge_mask)) // 2


def test_md_and_relax_pack_the_bond_pairs(request):
    """``run_md`` and ``relax_structures`` pack each rebuild with the bond
    pairs when the model names ``edge_reverse`` in its ``batch_index``: NVE
    MD keeps the total energy, and FIRE lowers the energy."""
    from torch_m3gnet_tpu_torch.simulate.md import MDConfig, run_md
    from torch_m3gnet_tpu_torch.simulate.relax import FireConfig, relax_structures

    pot = potential()
    assert "edge_reverse" in pot.model.batch_index
    raw = structures_of(request, ["al_fcc"])[0]
    s = Structure(*raw)
    res = run_md(pot, [s], CUTOFF, BOND_CUTOFF, MDConfig(dt=0.5, n_steps=4, rebuild_every=2,
                                                         temperature=100.0),
                 pad_multiple=32, dtype=np.float64)
    total = res.energies[:, 0] + res.kinetic[:, 0]
    assert np.all(np.isfinite(total)) and np.ptp(total) <= 1e-3 * np.abs(total).max()
    start = float(pot(pack([raw])).energy[0].detach())
    _, energies, _ = relax_structures(pot, [s], CUTOFF, BOND_CUTOFF,
                                      FireConfig(max_steps=6, rebuild_every=3), pad_multiple=32)
    assert energies[0] < start
