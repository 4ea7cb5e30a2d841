"""The mp-mix generator: seeded, fixed shares, real crystals."""

import json
from collections import Counter
from pathlib import Path

import numpy as np

from portbench import mpmix

TRAFFIC = Path(__file__).resolve().parent / "traffic"


def recipe(name):
    t = json.loads((TRAFFIC / f"{name}.json").read_text())
    return t["recipe"] * t["repeat"], t


def test_same_seed_same_structures():
    r, t = recipe("train")
    a = mpmix.batches(r, 2, 2**31 + 5, t["strain"], t["noise"])
    b = mpmix.batches(r, 2, 2**31 + 5, t["strain"], t["noise"])
    for ba, bb in zip(a, b):
        for (la, pa, za), (lb, pb, zb) in zip(ba, bb):
            assert np.array_equal(la, lb) and np.array_equal(pa, pb) and np.array_equal(za, zb)
    c = mpmix.batches(r, 1, 2**31 + 6, t["strain"], t["noise"])[0]
    assert not all(np.array_equal(x[1], y[1]) for x, y in zip(a[0], c))


def test_prototype_shares_and_atoms_fixed_across_seeds():
    r, t = recipe("screen")
    seen = set()
    for seed in (1, 2**31 + 3, 2**33):
        for batch in mpmix.batches(r, 2, seed, t["strain"], t["noise"]):
            shares = Counter(mpmix.COMPOUNDS[_compound(s)][0] for s in batch)
            seen.add((tuple(sorted(shares.items())), sum(len(s[2]) for s in batch)))
    assert len(seen) == 1
    (shares, atoms), = seen
    assert dict(shares) == {"fcc": 18, "bcc": 18, "hcp": 18, "rocksalt": 18, "diamond": 18,
                            "perovskite": 12}
    assert atoms == 16242


def _compound(structure):
    z = tuple(sorted(set(structure[2].tolist())))
    return next(name for name, (_, _, _, numbers) in mpmix.COMPOUNDS.items()
                if tuple(sorted(set(numbers))) == z)


def test_sizes_strain_noise_and_wrapping():
    rng = np.random.default_rng(0)
    for name in mpmix.COMPOUNDS:
        lat, pos, z = mpmix.crystal(name, (2, 2, 2), rng, 0.02, 0.05)
        frac = pos @ np.linalg.inv(lat)
        assert frac.min() >= 0 and frac.max() < 1
        base, _, _ = mpmix.crystal(name, (2, 2, 2))
        assert np.abs(np.linalg.inv(base) @ lat - np.eye(3)).max() <= 0.02 + 1e-12
    for r, _ in (recipe("screen"), recipe("train")):
        for compound, *reps in r:
            assert 64 <= len(mpmix.crystal(compound, reps)[2]) <= 256


def test_fcc_copper_neighbours():
    """12 nearest neighbours at a / sqrt(2) in fcc Cu: the table is a real crystal."""
    lat, pos, _ = mpmix.crystal("Cu", (3, 3, 3))
    d = np.linalg.norm(pos[1:] - pos[0], axis=1)
    images = np.linalg.norm(pos[None, :] + (np.array([[i, j, k] for i in (-1, 0, 1)
                            for j in (-1, 0, 1) for k in (-1, 0, 1)]) @ lat)[:, None] - pos[0],
                            axis=-1)
    near = np.sort(images[images > 1e-9])[:13]
    assert np.allclose(near[:12], 3.615 / np.sqrt(2)) and near[12] > 3.0
    assert d.min() > 2.5


def test_every_seed_gets_the_same_graphs_sizes():
    """The seed changes the order and the noise, not the strains: the pool's
    lattices, and so the shells inside each cutoff, are the same."""
    r, t = recipe("train")
    pools = [mpmix.batches(r, 2, seed, t["strain"], t["noise"]) for seed in (4, 2**31 + 77)]
    for a, b in zip(*pools):
        key = lambda s: (len(s[2]), tuple(np.round(s[0], 12).ravel()))
        assert sorted(map(key, a)) == sorted(map(key, b))
