"""The kernel launch counts that chip_smoke.py asserts on the card, held to
the calls the port makes on the CPU.

On the CPU each kernel wrapper calls its plain version exactly where, on a
CUDA tensor, it would launch its kernel; counting those calls over one eval
and one train step gives the card's launch counts, in every three-body mode
and at two depths (the counts that grow with the blocks and those that do
not); on each rank of a partitioned graph (two gloo ranks, spawned once),
one gp evaluation and one ``GraphParallelTrainer`` step launch what one
evaluation and one train step do on one device.
"""

import collections

import numpy as np
import pytest
import torch

import chip_smoke
from torch_m3gnet_tpu_torch.config import M3GNetConfig
from torch_m3gnet_tpu_torch.data import Structure, graph_from_structure, pack_structures
from torch_m3gnet_tpu_torch.models import build_model
from torch_m3gnet_tpu_torch.parallel import launch, partition_graph
from torch_m3gnet_tpu_torch.ops import factorized_stage as fs
from torch_m3gnet_tpu_torch.ops import fused_triplet as ft
from torch_m3gnet_tpu_torch.ops import sorted_segment as ss
from torch_m3gnet_tpu_torch.ops import windowed_take as wt
from torch_m3gnet_tpu_torch.train import Trainer

from _torch_parallel_ranks import PLAIN as PLAIN_NAMES

# kernel name -> (module, the function its wrapper calls on a CPU tensor)
MODULES = {"factorized_stage": fs, "fused_triplet": ft, "sorted_segment": ss, "windowed_take": wt}
PLAIN = {name: (MODULES[mod], attr) for name, (mod, attr) in PLAIN_NAMES.items()}


@pytest.fixture
def counted(monkeypatch):
    counts = collections.Counter()
    for name, (mod, attr) in PLAIN.items():
        fn = getattr(mod, attr)

        def wrapper(*args, _fn=fn, _name=name, **kwargs):
            counts[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(mod, attr, wrapper)
    return counts


def two_cells():
    rng = np.random.default_rng(0)
    base = Structure.from_frac_coords(
        np.eye(3) * 3.62, [[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]], [29] * 4)
    structs = [Structure(base.lattice, base.cart_coords + 0.05 * rng.standard_normal((4, 3)),
                         base.atomic_numbers) for _ in range(2)]
    batch = pack_structures(structs, 5.0, 4.0, pad_multiple=64)
    return batch.replace(energy=np.array([-12.0, -12.1], np.float32),
                         forces=np.zeros((batch.num_nodes, 3), np.float32),
                         stress=np.zeros((2, 6), np.float32))


def eval_and_train_launches(counted, cfg, batch):
    """The kernel calls of one evaluation and of one train step."""
    pot = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    counted.clear()
    pot(batch)
    ev = {n: counted[n] for n in PLAIN}
    counted.clear()
    Trainer(pot, cfg).train_step(batch)
    return ev, {n: counted[n] for n in PLAIN}


@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("mode", ["factorized", "fused", "gather"])
def test_launch_counts_match_chip_smoke(counted, mode, nb):
    cfg = M3GNetConfig(threebody_mode=mode, embedding_dim=8, num_blocks=nb)
    ev, train = eval_and_train_launches(counted, cfg, two_cells())
    assert ev == chip_smoke.expected_launches(mode, nb, False)
    assert train == chip_smoke.expected_launches(mode, nb, True)


@pytest.mark.parametrize("setting", ["bf16", "remat", "bf16+remat"])
@pytest.mark.parametrize("mode", ["factorized", "fused", "gather"])
def test_launch_counts_bf16_and_remat(counted, mode, setting):
    """bf16 launches what float32 does; remat adds one forward of each
    block's stage kernels per backward pass that reaches the stage (one in
    an evaluation, two in a train step), as chip_smoke.py phase 12 asserts."""
    remat = "remat" in setting
    cfg = M3GNetConfig(threebody_mode=mode, embedding_dim=8, num_blocks=2, remat_triplets=remat,
                       compute_dtype="bfloat16" if "bf16" in setting else "float32")
    ev, train = eval_and_train_launches(counted, cfg, two_cells())
    assert ev == chip_smoke.expected_launches(mode, 2, False, remat)
    assert train == chip_smoke.expected_launches(mode, 2, True, remat)


@pytest.fixture(scope="module")
def gp_launches():
    rng = np.random.default_rng(1)
    base = Structure.from_frac_coords(
        np.eye(3) * 3.62, [[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]],
        [29] * 4).supercell((2, 2, 2))
    cell = Structure(base.lattice, base.cart_coords + 0.05 * rng.standard_normal((32, 3)),
                     base.atomic_numbers)
    g = graph_from_structure(cell, 5.0, 4.0)
    g = g.replace(energy=np.array([-110.0], np.float32),
                  forces=(0.1 * rng.standard_normal((32, 3))).astype(np.float32),
                  stress=np.zeros((1, 6), np.float32))
    settings = dict(embedding_dim=8, num_blocks=2)
    return launch.run("tests._torch_parallel_ranks:gp_launches", 2, settings,
                      ("factorized", "fused", "gather"), partition_graph(g, 2), timeout_s=300)


@pytest.mark.parametrize("mode", ["factorized", "fused", "gather"])
def test_gp_launches_per_rank_match_chip_smoke(gp_launches, mode):
    """Each rank of a 2-shard graph: one gp eval launches one eval's
    kernels, one gp train step one train step's (chip_smoke.py phase 11
    asserts the eval's on the card)."""
    for rank in gp_launches:
        assert rank[mode]["eval"] == chip_smoke.expected_launches(mode, 2, False)
        assert rank[mode]["train"] == chip_smoke.expected_launches(mode, 2, True)
