"""Each rank's card is bound before its process group starts, on the CPU
with ``torch.distributed.init_process_group`` and ``torch.cuda`` stubbed:
``parallel.distributed.initialize`` and ``parallel.launch`` bind
``cuda:LOCAL_RANK`` (or the one card named for every rank) and pass it as
``device_id`` under NCCL, gloo binds nothing, ``make_mesh`` raises where the
bound card is not the one it would use, and the training CLI under
torchrun's variables binds before its first barrier. Each test records the
order of the calls.
"""

import os

import pytest
import torch
import torch.distributed as dist
from torch.distributed import distributed_c10d as c10d

from torch_m3gnet_tpu_torch.cli import train_mlearn
from torch_m3gnet_tpu_torch.parallel import distributed, launch, mesh

CARDS = 4


@pytest.fixture
def calls(monkeypatch):
    """The calls in order; ``init_process_group`` and ``set_device``
    recorded, ``CARDS`` cards on the host."""
    record = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: CARDS)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: record.append(("set_device", torch.device(d))))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: record.append(("init", backend,
                                                             kw.get("device_id"))))
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "6")
    monkeypatch.setenv("LOCAL_RANK", "2")
    return record


def test_initialize_binds_local_rank_before_the_group(calls):
    distributed.initialize(platform="cuda")
    card = torch.device("cuda", 2)
    assert calls == [("set_device", card), ("init", "nccl", card)]


def test_initialize_binds_the_card_named_for_every_rank(calls):
    distributed.initialize(device="cuda:0")
    card = torch.device("cuda", 0)
    assert calls == [("set_device", card), ("init", "nccl", card)]


def test_initialize_without_local_rank_binds_the_rank(calls, monkeypatch):
    monkeypatch.delenv("LOCAL_RANK")
    monkeypatch.setenv("RANK", "3")
    distributed.initialize()
    assert calls == [("set_device", torch.device("cuda", 3)),
                     ("init", "nccl", torch.device("cuda", 3))]


def test_initialize_raises_for_a_card_that_is_not_there(calls, monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", str(CARDS))
    with pytest.raises(ValueError, match="is not there"):
        distributed.initialize()
    assert calls == []


@pytest.mark.parametrize("kw", [dict(platform="cpu"), dict(backend="gloo"),
                                dict(backend="gloo", device="cuda:0")])
def test_initialize_over_gloo_binds_nothing(calls, kw):
    distributed.initialize(**kw)
    assert calls == [("init", "gloo", None)]


@pytest.mark.parametrize("backend,want", [("nccl", torch.device("cuda", 2)), ("gloo", None)])
def test_launch_rank_binds_its_card_under_nccl(calls, monkeypatch, tmp_path, backend, want):
    """``launch._rank_main`` of rank 2: under NCCL ``cuda:2`` is bound and
    passed before the group starts; under gloo nothing is."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.setenv(k, os.environ.get(k, "0"))  # restored after the test
    threads = torch.get_num_threads()
    try:
        launch._rank_main("tests._torch_parallel_ranks:sleep", 2, 4, str(tmp_path / "store"),
                          backend, 60.0, (0.0,), str(tmp_path))
    finally:
        torch.set_num_threads(threads)
    assert calls == ([("set_device", want)] if want else []) + [("init", backend, want)]
    assert (tmp_path / "rank2.pkl").exists()


@pytest.fixture
def group(tmp_path, monkeypatch):
    """A real one-rank gloo group, its bound card set as NCCL's
    ``device_id`` would set it; ``DeviceMesh`` stubbed (no card here)."""
    c10d.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    made = []
    monkeypatch.setattr(mesh, "DeviceMesh", lambda *a, **kw: made.append((a, kw)) or "mesh")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    try:
        yield made
    finally:
        dist.group.WORLD.bound_device_id = None
        dist.destroy_process_group()


def test_make_mesh_raises_when_the_bound_card_disagrees(calls, group):
    dist.group.WORLD.bound_device_id = torch.device("cuda", 1)
    with pytest.raises(ValueError, match="bound to cuda:1; the mesh asks for cuda:0"):
        mesh.make_mesh(None, "dp", "cuda")
    with pytest.raises(ValueError, match="bound to cuda:1"):
        mesh.make_mesh(None, "dp", "cuda", device="cuda:0")
    assert calls == [] and group == []


def test_make_mesh_agrees_with_the_bound_card(calls, group):
    dist.group.WORLD.bound_device_id = torch.device("cuda", 0)
    assert mesh.make_mesh(None, "dp", "cuda") == "mesh"
    assert calls == [("set_device", torch.device("cuda", 0))] and len(group) == 1


def test_train_mlearn_binds_before_its_first_barrier(calls, monkeypatch, tmp_path):
    """``train_mlearn --mesh 4`` on rank 6 (local rank 2) under torchrun's
    variables: the card is bound and passed to the process group before
    the barrier that rank waits in for rank 0's cache (the run stops
    there)."""
    started = []
    monkeypatch.setattr(dist, "is_initialized", lambda: bool(started))
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 6)
    recorded = dist.init_process_group

    def init(backend, **kw):
        recorded(backend, **kw)
        started.append(True)

    monkeypatch.setattr(dist, "init_process_group", init)

    class Stop(Exception):
        pass

    def barrier(*args, **kw):
        calls.append(("barrier",))
        raise Stop

    monkeypatch.setattr(dist, "barrier", barrier)
    with pytest.raises(Stop):
        train_mlearn.main(["--mesh", "4", "--path", str(tmp_path / "none"),
                           "--root", str(tmp_path / "run")])
    card = torch.device("cuda", 2)
    assert calls == [("set_device", card), ("init", "nccl", card), ("barrier",)]
