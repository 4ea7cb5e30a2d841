"""Device meshes over the ranks of a process group.

Counterpart of ``torch_m3gnet_tpu.parallel.mesh``: where JAX builds a
``jax.sharding.Mesh`` over the devices of one process, the port runs one
process per rank (``torchrun``, or ``parallel.launch``) and names the
dimensions of a ``torch.distributed.device_mesh.DeviceMesh`` over them:
``("dp",)``, ``("gp",)`` or ``("dp", "gp")``. Each rank computes on its own
card, ``cuda:LOCAL_RANK``. There is no fallback to the CPU: too few ranks
or cards raise. Several ranks share one card only where the caller names
it (``device="cuda:0"``).

Under NCCL a rank is bound to its card before its process group starts
(:func:`bind_device`, which ``parallel.distributed.initialize`` and
``parallel.launch`` call and whose card they pass to
``init_process_group`` as ``device_id``): every collective, a barrier
too, then runs on that card, never on ``cuda:0`` by default. ``make_mesh``
agrees with the bound card or raises.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def bind_device(device, local_rank: int) -> torch.device:
    """Make this rank's card the current device and return it: ``device``
    where it names one with an index (``"cuda:0"``: every rank on that
    card), else ``cuda:local_rank``. A card that the host does not have
    raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise ValueError(f"a rank binds a CUDA device, not {device}")
    if device.index is None:
        device = torch.device("cuda", local_rank)
    have = torch.cuda.device_count()
    if device.index >= have:
        raise ValueError(f"this rank's card {device} is not there: the host has {have} CUDA "
                         "devices")
    torch.cuda.set_device(device)
    return device


def _bound_device() -> Optional[torch.device]:
    """The card the default process group was started on (``device_id``),
    or None."""
    return getattr(dist.group.WORLD, "bound_device_id", None)


def make_mesh(
    n_devices: Union[int, Sequence[int], None] = None,
    axis_name: Union[str, Sequence[str]] = "dp",
    platform: Optional[str] = None,
    device=None,
) -> DeviceMesh:
    """A mesh over the ranks of the default process group
    (``parallel.distributed.initialize`` starts it).

    Args:
        n_devices: the mesh's shape, an int or one int per name in
            ``axis_name`` (default: every rank on one axis); it must hold
            every rank of the group.
        platform: ``"cuda"`` (default) or ``"cpu"``.
        device: on ``"cuda"``, the card of this rank; default
            ``cuda:LOCAL_RANK``, which needs a card for each rank of the
            host. Naming one (``"cuda:0"``) lets several ranks share it.
            A process group bound to another card (``device_id``) raises:
            the rank is never moved.
    """
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.distributed.initialize "
                           "(or run under torchrun) before make_mesh")
    world = dist.get_world_size()
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    shape = ((world,) if n_devices is None
             else (n_devices,) if isinstance(n_devices, int) else tuple(n_devices))
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} does not match its names {names}")
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of {shape} needs {math.prod(shape)} ranks, "
                         f"the process group has {world}")
    platform = platform or "cuda"
    if platform == "cuda":
        if device is None:
            local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
            per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
            if torch.cuda.device_count() < per_host:
                raise ValueError(
                    f"{per_host} ranks on this host need {per_host} CUDA devices, it has "
                    f"{torch.cuda.device_count()}; name the device to share one card")
            device = torch.device("cuda", local)
        device, bound = torch.device(device), _bound_device()
        if bound is not None and bound != device:
            raise ValueError(f"this rank's process group is bound to {bound}; the mesh asks "
                             f"for {device}")
        torch.cuda.set_device(device)
    elif platform != "cpu":
        raise ValueError(f"unknown platform {platform!r}")
    return DeviceMesh(platform, torch.arange(world).reshape(shape), mesh_dim_names=names)


def local_device(mesh: DeviceMesh) -> torch.device:
    """The device that this rank computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
