"""Peak device memory of the port's ``torch.func`` passes on one NVIDIA GPU:
where a committee's and a batched Hessian's memory goes.

    python3 tools/func_memory.py

With the default model (seeded weights, f32) it reads, each after one warm
call, the peak allocated above what was allocated before the call and the
call's time (host clock to a synchronise):

- on the 32-cell bench batch (``chip_smoke.build_batch``): one eager
  evaluation; the potential's functional pass (``functional=True``, the
  forces by ``torch.func.vjp``) with ``create_graph`` False and True; the
  same pass ``torch.func.vmap``-ped over K = 1 and K = 3 stacked weight
  sets (seeds 0-2), with ``create_graph`` False and True; and the forces by
  ``torch.func.grad`` of the energy under the same vmap (the form the
  committee took before, which keeps its graph);
- on a perturbed 4-atom fcc-Cu cell and its 3x3x3 and 5x5x5 supercells:
  ``simulate.elastic._hessian`` of the force constants over the first 2,
  8 and 16 rows in one pass, with the VJP's ``create_graph`` False (as
  ``_hessian`` runs it) and True (torch's default with grad mode on), as
  GB a row and floats a row for each padded edge, feature unit and block
  (``simulate.elastic.HESSIAN_ROW_FLOATS``).

Prints one JSON line per reading, then the card's ``nvidia-smi`` name and
power limit. Exits non-zero without a GPU.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def peak(fn) -> dict:
    """Peak GB allocated above the baseline during ``fn()``, and its ms
    (host clock to a synchronise), after one warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return {"peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9, "ms": ms}


def committee(cfg, gbatch) -> None:
    import torch
    from torch.func import functional_call, vmap

    from torch_m3gnet_tpu_torch.models import build_model, stack_params
    from torch_m3gnet_tpu_torch.models.m3gnet import edge_vectors_fm

    pots = [build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(s))
            for s in range(3)]
    stacked = stack_params([p.state_dict() for p in pots])
    pot = pots[0]

    def vmapped(k, create_graph):
        def member(params):
            out = functional_call(pot, params, (gbatch,),
                                  {"functional": True, "create_graph": create_graph})
            return out.energy, out.forces, out.stress
        return lambda: vmap(member)({n: v[:k] for n, v in stacked.items()})

    def by_grad(params):
        """The committee's member before: forces by torch.func.grad."""
        r_fm = edge_vectors_fm(gbatch, gbatch.positions, gbatch.lattice)

        def total_energy(r):
            energy, atomic = functional_call(pot.model, params_model(params), (gbatch, r),
                                             {"remat": False})
            return energy.sum(), (energy, atomic)

        g_fm, (energy, atomic) = torch.func.grad(total_energy, has_aux=True)(r_fm)
        out = pot.assemble(gbatch, r_fm, g_fm, energy, atomic)
        return out.energy, out.forces, out.stress

    def params_model(params):
        return {k[len("model."):]: v for k, v in params.items() if k.startswith("model.")}

    readings = {
        "eager": lambda: pot(gbatch),
        "functional_vjp": lambda: pot(gbatch, functional=True),
        "functional_vjp_create_graph": lambda: pot(gbatch, functional=True, create_graph=True),
        "vmap_k1": vmapped(1, False),
        "vmap_k1_create_graph": vmapped(1, True),
        "vmap_k3": vmapped(3, False),
        "vmap_k3_create_graph": vmapped(3, True),
        "vmap_k3_func_grad": lambda: vmap(by_grad)(stacked),
    }
    for label, fn in readings.items():
        print(json.dumps({"committee": label, **peak(fn)}), flush=True)


def hessian(cfg) -> None:
    import torch

    import chip_smoke
    from torch_m3gnet_tpu_torch.data import pack_structures
    from torch_m3gnet_tpu_torch.models import build_model
    from torch_m3gnet_tpu_torch.simulate import elastic

    pot = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    kernel = pot.model.edge_init.kernel
    for reps in ((1, 1, 1), (3, 3, 3), (5, 5, 5)):
        cell = chip_smoke.elastic_cell().supercell(reps)
        batch = pack_structures([cell], 5.0, 4.0, pad_multiple=64)
        graph, energy = elastic._energy_fn(pot, batch)
        x = graph.positions.detach()
        _, grad_vjp = torch.func.vjp(torch.func.grad(lambda p: energy(p, graph.lattice)), x)
        for create_graph in (False, True):
            for rows in (2, 8, 16):
                eye = torch.eye(rows, x.numel(), device=x.device).reshape(rows, *x.shape)
                got = peak(lambda: torch.func.vmap(
                    lambda v: grad_vjp(v, create_graph=create_graph))(eye))
                per_row = got["peak_gb"] * 1e9 / rows
                print(json.dumps({
                    "hessian_atoms": len(cell), "edges": batch.num_edges, "rows": rows,
                    "create_graph": create_graph, **got, "gb_a_row": per_row / 1e9,
                    "floats_a_row": per_row / (batch.num_edges * kernel.shape[-1]
                                               * pot.model.num_blocks * kernel.element_size()),
                }), flush=True)
        del graph, energy, grad_vjp


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("func_memory: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke
    from torch_m3gnet_tpu_torch.config import M3GNetConfig
    from torch_m3gnet_tpu_torch.data import to_torch

    cfg = M3GNetConfig()
    committee(cfg, to_torch(chip_smoke.build_batch(), "cuda", torch.float32))
    torch.cuda.empty_cache()
    hessian(cfg)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
