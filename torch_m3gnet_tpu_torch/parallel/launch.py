"""Run a function of the port on S spawned ranks: ``run``.

Each rank is a fresh interpreter (``multiprocessing``'s ``spawn``) that
joins one process group through a ``FileStore`` in a temporary directory
(no port to find), with one CPU thread, runs the named function and
writes what it returns for the caller. The caller gets every rank's
return value, or an error naming the rank that failed (with its
traceback) or the ranks still running at the job's timeout; every rank is
stopped either way.

The function is named by ``"module:function"`` and imported in the rank:
nothing of the caller's module is pickled, so a rank imports only what the
named module does (a test module that imports JAX never reaches a rank).
torchrun (``python -m torch.distributed.run --nproc-per-node N``) is the
other way to start ranks; the port's entry points take either.
"""

from __future__ import annotations

import datetime
import importlib
import multiprocessing
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Optional

_POLL_S = 0.05  # how often run() looks at the ranks' exit codes


def _rank_main(target: str, rank: int, world: int, store: str, backend: str,
               timeout_s: float, args: tuple, out_dir: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        module, name = target.split(":")
        out = getattr(importlib.import_module(module), name)(*args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run(target: str, world_size: int, *args, backend: str = "gloo",
        timeout_s: float = 600.0) -> list[Any]:
    """Run ``target`` (``"module:function"``) with ``args`` on
    ``world_size`` ranks of one ``backend`` process group; returns each
    rank's return value in rank order.

    Raises ``RuntimeError`` with every failed rank's traceback when a rank
    exits with an error (every other rank is then stopped; a rank waiting
    in a collective on the failed one may fail first) and ``TimeoutError``
    when the job outlasts ``timeout_s``. The arguments and return values cross processes by
    pickle: plain data (numpy arrays, dicts, paths).
    """
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="m3g_ranks_") as tmp:
        procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                             args=(target, r, world_size, os.path.join(tmp, "store"),
                                   backend, timeout_s, args, tmp))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        failed: Optional[str] = None
        try:
            while True:
                codes = [p.exitcode for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    failed = f"ranks {bad} exited with codes {[codes[r] for r in bad]}"
                    break
                if None not in codes:
                    break
                if time.monotonic() > deadline:
                    running = [r for r, c in enumerate(codes) if c is None]
                    raise TimeoutError(f"{target} on {world_size} ranks: ranks {running} "
                                       f"still running after {timeout_s} s")
                time.sleep(_POLL_S)
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.kill()
                p.join()
        if failed:
            errs = [os.path.join(tmp, f"rank{r}.err") for r in range(world_size)]
            detail = "".join(open(e).read() for e in errs if os.path.exists(e))
            raise RuntimeError(f"{target} on {world_size} ranks: {failed}\n{detail}")
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out

