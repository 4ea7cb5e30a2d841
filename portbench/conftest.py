"""Settings of the benchmark's own tests: ``python -m pytest portbench -q``
from the root of the repository. Tests marked ``card`` need a CUDA device;
they decide so in their body and skip on the CPU."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


def tiny(ctx, spec):
    """A cell cut to a size the CPU runs in seconds: width 16, three small
    structures a batch, three batches, MD on a 108-atom cell."""
    ctx.config["embedding_dim"] = 16
    t = ctx.traffic
    if t["kind"] in ("screen", "train"):
        t.update(recipe=[["Cu", 2, 2, 2], ["NaCl", 1, 1, 2], ["Mg", 3, 3, 2]], repeat=1, pool=3,
                 pad_multiple=64, traced=2, checked=2, followed=2)
    else:
        t.update(reps=[3, 3, 3], rebuild_every=3, pad_multiple=64)


@pytest.fixture
def tiny_patch():
    return tiny


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
