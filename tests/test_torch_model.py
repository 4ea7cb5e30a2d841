"""The PyTorch port's model against the JAX package, with the same weights.

Weights come from the JAX model's Flax tree through
``torch_m3gnet_tpu_torch.models.params_from_flax``; the batches are the JAX
package's own ``pack_structures`` output, so both sides see identical
inputs. The JAX side runs on the CPU: its factorized feature-major path
(XLA segment ops), its gather mode (XLA take/segment_sum) and its fused mode
(the Pallas kernels in TPU interpret mode, as the JAX tests run them); the
port runs the plain versions of its kernels.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from torch_m3gnet_tpu.config import M3GNetConfig as JaxConfig
from torch_m3gnet_tpu.data.graph import pack_structures as jax_pack
from torch_m3gnet_tpu.data.structure import Structure as JaxStructure
from torch_m3gnet_tpu.models import build_model as jax_build_model
from torch_m3gnet_tpu_torch.config import M3GNetConfig
from torch_m3gnet_tpu_torch.models import build_model, params_from_flax

jax.config.update("jax_enable_x64", True)

SMALL = dict(embedding_dim=16, num_blocks=2)
FIELDS = ("energy", "forces", "stress", "energy_per_atom", "atomic_energy")


def _perturbed(s, seed, scale=0.05):
    """Off-lattice copy: a perfect crystal has zero forces by symmetry."""
    rng = np.random.default_rng(seed)
    return JaxStructure(
        s.lattice, s.cart_coords + scale * rng.standard_normal(s.cart_coords.shape),
        s.atomic_numbers,
    )


FACTORIZED = dict(threebody_mode="factorized", layout="fm")


@pytest.fixture
def interpret():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _both(kw, batch, stress_mode, dtype, jax_mode=FACTORIZED, port_mode=None):
    """(JAX output, port output) for one config and batch, same weights.
    ``jax_mode``/``port_mode``: the three-body settings of each side (the
    port takes the JAX side's unless given)."""
    jpot = jax_build_model(JaxConfig(**jax_mode, **kw), stress_mode=stress_mode)
    params = jpot.init(jax.random.PRNGKey(0), batch)
    want = jpot.apply(params, batch)

    cfg = M3GNetConfig(**(jax_mode if port_mode is None else port_mode), **kw)
    pot = build_model(cfg, stress_mode=stress_mode, device="cpu").to(dtype)
    pot.model.load_state_dict(
        params_from_flax(jax.tree.map(np.asarray, params), dtype=dtype)
    )
    got = pot(batch)
    n_jax = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(params))
    return want, got, n_jax, pot


@pytest.mark.parametrize("stress_mode", ["strain", "virial"])
@pytest.mark.parametrize("pair", [("al_fcc", "na_bcc"), ("tio2_rutile", "al_fcc")])
def test_efs_match_jax_f64(request, pair, stress_mode):
    """f64, small width: the two stacks differ only in summation order, so
    everything agrees to rtol 1e-9 (atol 1e-12 for components near 0)."""
    structs = [_perturbed(request.getfixturevalue(n), seed=i) for i, n in enumerate(pair)]
    batch = jax_pack(structs, 5.0, 4.0, pad_multiple=64, dtype=np.float64)
    want, got, _, _ = _both(SMALL, batch, stress_mode, torch.float64)
    for name in FIELDS:
        g = getattr(got, name).detach().numpy()
        assert g.dtype == np.float64
        np.testing.assert_allclose(
            g, np.asarray(getattr(want, name)), rtol=1e-9, atol=1e-12, err_msg=name
        )


def test_efs_match_jax_f32_full_width(al_fcc, na_bcc):
    """f32 at the default width (227,549 parameters). The JAX side fuses the
    twin MLP matmuls and sums in other orders than torch's CPU kernels;
    through three blocks and the backward pass that leaves f32 rounding of
    a few 1e-6 relative. Tolerances: 2e-5 of each quantity's largest
    magnitude (test_pallas_factorized.py uses 2e-5 for the same paths)."""
    batch = jax_pack(
        [_perturbed(al_fcc, 0), _perturbed(na_bcc, 1)], 5.0, 4.0, pad_multiple=64
    )
    want, got, n_jax, pot = _both({}, batch, "strain", torch.float32)
    assert n_jax == 227_549
    assert sum(p.numel() for p in pot.parameters()) == n_jax
    for name in FIELDS:
        g = getattr(got, name).detach().numpy()
        w = np.asarray(getattr(want, name))
        assert g.dtype == np.float32 and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-5 * np.abs(w).max(), err_msg=name)


def test_default_param_count():
    pot = build_model(M3GNetConfig(), device="cpu")
    assert sum(p.numel() for p in pot.parameters()) == 227_549


def test_build_model_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: build_model() would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(M3GNetConfig())


def _assert_close_to_max(got, want, rel):
    """Each field within ``rel`` of its largest magnitude."""
    for name in FIELDS:
        g = getattr(got, name).detach().numpy()
        w = np.asarray(getattr(want, name))
        assert g.dtype == np.float32 and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * np.abs(w).max(), err_msg=name)


def test_fused_matches_jax_fused_f32(interpret, al_fcc, tio2_rutile):
    """Fused mode, f32, small width, against JAX's fused mode (its Pallas
    kernels in interpret mode): the same per-triplet stage, sums in other
    orders: 2e-5 of each field's largest magnitude."""
    batch = jax_pack([_perturbed(al_fcc, 0), _perturbed(tio2_rutile, 1)], 5.0, 4.0,
                     pad_multiple=64)
    want, got, _, pot = _both(SMALL, batch, "strain", torch.float32,
                              jax_mode=dict(fused_triplets="on"))
    assert pot.model.threebody_mode == "fused"
    _assert_close_to_max(got, want, 2e-5)


@pytest.mark.parametrize("pair", [("al_fcc", "na_bcc"), ("tio2_rutile", "al_fcc")])
def test_gather_matches_jax_gather_f64(request, pair):
    """Gather mode at f64 against JAX's gather mode at f64 (JAX's fused mode
    casts its stage to f32 even in f64, so f64 parity is held against
    gather): summation order only, rtol 1e-9 (atol 1e-12 near 0)."""
    structs = [_perturbed(request.getfixturevalue(n), seed=i) for i, n in enumerate(pair)]
    batch = jax_pack(structs, 5.0, 4.0, pad_multiple=64, dtype=np.float64)
    want, got, _, pot = _both(SMALL, batch, "strain", torch.float64,
                              jax_mode=dict(threebody_mode="gather"))
    assert pot.model.threebody_mode == "gather"
    for name in FIELDS:
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-9, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("stress_mode", ["strain", "virial"])
def test_triplet_modes_match_factorized_f64(al_fcc, tio2_rutile, stress_mode):
    """Inside the port, same weights: the fused and gather modes compute the
    factorized mode's function (the factorized stage only subtracts the
    analytic j = k diagonal), to rtol 1e-9 at f64 (atol 1e-12 near 0)."""
    batch = jax_pack([_perturbed(al_fcc, 0), _perturbed(tio2_rutile, 1)], 5.0, 4.0,
                     pad_multiple=64, dtype=np.float64)
    gen = torch.Generator()
    pots = {
        mode: build_model(M3GNetConfig(threebody_mode=mode, **SMALL), stress_mode=stress_mode,
                          device="cpu", generator=gen.manual_seed(2)).double()
        for mode in ("factorized", "fused", "gather")
    }
    outs = {mode: pot(batch) for mode, pot in pots.items()}
    for mode in ("fused", "gather"):
        for name in FIELDS:
            np.testing.assert_allclose(getattr(outs[mode], name).detach().numpy(),
                                       getattr(outs["factorized"], name).detach().numpy(),
                                       rtol=1e-9, atol=1e-12, err_msg=f"{mode} {name}")


def test_fused_matches_jax_fused_f32_full_width(interpret, al_fcc, na_bcc):
    """Fused mode at the default width (227,549 parameters), f32, against
    JAX's fused mode: 2e-5 of each field's largest magnitude, as the
    factorized full-width test."""
    batch = jax_pack([_perturbed(al_fcc, 0), _perturbed(na_bcc, 1)], 5.0, 4.0, pad_multiple=64)
    want, got, n_jax, pot = _both({}, batch, "strain", torch.float32,
                                  jax_mode=dict(threebody_mode="fused"))
    assert n_jax == 227_549 and pot.model.threebody_mode == "fused"
    _assert_close_to_max(got, want, 2e-5)


@pytest.mark.parametrize(
    "kw, mode",
    [
        (dict(threebody_mode="gather"), "gather"),
        (dict(threebody_mode="fused"), "fused"),
        (dict(fused_triplets="on"), "fused"),
        (dict(fused_triplets="off"), "gather"),
    ],
    ids=["gather", "fused", "legacy-fused", "legacy-gather"],
)
def test_triplet_modes_resolve_and_evaluate(al_fcc, kw, mode):
    """The three-body knobs resolve as the JAX package's build_model does,
    and the resolved mode evaluates E/F/S on the CPU."""
    pot = build_model(M3GNetConfig(**kw, **SMALL), device="cpu")
    assert pot.model.threebody_mode == mode
    batch = jax_pack([_perturbed(al_fcc, 0)], 5.0, 4.0, pad_multiple=64)
    out = pot(batch)
    assert tuple(out.forces.shape) == (batch.num_nodes, 3)
    assert tuple(out.stress.shape) == (batch.num_graphs, 6)
    for name in FIELDS:
        assert torch.isfinite(getattr(out, name)).all(), name


@pytest.mark.parametrize("mode", ["factorized", "gather", "fused"])
def test_each_mode_builds_only_its_batch_index(al_fcc, monkeypatch, mode):
    """A host batch through the potential gets only the parts of the
    kernel index that its mode reads: the e2 order (a device sort of every
    triplet) in the fused mode alone, in one build for the whole forward
    and backward; the triplet_e1 offsets in the gather and fused modes."""
    from torch_m3gnet_tpu_torch.data import graph
    from torch_m3gnet_tpu_torch.ops import fused_triplet, sorted_segment

    calls = {"e2_order": 0, "offsets": []}
    e2_order, offsets = fused_triplet.triplet_e2_order, sorted_segment.sorted_segment_offsets

    def count_e2_order(*args):
        calls["e2_order"] += 1
        return e2_order(*args)

    def count_offsets(seg, n):
        calls["offsets"].append(n)
        return offsets(seg, n)

    monkeypatch.setattr(fused_triplet, "triplet_e2_order", count_e2_order)
    monkeypatch.setattr(sorted_segment, "sorted_segment_offsets", count_offsets)
    pot = build_model(M3GNetConfig(threebody_mode=mode, **SMALL), device="cpu")
    batch = jax_pack([_perturbed(al_fcc, 0)], 5.0, 4.0, pad_multiple=64)
    pot(batch).forces.sum()
    want = {"factorized": ("edge_src_offsets",),
            "gather": ("edge_src_offsets", "triplet_e1_offsets"),
            "fused": ("edge_src_offsets", "triplet_e1_offsets", "triplet_e2_order",
                      "triplet_e2_offsets")}[mode]
    assert pot.model.batch_index == want
    assert set(want) <= set(graph.BATCH_INDEX_FIELDS)
    assert calls["e2_order"] == (mode == "fused")
    n, e = batch.num_nodes, batch.num_edges
    assert calls["offsets"] == [n] + ([e] if mode in ("gather", "fused") else [])


def test_auto_mode_resolves_to_factorized():
    assert build_model(M3GNetConfig(**SMALL), device="cpu").model.threebody_mode == "factorized"
    for mode in ("gather", "fused"):
        with pytest.raises(ValueError, match="layout='fm' requires"):
            build_model(M3GNetConfig(threebody_mode=mode, layout="fm"), device="cpu")
    with pytest.raises(ValueError, match="unknown threebody_mode"):
        build_model(M3GNetConfig(threebody_mode="pairwise"), device="cpu")


@pytest.mark.parametrize("value, dtype", [("float32", None), (None, None),
                                          ("bfloat16", torch.bfloat16)],
                         ids=["float32", "none", "bfloat16"])
def test_compute_dtype_resolves(value, dtype):
    """``compute_dtype`` as the JAX package reads it: ``"float32"`` and
    ``None`` compute in the weights' dtype, a float type's name in it."""
    pot = build_model(M3GNetConfig(compute_dtype=value, remat_triplets=True, **SMALL),
                      device="cpu")
    assert pot.model.compute_dtype == dtype and pot.model.remat_triplets


@pytest.mark.parametrize("value", ["int8", "bf16"])
def test_unknown_compute_dtype_raises(value):
    with pytest.raises(ValueError, match="unknown compute_dtype"):
        build_model(M3GNetConfig(compute_dtype=value), device="cpu")


def test_seeded_weights_are_reproducible():
    cfg = M3GNetConfig(**SMALL)
    a, b = (
        build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
        for _ in range(2)
    )
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


@pytest.mark.parametrize(
    "path", sorted((Path(__file__).resolve().parent.parent / "configs").glob("*.yaml")),
    ids=lambda p: p.name,
)
def test_configs_load_into_the_port(path):
    """The port's config has the JAX config's fields, so every YAML loads;
    its own field (the architecture) keeps its default there."""
    port, jax_cfg = M3GNetConfig.from_yaml(str(path)).to_dict(), JaxConfig.from_yaml(str(path)).to_dict()
    assert {k: port[k] for k in jax_cfg} == jax_cfg
    assert {k: v for k, v in port.items() if k not in jax_cfg} == {"architecture": "m3gnet"}
