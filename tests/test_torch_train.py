"""The port's training loss and its weight gradients against the JAX
package's, with the same weights.

Weights come from the JAX model's Flax tree through ``params_from_flax``;
the batch is the JAX package's own ``pack_structures`` output with seeded
E/F/S targets, so both sides see identical inputs. The gradient of the
force and stress terms is a gradient of a gradient through the whole model:
on the port's side through every kernel Function's VJP of a VJP (their
plain versions on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_m3gnet_tpu.config import M3GNetConfig as JaxConfig
from torch_m3gnet_tpu.data.graph import pack_structures as jax_pack
from torch_m3gnet_tpu.data.structure import Structure as JaxStructure
from torch_m3gnet_tpu.models import build_model as jax_build_model
from torch_m3gnet_tpu.train.loop import loss_and_metrics as jax_loss_and_metrics
from torch_m3gnet_tpu_torch.config import M3GNetConfig
from torch_m3gnet_tpu_torch.models import build_model, params_from_flax
from torch_m3gnet_tpu_torch.train import loss_and_metrics

jax.config.update("jax_enable_x64", True)

SMALL = dict(embedding_dim=16, num_blocks=2)
METRICS = ("loss", "energy_loss", "forces_loss", "stresses_loss", "energy_rmse",
           "forces_rmse", "stresses_rmse", "energy_mae", "forces_mae", "stresses_mae")


def perturbed(s, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return JaxStructure(
        s.lattice, s.cart_coords + scale * rng.standard_normal(s.cart_coords.shape),
        s.atomic_numbers,
    )


def target_batch(structs, dtype, seed=0):
    """JAX-packed batch (one padded graph) with seeded E/F/S targets, zero
    on padding."""
    batch = jax_pack([perturbed(s, i) for i, s in enumerate(structs)], 5.0, 4.0,
                     max_graphs=len(structs) + 1, pad_multiple=64, dtype=dtype)
    rng = np.random.default_rng(seed)
    gm = np.asarray(batch.graph_mask, dtype=dtype)
    nm = np.asarray(batch.node_mask, dtype=dtype)
    n_node = np.asarray(batch.n_node)
    return batch.replace(
        energy=((-3.0 + 0.2 * rng.standard_normal(gm.size)) * n_node * gm).astype(dtype),
        forces=(0.3 * rng.standard_normal((nm.size, 3)) * nm[:, None]).astype(dtype),
        stress=(0.02 * rng.standard_normal((gm.size, 6)) * gm[:, None]).astype(dtype),
    )


def jax_and_port(batch, jax_mode, port_mode, dtype, **cfg_kw):
    """(JAX potential, f32 or f64 params, JAX config, port potential, port
    config) with the same weights."""
    jcfg = JaxConfig(**jax_mode, **SMALL, **cfg_kw)
    jpot = jax_build_model(jcfg)
    params = jpot.init(jax.random.PRNGKey(0), batch)
    if dtype == torch.float64:
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
    cfg = M3GNetConfig(**port_mode, **SMALL, **cfg_kw)
    pot = build_model(cfg, device="cpu").to(dtype)
    pot.model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), dtype=dtype))
    return jpot, params, jcfg, pot, cfg


def jax_loss_grads(jpot, params, batch, jcfg):
    (_, metrics), grads = jax.value_and_grad(
        lambda p: jax_loss_and_metrics(jpot, p, batch, jcfg), has_aux=True)(params)
    return ({k: float(v) for k, v in metrics.items()},
            {f"model.{k}": v.numpy() for k, v in params_from_flax(
                jax.tree.map(np.asarray, grads)).items()})


def port_loss_grads(pot, batch, cfg):
    loss, metrics = loss_and_metrics(pot, batch, cfg)
    names, params = zip(*pot.named_parameters())
    grads = torch.autograd.grad(loss, params)
    return ({k: float(v.detach()) for k, v in metrics.items()},
            {n: g.numpy() for n, g in zip(names, grads)})


@pytest.mark.parametrize(
    "jax_mode, port_mode",
    [(dict(threebody_mode="factorized", layout="fm"), dict(threebody_mode="factorized")),
     (dict(threebody_mode="gather"), dict(threebody_mode="gather"))],
    ids=["factorized", "gather"],
)
def test_loss_and_gradients_match_jax_f64(al_fcc, tio2_rutile, jax_mode, port_mode):
    """f64: the ten metrics and every weight gradient, rtol 1e-8 (the two
    stacks differ in summation order only; atol 1e-12 of each gradient's
    largest magnitude for entries that cancel to ~0)."""
    batch = target_batch([al_fcc, tio2_rutile], np.float64)
    jpot, params, jcfg, pot, cfg = jax_and_port(batch, jax_mode, port_mode, torch.float64)
    want_m, want_g = jax_loss_grads(jpot, params, batch, jcfg)
    got_m, got_g = port_loss_grads(pot, batch, cfg)
    assert set(got_m) == set(METRICS) == set(want_m)
    for k in METRICS:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-8, err_msg=k)
    assert set(got_g) == set(want_g)
    for name, w in want_g.items():
        assert got_g[name].dtype == np.float64
        np.testing.assert_allclose(got_g[name], w, rtol=1e-8,
                                   atol=1e-12 * max(np.abs(w).max(), 1e-30), err_msg=name)
    # the loss's force and stress terms are not trivially zero
    assert got_m["forces_loss"] > 0 and got_m["stresses_loss"] > 0


def test_loss_and_gradients_match_jax_fused_f32(al_fcc, na_bcc):
    """Fused mode, f32, against JAX's fused mode with its Pallas kernels in
    TPU interpret mode (also under their double differentiation): each
    metric and gradient within 2e-5 of its largest magnitude, as the fused
    E/F/S test in test_torch_model.py."""
    from jax.experimental.pallas import tpu as pltpu

    batch = target_batch([al_fcc, na_bcc], np.float32)
    with pltpu.force_tpu_interpret_mode():
        jpot, params, jcfg, pot, cfg = jax_and_port(
            batch, dict(threebody_mode="fused"), dict(threebody_mode="fused"), torch.float32)
        want_m, want_g = jax_loss_grads(jpot, params, batch, jcfg)
    got_m, got_g = port_loss_grads(pot, batch, cfg)
    for k in METRICS:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=2e-5, err_msg=k)
    for name, w in want_g.items():
        g = got_g[name]
        assert g.dtype == np.float32 and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-5 * np.abs(w).max(), err_msg=name)


def test_pallas_segment_is_checked_and_ignored(al_fcc):
    """Every accepted ``pallas_segment`` value builds the same potential (the
    sorted sums always go through the sorted-segment op); an unknown value
    raises."""
    batch = target_batch([al_fcc], np.float32)
    outs = {}
    for ps in ("auto", "off", "on"):
        pot = build_model(M3GNetConfig(pallas_segment=ps, **SMALL), device="cpu",
                          generator=torch.Generator().manual_seed(2))
        outs[ps] = pot(batch)
    for ps in ("off", "on"):
        for name in ("energy", "forces", "stress", "atomic_energy"):
            assert torch.equal(getattr(outs[ps], name), getattr(outs["auto"], name)), (ps, name)
    with pytest.raises(ValueError, match="unknown pallas_segment"):
        build_model(M3GNetConfig(pallas_segment="yes", **SMALL), device="cpu")
