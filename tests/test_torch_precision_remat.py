"""``compute_dtype="bfloat16"`` and ``remat_triplets=True`` in the port
against the JAX package, on the CPU, with the same weights.

Width 16, two blocks, ``l_max = n_max = 3`` (one case at the default
width, 227,549 parameters), on the conftest crystals perturbed, packed by
the JAX package with seeded E/F/S targets; f32 weights from the JAX
model's Flax tree through ``params_from_flax``.

bfloat16. Each port mode is held to the JAX path that runs it under bf16:

- factorized -> JAX's feature-major path with XLA segment ops (its fused
  stage, the TPU default, dies under bf16 at the first force VJP:
  ``_q_bwd`` returns f32 cotangents for the bf16 operands);
- fused -> JAX's fused mode with its kernels' plain references
  (``reference_triplet_gate_sum``, ``reference_take_fm``) in place of the
  Pallas kernels, as JAX's kernel tests hold them: the same rounding
  points, f32 sums (the port's fused kernels are held to the Pallas
  kernels in interpret mode by ``test_torch_model.py``);
- gather -> JAX's gather mode.

The measure is JAX's own bf16-f32 gap, by largest magnitude: each field of
E/F/S, the loss, and the gradient of every weight as one vector, within 5 %
of it; a control shows that the casts happen in the port (its own bf16-f32
gap 0.5-2x JAX's). In the gather mode, where no sum is rounded to bf16,
every weight tensor meets the 5 % rule alone too (the worst at 1.6 %). In
the fused mode (an f32 sum rounded to bf16) and the factorized mode (the
stage's output formed in bf16) a sum in another order flips a bf16
rounding here and there, and the three-body weights' gradients, whose gap
is only ~0.1-0.3 % of their size, move by as much as their gap: JAX's own
two factorized paths (XLA segment sums in bf16, and its fused stage's f32
sums as the port runs them) differ there by up to 1.5x those tensors' gap.
The whole gradient agrees to ~3e-4 of its gap in every mode.

Remat. At f64 the port with ``remat_triplets`` equals the port without it
(within 1e-12 of each field's largest magnitude), E/F/S, loss and every
weight gradient (the double backward through the recomputed stage), in
all three modes; against JAX's remat at rtol 1e-9 in the factorized (XLA
segment ops) and gather modes. JAX's fused mode casts its stage to f32
even at f64, and its remat cannot run its Pallas kernels in interpret mode
(ordered IO callbacks in a checkpoint), so the fused remat is held at f32
to JAX's fused mode without remat (through the plain references), 2e-5 of
each quantity's largest magnitude as ``test_torch_model.py``'s fused
comparisons.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_m3gnet_tpu.config import M3GNetConfig as JaxConfig
from torch_m3gnet_tpu.data.graph import pack_structures as jax_pack
from torch_m3gnet_tpu.data.structure import Structure as JaxStructure
from torch_m3gnet_tpu.models import build_model as jax_build_model
from torch_m3gnet_tpu.ops import pallas_fused_triplet, pallas_windowed_take
from torch_m3gnet_tpu.train.loop import loss_and_metrics as jax_loss_and_metrics
from torch_m3gnet_tpu_torch.config import M3GNetConfig
from torch_m3gnet_tpu_torch.models import build_model, params_from_flax
from torch_m3gnet_tpu_torch.train import loss_and_metrics

jax.config.update("jax_enable_x64", True)

SMALL = dict(embedding_dim=16, num_blocks=2, l_max=3, n_max=3)
FIELDS = ("energy", "forces", "stress")
MODES = ("factorized", "fused", "gather")
JAX_MODES = {"factorized": dict(threebody_mode="factorized", layout="fm"),
             "fused": dict(threebody_mode="fused"), "gather": dict(threebody_mode="gather")}
GAP_FRACTION = 0.05
CONTROL = (0.5, 2.0)


def perturbed(s, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return JaxStructure(s.lattice, s.cart_coords + scale * rng.standard_normal(s.cart_coords.shape),
                        s.atomic_numbers)


def target_batch(structs, dtype):
    """JAX-packed batch (one padded graph) with seeded E/F/S targets."""
    batch = jax_pack([perturbed(s, i) for i, s in enumerate(structs)], 5.0, 4.0,
                     max_graphs=len(structs) + 1, pad_multiple=64, dtype=dtype)
    rng = np.random.default_rng(0)
    gm = np.asarray(batch.graph_mask, dtype=dtype)
    nm = np.asarray(batch.node_mask, dtype=dtype)
    return batch.replace(
        energy=((-3.0 + 0.2 * rng.standard_normal(gm.size)) * np.asarray(batch.n_node)
                * gm).astype(dtype),
        forces=(0.3 * rng.standard_normal((nm.size, 3)) * nm[:, None]).astype(dtype),
        stress=(0.02 * rng.standard_normal((gm.size, 6)) * gm[:, None]).astype(dtype),
    )


def flat(grads: dict) -> np.ndarray:
    return np.concatenate([grads[k].ravel() for k in sorted(grads)])


def jax_run(mode, batch, params, grads=True, **kw):
    """JAX's E/F/S (and loss and weight gradients, by port name) of one
    config, jitted (under :func:`plain_references` in the fused mode)."""
    cfg = JaxConfig(**JAX_MODES[mode], **kw)
    pot = jax_build_model(cfg)

    def run(p):
        out = pot.apply(p, batch)
        res = {f: getattr(out, f) for f in FIELDS}
        if grads:
            (res["loss"], _), res["grads"] = jax.value_and_grad(
                lambda q: jax_loss_and_metrics(pot, q, batch, cfg), has_aux=True)(p)
        return res

    res = jax.tree.map(np.asarray, jax.jit(run)(params))
    if grads:
        res["loss"] = float(res["loss"])
        res["grads"] = {f"model.{k}": v.numpy() for k, v in params_from_flax(res["grads"]).items()}
    return res


def port_run(mode, batch, state, dtype, grads=True, **kw):
    """The port's E/F/S (and loss and weight gradients) of one config."""
    cfg = M3GNetConfig(threebody_mode=mode, **kw)
    pot = build_model(cfg, device="cpu").to(dtype)
    pot.model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    out = pot(batch)
    res = {f: getattr(out, f).detach().numpy() for f in FIELDS}
    if grads:
        loss, _ = loss_and_metrics(pot, batch, cfg)
        names, params = zip(*pot.named_parameters())
        res["loss"] = float(loss)
        res["grads"] = {n: g.numpy() for n, g in zip(names, torch.autograd.grad(loss, params))}
    return res


def plain_references(mp) -> None:
    """JAX's fused mode through its kernels' plain references."""
    mp.setattr(pallas_fused_triplet, "fused_triplet_gate_sum",
               pallas_fused_triplet.reference_triplet_gate_sum)
    mp.setattr(pallas_windowed_take, "windowed_take_fm", pallas_windowed_take.reference_take_fm)


def weights(params, dtype=None) -> dict:
    return {k: v.numpy() for k, v in params_from_flax(jax.tree.map(np.asarray, params),
                                                       dtype=dtype).items()}


def crystals():
    """The conftest's ``al_fcc`` and ``na_bcc`` (module scope cannot take
    its function-scoped fixtures)."""
    return (JaxStructure.from_frac_coords(np.eye(3) * 4.05, [[0, 0, 0], [0.5, 0.5, 0],
                                                             [0.5, 0, 0.5], [0, 0.5, 0.5]],
                                          [13] * 4),
            JaxStructure.from_frac_coords(np.eye(3) * 4.29, [[0, 0, 0], [0.5, 0.5, 0.5]],
                                          [11] * 2))


@pytest.fixture(scope="module")
def runs():
    """Every JAX reference (jitted, four at a time in threads) and the
    port's runs beside them."""
    al, na = crystals()
    b32, b64 = target_batch([al, na], np.float32), target_batch([al, na], np.float64)
    wide = jax_pack([perturbed(al, 0), perturbed(na, 1)], 5.0, 4.0, pad_multiple=64)
    params = jax.jit(jax_build_model(JaxConfig(threebody_mode="gather", **SMALL)).init)(
        jax.random.PRNGKey(0), b32)
    params64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
    params_wide = jax.jit(jax_build_model(JaxConfig(threebody_mode="gather")).init)(
        jax.random.PRNGKey(0), wide)
    jobs = {}
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(4) as pool:
        plain_references(mp)
        for mode in MODES:
            for cd in ("float32", "bfloat16"):
                jobs[mode, cd] = pool.submit(jax_run, mode, b32, params, compute_dtype=cd, **SMALL)
        for mode in ("factorized", "gather"):
            jobs[mode, "remat"] = pool.submit(jax_run, mode, b64, params64, remat_triplets=True,
                                              **SMALL)
        for cd in ("float32", "bfloat16"):
            jobs["wide", cd] = pool.submit(jax_run, "factorized", wide, params_wide, grads=False,
                                           compute_dtype=cd)
        state, state64, state_wide = weights(params), weights(params64, torch.float64), weights(
            params_wide)
        port = {}
        for mode in MODES:
            for cd in ("float32", "bfloat16"):
                port[mode, cd] = port_run(mode, b32, state, torch.float32, compute_dtype=cd,
                                          **SMALL)
            for remat in (False, True):
                port[mode, "f64", remat] = port_run(mode, b64, state64, torch.float64,
                                                    remat_triplets=remat, **SMALL)
        port["fused", "f32", True] = port_run("fused", b32, state, torch.float32,
                                              remat_triplets=True, **SMALL)
        for remat in (False, True):
            port["factorized", "bfloat16", remat] = port_run(
                "factorized", b32, state, torch.float32, compute_dtype="bfloat16",
                remat_triplets=remat, **SMALL)
        for cd in ("float32", "bfloat16"):
            port["wide", cd] = port_run("factorized", wide, state_wide, torch.float32, grads=False,
                                        compute_dtype=cd)
        n_wide = sum(v.size for v in state_wide.values())
        jax_out = {k: job.result() for k, job in jobs.items()}
    return dict(jax=jax_out, port=port, n_wide=n_wide)


def assert_within_gap(label, got, want, want_f32, got_f32):
    """``got`` (port, bf16) within GAP_FRACTION of JAX's bf16-f32 gap of
    ``want``, by largest magnitude; the port's own gap CONTROL x JAX's."""
    gap = np.abs(np.asarray(want) - np.asarray(want_f32)).max()
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    own = np.abs(np.asarray(got) - np.asarray(got_f32)).max()
    assert gap > 0, f"{label}: no bf16-f32 gap in JAX"
    assert err <= GAP_FRACTION * gap, f"{label}: {err:.3e} > {GAP_FRACTION} x gap {gap:.3e}"
    assert CONTROL[0] <= own / gap <= CONTROL[1], f"{label}: port gap {own:.3e}, JAX's {gap:.3e}"


@pytest.mark.parametrize("mode", MODES)
def test_bf16_efs_matches_jax(runs, mode):
    """E/F/S under bf16: each field within 5 % of JAX's bf16-f32 gap, in
    the geometry dtype (f32), with the control."""
    j, p = runs["jax"], runs["port"]
    for f in FIELDS:
        assert p[mode, "bfloat16"][f].dtype == np.float32
        assert np.isfinite(p[mode, "bfloat16"][f]).all()
        assert_within_gap(f"{mode} {f}", p[mode, "bfloat16"][f], j[mode, "bfloat16"][f],
                          j[mode, "float32"][f], p[mode, "float32"][f])


@pytest.mark.parametrize("mode", MODES)
def test_bf16_loss_and_gradients_match_jax(runs, mode):
    """The loss and the weight gradients (the double backward through the
    bf16 casts) within 5 % of JAX's bf16-f32 gap; every tensor alone too
    in the gather mode (see the module docstring)."""
    j, p = runs["jax"], runs["port"]
    jb, jf, pb, pf = (x[mode, cd] for x in (j, p) for cd in ("bfloat16", "float32"))
    assert_within_gap(f"{mode} loss", pb["loss"], jb["loss"], jf["loss"], pf["loss"])
    assert set(pb["grads"]) == set(jb["grads"])
    assert all(np.isfinite(g).all() for g in pb["grads"].values())
    assert_within_gap(f"{mode} gradient", flat(pb["grads"]), flat(jb["grads"]),
                      flat(jf["grads"]), flat(pf["grads"]))
    if mode == "gather":
        for name in jb["grads"]:
            assert_within_gap(f"{mode} {name}", pb["grads"][name], jb["grads"][name],
                              jf["grads"][name], pf["grads"][name])


def test_bf16_full_width_factorized(runs):
    """The default width (227,549 parameters), factorized, E/F/S under bf16
    against JAX's feature-major path: 5 % of its gap, with the control."""
    assert runs["n_wide"] == 227_549
    j, p = runs["jax"], runs["port"]
    for f in FIELDS:
        assert_within_gap(f"wide {f}", p["wide", "bfloat16"][f], j["wide", "bfloat16"][f],
                          j["wide", "float32"][f], p["wide", "float32"][f])


def assert_same(label, got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=label)


@pytest.mark.parametrize("mode", MODES)
def test_remat_equals_no_remat_f64(runs, mode):
    """f64: remat changes nothing (within 1e-12 of each quantity's largest
    magnitude): E/F/S, the loss and every weight gradient."""
    got, want = runs["port"][mode, "f64", True], runs["port"][mode, "f64", False]
    for f in FIELDS + ("loss",):
        assert_same(f"{mode} {f}", got[f], want[f], 1e-12)
    for name, w in want["grads"].items():
        assert_same(f"{mode} {name}", got["grads"][name], w, 1e-12)


@pytest.mark.parametrize("mode", ["factorized", "gather"])
def test_remat_matches_jax_remat_f64(runs, mode):
    """f64 against JAX's remat (``jax.checkpoint`` of the same closure):
    E/F/S, the loss and every weight gradient at rtol 1e-9 (atol 1e-12 of
    each gradient's largest magnitude for entries that cancel)."""
    got, want = runs["port"][mode, "f64", True], runs["jax"][mode, "remat"]
    for f in FIELDS:
        np.testing.assert_allclose(got[f], want[f], rtol=1e-9, atol=1e-12, err_msg=f)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-9)
    for name, w in want["grads"].items():
        np.testing.assert_allclose(got["grads"][name], w, rtol=1e-9,
                                   atol=1e-12 * np.abs(w).max(), err_msg=name)


def test_remat_fused_matches_jax_fused_f32(runs):
    """f32, fused with remat against JAX's fused mode without it (see the
    module docstring): 2e-5 of each quantity's largest magnitude."""
    got, want = runs["port"]["fused", "f32", True], runs["jax"]["fused", "float32"]
    for f in FIELDS + ("loss",):
        assert_same(f"fused {f}", got[f], want[f], 2e-5)
    for name, w in want["grads"].items():
        assert_same(f"fused {name}", got["grads"][name], w, 2e-5)


def test_remat_with_bf16_equals_bf16(runs):
    """bf16 and remat together: the same numbers as bf16 alone (the
    recompute repeats the same casts and sums)."""
    got, want = (runs["port"]["factorized", "bfloat16", r] for r in (True, False))
    for f in FIELDS + ("loss",):
        assert_same(f"bf16 remat {f}", got[f], want[f], 0.0)
    for name, w in want["grads"].items():
        assert_same(f"bf16 remat {name}", got["grads"][name], w, 0.0)
