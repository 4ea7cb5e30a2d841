"""The port's graph parallelism against the JAX package's, at float64 on
the CPU: the halo exchange (its values, gradient and gradient of the
gradient) and the E/F/S of a partitioned graph in every three-body mode,
with the halo plan and with the legacy all-gather.

JAX runs on four devices of the 8-device virtual CPU mesh
(``tests/conftest.py``); the port runs on four gloo ranks spawned once for
the whole file (``parallel.launch``; what they run is
``tests/_torch_parallel_ranks.py``), while the pytest process computes
JAX's side. The cells are ``tests/test_graph_shard.py``'s 72-atom Cu cell
and its 64-atom rod, with its small model (``l_max = n_max = 2``, width 8,
two blocks); JAX's weights (cast to float64) go to the port through
``models.convert``.

Tolerance: rtol 1e-8 (atol 1e-12 near zero), the port's modes against
JAX's gather and factorized modes; the port's fused mode is held there to
JAX's gather mode, since JAX's fused kernels compute in float32. In float32
the port's fused mode is held to JAX's (its Pallas kernels in TPU interpret
mode, as ``tests/test_graph_shard.py`` runs them): 2e-5 of each field's
largest magnitude, as ``test_torch_model.py``'s float32 fused comparisons.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh, PartitionSpec as P

from torch_m3gnet_tpu.config import M3GNetConfig as JaxConfig
from torch_m3gnet_tpu.data.graph import graph_from_structure as jax_graph
from torch_m3gnet_tpu.data.graph import pad_batch as jax_pad
from torch_m3gnet_tpu.data.structure import Structure as JaxStructure
from torch_m3gnet_tpu.models import build_model as jax_build
from torch_m3gnet_tpu.ops.halo import halo_exchange_fm as jax_exchange
from torch_m3gnet_tpu.parallel import graph_shard as jax_gs
from torch_m3gnet_tpu_torch.config import M3GNetConfig
from torch_m3gnet_tpu_torch.data import Structure, graph_from_structure
from torch_m3gnet_tpu_torch.data.graph import pad_batch
from torch_m3gnet_tpu_torch.models import build_model, params_from_flax
from torch_m3gnet_tpu_torch.parallel import graph_shard, launch

jax.config.update("jax_enable_x64", True)

SETTINGS = dict(l_max=2, n_max=2, embedding_dim=8, num_blocks=2)
RTOL, ATOL = 1e-8, 1e-12
MODES = ("factorized", "fused", "gather")
BF16_REMAT = dict(compute_dtype="bfloat16", remat_triplets=True)
CU = ([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]], [29] * 4)


def cu_cell(reps, seed, scale):
    """The JAX tests' perturbed fcc-Cu supercells (JAX structure)."""
    base = JaxStructure.from_frac_coords(np.eye(3) * 3.62, *CU).supercell(reps)
    rng = np.random.default_rng(seed)
    return JaxStructure(base.lattice,
                        base.cart_coords + scale * rng.standard_normal(base.cart_coords.shape),
                        base.atomic_numbers)


def shuffled(s, seed):
    p = np.random.default_rng(seed).permutation(len(s))
    return JaxStructure(s.lattice, s.cart_coords[p], s.atomic_numbers[p])


def graphs(s):
    """(JAX graph, port graph) of ``s`` at float64."""
    return (jax_graph(s, 5.0, 4.0, dtype=np.float64),
            graph_from_structure(Structure(s.lattice, s.cart_coords, s.atomic_numbers),
                                 5.0, 4.0, dtype=np.float64))


def jax_setup(jg, **mode):
    pot = jax_build(JaxConfig(**SETTINGS, **mode))
    single = jax_pad(jg, jg.num_nodes, jg.num_edges, jg.num_triplets, 1)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                          jax.jit(pot.init)(jax.random.PRNGKey(0), single))
    return pot, params, single


def port_weights(params, dtype) -> dict:
    return {k: v.numpy() for k, v in params_from_flax(
        jax.tree.map(np.asarray, params), dtype=dtype).items()}


def exchange_inputs():
    """A real plan (the 8-cell rod of ``tests/test_halo.py`` at 4 shards:
    two ring offsets) and seeded x (4, nps, F), w (4, nps + H, F), v."""
    rod = JaxStructure.from_frac_coords(np.eye(3) * 3.62, *CU).supercell((1, 1, 8))
    sharded = jax_gs.partition_graph(jax_graph(rod, 4.5, 4.0), 4, pad_multiple=32)
    nps, h = sharded.positions.shape[1], sharded.halo_recv_idx.shape[1]
    rng = np.random.default_rng(0)
    x, w, v = (rng.standard_normal((4, n, 5)) for n in (nps, nps + h, nps))
    plan = dict(send=np.asarray(sharded.halo_send_idx), recv=np.asarray(sharded.halo_recv_idx),
                offsets=sharded.halo_offsets)
    return plan, x, w, v


def jax_exchange_results(plan, x, w, v):
    mesh = Mesh(np.array(jax.devices("cpu")[:4]), ("gp",))

    def ext_of(xs, send, recv):
        return jax_exchange(xs.T, send, recv, plan["offsets"], "gp")

    @jax.jit
    @jax.shard_map(mesh=mesh, in_specs=(P("gp"),) * 3, out_specs=P("gp"))
    def forward(x_s, send_s, recv_s):
        return ext_of(x_s[0], send_s[0], recv_s[0]).T[None]

    def loss(x_):
        @jax.shard_map(mesh=mesh, in_specs=(P("gp"),) * 4, out_specs=P())
        def run(x_s, w_s, send_s, recv_s):
            ext = ext_of(x_s[0], send_s[0], recv_s[0])
            return jax.lax.psum(jnp.sum(jnp.sin(ext) * w_s[0].T), "gp")

        return run(x_, w, plan["send"], plan["recv"])

    grad = jax.grad(loss)
    return dict(forward=np.asarray(forward(x, plan["send"], plan["recv"])),
                loss=float(jax.jit(loss)(x)), grad=np.asarray(jax.jit(grad)(x)),
                gradgrad=np.asarray(jax.jit(jax.grad(lambda x_: jnp.sum(grad(x_) * v)))(x)))


@pytest.fixture(scope="module")
def runs():
    """The port's job on four ranks, started first; JAX's references in
    this process meanwhile."""
    cell = cu_cell((3, 3, 2), 0, 0.05)
    jg, g = graphs(cell)
    pot, params, single = jax_setup(jg)
    params32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    states = {"f64": port_weights(params, torch.float64), "f32": port_weights(params32, None)}
    jg32, g32 = (jax_graph(cell, 5.0, 4.0), graph_from_structure(
        Structure(cell.lattice, cell.cart_coords, cell.atomic_numbers), 5.0, 4.0))
    rod = shuffled(cu_cell((1, 1, 16), 6, 0.03), 7)
    jrod, rod_g = graphs(rod)
    rod_g2, perm = graph_shard.spatial_reorder(rod_g)
    cases = {mode: (mode, graph_shard.partition_graph(g, 4), "f64") for mode in MODES}
    cases.update({f"{mode}-allgather": (mode, graph_shard.partition_graph(g, 4, halo=False), "f64")
                  for mode in ("factorized", "gather")})
    cases["reordered"] = ("gather", graph_shard.partition_graph(rod_g2, 4), "f64")
    cases["fused-f32"] = ("fused", graph_shard.partition_graph(g32, 4), "f32")
    cases["factorized-bf16-remat"] = ("factorized", graph_shard.partition_graph(g32, 4), "f32",
                                      BF16_REMAT)
    cases["fused-remat"] = ("fused", graph_shard.partition_graph(g, 4), "f64",
                            dict(remat_triplets=True))
    ex = exchange_inputs()
    with ThreadPoolExecutor(1) as pool:
        job = pool.submit(launch.run, "tests._torch_parallel_ranks:gp_job", 4, ex,
                          (SETTINGS, states, cases), timeout_s=600)
        gp = jax_gs.GraphParallelPotential(pot.model, Mesh(np.array(jax.devices("cpu")[:4]),
                                                           ("gp",)))
        pot_f = jax_build(JaxConfig(**SETTINGS, threebody_mode="factorized", layout="em"))
        gp_f = jax_gs.GraphParallelPotential(pot_f.model, gp.mesh)
        want = {"halo": gp.apply(params, jax_gs.partition_graph(jg, 4)),
                "allgather": gp.apply(params, jax_gs.partition_graph(jg, 4, halo=False)),
                "factorized": gp_f.apply(params, jax_gs.partition_graph(jg, 4)),
                "single": pot.apply(params, single)}
        want = {k: {f: np.asarray(getattr(o, f)) for f in ("energy", "forces", "stress")}
                for k, o in want.items()}
        rod_single = jax_pad(jrod, jrod.num_nodes, jrod.num_edges, jrod.num_triplets, 1)
        rod_ref = pot.apply(params, rod_single)
        want["rod"] = dict(energy=np.asarray(rod_ref.energy),
                           forces=np.asarray(rod_ref.forces)[perm],
                           stress=np.asarray(rod_ref.stress))
        want["exchange"] = jax_exchange_results(*ex)
        gp_fused = jax_gs.GraphParallelPotential(
            jax_build(JaxConfig(**SETTINGS, threebody_mode="fused")).model, gp.mesh)
        with pltpu.force_tpu_interpret_mode():
            out = gp_fused.apply(params32, jax_gs.partition_graph(jg32, 4))
        want["fused-f32"] = {f: np.asarray(getattr(out, f)) for f in ("energy", "forces", "stress")}
        ranks = job.result()
    got = {part: [r[part] for r in ranks] for part in ("exchange", "eval")}
    return dict(got=got, want=want, n=g.num_nodes, state=states["f64"], g=g, states=states,
                g32=g32)


def assert_efs(got, want, n):
    np.testing.assert_allclose(got["energy"], want["energy"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["forces"][:n], want["forces"][:n], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["stress"][:1], want["stress"][:1], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("part", ["forward", "loss", "grad", "gradgrad"])
def test_halo_exchange_matches_jax(runs, part):
    """S = 4, two ring offsets: the extended columns, the loss summed over
    the shards, its gradient (the reverse exchange into the owner rows) and
    the gradient of the gradient (the exchange again)."""
    got, want = runs["got"]["exchange"], runs["want"]["exchange"]
    if part == "loss":
        np.testing.assert_allclose(got[0]["loss"], want["loss"], rtol=RTOL)
        return
    np.testing.assert_allclose(np.stack([r[part] for r in got]), want[part],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case,ref", [
    ("factorized", "factorized"), ("fused", "halo"), ("gather", "halo"),
    ("factorized-allgather", "allgather"), ("gather-allgather", "allgather"),
])
def test_gp_efs_matches_jax(runs, case, ref):
    """E, every shard's forces and S of the partitioned 72-atom cell, the
    same on every rank, against JAX's ``GraphParallelPotential`` (gather
    mode with the halo plan or the all-gather, factorized em)."""
    got = runs["got"]["eval"]
    for r in range(1, 4):
        for f in ("energy", "forces", "stress"):
            np.testing.assert_array_equal(got[r][case][f], got[0][case][f])
    assert_efs(got[0][case], runs["want"][ref], runs["n"])


def single_device(g, state, mode, dtype, **kw):
    """The port's E/F/S of the unpartitioned graph ``g`` on one device."""
    pot = build_model(M3GNetConfig(**SETTINGS, threebody_mode=mode, **kw), device="cpu").to(dtype)
    pot.model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    out = pot(pad_batch(g, g.num_nodes, g.num_edges, g.num_triplets, 1))
    return {f: getattr(out, f).detach().numpy() for f in ("energy", "forces", "stress")}


@pytest.mark.parametrize("mode", MODES)
def test_gp_matches_single_device(runs, mode):
    """Each mode's gp E/F/S against the port's own single-device potential
    on the unpartitioned graph, and against JAX's."""
    single = single_device(runs["g"], runs["state"], mode, torch.float64)
    assert_efs(runs["got"]["eval"][0][mode], single, runs["n"])
    assert_efs(single, runs["want"]["single"], runs["n"])


@pytest.mark.parametrize("case", ["factorized-bf16-remat", "fused-remat"])
def test_gp_bf16_and_remat_match_single_device(runs, case):
    """gp with ``remat_triplets`` (the recompute reruns the stage's halo
    exchange in every backward pass, on every rank alike) and with bf16
    (block 0 exchanges the bf16 node features) against the port's single
    device on the unpartitioned graph with the same settings: f64 remat
    at rtol 1e-8; bf16 + remat within 5 % of the single device's bf16-f32
    gap per field (the shards sum in another order, which may flip a bf16
    rounding), that gap non-zero."""
    got = runs["got"]["eval"][0][case]
    n = runs["n"]
    if case == "fused-remat":
        assert_efs(got, single_device(runs["g"], runs["state"], "fused", torch.float64,
                                      remat_triplets=True), n)
        return
    want = single_device(runs["g32"], runs["states"]["f32"], "factorized", torch.float32,
                         **BF16_REMAT)
    f32 = single_device(runs["g32"], runs["states"]["f32"], "factorized", torch.float32)
    for f in ("energy", "forces", "stress"):
        rows = slice(0, n) if f == "forces" else slice(0, 1)
        gap = np.abs(want[f][rows] - f32[f][rows]).max()
        assert got[f].dtype == np.float32 and gap > 0
        np.testing.assert_allclose(got[f][rows], want[f][rows], rtol=0, atol=0.05 * gap,
                                   err_msg=f)


def test_spatial_reorder_then_gp_matches_dense(runs):
    """A shuffled 64-atom rod, reordered along its long axis and
    partitioned: the gp forces are the dense ones permuted."""
    assert_efs(runs["got"]["eval"][0]["reordered"], runs["want"]["rod"], 64)


def test_gp_fused_f32_matches_jax_fused(runs):
    """float32: the port's fused gp (its kernels' plain versions) against
    JAX's fused gp (its Pallas kernels in interpret mode), 2e-5 of each
    field's largest magnitude."""
    got, want, n = runs["got"]["eval"][0]["fused-f32"], runs["want"]["fused-f32"], runs["n"]
    for f in ("energy", "forces", "stress"):
        assert got[f].dtype == np.float32
        w = want[f][:n] if f == "forces" else want[f][:1]
        np.testing.assert_allclose((got[f][:n] if f == "forces" else got[f][:1]), w, rtol=0,
                                   atol=2e-5 * np.abs(w).max(), err_msg=f)
