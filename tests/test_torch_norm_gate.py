"""CHGNet's norm-and-gate (``ops.norm_gate``): the tail of
``models.layers.NormGatedMLPFM``, SiLU(LN_c(core + b_c)) * sigmoid(LN_g(gate +
b_g)) normalised over the features of (F, M) arrays.

On the CPU, in float64: the plain feature-major version equals the row-major
composition that the port ran before (a transpose, ``F.layer_norm``, the
gate, the transpose back), in value and in first- and second-order
gradients; its closed-form backward equals autograd's; the Functions, with
the kernels' wrappers replaced by the plain version, pass ``gradcheck`` and
``gradgradcheck``; the module keeps its
parameter names and computes the row-major module's function from the same
weights; a CPU call takes the plain version; the kernels' wrappers refuse
what the kernels do not take. ``chip_smoke``'s checks run on the CPU too.

On a card (tests marked ``card``, which skip without one): the kernels
against the plain version at F 64, 8, 100 and 256 with M no multiple of the
tile, and at a screen request's edges and angles (F 64) (output, d core, d
gate, the six parameters' gradients, which repeat bitwise), the second order through the kernels, the counters of one CHGNet
E/F/S of a chgnet-mptrj.screen batch (9 forward and 9 backward launches),
and CHGNet's functional path (``torch.func.vjp`` through the Functions)
against its eager one. No JAX here: ``python3 -m pytest --noconftest -q
tests/test_torch_norm_gate.py`` runs the card tests on the card.
"""

import json
from pathlib import Path

import pytest
import torch
from torch.nn import functional as F

import chip_smoke
from torch_m3gnet_tpu_torch.models.layers import NormGatedMLPFM
from torch_m3gnet_tpu_torch.ops import norm_gate as ng

EPS = 1e-5
ROOT = Path(__file__).resolve().parent.parent


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def row_major(core, gate, core_bias, gate_bias, core_scale, core_shift, gate_scale, gate_shift,
              eps=EPS):
    """The composition the port ran before: rows of (M, F), LayerNorm, the
    gate, the product back to (F, M)."""
    f = core.shape[0]
    yc = F.layer_norm((core + core_bias[:, None]).t(), (f,), core_scale, core_shift, eps)
    yg = F.layer_norm((gate + gate_bias[:, None]).t(), (f,), gate_scale, gate_shift, eps)
    return (F.silu(yc) * torch.sigmoid(yg)).t()


def inputs(f, m, seed=0):
    """(g, core, gate, six parameters) in float64, each requiring grad."""
    return [t.requires_grad_(True) for t in
            chip_smoke.norm_gate_inputs(f, m, "cpu", seed=seed, dtype=torch.float64)]


def close(got, want, rtol=1e-12):
    """Within rtol of the larger of 1 and want's largest magnitude (at F = 1
    a column normalises to 0 and its exact gradients are zeros)."""
    assert got.shape == want.shape
    assert (got - want).abs().max() <= rtol * max(want.abs().max(), 1.0)


SHAPES = [(8, 5), (3, 7), (1, 4)]


@pytest.mark.parametrize("f,m", SHAPES)
def test_plain_equals_the_row_major_composition(f, m):
    _, *xs = inputs(f, m, seed=f + m)
    got, want = ng.norm_gate_fm_plain(*xs, EPS), row_major(*xs)
    close(got, want)
    w = torch.randn(f, m, dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    first = lambda fn: torch.autograd.grad((fn(*xs, EPS) * w).sum(), xs,  # noqa: E731
                                           create_graph=True)
    g_plain, g_rows = first(ng.norm_gate_fm_plain), first(row_major)
    for a, b in zip(g_plain, g_rows):
        close(a, b, 1e-11)
    # second order: a weighted sum of the first-order gradients, differentiated
    second = lambda gs: torch.autograd.grad(  # noqa: E731
        sum((d * d.detach().sin()).sum() for d in gs), xs, materialize_grads=True)
    for a, b in zip(second(g_plain), second(g_rows)):
        close(a, b, 1e-10)


@pytest.mark.parametrize("f,m", SHAPES[:2])
def test_plain_gradcheck_and_gradgradcheck(f, m):
    _, *xs = inputs(f, m, seed=1)
    fn = lambda *a: ng.norm_gate_fm_plain(*a, EPS)  # noqa: E731
    assert torch.autograd.gradcheck(fn, xs)
    assert torch.autograd.gradgradcheck(fn, xs)


@pytest.mark.parametrize("f,m", SHAPES)
def test_closed_form_backward_is_autograds(f, m):
    g, *xs = inputs(f, m, seed=2)
    want = torch.autograd.grad(ng.norm_gate_fm_plain(*xs, EPS), xs, g)
    got = ng.norm_gate_backward_plain(g, *xs, EPS)
    for a, b in zip(got, want):
        close(a, b, 1e-11)


@pytest.fixture
def plain_kernels(monkeypatch):
    """The kernels' wrappers replaced by the plain version, so that the
    Functions run on the CPU."""
    monkeypatch.setattr(ng, "norm_gate_fwd_cuda",
                        lambda core, gate, params, eps: ng.norm_gate_fm_plain(core, gate, *params,
                                                                              eps))
    monkeypatch.setattr(ng, "norm_gate_bwd_cuda",
                        lambda g, core, gate, params, eps: ng.norm_gate_backward_plain(
                            g, core, gate, *params, eps))


def test_functions_gradcheck_and_gradgradcheck_on_the_cpu(plain_kernels):
    """``NormGate`` and ``NormGateBackward`` over the plain version: the
    first order is the closed-form backward, the second the plain
    backward's own gradient."""
    _, *xs = inputs(4, 6, seed=4)
    fn = lambda *a: ng.NormGate.apply(*a, EPS)  # noqa: E731
    assert torch.autograd.gradcheck(fn, xs)
    assert torch.autograd.gradgradcheck(fn, xs)


def test_chip_smoke_checks_on_the_cpu(plain_kernels):
    """The checks that chip_smoke runs on the card, on the plain version
    (float32 against float64) and through the Functions over it."""
    worst = chip_smoke.check_norm_gate("cpu")
    assert max(worst.values()) <= chip_smoke.NORM_GATE_TOL
    assert chip_smoke.check_norm_gate_second_order("cpu") <= chip_smoke.NORM_GATE_TOL2


def old_forward(module, x):
    """NormGatedMLPFM as it was: the first Dense feature-major, the rest
    row-major after a transpose, nn.LayerNorm, the product transposed back."""
    out = {}
    for part in ("core", "gate"):
        h = getattr(module, f"{part}_0")(x).t()
        for i in range(1, module.depth):
            layer = getattr(module, f"{part}_{i}")
            h = torch.addmm(layer.bias, F.silu(h), layer.kernel)
        out[part] = getattr(module, f"{part}_norm")(h)
    return (F.silu(out["core"]) * torch.sigmoid(out["gate"])).t()


@pytest.mark.parametrize("hidden", [(), (8,)], ids=["depth1", "depth2"])
def test_module_keeps_its_names_and_function(hidden):
    module = NormGatedMLPFM(12, 8, hidden, generator=torch.Generator().manual_seed(0)).double()
    depth = len(hidden) + 1
    names = [f"{part}_{i}.{w}" for part in ("core", "gate") for i in range(depth)
             for w in ("kernel", "bias")]
    names += [f"{part}_norm.{w}" for part in ("core", "gate") for w in ("weight", "bias")]
    state = module.state_dict()
    assert sorted(state) == sorted(names)
    assert module.core_norm.eps == module.gate_norm.eps == EPS
    gen = torch.Generator().manual_seed(1)
    saved = {k: v + 0.1 * torch.randn(v.shape, generator=gen, dtype=v.dtype)
             for k, v in state.items()}
    module.load_state_dict(saved)  # a state dict of the row-major module loads as it is
    x = torch.randn(12, 9, dtype=torch.float64, generator=gen)
    close(module(x), old_forward(module, x))


def test_a_cpu_call_takes_the_plain_version(monkeypatch):
    from torch_m3gnet_tpu_torch.utils import profiling

    calls = []
    plain = ng.norm_gate_fm_plain
    monkeypatch.setattr(ng, "norm_gate_fm_plain", lambda *a: calls.append(1) or plain(*a))
    monkeypatch.setattr(ng.NormGate, "apply",
                        lambda *a: pytest.fail("the Function ran for a CPU tensor"))
    profiling.reset_counts("launch.norm_gate")
    module = NormGatedMLPFM(12, 8, (8,), generator=torch.Generator().manual_seed(0))
    x = torch.randn(12, 5, requires_grad=True)
    module(x).sum().backward()
    assert calls == [1] and x.grad is not None
    assert not any(k.startswith("launch.norm_gate") for k in profiling.counts())


def refused(kind, f=8, m=12):
    """A call of each kernel wrapper on operands that fault by ``kind``."""
    g, core, gate, *params = chip_smoke.norm_gate_inputs(f, m, "cpu")
    if kind == "dtype":
        g, core, gate = g.double(), core.double(), gate.double()
    elif kind == "contiguous":
        g, core, gate = (t.t().contiguous().t() for t in (g, core, gate))
    elif kind == "param_shape":
        params[3] = params[3][:-1]
    elif kind == "rank":
        g, core, gate = g[0], core[0], gate[0]
    return [lambda: ng.norm_gate_fwd_cuda(core, gate, params, EPS),
            lambda: ng.norm_gate_bwd_cuda(g, core, gate, params, EPS)]


@pytest.mark.parametrize("kind,error,match", [
    ("dtype", TypeError, "float32"),
    ("contiguous", ValueError, "contiguous"),
    ("cpu", ValueError, "CUDA tensors"),
    ("param_shape", ValueError, "core_shift has shape"),
    ("rank", ValueError, r"must be \(F, M\)"),
])
def test_kernel_wrappers_refuse(kind, error, match):
    for call in refused(kind):
        with pytest.raises(error, match=match):
            call()


def test_kernel_wrappers_refuse_more_than_256_features():
    for call in refused("cpu", f=ng.MAX_FEATURES + 1):
        with pytest.raises(ValueError, match="1 to 256 features"):
            call()


@pytest.mark.card
def test_kernels_match_the_plain_version():
    card()
    worst = chip_smoke.check_norm_gate("cuda")
    assert max(worst.values()) <= chip_smoke.NORM_GATE_TOL


@pytest.mark.card
def test_second_order_through_the_kernels():
    card()
    assert chip_smoke.check_norm_gate_second_order("cuda") <= chip_smoke.NORM_GATE_TOL2


def chgnet_on_the_card(recipe, seed):
    """CHGNet at the chgnet-mptrj configuration on the card, seeded weights,
    and one batch of the screen traffic's structures made by ``recipe``."""
    from portbench import mpmix
    from torch_m3gnet_tpu_torch import M3GNetConfig
    from torch_m3gnet_tpu_torch.data import Structure, pack_structures, to_torch
    from torch_m3gnet_tpu_torch.models import build_model

    cfg = json.loads((ROOT / "portbench" / "configs" / "chgnet-mptrj.json").read_text())
    t = json.loads((ROOT / "portbench" / "traffic" / "chgnet-screen.json").read_text())
    (structs,) = mpmix.batches(recipe(t), 1, seed, t["strain"], t["noise"])
    pot = build_model(M3GNetConfig(architecture="chgnet", cutoff=cfg["cutoff"],
                                   threebody_cutoff=cfg["threebody_cutoff"],
                                   num_types=cfg["num_types"], embedding_dim=cfg["embedding_dim"],
                                   num_blocks=cfg["num_blocks"]), device="cuda",
                      generator=torch.Generator().manual_seed(seed % 1000))
    batch = pack_structures([Structure(*s) for s in structs], cfg["cutoff"],
                            cfg["threebody_cutoff"], pad_multiple=t["pad_multiple"],
                            bond_pairs=True)
    return pot, to_torch(batch, "cuda", torch.float32, pot.model.batch_index)


@pytest.mark.card
def test_one_chgnet_screen_request_launches_each_kernel_nine_times():
    """One E/F/S of a chgnet-mptrj.screen batch: 4 atom convs, 3 bond convs
    and 2 angle updates each run the forward kernel once and, in the force
    backward, the backward kernel once."""
    card()
    from torch_m3gnet_tpu_torch.utils import profiling

    pot, graph = chgnet_on_the_card(lambda t: t["recipe"] * t["repeat"], 2**31 + 11)
    profiling.reset_counts("launch.norm_gate")
    out = pot(graph)
    torch.cuda.synchronize()
    counts = profiling.counts()
    assert (counts.get("launch.norm_gate_fwd"), counts.get("launch.norm_gate_bwd")) == (9, 9)
    assert torch.isfinite(out.forces).all() and torch.isfinite(out.energy).all()


@pytest.mark.card
def test_functional_path_through_the_kernels():
    """``forward(functional=True)`` takes the forces by ``torch.func.vjp``
    through the Functions: the eager path's E/F/S and moments, and the same
    launches."""
    card()
    from torch_m3gnet_tpu_torch.utils import profiling

    pot, graph = chgnet_on_the_card(lambda t: t["recipe"][:6], 2**31 + 5)
    runs = []
    for functional in (False, True):
        profiling.reset_counts("launch.norm_gate")
        out = pot(graph, functional=functional)
        counts = profiling.counts()
        runs.append((out, (counts.get("launch.norm_gate_fwd"), counts.get("launch.norm_gate_bwd"))))
    (eager, n_eager), (func, n_func) = runs
    assert n_eager == n_func == (9, 9)
    for field in ("energy", "forces", "stress", "magmom"):
        a, b = getattr(func, field).detach(), getattr(eager, field).detach()
        assert (a - b).abs().max() <= 1e-5 * max(b.abs().max(), 1.0)
