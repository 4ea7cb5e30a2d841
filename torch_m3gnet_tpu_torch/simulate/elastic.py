"""Second-order observables by exact automatic differentiation.

Counterpart of ``torch_m3gnet_tpu.simulate.elastic``: elastic constants and
phonons as EXACT second derivatives of the potential's energy. JAX takes
``jax.hessian``, which maps the gradient's derivative over every row at
once; here each Hessian is the VJP of ``torch.func.grad`` of the energy,
mapped by ``torch.func.vmap`` over the rows of an identity: a batched
backward (6 rows for the strain Hessian, 3N for the force constants), in
chunks of rows sized to a memory budget (:func:`hessian_chunk`). The
port's custom ops are ``autograd.Function``s whose backward passes are
built from Functions again, each with a ``vmap`` rule, so the batched
second derivative runs through them once for all rows: on the card the
factorized stage's kernels (B1-B3 on their member axis, the saved primals
shared at stride 0) and the sorted segment sum (B8, the rows folded).
(``torch.autograd.grad(..., is_grads_batched=True)`` would not do: it maps
with torch's older ``_vmap_internals``, which knows no Function's vmap rule
and hands the kernels' forward a batched tensor with no storage.) The
energy runs without ``remat_triplets``' checkpoint, which ``torch.func``
refuses; remat changes no value.

Conventions:
- strain: lattice and positions deform affinely, x -> x @ (1 + eps), with
  Voigt engineering shears (eps_4..6 are 2*eps_yz etc.), so the returned
  C_ij = (1/V) d^2E / d eps_i d eps_j is the standard elastic matrix;
- clamped-ion: internal coordinates are NOT re-relaxed under strain (the
  pure second derivative);
- phonons: the dynamical matrix is the position Hessian of the PBC energy,
  mass-weighted; its PBC construction satisfies the acoustic sum rule (a
  uniform translation costs nothing), so Gamma has three zero modes.

Every function takes a host batch (numpy) or a batch on the device, and runs
on the potential's device in its dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from torch_m3gnet_tpu_torch.models.m3gnet import edge_vectors_fm
from torch_m3gnet_tpu_torch.simulate.relax import device_batch

EV_PER_A3_TO_GPA = 160.21766208

# sqrt(eV / (amu * A^2)) -> THz (nu = omega / 2pi)
_SQRT_EV_AMU_A2_TO_THZ = 15.633302


def _energy_fn(potential, batch):
    """(device batch, differentiable total energy of (positions, lattice))."""
    graph = device_batch(potential, batch)
    model = potential.model

    def energy(positions, lattice):
        g = graph.replace(positions=positions, lattice=lattice)
        total, _ = model(g, edge_vectors_fm(g, positions, lattice), remat=False)
        return total.sum()

    return graph, energy


# The rows of a Hessian go through the batched backward in chunks: every
# row carries its own copy of the backward pass's tensors, about
# HESSIAN_ROW_FLOATS floats a row for each padded edge, feature unit and
# block, so a chunk takes as many rows as fit in HESSIAN_CHUNK_BYTES (at
# least one). On an H100 the default model at f32 read 25.3 such floats a
# row (500 atoms, passes of 20 rows peaking at 8.17 GB; chip_smoke.py
# phase 8).
HESSIAN_ROW_FLOATS = 26
HESSIAN_CHUNK_BYTES = 8 << 30


def hessian_chunk(potential, num_edges: int) -> int:
    """Rows of one batched backward for a graph of ``num_edges`` (padded)
    edges: ``HESSIAN_CHUNK_BYTES`` over the estimated bytes of one row."""
    model = potential.model
    kernel = model.edge_init.kernel  # (n_max, width)
    row = HESSIAN_ROW_FLOATS * num_edges * kernel.shape[-1] * model.num_blocks
    row *= kernel.element_size()
    return max(1, HESSIAN_CHUNK_BYTES // row)


def _hessian(fn, x: torch.Tensor, rows: int | None = None,
             chunk: int | None = None) -> torch.Tensor:
    """d^2 fn / dx dx[:rows] as (rows, *x.shape): the VJP of the gradient,
    vmapped over the first ``rows`` rows of an identity (all of them by
    default), as ``jax.hessian`` maps its rows, ``chunk`` rows at a time
    (all at once by default)."""
    x = x.detach()
    rows = x.numel() if rows is None else rows
    _, grad_vjp = torch.func.vjp(torch.func.grad(fn), x)
    eye = torch.eye(rows, x.numel(), dtype=x.dtype, device=x.device).reshape(rows, *x.shape)
    # create_graph=False: a chunk's backward keeps no graph of its own
    (hess,) = torch.func.vmap(lambda v: grad_vjp(v, create_graph=False), chunk_size=chunk)(eye)
    return hess


def voigt_strain_matrix(eps6: torch.Tensor) -> torch.Tensor:
    """(6,) engineering Voigt strain -> symmetric (3, 3) strain matrix."""
    e = eps6
    return torch.stack([
        torch.stack([e[0], e[5] / 2, e[4] / 2]),
        torch.stack([e[5] / 2, e[1], e[3] / 2]),
        torch.stack([e[4] / 2, e[3] / 2, e[2]]),
    ])


def elastic_tensor(potential, batch, gpa: bool = True) -> np.ndarray:
    """Clamped-ion elastic matrix C (6, 6) of a SINGLE-graph batch.

    C_ij = (1/V) d^2 E / (d eps_i d eps_j) at zero strain, exact autodiff.
    Returns GPa by default, eV/A^3 otherwise.
    """
    if batch.num_graphs_real != 1:
        raise ValueError("elastic_tensor expects a single-graph batch")
    graph, energy = _energy_fn(potential, batch)
    pos0, lat0 = graph.positions, graph.lattice

    def e_of_eps(eps6):
        deform = torch.eye(3, dtype=pos0.dtype, device=pos0.device) + voigt_strain_matrix(eps6)
        return energy(pos0 @ deform, lat0 @ deform)

    hess = _hessian(e_of_eps, pos0.new_zeros(6),
                    chunk=hessian_chunk(potential, graph.edge_src.shape[0]))
    lat = torch.as_tensor(batch.lattice).detach().cpu().double().numpy()
    c = hess.detach().cpu().double().numpy() / abs(np.linalg.det(lat[0]))
    c = 0.5 * (c + c.T)
    return c * EV_PER_A3_TO_GPA if gpa else c


def bulk_modulus_voigt(c_gpa: np.ndarray) -> float:
    """Voigt-average bulk modulus from the elastic matrix (GPa in, GPa out)."""
    c = np.asarray(c_gpa)
    return float(
        (c[0, 0] + c[1, 1] + c[2, 2] + 2 * (c[0, 1] + c[0, 2] + c[1, 2])) / 9.0
    )


def force_constants(potential, batch) -> np.ndarray:
    """(N, 3, N, 3) PBC force-constant matrix d^2E/du_i du_j of the N real
    atoms, exact autodiff: 3N gradients of the forces' graph.

    Folded over periodic images by construction (the PBC energy already sums
    them), i.e. the supercell-Gamma force constants of the given cell.
    """
    if batch.num_graphs_real != 1:
        raise ValueError("force_constants expects a single-graph batch")
    graph, energy = _energy_fn(potential, batch)
    n = int(graph.n_node[0])
    hess = _hessian(lambda p: energy(p, graph.lattice), graph.positions, rows=3 * n,
                    chunk=hessian_chunk(potential, graph.edge_src.shape[0]))
    return hess[:, :n].detach().cpu().double().numpy().reshape(n, 3, n, 3)


def phonon_dispersion(
    potential,
    primitive,
    reps,
    k_frac,
    masses_amu,
    cutoff: float,
    threebody_cutoff: float,
    pad_multiple: int = 64,
) -> dict:
    """Phonon frequencies along a k-path by the supercell force-constant
    method, with the force constants from ONE exact autodiff Hessian.

    ``primitive`` is the unit cell; ``reps = (na, nb, nc)`` builds the
    supercell whose PBC Hessian supplies the interatomic force constants.
    ``k_frac`` is (nk, 3) in fractional coordinates of the PRIMITIVE
    reciprocal lattice; ``masses_amu`` has one mass per primitive atom.

    D(k)_{p a, p' b} = (m_p m_p')^{-1/2} sum_R Phi[(0,p)a, (R,p')b] e^{i k.R}

    using the image-major supercell ordering of ``Structure.supercell``
    (supercell atom s = m * n_prim + p with R_m in lexicographic order).
    Frequencies are EXACT at k commensurate with the supercell and
    Fourier-interpolated elsewhere.

    Returns {"frequencies_thz": (nk, 3*n_prim) ascending per k (negative =
    imaginary), "force_constants": the supercell (N, 3, N, 3) array}.
    """
    from torch_m3gnet_tpu_torch.data.graph import cast_batch, pack_structures

    na, nb, nc = reps
    n_prim = len(primitive)
    masses = np.asarray(masses_amu, dtype=np.float64).reshape(n_prim)
    sc = primitive.supercell(reps)
    batch = cast_batch(
        pack_structures([sc], cutoff, threebody_cutoff, pad_multiple=pad_multiple,
                        bond_pairs="edge_reverse" in potential.model.batch_index),
        np.float64,
    )
    phi = force_constants(potential, batch)  # (N, 3, N, 3)

    images = np.array(
        [[i, j, k] for i in range(na) for j in range(nb) for k in range(nc)],
        dtype=np.float64,
    )  # matches Structure.supercell ordering
    n_img = len(images)
    # Phi blocks between home-cell atom p and image-m atom p'
    blocks = phi[:n_prim].reshape(n_prim, 3, n_img, n_prim, 3)

    inv_sqrt_m = 1.0 / np.sqrt(masses)
    k_frac = np.atleast_2d(np.asarray(k_frac, dtype=np.float64))
    freqs = np.empty((len(k_frac), 3 * n_prim))
    for ki, kf in enumerate(k_frac):
        phase = np.exp(2j * np.pi * (images @ kf))  # (n_img,)
        dk = np.einsum("pamqb,m->paqb", blocks, phase)  # (np,3,np,3) complex
        dk = (
            dk
            * inv_sqrt_m[:, None, None, None]
            * inv_sqrt_m[None, None, :, None]
        ).reshape(3 * n_prim, 3 * n_prim)
        dk = 0.5 * (dk + dk.conj().T)
        evals = np.linalg.eigvalsh(dk)
        freqs[ki] = np.sign(evals) * np.sqrt(np.abs(evals)) * _SQRT_EV_AMU_A2_TO_THZ
    return {"frequencies_thz": freqs, "force_constants": phi}


def gamma_phonons(potential, batch, masses_amu) -> dict:
    """Gamma-point phonon frequencies (THz) and eigenvectors of one cell.

    Returns {"frequencies_thz": (3N,) sorted (negative = imaginary, i.e.
    sqrt of a negative dynamical-matrix eigenvalue), "modes": (3N, N, 3),
    "force_constants": (N, 3, N, 3)}.
    """
    phi = force_constants(potential, batch)  # eV / A^2
    n = phi.shape[0]
    masses = np.asarray(masses_amu, dtype=np.float64).reshape(n)

    inv_sqrt_m = 1.0 / np.sqrt(masses)
    dyn = (
        phi
        * inv_sqrt_m[:, None, None, None]
        * inv_sqrt_m[None, None, :, None]
    ).reshape(3 * n, 3 * n)
    dyn = 0.5 * (dyn + dyn.T)
    evals, evecs = np.linalg.eigh(dyn)  # eV / (amu A^2)
    freqs = np.sign(evals) * np.sqrt(np.abs(evals)) * _SQRT_EV_AMU_A2_TO_THZ
    modes = evecs.T.reshape(3 * n, n, 3) * inv_sqrt_m[None, :, None]
    return {"frequencies_thz": freqs, "modes": modes, "force_constants": phi}
