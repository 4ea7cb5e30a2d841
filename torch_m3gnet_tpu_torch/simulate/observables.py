"""Trajectory observables and writers for MD/relaxation output.

Own numpy copy of ``torch_m3gnet_tpu.simulate.observables``: radial
distribution function, mean-squared displacement and diffusion, velocity
autocorrelation and the vibrational density of states from it, and an
ASE-compatible extended-XYZ trajectory writer. All host-side numpy; the RDF
uses the port's ``neighbor_list_pbc`` (the C++ cell list from 48 atoms up).
"""

from __future__ import annotations

from typing import Optional, Sequence, TextIO, Union

import numpy as np

from torch_m3gnet_tpu_torch.data.neighborlist import neighbor_list_pbc
from torch_m3gnet_tpu_torch.data.structure import Structure

# IUPAC symbols indexed by Z (index 0 unused), Z <= 94 — matches the mass
# table in simulate/md.py.
SYMBOLS = (
    "X H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca Sc Ti V Cr Mn Fe "
    "Co Ni Cu Zn Ga Ge As Se Br Kr Rb Sr Y Zr Nb Mo Tc Ru Rh Pd Ag Cd In Sn "
    "Sb Te I Xe Cs Ba La Ce Pr Nd Pm Sm Eu Gd Tb Dy Ho Er Tm Yb Lu Hf Ta W "
    "Re Os Ir Pt Au Hg Tl Pb Bi Po At Rn Fr Ra Ac Th Pa U Np Pu"
).split()


def radial_distribution(
    lattice: np.ndarray,
    frames: Sequence[np.ndarray],
    r_max: float = 6.0,
    n_bins: int = 120,
) -> tuple[np.ndarray, np.ndarray]:
    """g(r) averaged over ``frames`` (each (N, 3) cartesian) in a fixed cell.

    Normalized so an ideal gas gives g(r) = 1. Returns (r_centers, g).
    """
    lattice = np.asarray(lattice, dtype=np.float64)
    edges_r = np.linspace(0.0, r_max, n_bins + 1)
    counts = np.zeros(n_bins, dtype=np.float64)
    n = None
    for pos in frames:
        pos = np.asarray(pos, dtype=np.float64)
        n = len(pos)
        _, _, dist = neighbor_list_pbc(lattice, pos, r_max)
        counts += np.histogram(dist, bins=edges_r)[0]
    if n is None or n == 0:
        raise ValueError("radial_distribution needs at least one frame")
    counts /= len(frames)

    vol = abs(np.dot(lattice[0], np.cross(lattice[1], lattice[2])))
    density = n / vol
    shell = 4.0 / 3.0 * np.pi * (edges_r[1:] ** 3 - edges_r[:-1] ** 3)
    # full directed neighbor list -> n ordered pairs per shell on average
    g = counts / (n * density * shell)
    centers = 0.5 * (edges_r[1:] + edges_r[:-1])
    return centers, g


def mean_squared_displacement(
    frames: Sequence[np.ndarray], times: Optional[np.ndarray] = None
) -> tuple[np.ndarray, np.ndarray]:
    """MSD(t) = <|r_i(t) - r_i(0)|^2>_i for UNWRAPPED cartesian frames.

    (run_md integrates unwrapped positions, so its trajectory is directly
    usable.) Returns (times, msd); times defaults to the frame index.
    """
    frames = [np.asarray(f, dtype=np.float64) for f in frames]
    ref = frames[0]
    msd = np.array([np.mean(np.sum((f - ref) ** 2, axis=-1)) for f in frames])
    if times is None:
        times = np.arange(len(frames), dtype=np.float64)
    return np.asarray(times, dtype=np.float64), msd


def diffusion_coefficient(times: np.ndarray, msd: np.ndarray, skip: float = 0.2):
    """Einstein relation D = slope(MSD)/6 from a least-squares fit, skipping
    the initial ballistic fraction ``skip`` of the trajectory."""
    i0 = int(len(times) * skip)
    t, m = np.asarray(times[i0:]), np.asarray(msd[i0:])
    if len(t) < 2:
        raise ValueError("not enough frames to fit a diffusion coefficient")
    slope = np.polyfit(t, m, 1)[0]
    return slope / 6.0


def write_extxyz(
    fileobj: Union[str, TextIO],
    structure: Structure,
    frames: Sequence[np.ndarray],
    velocities: Optional[Sequence[np.ndarray]] = None,
    energies: Optional[Sequence[float]] = None,
    times: Optional[Sequence[float]] = None,
    lattices: Optional[Sequence[np.ndarray]] = None,
) -> None:
    """Write a trajectory as ASE-compatible extended XYZ (one block per frame).

    ``lattices``: optional per-frame (3, 3) cells for runs where the cell
    evolves (NPT — the barostat rescales it every step); defaults to the
    input structure's fixed cell.
    """
    close = False
    if isinstance(fileobj, str):
        fileobj = open(fileobj, "w")
        close = True
    try:
        z = np.asarray(structure.atomic_numbers)
        species = [SYMBOLS[int(zi)] for zi in z]
        lat_fixed = " ".join(
            f"{x:.10g}" for x in np.asarray(structure.lattice).ravel()
        )
        for i, pos in enumerate(frames):
            pos = np.asarray(pos)
            props = "species:S:1:pos:R:3"
            if velocities is not None:
                props += ":vel:R:3"
            lat = (
                " ".join(f"{x:.10g}" for x in np.asarray(lattices[i]).ravel())
                if lattices is not None
                else lat_fixed
            )
            header = f'Lattice="{lat}" Properties={props} pbc="T T T"'
            if energies is not None:
                header += f" energy={float(energies[i]):.10g}"
            if times is not None:
                header += f" time={float(times[i]):.10g}"
            fileobj.write(f"{len(pos)}\n{header}\n")
            for a in range(len(pos)):
                row = f"{species[a]} " + " ".join(f"{x:.10f}" for x in pos[a])
                if velocities is not None:
                    row += " " + " ".join(f"{x:.10f}" for x in np.asarray(velocities[i])[a])
                fileobj.write(row + "\n")
    finally:
        if close:
            fileobj.close()


def velocity_autocorrelation(
    velocities: Sequence[np.ndarray], max_lag: Optional[int] = None
) -> np.ndarray:
    """Normalized VACF(t) = <v(t0).v(t0+t)> / <v.v>, averaged over atoms,
    components, and time origins (FFT-accelerated). ``velocities`` is a
    sequence of (N, 3) frames; returns (max_lag,) with VACF[0] = 1."""
    v = np.stack([np.asarray(f, dtype=np.float64) for f in velocities])
    t, n, _ = v.shape
    if max_lag is None:
        max_lag = t // 2
    flat = v.reshape(t, -1)  # (T, 3N)
    # autocorrelation per component via FFT, then average
    f = np.fft.rfft(flat, n=2 * t, axis=0)
    acf = np.fft.irfft(f * f.conj(), axis=0)[:max_lag].real  # (lag, 3N)
    counts = (t - np.arange(max_lag))[:, None]
    acf = (acf / counts).sum(axis=1)
    return acf / acf[0]


def phonon_dos_from_vacf(
    velocities: Sequence[np.ndarray], dt_fs: float, max_lag: Optional[int] = None
) -> tuple[np.ndarray, np.ndarray]:
    """Vibrational density of states: cosine transform of the VACF.

    Returns (frequencies_thz, dos) with a Hann window; peak positions match
    the harmonic normal-mode frequencies (pinned in tests on an exactly
    harmonic trajectory).
    """
    vacf = velocity_autocorrelation(velocities, max_lag=max_lag)
    m = len(vacf)
    window = np.hanning(2 * m)[m:]
    spec = np.abs(np.fft.rfft(vacf * window, n=4 * m))
    freqs_thz = np.fft.rfftfreq(4 * m, d=dt_fs * 1e-3)  # 1/ps = THz
    return freqs_thz, spec / max(spec.max(), 1e-300)
