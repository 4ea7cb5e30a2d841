"""Radial/angular basis functions as plain, differentiable torch code.

Counterpart of ``torch_m3gnet_tpu.ops.basis`` (feature-major forms only:
the new axis of l, n or m comes first):

- smooth radial basis: the Kocer two-sinc + Gram-Schmidt recursion;
- spherical Bessel j_l via upward recurrence with a small-z Taylor series;
- normalized spherical Bessel chi_ln;
- smooth polynomial cutoff;
- Legendre polynomials P_l(cos theta) by Bonnet's recursion (the triplet
  modes' angular basis);
- real Racah-normalized harmonics, whose products give P_l(cos theta) by the
  addition theorem;
- spherical Bessel zeros by interlaced root bracketing (scipy, own copy).

Every branch uses the double-``where`` guard: ``torch.where`` propagates NaN
gradients from the branch it does not select, exactly as ``jnp.where`` does,
so each branch gets an argument that is finite there (padded edges would
otherwise turn forces NaN). No custom autograd rules are needed, so
gradients of gradients work to any order.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

_EPS = 1e-8


@lru_cache(maxsize=None)
def spherical_bessel_zeros(l_max: int, n_max: int) -> np.ndarray:
    """First ``n_max`` positive roots of j_l for l = 0..l_max-1.

    Roots of j_l strictly separate roots of j_{l+1}, so each root of j_{l+1}
    is bracketed by consecutive roots of j_l.
    """
    from scipy.optimize import brentq
    from scipy.special import spherical_jn

    # Roots of j_0 are exactly n*pi; each recurrence row loses one usable
    # bracket, so start with l_max extras.
    width = n_max + l_max + 1
    zeros = np.zeros((l_max, width))
    zeros[0] = np.arange(1, width + 1) * np.pi
    valid = width
    for ell in range(1, l_max):
        f = lambda z, ell=ell: spherical_jn(ell, z)
        valid -= 1
        for k in range(valid):
            zeros[ell, k] = brentq(f, zeros[ell - 1, k], zeros[ell - 1, k + 1])
    return np.ascontiguousarray(zeros[:, :n_max])


@lru_cache(maxsize=None)
def chi_norm_constants(cutoff: float, l_max: int, n_max: int) -> np.ndarray:
    """(l_max, n_max) chi normalization: sqrt(2/rc^3) / |j_{l+1}(z_ln)| with
    z_ln the n-th root of j_l (the textbook M3GNet constants, as the JAX
    package's default)."""
    from scipy.special import spherical_jn

    zeros = spherical_bessel_zeros(l_max + 1, n_max)
    return np.stack(
        [
            math.sqrt(2.0 / cutoff**3) / np.abs(spherical_jn(ell + 1, zeros[ell]))
            for ell in range(l_max)
        ]
    )


def cutoff_poly(r: torch.Tensor, cutoff: float) -> torch.Tensor:
    """Smooth C^2 cutoff: 1 - 6u^5 + 15u^4 - 10u^3 for u = r/rc, 0 beyond."""
    u = r / cutoff
    val = 1.0 - 6.0 * u**5 + 15.0 * u**4 - 10.0 * u**3
    return torch.where(u <= 1.0, val, torch.zeros_like(val))


def legendre_cos_all(x: torch.Tensor, l_max: int) -> torch.Tensor:
    """Legendre polynomials P_l(x) for l = 0..l_max-1 by Bonnet's recursion,
    stacked on a new axis 0: shape (l_max, *x.shape)."""
    out = [torch.ones_like(x)]
    if l_max > 1:
        out.append(x)
        for n in range(1, l_max - 1):
            out.append(((2 * n + 1) * x * out[n] - n * out[n - 1]) / (n + 1))
    return torch.stack(out)


def spherical_bessel_all(z: torch.Tensor, l_max: int) -> torch.Tensor:
    """Spherical Bessel j_l(z) for l = 0..l_max-1, stacked on a new axis 0.

    Upward recurrence j_{l+1} = (2l+1)/z j_l - j_{l-1} for z > 0.5; below
    that a 6-term Taylor series. Both branches see grad-safe arguments.
    """
    small = z <= 0.5
    zs = torch.where(small, torch.ones_like(z), z)  # safe denominator
    zt = torch.where(small, z, torch.zeros_like(z))  # safe series argument

    def series(ell: int) -> torch.Tensor:
        dfact = 1.0
        for i in range(ell):
            dfact *= 2 * i + 3  # (2l+1)!!
        term = torch.ones_like(zt)
        acc = term
        for k in range(1, 6):
            term = term * (-(zt * zt) / 2.0) / (k * (2 * ell + 2 * k + 1))
            acc = acc + term
        return zt**ell / dfact * acc

    rec = [torch.sin(zs) / zs]
    if l_max > 1:
        rec.append((torch.sin(zs) / zs - torch.cos(zs)) / zs)
        for n in range(1, l_max - 1):
            rec.append((2 * n + 1) / zs * rec[n] - rec[n - 1])

    return torch.stack(
        [torch.where(small, series(ell), rec[ell]) for ell in range(l_max)]
    )


def normalized_spherical_bessel(
    r: torch.Tensor, cutoff: float, l_max: int, n_max: int
) -> torch.Tensor:
    """chi_ln(r) = norm_ln * j_l(z_ln r / rc): shape (l_max, n_max, *r.shape)."""
    zeros = spherical_bessel_zeros(l_max + 1, n_max)
    norm = chi_norm_constants(cutoff, l_max, n_max)
    shape = (n_max,) + (1,) * r.dim()
    chis = []
    for ell in range(l_max):
        zl = torch.as_tensor(zeros[ell], dtype=r.dtype, device=r.device).reshape(shape)
        nl = torch.as_tensor(norm[ell], dtype=r.dtype, device=r.device).reshape(shape)
        z = zl * r[None] / cutoff  # (n_max, *r)
        j = spherical_bessel_all(z.reshape(n_max, -1), ell + 1)[ell]
        chis.append(j.reshape((n_max,) + tuple(r.shape)) * nl)
    return torch.stack(chis)


def racah_l_index(l_max: int) -> np.ndarray:
    """Degree l of each component of :func:`real_racah_harmonics_fm`: (M,)
    int, M = l_max^2; components are grouped by l, so l_m = floor(sqrt(m))."""
    return np.concatenate(
        [np.full(2 * ell + 1, ell, dtype=np.int64) for ell in range(l_max)]
    )


def real_racah_harmonics_fm(u_fm: torch.Tensor, l_max: int) -> torch.Tensor:
    """Real Racah-normalized harmonics C_lm(u), (3, E) unit vectors ->
    (l_max^2, E), normalized so that sum_m C_lm(a) C_lm(b) = P_l(a . b).

    Built from the scaled associated Legendre polynomials
    Pi_l^m(z) = P_l^m(z) / r_xy^m and the azimuthal factor
    r_xy^m (cos m phi, sin m phi) = (Re, Im)(x + iy)^m, so every component
    is a polynomial in x, y, z (grad-safe at the poles). The Condon-Shortley
    phase is dropped; it cancels in the products the model consumes.
    """
    x, y, z = u_fm[0], u_fm[1], u_fm[2]
    pi: dict = {(0, 0): torch.ones_like(z)}
    for m in range(1, l_max):
        pi[(m, m)] = (2 * m - 1) * pi[(m - 1, m - 1)]
    for m in range(l_max):
        if m + 1 < l_max:
            pi[(m + 1, m)] = (2 * m + 1) * z * pi[(m, m)]
        for ell in range(m + 2, l_max):
            pi[(ell, m)] = (
                (2 * ell - 1) * z * pi[(ell - 1, m)] - (ell - 1 + m) * pi[(ell - 2, m)]
            ) / (ell - m)
    a_m, b_m = [torch.ones_like(x)], [torch.zeros_like(x)]
    for m in range(1, l_max):
        a_m.append(x * a_m[m - 1] - y * b_m[m - 1])
        b_m.append(x * b_m[m - 1] + y * a_m[m - 1])
    comps = []
    for ell in range(l_max):
        comps.append(pi[(ell, 0)])
        for m in range(1, ell + 1):
            norm = math.sqrt(2.0 * math.factorial(ell - m) / math.factorial(ell + m))
            comps.append(norm * pi[(ell, m)] * a_m[m])
            comps.append(norm * pi[(ell, m)] * b_m[m])
    return torch.stack(comps, dim=0)


def smooth_radial_basis_fm(r: torch.Tensor, n_max: int, cutoff: float) -> torch.Tensor:
    """Kocer-style smooth radial basis h_m(r), m = 0..n_max-1, shape
    (n_max, *r.shape).

    f_m(r) = c_m (sinc((m+1) pi r / rc) + sinc((m+2) pi r / rc)) with the
    normalized sinc applied to the already pi-scaled argument,
    h_m = (f_m + sqrt(e_m / d_{m-1}) h_{m-1}) / sqrt(d_m),
    e_m = m^2 (m+2)^2 / (4 (m+1)^4 + 1), d_0 = 1, d_m = 1 - e_m / d_{m-1},
    c_m = (-1)^m sqrt(2) pi / rc^1.5 (m+1)(m+2) / sqrt((m+1)^2 + (m+2)^2).
    """
    m = np.arange(n_max, dtype=np.float64)
    em = (m**2) * ((m + 2) ** 2) / (4 * ((m + 1) ** 4) + 1)
    dm = np.ones(n_max)
    for i in range(1, n_max):
        dm[i] = 1 - em[i] / dm[i - 1]
    coeff = (
        ((-1.0) ** m)
        * math.sqrt(2.0)
        * math.pi
        / cutoff**1.5
        * (m + 1)
        * (m + 2)
        / np.sqrt((m + 1) ** 2 + (m + 2) ** 2)
    )

    def sinc(x):
        # normalized sinc sin(pi x)/(pi x), safe at 0
        small = torch.abs(x) <= _EPS
        xs = torch.where(small, torch.ones_like(x), x)
        return torch.where(
            small, torch.ones_like(x), torch.sin(math.pi * xs) / (math.pi * xs)
        )

    hs = []
    for i in range(n_max):
        f = float(coeff[i]) * (
            sinc((i + 1) * math.pi / cutoff * r) + sinc((i + 2) * math.pi / cutoff * r)
        )
        if i == 0:
            h = f
        else:
            h = (f + math.sqrt(em[i] / dm[i - 1]) * hs[i - 1]) / math.sqrt(dm[i])
        hs.append(h)
    return torch.stack(hs, dim=0)
