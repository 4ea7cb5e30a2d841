"""The port's basis functions (torch_m3gnet_tpu_torch.ops.basis) against the
JAX package's, at f64: values and first derivatives (torch.autograd.grad of
a weighted sum against jax.grad of the same sum) to 1e-10.

Cosines for the Legendre polynomials span [-1, 1]. The radii cover the
small-z series branch of the Bessel functions, the recurrence branch, the
sinc at 0 and the cutoff's zero beyond rc.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_m3gnet_tpu.ops import basis as jb
from torch_m3gnet_tpu_torch.ops import basis as tb

jax.config.update("jax_enable_x64", True)

RC, L_MAX, N_MAX = 5.0, 3, 3

# name: (jax function of r, torch function of r); r is (E,) or, for the
# harmonics, (3, E) unit vectors.
CASES = {
    "cutoff_poly": (lambda r: jb.cutoff_poly(r, 4.0), lambda r: tb.cutoff_poly(r, 4.0)),
    "spherical_bessel_all": (
        lambda r: jb.spherical_bessel_all(r, 4), lambda r: tb.spherical_bessel_all(r, 4)
    ),
    "normalized_spherical_bessel": (
        lambda r: jb.normalized_spherical_bessel(r, RC, L_MAX, N_MAX),
        lambda r: tb.normalized_spherical_bessel(r, RC, L_MAX, N_MAX),
    ),
    "smooth_radial_basis_fm": (
        lambda r: jb.smooth_radial_basis_fm(r, N_MAX, RC),
        lambda r: tb.smooth_radial_basis_fm(r, N_MAX, RC),
    ),
    "legendre_cos_all": (
        lambda x: jb.legendre_cos_all(x, 4), lambda x: tb.legendre_cos_all(x, 4)
    ),
    "real_racah_harmonics_fm": (
        lambda u: jb.real_racah_harmonics_fm(u / jnp.linalg.norm(u, axis=0), 4),
        lambda u: tb.real_racah_harmonics_fm(u / torch.linalg.norm(u, dim=0), 4),
    ),
}


def _inputs(name):
    rng = np.random.default_rng(0)
    if name == "real_racah_harmonics_fm":
        u = rng.standard_normal((3, 64))
        u[:, 0] = [0.0, 0.0, 1.0]  # the pole
        return u
    if name == "legendre_cos_all":
        return np.concatenate([[-1.0, 0.0, 1.0], rng.uniform(-1.0, 1.0, 61)])
    return np.concatenate([[0.0, 1e-3, 0.3, 0.5, 4.0, 5.0, 5.5], rng.uniform(0.01, 6.0, 57)])


@pytest.mark.parametrize("name", sorted(CASES))
def test_basis_matches_jax(name):
    jfn, tfn = CASES[name]
    x = _inputs(name)
    want = np.asarray(jfn(jnp.asarray(x)))
    w = np.random.default_rng(1).standard_normal(want.shape)  # weights of the VJP

    xt = torch.tensor(x, requires_grad=True)
    got = tfn(xt)
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-10, atol=1e-10)

    (grad,) = torch.autograd.grad((got * torch.as_tensor(w)).sum(), xt)
    want_grad = jax.grad(lambda v: jnp.sum(jfn(v) * w))(jnp.asarray(x))
    assert np.isfinite(grad.numpy()).all()
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), rtol=1e-10, atol=1e-10)


def test_constants_match_jax():
    np.testing.assert_array_equal(tb.spherical_bessel_zeros(4, 3), jb.spherical_bessel_zeros(4, 3))
    np.testing.assert_array_equal(tb.chi_norm_constants(RC, 3, 3), jb.chi_norm_constants(RC, 3, 3))
    np.testing.assert_array_equal(tb.racah_l_index(4), jb.racah_l_index(4))
