"""The port's ``elastic`` CLI against the JAX package's on the same file, on
the CPU, from JAX's seeded initial weights (recorded and written as a port
checkpoint, as in ``test_torch_cli_predict.py``), both in float32: the 6x6
elastic matrix, the Voigt bulk modulus, the Gamma frequencies (with the
masses table, and with a ``masses_amu`` override), the E(V) curve and its
Birch-Murnaghan fit, or its graceful error when the window holds no minimum.

JAX's ``jax.hessian`` needs its default CPU mode (gather: the factorized
mode's custom VJPs have no forward mode); the port runs its factorized mode
(nested ``torch.autograd.grad``). Second derivatives in float32 through two
algorithms: within rtol 1e-4 of each entry, atol 1e-6 (GPa, eV, A^3). The
Gamma frequencies are compared as the dynamical matrix's eigenvalues
sign(f) f^2, which float32 computes, at rtol 1e-4 and atol 1e-4 of the
largest: the three acoustic modes are zero in exact arithmetic, and float32
leaves eigenvalues of ~1e-9 THz^2 there whose square roots (~1e-4 THz, of
either sign) are rounding, not physics.
"""

import json

import numpy as np
import pytest

from torch_m3gnet_tpu.cli import elastic as jax_elastic
from torch_m3gnet_tpu_torch.cli import elastic

from test_torch_cli_predict import RTOL, FCC, assert_close, record_jax_init, run_jax, run_port
from test_torch_cli_predict import write_config, write_port_checkpoint


@pytest.mark.parametrize("masses", [None, [63.5, 63.5, 100.0, 100.0]])
def test_elastic_matches_jax(tmp_path, monkeypatch, capsys, masses):
    rng = np.random.default_rng(4)
    cell = {"lattice": (np.eye(3) * 3.62).tolist(),
            "frac_coords": (np.array(FCC) + 0.005 * rng.standard_normal((4, 3))).tolist(),
            "atomic_numbers": [29] * 4}
    if masses is not None:
        cell["masses_amu"] = masses
    path = tmp_path / "cell.json"
    path.write_text(json.dumps([cell]))
    args = ["--structure", str(path), "--config", write_config(tmp_path), "--eos",
            "--eos-points", "7"]
    params = record_jax_init(monkeypatch)
    want = run_jax(monkeypatch, capsys, jax_elastic.main, args)
    ckpt = write_port_checkpoint(tmp_path / "best", params[0])
    got = run_port(capsys, elastic.main, [*args, "--checkpoint", ckpt, "--device", "cpu"])
    assert set(want) == {"elastic_gpa", "bulk_modulus_voigt_gpa", "gamma_frequencies_thz",
                         "eos_volumes_a3", "eos_energies_ev", "birch_murnaghan"}
    freqs = [np.asarray(out.pop("gamma_frequencies_thz")) for out in (got, want)]
    assert_close(got, want)
    eig = [np.sign(f) * f**2 for f in freqs]
    np.testing.assert_allclose(eig[0], eig[1], rtol=RTOL, atol=RTOL * np.abs(eig[1]).max())
    assert (np.sort(np.abs(freqs[1]))[3:] > 0.1).all()  # the other nine are resolved
    skipped = run_port(capsys, elastic.main, [*args, "--checkpoint", ckpt, "--device", "cpu",
                                              "--skip-phonons"])
    assert "gamma_frequencies_thz" not in skipped and skipped["elastic_gpa"] == got["elastic_gpa"]
