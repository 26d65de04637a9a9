"""The port's spectral DNS example (mpi4py_fft_torch/examples/
spectral_dns_planar.py) against the JAX package's
(examples/spectral_dns_planar.py), on the CPU.

Both solvers start from the same Taylor-Green field at 32^3 float64 and
take two RK4 steps (72 r2c/c2r transforms); the states are held at
relative L2 2e-10, the reference's f64 tolerance (tests/test_ds.py:18).
Taylor-Green data keeps the imaginary parts of the DC and Nyquist rows at
round-off, where the JAX CPU c2r (which drops them) and the port's packed
c2r (which keeps them) agree; a random field would not.  The port's
solver also reproduces the reference's kinetic-energy anchor at 64^3 on
its CPU path.
"""
import os
import sys

import numpy as np
import pytest
import torch

from mpi4py_fft_torch.examples import spectral_dns_planar as tdns

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'examples'))

D_TOL = 2e-10


def _rel(got, ref):
    got = np.asarray(got)
    ref = np.asarray(ref)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def test_dns_vs_jax():
    import spectral_dns_planar as jdns
    N = (32, 32, 32)
    _, J, jstep, _ = jdns.make_solver(N=N, dtype='d')
    pfft, P, step, _ = tdns.make_solver(N=N, dtype='d', device='cpu')
    assert P.dtype == torch.float64 and P.device.type == 'cpu'
    assert tuple(P.shape) == tuple(J.shape) == (3, 2, 32, 32, 17)
    assert _rel(P, J) < D_TOL
    for _ in range(2):
        J = jstep(J)
        P = step(P)
    assert _rel(P, J) < D_TOL
    # PyTorch runs eagerly: the JAX example's split and per-pipeline
    # steps are this same step
    assert step.split is step and step.perpipe is step


def test_dns_energy_anchor_cpu():
    """The reference's Taylor-Green energy at 64^3, T = 0.1 (10 steps)."""
    k = tdns.run(N=(64, 64, 64), T=0.1, dt=0.01, dtype='d', verbose=False,
                 device='cpu')
    assert round(k - tdns.ENERGY_64, 7) == 0, k


def test_dns_default_device_is_cuda():
    """No CUDA and no device='cpu': raise, never carry on on the CPU."""
    if torch.cuda.is_available():
        pfft, U_hat, _, _ = tdns.make_solver(N=(16, 16, 16))
        assert pfft.device.type == 'cuda' and U_hat.is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdns.make_solver(N=(16, 16, 16))
