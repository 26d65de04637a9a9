"""The port's spectral DNS example (mpi4py_fft_torch/examples/
spectral_dns_planar.py) against the JAX package's
(examples/spectral_dns_planar.py), on the CPU.

Both solvers start from the same Taylor-Green field at 32^3 float64 and
take two RK4 steps (72 r2c/c2r transforms); the states are held at
relative L2 2e-10, the reference's f64 tolerance (tests/test_ds.py:18).
They also take two steps from a seeded random solenoidal field with its
Nyquist modes, whose c2r inputs have imaginary DC and Nyquist rows: the
port's c2r reads them as real, as the JAX CPU c2r and numpy do.  The
port's solver also reproduces the reference's kinetic-energy anchor at
64^3 on its CPU path.
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


def _solenoidal(pfft, L, seed):
    """A seeded random velocity field's spectrum (3, 2) + spectral shape,
    projected onto divergence-free fields (K . U = 0), Nyquist modes
    kept: the spectrum of a real field whose curl i K x U is not one at
    the Nyquist wavenumbers."""
    N = pfft.global_shape(False)
    rng = np.random.default_rng(seed)
    U = np.stack([pfft.forward(torch.from_numpy(rng.standard_normal(N)))
                  .numpy() for _ in range(3)])
    k = [np.fft.fftfreq(n, 1. / n) for n in N[:-1]]
    k.append(np.fft.rfftfreq(N[-1], 1. / N[-1]))
    K = np.meshgrid(*[ki * 2 * np.pi / li for ki, li in zip(k, L)],
                    indexing='ij', sparse=True)
    K2 = sum(Ki * Ki for Ki in K)
    KdotU = sum(Ki * U[i] for i, Ki in enumerate(K))
    return U - np.stack([Ki * KdotU / np.where(K2 == 0, 1, K2) for Ki in K])


def test_dns_random_field_vs_jax():
    """Two RK4 steps of both solvers from the same random solenoidal field
    at 32^3 float64 (``_solenoidal``), held at 2e-10."""
    import jax.numpy as jnp
    import spectral_dns_planar as jdns
    N = (32, 32, 32)
    L = (2 * np.pi, 4 * np.pi, 4 * np.pi)
    _, _, jstep, _ = jdns.make_solver(N=N, L=L, dtype='d')
    pfft, _, step, _ = tdns.make_solver(N=N, L=L, dtype='d', device='cpu')
    U = _solenoidal(pfft, L, 7)
    assert U.shape == (3, 2, 32, 32, 17)
    assert np.abs(U[:, :, 16]).max() > 0.1 * np.abs(U).max()   # Nyquist
    J, P = jnp.asarray(U), torch.from_numpy(U)
    for _ in range(2):
        J = jstep(J)
        P = step(P)
    assert np.isfinite(P.numpy()).all()
    assert _rel(P, J) < D_TOL


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
