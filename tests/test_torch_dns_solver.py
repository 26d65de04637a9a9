"""The port's reference spectral DNS solver (mpi4py_fft_torch/examples/
spectral_dns_solver.py, on the port's ``PFFT``) against the JAX package's
(examples/spectral_dns_solver.py), on the CPU.

Both solvers start from the same Taylor-Green field and take two RK4
steps (72 transforms); the states are held at relative L2 2e-10, the
reference's f64 tolerance.  Dealiased (``padding=True``, the 3/2-rule
plan on a 24^3 grid) at 16^3; unpadded at 32^3.  Every c2r of the port
reads the imaginary parts of the DC and Nyquist rows as 0, as the JAX
CPU c2r does, so the two agree from any state
(tests/test_torch_dns.py steps a random one).  The 64^3 energy anchor runs
on the card (tests/test_torch_cuda.py): the plain CPU path takes too long
for the test suite.
"""
import os
import sys

import numpy as np
import pytest
import torch

from mpi4py_fft_torch.examples import spectral_dns_solver as tdns

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'examples'))

D_TOL = 2e-10


def _rel(got, ref):
    got = np.asarray(got)
    ref = np.asarray(ref)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _jit_transforms(jdns, monkeypatch):
    """Jit the JAX solver's ``fn``s: its step is jitted anyway, but the
    initial forwards run eagerly, and each eager call of the shard_map
    executor on the CPU mesh takes seconds."""
    import jax
    base = jdns.PFFT

    def pfft(*a, **kw):
        fft = base(*a, **kw)
        for t in (fft.forward, fft.backward):
            t.fn = jax.jit(t.fn, static_argnames='normalize')
        return fft

    monkeypatch.setattr(jdns, 'PFFT', pfft)


@pytest.mark.parametrize('n,padding', [(16, True), (32, False)])
def test_dns_solver_vs_jax(n, padding, monkeypatch):
    import spectral_dns_solver as jdns
    _jit_transforms(jdns, monkeypatch)
    N = (n,) * 3
    _, J, jstep, _ = jdns.make_solver(N=N, padding=padding)
    fft, P, step, _ = tdns.make_solver(N=N, padding=padding, device='cpu')
    assert P.dtype == torch.complex128 and P.device.type == 'cpu'
    assert tuple(P.shape) == tuple(J.shape) == (3, n, n, n // 2 + 1)
    assert _rel(P.numpy(), J) < D_TOL
    for _ in range(2):
        J = jstep(J)
        P = step(P)
    assert _rel(P.numpy(), J) < D_TOL


def test_dns_solver_default_device_is_cuda():
    """No CUDA and no device='cpu': raise, never carry on on the CPU."""
    if torch.cuda.is_available():
        fft, U_hat, _, _ = tdns.make_solver(N=(16, 16, 16))
        assert fft.device.type == 'cuda' and U_hat.is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdns.make_solver(N=(16, 16, 16))
