"""Spectral DNS solver on the planar pipeline: the port of
``examples/spectral_dns_planar.py``.

Taylor-Green initial data, classic RK4 in time and the pseudo-spectral
Navier-Stokes right-hand side in rotational form, with a pressure
projection: 9 r2c/c2r transforms a stage, 36 a step, all through the
port's ``PlanarPFFT``.  Every array is real-typed (planar complex), as in
the JAX example.  The default precision is float64, as there; the plan
runs on CUDA unless ``device`` says otherwise (``device='cpu'`` runs the
kernels' plain versions).

Run on the card:

    python -m mpi4py_fft_torch.examples.spectral_dns_planar 6

(argument M: a 2^M cube; at 64^3 float64 the script checks the reference's
kinetic energy anchor; ``DNS_DTYPE=f`` runs float32).
"""
import os
import sys
from time import time

import numpy as np
import torch

from mpi4py_fft_torch import PlanarPFFT

ENERGY_64 = 0.124953117517      # the reference's anchor at 64^3, T = 0.1


def make_solver(N=(64, 64, 64), L=(2 * np.pi, 4 * np.pi, 4 * np.pi),
                nu=0.000625, dt=0.01, dtype='d', device=None):
    """Return ``(pfft, U_hat, step, energy)``: the plan, the Taylor-Green
    initial state as a planar (3, 2) + spectral-shape tensor, the RK4
    step ``U_hat -> U_hat`` and the kinetic energy of a state."""
    pfft = PlanarPFFT(None, N, dtype=dtype, device=device)
    rdt = pfft.rdtype
    tdt = torch.float32 if rdt == np.float32 else torch.float64
    dev = pfft.device

    k = [np.fft.fftfreq(n, 1. / n) for n in N[:-1]]
    k.append(np.fft.rfftfreq(N[-1], 1. / N[-1]))
    Lp = 2 * np.pi / np.asarray(L)
    spec = pfft.global_shape(True)[1:]
    # each wavenumber component is a rank-1 broadcastable vector; K^2 and
    # the projection are formed from them inside the elementwise passes
    Kv = []
    for i in range(3):
        sh = [1, 1, 1]
        sh[i] = spec[i]
        Kv.append(torch.from_numpy((k[i] * Lp[i]).astype(rdt).reshape(sh))
                  .to(dev))
    K0, K1, K2v = Kv

    a_rk = [1. / 6., 1. / 3., 1. / 3., 1. / 6.]
    b_rk = [0.5, 0.5, 1.]

    fwd = pfft.forward            # real -> planar
    bck = pfft.backward           # planar -> real

    def pmul_i(K_ax, p):
        """planar multiply by (i*K): (re, im) -> (-K*im, K*re)."""
        return torch.stack([-K_ax * p[1], K_ax * p[0]])

    def _project(rhs, U_hat):
        """Pressure projection + viscous term."""
        K2 = K0 * K0 + K1 * K1 + K2v * K2v
        K2s = torch.where(K2 == 0, 1, K2)
        P_hat = (rhs[0] * K0 + rhs[1] * K1 + rhs[2] * K2v) / K2s
        rhs = rhs - torch.stack([P_hat * K0, P_hat * K1, P_hat * K2v])
        return rhs - nu * K2 * U_hat

    def compute_rhs(U_hat):
        u = [bck(U_hat[j]) for j in range(3)]
        w = [bck(pmul_i(K1, U_hat[2]) - pmul_i(K2v, U_hat[1])),
             bck(pmul_i(K2v, U_hat[0]) - pmul_i(K0, U_hat[2])),
             bck(pmul_i(K0, U_hat[1]) - pmul_i(K1, U_hat[0]))]
        rhs = torch.stack([fwd(u[1] * w[2] - u[2] * w[1]),
                           fwd(u[2] * w[0] - u[0] * w[2]),
                           fwd(u[0] * w[1] - u[1] * w[0])])
        return _project(rhs, U_hat)

    def step(U_hat):
        """One RK4 step: 4 right-hand sides of 9 transforms each."""
        U_hat0 = U_hat
        U_hat1 = U_hat
        for rk in range(4):
            dU = compute_rhs(U_hat)
            if rk < 3:
                U_hat = U_hat0 + b_rk[rk] * dt * dU
            U_hat1 = U_hat1 + a_rk[rk] * dt * dU
        return U_hat1

    # The JAX example also has a split step (one program per RK stage)
    # and a per-pipeline step (one program per transform), which exist
    # only to keep its compiled XLA programs within the compiler's limits.
    # PyTorch runs eagerly, so all three are this same step.
    step.split = step
    step.perpipe = step

    # Taylor-Green velocity, built per axis on the device in float64
    X = [torch.arange(n, dtype=torch.float64, device=dev) * L[i] / N[i]
         for i, n in enumerate(N)]
    s = [torch.sin(x) for x in X]
    c = [torch.cos(x) for x in X]
    u0 = (s[0][:, None, None] * c[1][None, :, None]
          * c[2][None, None, :]).to(tdt)
    u1 = (-c[0][:, None, None] * s[1][None, :, None]
          * c[2][None, None, :]).to(tdt)
    U_hat = torch.stack([fwd(u0), fwd(u1),
                         fwd(torch.zeros(tuple(N), dtype=tdt, device=dev))])
    del u0, u1

    def energy(U_hat):
        U = torch.stack([bck(U_hat[i]) for i in range(3)])
        return float(torch.sum(U * U)) / N[0] / N[1] / N[2] / 2

    return pfft, U_hat, step, energy


def run(N=(64, 64, 64), T=0.1, dt=0.01, dtype='d', verbose=True,
        device=None):
    """Integrate the Taylor-Green vortex to time T; return the kinetic
    energy."""
    pfft, U_hat, step, energy = make_solver(N=N, dt=dt, dtype=dtype,
                                            device=device)
    t, nsteps = 0.0, 0
    t0 = time()
    while t < T - 1e-8:
        t += dt
        nsteps += 1
        U_hat = step(U_hat)
    if U_hat.is_cuda:
        torch.cuda.synchronize(U_hat.device)
    k = energy(U_hat)
    if verbose:
        print(f'Time = {time() - t0:.3f} s  ({nsteps} steps)')
        print(f'Energy = {k:.12f}')
    return k


if __name__ == '__main__':
    M = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    n = 2 ** M
    dtype = os.environ.get('DNS_DTYPE', 'd')
    k = run(N=(n, n, n), dtype=dtype)
    if n == 64 and dtype == 'd':
        assert round(k - ENERGY_64, 7) == 0, k
        print('energy check PASSED')
