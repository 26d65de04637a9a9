"""Spectral DNS solver on the reference API: the port of
``examples/spectral_dns_solver.py``.

Taylor-Green initial data, classic RK4 in time and the pseudo-spectral
Navier-Stokes right-hand side in rotational form, with a pressure
projection: 9 transforms a stage, 36 a step, through the port's ``PFFT``
with the reference's calls, ``forward.fn``/``backward.fn`` on complex
tensors (each pays one planar copy in and one out).  ``padding=True``
runs the nonlinear term on the 3/2-rule dealiased grid
(``padding=[1.5]*3``), whose padded c2c stages take the fused kernel
``fft_axis_tp``.  Float64, as in the reference; the plans run on CUDA
unless ``device`` says otherwise (``device='cpu'`` runs the kernels'
plain versions).

Run on the card:

    python -m mpi4py_fft_torch.examples.spectral_dns_solver 6

(argument M: a 2^M cube; at 64^3 the script checks the reference's
kinetic-energy anchor; ``DNS_PADDING=1`` dealiases).
"""
import os
import sys
from time import time

import numpy as np
import torch

from mpi4py_fft_torch import PFFT
from mpi4py_fft_torch.ops import dns_algebra as algebra
from mpi4py_fft_torch.utils.profiling import annotate

ENERGY_64 = 0.124953117517      # the reference's anchor at 64^3, T = 0.1


def make_solver(N=(64, 64, 64), L=(2 * np.pi, 4 * np.pi, 4 * np.pi),
                nu=0.000625, dt=0.01, padding=False, device=None):
    """Return ``(fft, U_hat, step, energy)``: the unpadded plan, the
    Taylor-Green initial state as a complex (3,) + spectral-shape tensor,
    the RK4 step ``U_hat -> U_hat`` and the kinetic energy of a state."""
    fft = PFFT(None, list(N), collapse=False, dtype='d', device=device)
    fft_pad = (PFFT(None, list(N), padding=[1.5, 1.5, 1.5], dtype='d',
                    device=fft.device) if padding else fft)
    dev = fft.device

    # wavenumbers (reference: spectral_dns_solver.py:51-61): each
    # component a broadcastable rank-1 tensor; the algebra's kernels form
    # K^2 and K/K^2 from them per element
    k = [np.fft.fftfreq(n, 1. / n).astype(int) for n in N[:-1]]
    k.append(np.fft.rfftfreq(N[-1], 1. / N[-1]).astype(int))
    Lp = 2 * np.pi / np.asarray(L)
    K = []
    for i in range(3):
        sh = [1, 1, 1]
        sh[i] = len(k[i])
        K.append(torch.from_numpy((k[i] * Lp[i]).astype(float).reshape(sh))
                 .to(dev))

    a = [1. / 6., 1. / 3., 1. / 3., 1. / 6.]
    b = [0.5, 0.5, 1.]

    fwd = fft_pad.forward.fn        # normalized forward
    bck = fft_pad.backward.fn       # unnormalized backward

    def compute_rhs(U_hat):
        """The nonlinear term of the right-hand side (reference:
        spectral_dns_solver.py:82-91): the three forwards N_j of
        (u x curl u)_j, which ``algebra.project_rk`` projects; the span
        ``dns.rhs``.  The curl is taken first, so that its spectra are
        freed before the velocity's backwards."""
        with annotate('dns.rhs'):
            W_hat = algebra.curl(U_hat, K)
            w = [bck(W_hat[j]) for j in range(3)]
            del W_hat
            u = [bck(U_hat[j]) for j in range(3)]
            algebra.cross(u, w)
            del u
            # each grid freed once its forward has read it
            return [fwd(w.pop(0)) for _ in range(3)]

    def step(U_hat):
        """One RK4 step (reference: spectral_dns_solver.py:104-113); the
        span ``dns.step``.  Each stage ends in one ``project_rk`` launch:
        the pressure projection, the viscous term and both updates.  The
        first writes new buffers; later stages update them in place, so
        ``U_hat`` is never written."""
        with annotate('dns.step'):
            U_hat0 = U_hat1 = U = U_hat
            for rk in range(4):
                N = compute_rhs(U)
                U, U_hat1 = algebra.project_rk(
                    N, U, U_hat0, U_hat1, K, nu, a[rk] * dt,
                    b[rk] * dt if rk < 3 else None, inplace=rk > 0)
                del N
            return U_hat1

    # Taylor-Green velocity (reference: :44-49, :94-98), built per axis on
    # the device in float64
    X = [torch.arange(n, dtype=torch.float64, device=dev) * L[i] / N[i]
         for i, n in enumerate(N)]
    s = [torch.sin(x) for x in X]
    c = [torch.cos(x) for x in X]
    ffwd = fft.forward.fn
    u0 = s[0][:, None, None] * c[1][None, :, None] * c[2][None, None, :]
    U0 = ffwd(u0)
    del u0
    u1 = -c[0][:, None, None] * s[1][None, :, None] * c[2][None, None, :]
    U_hat = torch.stack([U0, ffwd(u1), torch.zeros_like(U0)])
    del u1, U0

    def energy(U_hat):
        e = 0.0
        for i in range(3):
            U = fft.backward.fn(U_hat[i])
            e += float(torch.sum(U * U))
        return e / N[0] / N[1] / N[2] / 2

    return fft, U_hat, step, energy


def run(N=(64, 64, 64), T=0.1, dt=0.01, padding=False, verbose=True,
        device=None):
    """Integrate the Taylor-Green vortex to time T; return the kinetic
    energy."""
    fft, U_hat, step, energy = make_solver(N=N, dt=dt, padding=padding,
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
    padding = os.environ.get('DNS_PADDING', '0') not in ('0', '')
    k = run(N=(n, n, n), padding=padding)
    if n == 64 and not padding:
        assert round(k - ENERGY_64, 7) == 0, k
        print('energy check PASSED')
