"""Plain reference of the dealiased spectral DNS of mpi4py-fft's
``examples/spectral_dns_solver.py``: the rotational-form Navier-Stokes
right-hand side with a pressure projection, classic RK4.

Transforms are 3-D ``torch.fft`` plans on the padded grid, with
mpi4py-fft's 3/2 rule written out (``libfft.py`` ``_padding_backward``
and ``_truncation_forward``): a complex axis of even length N is padded
with its Nyquist row halved into both the +N/2 and -N/2 rows, and
truncated with the two rows summed back; the halved real axis (N//2 + 1
rows, odd here) is padded with zeros and truncated by a cut.  The
forward of the padded plan is normalized by the padded grid, its
backward is not.  mpi4py-fft's c2r runs its axes one stage at a time and
FFTW's 1-D c2r reads the imaginary part of the real axis's DC row as 0,
which is the inverse of the Hermitian part of that plane: the backward
takes that part before the 3-D c2r.
"""
import math

import numpy as np
import torch

TYPES = {'d': torch.float64, 'f': torch.float32}


def _pad_c(U, axis, M):
    N = U.shape[axis]
    h = N // 2
    sh = list(U.shape)
    sh[axis] = M
    out = U.new_zeros(sh)
    out.narrow(axis, 0, h + 1).copy_(U.narrow(axis, 0, h + 1))
    out.narrow(axis, M - h, h).copy_(U.narrow(axis, N - h, h))
    if N % 2 == 0:
        out.narrow(axis, h, 1).mul_(0.5)
        out.narrow(axis, M - h, 1).mul_(0.5)
    return out


def _trunc_c(P, axis, N):
    M = P.shape[axis]
    h = N // 2
    sh = list(P.shape)
    sh[axis] = N
    out = P.new_zeros(sh)
    out.narrow(axis, 0, h + 1).copy_(P.narrow(axis, 0, h + 1))
    out.narrow(axis, N - h, h).add_(P.narrow(axis, M - h, h))
    return out


def _pad_r(U, axis, Mh):
    N = U.shape[axis]
    sh = list(U.shape)
    sh[axis] = Mh
    out = U.new_zeros(sh)
    out.narrow(axis, 0, N).copy_(U)
    if N % 2 == 0:
        out.narrow(axis, N - 1, 1).real.mul_(0.5)
        out.narrow(axis, N - 1, 1).imag.zero_()
    return out


def _trunc_r(P, axis, N):
    out = P.narrow(axis, 0, N).clone()
    if N % 2 == 0:
        out.narrow(axis, N - 1, 1).real.mul_(2.0)
        out.narrow(axis, N - 1, 1).imag.zero_()
    return out


class Solver(object):
    """The solver of ``cfg`` on ``device`` in precision ``dtype``."""

    def __init__(self, cfg, device, dtype='d'):
        self.rt = TYPES[dtype]
        self.N = [int(n) for n in cfg['N']]
        self.M = [int(round(n * p)) for n, p in zip(self.N, cfg['padding'])]
        L = [p * math.pi for p in cfg['L_over_pi']]
        self.nu, self.dt = cfg['nu'], cfg['dt']
        N = self.N
        k = [np.fft.fftfreq(n, 1. / n) for n in N[:-1]]
        k.append(np.fft.rfftfreq(N[-1], 1. / N[-1]))
        self.K = []
        for i in range(3):
            sh = [1, 1, 1]
            sh[i] = len(k[i])
            Ki = torch.tensor(k[i] * (2 * math.pi / L[i]), dtype=torch.float64)
            self.K.append(Ki.reshape(sh).to(device=device, dtype=self.rt))
        K = self.K
        self.K2 = K[0] * K[0] + K[1] * K[1] + K[2] * K[2]
        K2s = torch.where(self.K2 == 0, torch.ones_like(self.K2), self.K2)
        self.K_over_K2 = [Ki / K2s for Ki in K]

    def initial(self, u):
        """The spectral state of a (3,) + N physical field: the normalized
        r2c of each component."""
        u = u.to(self.rt)
        return torch.stack([torch.fft.rfftn(u[i], norm='forward')
                            for i in range(3)])

    def backward(self, U, out=None):
        """Padded backward: N0 x N1 x (N2//2 + 1) spectrum -> M real grid,
        unnormalized (into ``out`` where given)."""
        M = self.M
        P = _pad_r(_pad_c(_pad_c(U, 0, M[0]), 1, M[1]), 2, M[2] // 2 + 1)
        for k in (0, M[2] // 2):
            # the plane's Hermitian part: (P[i, j] + conj(P[-i, -j])) / 2
            p = P[:, :, k]
            q = p.flip(0, 1).roll((1, 1), (0, 1)).conj()
            p.add_(q).mul_(0.5)
        return torch.fft.irfftn(P, s=M, norm='forward', out=out)

    def forward(self, u):
        """Padded forward: M real grid -> truncated spectrum, normalized
        by the padded grid."""
        N, M = self.N, self.M
        P = _trunc_r(torch.fft.rfftn(u), 2, N[2] // 2 + 1)
        P = _trunc_c(_trunc_c(P, 1, N[1]), 0, N[0])
        return P.mul_(1.0 / (M[0] * M[1] * M[2]))

    def rhs(self, U):
        K = self.K
        u = U.new_empty((3,) + tuple(self.M), dtype=self.rt)
        w = torch.empty_like(u)
        for j in range(3):
            self.backward(U[j], out=u[j])
        curl = (1j * (K[1] * U[2] - K[2] * U[1]),
                1j * (K[2] * U[0] - K[0] * U[2]),
                1j * (K[0] * U[1] - K[1] * U[0]))
        for j in range(3):
            self.backward(curl[j], out=w[j])
        del curl
        uw = torch.linalg.cross(u, w, dim=0)
        del u, w
        nl = torch.stack([self.forward(uw[j]) for j in range(3)])
        del uw
        P = nl[0] * self.K_over_K2[0] + nl[1] * self.K_over_K2[1] \
            + nl[2] * self.K_over_K2[2]
        for i in range(3):
            nl[i] -= P * K[i]
            nl[i] -= self.nu * self.K2 * U[i]
        return nl

    def step(self, U):
        """One classic RK4 step."""
        a = [1. / 6., 1. / 3., 1. / 3., 1. / 6.]
        b = [0.5, 0.5, 1.]
        U0, U1 = U, U
        for rk in range(4):
            dU = self.rhs(U)
            if rk < 3:
                U = U0 + b[rk] * self.dt * dU
            U1 = U1 + a[rk] * self.dt * dU
            del dU
        return U1


def run(cfg, u, steps, device, dtype='d'):
    """The state after ``steps`` RK4 steps from the physical field ``u``."""
    s = Solver(cfg, device, dtype)
    U = s.initial(u)
    for _ in range(steps):
        U = s.step(U)
    return U
