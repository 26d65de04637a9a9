"""Plain reference of mpi4py-fft's mixed plan of ``examples/transforms.py``:
``PFFT(None, N, axes=((0,), (1, 2)), transforms={(1, 2): (dctn type 3,
idctn type 3)})``.

Forward: FFTW's REDFT01 (the unnormalized DCT-III) on axes 2 and 1, then
the r2c on axis 0, the whole normalized by 1 / (N0 * 2 N1 * 2 N2).
Backward, unnormalized: the c2r on axis 0 (the imaginary parts of its DC
and Nyquist rows read as 0, as FFTW does), then REDFT10 (the
unnormalized DCT-II) on axes 1 and 2.  The DCTs are dense products with
their cosine matrices (``torch.matmul``, TF32 off), built here in float64.
"""
import math

import torch

TYPES = {'d': (torch.float64, torch.complex128),
         'f': (torch.float32, torch.complex64)}


_MATRICES = {}


def _matrix(n, kind, dtype, device):
    """REDFT01 (``'dct3'``) or REDFT10 (``'dct2'``) as an n x n matrix C
    with y = C x along an axis (built once, for a chain of round trips)."""
    key = (n, kind, dtype, str(device))
    if key not in _MATRICES:
        _MATRICES[key] = _build(n, kind).to(device=device, dtype=dtype)
    return _MATRICES[key]


def _build(n, kind):
    j = torch.arange(n, dtype=torch.float64)
    if kind == 'dct3':
        C = 2 * torch.cos(math.pi * j[None, :] * (2 * j[:, None] + 1)
                          / (2 * n))
        C[:, 0] = 1.0
    else:
        C = 2 * torch.cos(math.pi * (2 * j[None, :] + 1) * j[:, None]
                          / (2 * n))
    return C


def _along(x, C, axis):
    """C applied along ``axis`` of a 3-D tensor."""
    if axis == 2:
        return torch.matmul(x, C.T)
    if axis == 1:
        return torch.matmul(C, x)
    return torch.matmul(C, x.reshape(x.shape[0], -1)).reshape(
        (C.shape[0],) + tuple(x.shape[1:]))


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def forward(x, cfg, dtype='d'):
    """The plan's forward of the real field ``x``."""
    _no_tf32()
    rt, _ = TYPES[dtype]
    x = x.to(rt)
    N = x.shape
    for ax in (2, 1):
        x = _along(x, _matrix(N[ax], 'dct3', rt, x.device), ax)
    X = torch.fft.rfft(x, dim=0)
    return X.mul_(1.0 / (N[0] * 2 * N[1] * 2 * N[2]))


def backward(X, cfg, dtype='d'):
    """The plan's backward of the spectrum ``X`` (unnormalized)."""
    _no_tf32()
    rt, ct = TYPES[dtype]
    N0 = int(cfg['N'][0])
    X = X.to(ct).clone()
    X[0].imag.zero_()
    if N0 % 2 == 0:
        X[N0 // 2].imag.zero_()
    x = torch.fft.irfft(X, n=N0, dim=0, norm='forward')
    for ax in (1, 2):
        x = _along(x, _matrix(x.shape[ax], 'dct2', rt, x.device), ax)
    return x
