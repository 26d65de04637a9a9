"""Plain reference of the complex c2c plan ``PlanarPFFT(None, N,
dtype='D')``: ``torch.fft.fftn`` and ``ifftn`` over every axis of a
complex128 tensor.

The forward is normalized by the whole grid, 1 / (N0 N1 N2), as the
plan's forward normalizes; the backward is unscaled.  The plan keeps a
complex field planar, a real tensor (2,) + N of its real and imaginary
parts; :func:`to_complex` converts at the edge.
"""
import torch


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_complex(p):
    """The complex tensor of a planar (2,) + N tensor (a copy)."""
    return torch.complex(p[0], p[1])


def forward(z, cfg):
    """The plan's forward of the complex field ``z``, normalized."""
    _no_tf32()
    return torch.fft.fftn(z, norm='forward')


def backward(Z, cfg):
    """The plan's backward of the spectrum ``Z``, unscaled."""
    _no_tf32()
    return torch.fft.ifftn(Z, norm='forward')
