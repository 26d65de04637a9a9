"""Planar transform engine surface: one- and n-axis c2c, r2c and c2r on
planar tensors, dispatched to the Stockham kernels of ``butterfly``.

Port of the dispatch part of ``mpi4py_fft_tpu/ops/matfft.py`` (``planar``,
``unplanar``, ``_pmul`` :393-408; ``fft1d_p`` :606, ``fftn_p`` :640,
``rfftn_p`` :646, ``irfftn_p`` :688).

Planar complex: a complex array of shape S is a real tensor of shape
(2,) + S, index 0 the real part and 1 the imaginary part.  Axes are
counted without the leading planar dim.

Only the kernel path exists in this slice: lengths the kernels do not
take (not 2^a or 3*2^a, or over 1024) raise NotImplementedError until the
fallback engine arrives (ROADMAP Queue 1 item 2).
"""
import torch

from . import butterfly

__all__ = ['planar', 'unplanar', 'fft1d_p', 'fftn_p', 'rfftn_p',
           'irfftn_p']


def planar(z):
    """Complex tensor or array -> planar real tensor (2,) + z.shape."""
    z = torch.as_tensor(z)
    return torch.stack([z.real, z.imag])


def unplanar(p):
    """Planar real tensor -> complex tensor (drops the leading axis)."""
    return torch.complex(p[0], p[1])


def _pmul(a, b):
    """Planar elementwise complex multiply; a, b: (2, ...) broadcastable."""
    re = a[0] * b[0] - a[1] * b[1]
    im = a[0] * b[1] + a[1] * b[0]
    return torch.stack([re, im])


def fft1d_p(p, axis, forward=True, scale=None):
    """Planar c2c transform along ``axis``.  Unnormalized unless ``scale``
    is given (folded into the kernel's last stage)."""
    return butterfly.fft_axis_p(p, axis, forward, scale=scale)


def fftn_p(p, axes, forward=True):
    for a in axes:
        p = fft1d_p(p, a, forward)
    return p


def rfftn_p(x, axes, hext=None):
    """Real input -> planar half spectrum; axes[-1] halved to N//2+1
    (or zero rows up to ``hext`` when given)."""
    a_last = axes[-1] % x.dim()
    y = butterfly.rfft_axis_p(x, a_last, hext=hext)
    for a in axes[:-1]:
        y = fft1d_p(y, a, forward=True)
    return y


def irfftn_p(p, axes, last_size, scale=None):
    """Planar half spectrum -> real output of length ``last_size``.
    Input rows beyond N//2+1 along axes[-1] are ignored; ``scale`` is
    folded into the output."""
    for a in axes[:-1]:
        p = fft1d_p(p, a, forward=False)
    a_last = axes[-1] % (p.dim() - 1)
    return butterfly.irfft_axis_p(p, a_last, int(last_size), scale=scale)
