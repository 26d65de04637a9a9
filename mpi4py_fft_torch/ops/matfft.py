"""Planar transform engine surface: one- and n-axis c2c, r2c and c2r on
planar tensors, dispatched to the Stockham kernels of ``butterfly``.

Port of the dispatch part of ``mpi4py_fft_tpu/ops/matfft.py`` (``planar``,
``unplanar``, ``_pmul`` :393-408; ``fft1d_p`` :606, ``fftn_p`` :640,
``rfftn_p`` :646, ``irfftn_p`` :688) and of its long-axis routes
(``_use_butterfly_pair``/``_butterfly_pair`` :176-215,
``_butterfly_large_split``/``_butterfly_large`` :218-315, with
``_twiddle`` :362 and ``_combine_small`` :509).

Planar complex: a complex array of shape S is a real tensor of shape
(2,) + S, index 0 the real part and 1 the imaginary part.  Axes are
counted without the leading planar dim.

Only the kernel routes exist so far.  A c2c axis takes ``fft_axis_p`` for
2^a or 3*2^a up to 1024, one ``fft_axis_pair_p`` pass for 1536 and 2048,
and the four-step around ``fft_axis_p`` for 4096; r2c and c2r take
``rfft_axis_p``/``irfft_axis_p`` up to 1024 on their real axis.  Other
lengths raise NotImplementedError until the fallback engine arrives
(ROADMAP Queue 1 item 2).

float32 and float64 share this dispatch: the kernels' fp64 builds take
the place of the JAX package's separate double-single engine
(``pallas_ds``).  On CUDA, float64 axes over 1024 (the pair kernel and
the four-step) raise NotImplementedError until the pair kernel has its
fp64 build.
"""
import functools

import numpy as np
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


# ---------------------------------------------------------------------------
# the four-step for axes longer than the pair kernel takes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _twiddle(N1, N2, sign, dtype_str):
    """(2, N1, N2) planar twiddle exp(sign*2j*pi*k1*n2/(N1*N2)), built in
    numpy float64 and cast, as the JAX package does."""
    k1 = np.arange(N1)[:, None]
    n2 = np.arange(N2)[None, :]
    ang = sign * 2 * np.pi * k1 * n2 / (N1 * N2)
    W = np.stack([np.cos(ang), np.sin(ang)])
    return W.astype(np.dtype(dtype_str))


@functools.lru_cache(maxsize=None)
def _twiddle_tensor(N1, N2, sign, dtype, device):
    name = str(dtype).replace('torch.', '')
    return torch.tensor(_twiddle(N1, N2, sign, name), dtype=dtype,
                        device=device)


def _four_step_split(shape, axis):
    """(R, Q, dit) of the four-step N = R*Q around the Q = 1024-point
    kernel for a power-of-two axis past the pair kernel's 2048 (so
    N = 4096, R = 4), else None.  DIT (kernel first) when nothing comes
    before the axis, DIF otherwise, as ``_butterfly_large_split``
    chooses."""
    N = shape[axis]
    Q = butterfly._MAX_N_AXIS
    if N <= butterfly._MAX_N_PAIR or N & (N - 1) or not 2 <= N // Q <= 4:
        return None
    pre, _ = butterfly._pre_post(shape, axis)
    return N // Q, Q, pre == 1


def _pmul_(a, b):
    """a *= b, planar; b broadcasts against a.  One half-volume
    temporary at a time."""
    ar, ai = a[0], a[1]
    t = ar * b[1]
    ar.mul_(b[0]).sub_(ai * b[1])
    ai.mul_(b[0]).add_(t)
    return a


def _combine_small(z, R, axis, sign, out):
    """Elementwise DFT-R (R = 2, 4) over the length-R planar-coords
    ``axis`` of z, written into ``out`` (z's shape, any strides): the
    four-step's outer stage, with the same terms as the JAX package's."""
    def at(v, j):
        return v.narrow(axis, j, 1)

    if R == 2:
        torch.add(at(z, 0), at(z, 1), out=at(out, 0))
        torch.sub(at(z, 0), at(z, 1), out=at(out, 1))
        return out
    z0, z1, z2, z3 = (at(z, j) for j in range(4))
    t0, t1 = z0 + z2, z1 + z3
    torch.add(t0, t1, out=at(out, 0))
    torch.sub(t0, t1, out=at(out, 2))
    del t0, t1
    t2, t3 = z0 - z2, z1 - z3
    # exp(sign*i*pi/2) * t3 = sign * (-im, re)
    u3 = sign * torch.cat([-t3[1:2], t3[0:1]], dim=0)
    del t3
    torch.add(t2, u3, out=at(out, 1))
    torch.sub(t2, u3, out=at(out, 3))
    return out


def _butterfly_large(p, axis, sign, split):
    """Four-step long-axis transform: the outer radix-R stage, the
    twiddle and the interleave in plain torch (XLA's part in the JAX
    package) around one ``fft_axis_p`` pass over the Q-point sub-axis.

    DIF (batch present): y[r, n2] = sum_n1 x[n1, n2] wR^(n1 r); twiddle
    wN^(r n2); kernel over n2; X[k2*R + r] -> swap (R, Q), flatten.
    DIT (pre == 1): kernel over n2 of x[n2, n1]; twiddle wN^(n1 k2);
    combine over n1 straight into the (k1, k2) order of X[k1*Q + k2].
    The twiddle is applied in place and the combine writes into its
    output, so beside the kernel's output and the result the glue's
    temporaries stay under a volume."""
    R, Q, dit = split
    ax = 1 + axis
    shape = tuple(p.shape)
    lead = (1,) * (ax - 1)
    trail = (1,) * (p.dim() - ax - 1)
    tw = _twiddle_tensor(R, Q, sign, p.dtype, p.device)       # (2, R, Q)
    fwd = sign == -1
    if dit:
        x = p.reshape(shape[:ax] + (Q, R) + shape[ax + 1:])
        z = butterfly.fft_axis_p(x, axis, forward=fwd)
        _pmul_(z, tw.transpose(1, 2).reshape((2,) + lead + (Q, R) + trail))
        out = p.new_empty(shape[:ax] + (R, Q) + shape[ax + 1:])
        _combine_small(z, R, ax + 1, sign, out.transpose(ax, ax + 1))
        return out.reshape(shape)
    x = p.reshape(shape[:ax] + (R, Q) + shape[ax + 1:])
    y = _combine_small(x, R, ax, sign, torch.empty_like(x))  # r at ax
    _pmul_(y, tw.reshape((2,) + lead + (R, Q) + trail))
    c = butterfly.fft_axis_p(y, axis + 1, forward=fwd)
    del y
    return c.transpose(ax, ax + 1).reshape(shape)


def fft1d_p(p, axis, forward=True, scale=None):
    """Planar c2c transform along ``axis``.  Unnormalized unless ``scale``
    is given (folded into the kernel's last stage)."""
    shape = tuple(p.shape[1:])
    axis = axis % len(shape)
    N = shape[axis]
    if butterfly.supported_axis(shape, axis):
        return butterfly.fft_axis_p(p, axis, forward, scale=scale)
    half = shape[:axis] + (N // 2,) + shape[axis + 1:]
    pair = N > butterfly._MAX_N_AXIS and \
        butterfly.supported_axis_split(half, axis)
    split = None if pair else _four_step_split(shape, axis)
    if not pair and split is None:
        raise butterfly._unsupported_length(
            'fft1d_p', N, "2^a or 3*2^a up to 2048, or 4096")
    if p.device.type == 'cuda' and p.dtype == torch.float64:
        raise butterfly._no_f64_pair('fft1d_p')
    if pair:
        return butterfly.fft_axis_pair_p(p, axis, forward, scale=scale)
    y = _butterfly_large(p, axis, -1 if forward else +1, split)
    if scale is not None:
        y.mul_(scale)
    return y


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
