"""Planar transform engine: one- and n-axis c2c, r2c and c2r on planar
tensors of any extent, dispatched to the port's kernels, with the
mixed-radix and Bluestein engine for the lengths they do not take.

Port of ``mpi4py_fft_tpu/ops/matfft.py``: ``planar``, ``unplanar``,
``_pmul`` :393-408; the dispatch ``fft1d_p`` :606, ``fftn_p`` :640,
``rfftn_p`` :646, ``irfftn_p`` :688 and the complex wrappers :734-758;
the long-axis routes (``_use_butterfly_pair``/``_butterfly_pair``
:176-215, ``_butterfly_large_split``/``_butterfly_large`` :218-315,
``_combine_small`` :509); and the engine: the tables ``_factorize`` :323,
``_dft_matrix`` :353, ``_twiddle`` :362, ``_bluestein_consts`` :372, the
matmul stages ``_wblock`` :411, ``_pmatstage`` :426, ``_pmatmul_last``
:437, ``_pmatstage_mid`` :539, and the recursions ``_fft_last_p`` :452,
``_bluestein_p`` :482, ``_fft_axis_einsum`` :561 (the default
``_MID_AXIS = 'einsum'`` branch).

Planar complex: a complex array of shape S is a real tensor of shape
(2,) + S, index 0 the real part and 1 the imaginary part.  Axes are
counted without the leading planar dim.

Routes of a c2c axis, in the JAX package's order: ``fft_axis_p`` (A) for
2^a or 3*2^a up to 1024; else one ``fft_axis_pair_p`` pass (G) for 1536
and 2048; else the four-step around A for 4096; else the engine:
``_fft_last_p`` on the last axis, whose f32 lengths S*128 (S <= 8) run
the two-stage kernel J (``fft2stage.fft2stage_p``), or
``_fft_axis_einsum`` on any other axis.  The engine splits N into radices
of at most 32 (``_factorize``): each stage is one batched complex matrix
product, a twiddle and a recursion on the rest; a prime factor over 32
takes Bluestein's chirp-z transform, two power-of-two transforms of
length M >= 2N - 1 on the last axis.  r2c and c2r take ``rfft_axis_p``/
``irfft_axis_p`` (B, C) up to 1024 on their real axis; other real axes
run the c2c route on the stacked real input (r2c) or on the Hermitian
extension of the half spectrum (c2r).

float32 and float64 share this dispatch: the kernels' fp64 builds take
the place of the JAX package's double-single engine (``pallas_ds``).  The
pair pass, the four-step and J are float32 routes, as in the JAX package;
float64 axes over 1024 and every float64 non-kernel length run the
engine.

The engine's matrix products stay ``torch.einsum`` (plain XLA products in
the JAX package) at full float32, the counterpart of the JAX package's
``Precision.HIGHEST``: every product runs under ``_full_f32``, which
keeps cuBLAS out of TF32 whatever the process's global flags say.
"""
import contextlib
import functools

import numpy as np
import torch

from . import butterfly, fft2stage

__all__ = ['planar', 'unplanar', 'fft1d_p', 'fftn_p', 'rfftn_p',
           'irfftn_p', 'fft1d', 'fftn', 'rfftn', 'irfftn']

_BASE_RADIX = 32


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
# tables (numpy, cached, built in float64 and cast, as the JAX package does)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _twiddle(N1, N2, sign, dtype_str):
    """(2, N1, N2) planar twiddle exp(sign*2j*pi*k1*n2/(N1*N2))."""
    k1 = np.arange(N1)[:, None]
    n2 = np.arange(N2)[None, :]
    ang = sign * 2 * np.pi * k1 * n2 / (N1 * N2)
    W = np.stack([np.cos(ang), np.sin(ang)])
    return W.astype(np.dtype(dtype_str))


@functools.lru_cache(maxsize=None)
def _factorize(N):
    """Factor N into radices <= _BASE_RADIX (largest first); a leftover
    prime > _BASE_RADIX is returned as a single (Bluestein) factor."""
    factors = []
    m = N
    for p in range(2, _BASE_RADIX + 1):
        while m % p == 0 and m > _BASE_RADIX:
            factors.append(p)
            m //= p
        if m <= _BASE_RADIX:
            break
    if m > 1:
        factors.append(m)
    factors.sort()
    merged = []
    while factors:
        f = factors.pop()
        while factors and f * factors[0] <= _BASE_RADIX:
            f *= factors.pop(0)
        merged.append(f)
    return tuple(sorted(merged, reverse=True))


@functools.lru_cache(maxsize=None)
def _dft_matrix(N, sign, dtype_str):
    """(2, N, N) planar DFT matrix exp(sign*2j*pi*n*k/N): [0]=cos, [1]=sin."""
    n = np.arange(N)
    ang = sign * 2 * np.pi * np.outer(n, n) / N
    W = np.stack([np.cos(ang), np.sin(ang)])
    return W.astype(np.dtype(dtype_str))


@functools.lru_cache(maxsize=None)
def _bluestein_consts(N, sign, dtype_str):
    """Planar chirp arrays for Bluestein: (w[2,N], fft(b)[2,M], M)."""
    M = 1
    while M < 2 * N - 1:
        M *= 2
    n = np.arange(N)
    ang = sign * np.pi * n * n / N
    w = np.stack([np.cos(ang), np.sin(ang)])
    b = np.zeros(M, dtype=np.complex128)
    wc = np.exp(-1j * ang)
    b[:N] = wc
    b[M - N + 1:] = wc[1:][::-1]
    fb = np.fft.fft(b)
    fbp = np.stack([fb.real, fb.imag])
    return (w.astype(np.dtype(dtype_str)), fbp.astype(np.dtype(dtype_str)), M)


def _dtype_str(dtype):
    return str(dtype).replace('torch.', '')


@functools.lru_cache(maxsize=None)
def _const(table, args, dtype, device):
    """One numpy table (``_twiddle``, the ``_wblock`` of a DFT matrix, or
    a Bluestein array) as a tensor, uploaded once per dtype and device."""
    name = _dtype_str(dtype)
    if table == 'twiddle':
        a = _twiddle(*args, name)
    elif table == 'wblock':
        a = _wblock(_dft_matrix(*args, name))
    else:                                   # 'chirp' or 'chirp_fft'
        w, fb, _ = _bluestein_consts(*args, name)
        a = w if table == 'chirp' else fb
    return torch.tensor(a, dtype=dtype, device=device)


def _twiddle_tensor(N1, N2, sign, dtype, device):
    return _const('twiddle', (N1, N2, sign), dtype, device)


# ---------------------------------------------------------------------------
# the four-step for axes longer than the pair kernel takes
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# the mixed-radix engine: planar matrix stages at full float32
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _full_f32():
    """Run the enclosed products without TF32 (cuBLAS's float32 products
    at full precision, the JAX package's ``Precision.HIGHEST``), and put
    the process's setting back after."""
    m = torch.backends.cuda.matmul
    saved = m.allow_tf32
    m.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32 = saved


def _einsum(expr, a, b):
    with _full_f32():
        return torch.einsum(expr, a, b)


def _wblock(W):
    """Planar W (2, n, k) -> batched block form (2, n, 2k):
    [0] = [Wr | Wi], [1] = [Wi | Wr].  One planar-batched product against
    it gives all four real products of a complex contraction:
        out[0] = [xr Wr | xr Wi],  out[1] = [xi Wi | xi Wr]
        y_re = out[0,:k] - out[1,:k];  y_im = out[0,k:] + out[1,k:]"""
    Wr, Wi = W[0], W[1]
    return np.stack([np.concatenate([Wr, Wi], axis=1),
                     np.concatenate([Wi, Wr], axis=1)])


def _wb(N, sign, p):
    return _const('wblock', (N, sign), p.dtype, p.device)


def _pmatstage(p, Wb):
    """Planar radix stage: p (2, ..., n, t) contracted over n with the
    block form Wb (2, n, 2k) of a planar W -> (2, ..., k, t)."""
    k = Wb.shape[-1] // 2
    out = _einsum('p...nt,pnk->p...kt', p, Wb)
    return torch.stack([out[0, ..., :k, :] - out[1, ..., :k, :],
                        out[0, ..., k:, :] + out[1, ..., k:, :]])


def _pmatmul_last(p, Wb):
    """Planar contraction of the last axis with the block form Wb."""
    k = Wb.shape[-1] // 2
    out = _einsum('p...n,pnk->p...k', p, Wb)
    return torch.stack([out[0, ..., :k] - out[1, ..., :k],
                        out[0, ..., k:] + out[1, ..., k:]])


def _pmatstage_mid(p, Wb, axis):
    """Planar contraction of p's ``axis`` (in planar coords) with the
    block form Wb, output k at the same position."""
    nd = p.dim()
    k = Wb.shape[-1] // 2
    sub = 'abcdefghijklmnoq'[:nd - 1]
    lhs = 'p' + sub[:axis - 1] + 'n' + sub[axis - 1:nd - 2]
    out = 'p' + sub[:axis - 1] + 'k' + sub[axis - 1:nd - 2]
    o = _einsum(f'{lhs},pnk->{out}', p, Wb)
    lo = o.narrow(axis, 0, k)
    hi = o.narrow(axis, k, k)
    return torch.stack([lo[0] - lo[1], hi[0] + hi[1]])


def _fft_last_p(p, sign):
    """Unnormalized planar DFT along the last axis of (2, ..., N);
    sign=-1 forward, +1 inverse (unscaled).  f32 lengths S*128 (S <= 8)
    take J, as the JAX package's ``_use_pallas`` dispatches it."""
    N = p.shape[-1]
    if N == 1:
        return p
    if p.dtype == torch.float32 and fft2stage.supported_length(N):
        return fft2stage.fft2stage_p(p, sign)
    factors = _factorize(N)
    if len(factors) == 1:
        if factors[0] <= _BASE_RADIX:
            return _pmatmul_last(p, _wb(N, sign, p))
        return _bluestein_p(p, sign)
    N1 = factors[0]
    N2 = N // N1
    batch = tuple(p.shape[1:-1])
    x = p.reshape((2,) + batch + (N1, N2))    # x[n1, n2], n = n1*N2 + n2
    a = _pmatstage(x, _wb(N1, sign, p))
    tw = _twiddle_tensor(N1, N2, sign, p.dtype, p.device)
    _pmul_(a, tw.reshape((2,) + (1,) * len(batch) + (N1, N2)))
    c = _fft_last_p(a, sign)                  # c[k1, k2]
    del a
    return c.transpose(-1, -2).reshape((2,) + batch + (N,))  # X[k2*N1+k1]


def _bluestein_p(p, sign):
    """Planar chirp-z transform along the last axis, for a prime length
    over _BASE_RADIX: two transforms of the power of two M >= 2N - 1."""
    N = p.shape[-1]
    M = _bluestein_consts(N, sign, _dtype_str(p.dtype))[2]
    lead = (1,) * (p.dim() - 2)
    w = _const('chirp', (N, sign), p.dtype, p.device).reshape(
        (2,) + lead + (N,))
    fb = _const('chirp_fft', (N, sign), p.dtype, p.device).reshape(
        (2,) + lead + (M,))
    a = p.new_zeros(tuple(p.shape[:-1]) + (M,))
    a[..., :N] = _pmul(p, w)
    fa = _fft_last_p(a, -1)
    del a
    conv = _fft_last_p(_pmul(fa, fb), +1) / M
    del fa
    return _pmul(conv[..., :N], w)


def _fft_axis_einsum(p, axis, sign):
    """Planar DFT along a non-last ``axis`` (complex coords) in place:
    the axis is split with a reshape and contracted where it lies; only
    the final k1 <-> k2 swap moves data."""
    ax = 1 + axis                  # planar coords
    N = p.shape[ax]
    if N == 1:
        return p
    factors = _factorize(N)
    if len(factors) == 1 and factors[0] <= _BASE_RADIX:
        return _pmatstage_mid(p, _wb(N, sign, p), ax)
    if len(factors) == 1:
        # Bluestein needs the axis last
        y = _bluestein_p(p.movedim(ax, -1), sign)
        return y.movedim(-1, ax).contiguous()
    N1 = factors[0]
    N2 = N // N1
    shape = tuple(p.shape)
    x = p.reshape(shape[:ax] + (N1, N2) + shape[ax + 1:])
    a = _pmatstage_mid(x, _wb(N1, sign, p), ax)
    tw = _twiddle_tensor(N1, N2, sign, p.dtype, p.device)
    _pmul_(a, tw.reshape((2,) + (1,) * (ax - 1) + (N1, N2)
                         + (1,) * (len(shape) - ax - 1)))
    c = _fft_axis_einsum(a, axis + 1, sign)
    del a
    # X[k2*N1 + k1]: swap the two split axes, then flatten
    return c.transpose(ax, ax + 1).reshape(shape)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def fft1d_p(p, axis, forward=True, scale=None):
    """Planar c2c transform along ``axis`` of any length.  Unnormalized
    unless ``scale`` is given (folded into the kernel's last stage on the
    kernel routes)."""
    shape = tuple(p.shape[1:])
    axis = axis % len(shape)
    N = shape[axis]
    sign = -1 if forward else +1
    if butterfly.supported_axis(shape, axis):
        return butterfly.fft_axis_p(p, axis, forward, scale=scale)
    f32 = p.dtype == torch.float32
    half = shape[:axis] + (N // 2,) + shape[axis + 1:]
    if f32 and N > butterfly._MAX_N_AXIS and N % 2 == 0 and \
            butterfly.supported_axis_split(half, axis):
        return butterfly.fft_axis_pair_p(p, axis, forward, scale=scale)
    split = _four_step_split(shape, axis) if f32 else None
    if split is not None:
        y = _butterfly_large(p, axis, sign, split)
    elif axis == len(shape) - 1:
        y = _fft_last_p(p, sign)
    else:
        y = _fft_axis_einsum(p, axis, sign)
    if scale is not None:
        y = y * scale
    return y


def fftn_p(p, axes, forward=True):
    for a in axes:
        p = fft1d_p(p, a, forward)
    return p


def rfftn_p(x, axes, hext=None):
    """Real input -> planar half spectrum; axes[-1] halved to N//2+1
    (or zero rows up to ``hext`` when given)."""
    a_last = axes[-1] % x.dim()
    N = x.shape[a_last]
    if butterfly.supported_r2c(tuple(x.shape), a_last):
        y = butterfly.rfft_axis_p(x, a_last, hext=hext)
    else:
        y = fft1d_p(torch.stack([x, torch.zeros_like(x)]), a_last, True)
        nh = N // 2 + 1
        y = y.narrow(1 + a_last, 0, nh)
        if hext is not None and hext > nh:
            pad = [0, 0] * (x.dim() - 1 - a_last) + [0, hext - nh]
            y = torch.nn.functional.pad(y, pad)
        else:
            y = y.contiguous()
    for a in axes[:-1]:
        y = fft1d_p(y, a, forward=True)
    return y


def irfftn_p(p, axes, last_size, scale=None):
    """Planar half spectrum -> real output of length ``last_size``.
    Input rows beyond N//2+1 along axes[-1] are ignored; ``scale`` is
    folded into the output.

    Off the kernel's lengths the half spectrum is extended Hermitian-wise
    (X[N-k] = conj(X[k])) and the real part of a c2c inverse is kept: the
    imaginary parts of the DC and Nyquist rows drop out, as in the JAX
    package's fallback."""
    for a in axes[:-1]:
        p = fft1d_p(p, a, forward=False)
    nd = p.dim() - 1
    a_last = axes[-1] % nd
    N = int(last_size)
    if butterfly.supported_c2r(tuple(p.shape[1:]), a_last, N):
        return butterfly.irfft_axis_p(p, a_last, N, scale=scale)
    nh = N // 2 + 1
    H = p.narrow(1 + a_last, 0, nh).movedim(1 + a_last, -1)
    tail = H[..., 1:(N + 1) // 2].flip(-1)
    full = torch.cat([H, torch.stack([tail[0], -tail[1]])], dim=-1)
    del H, tail
    y = _fft_last_p(full.contiguous(), +1)[0]
    if scale is not None:
        y = y * scale
    return y.movedim(-1, a_last).contiguous()


# ---------------------------------------------------------------------------
# complex-dtype wrappers (boundary conversion)
# ---------------------------------------------------------------------------

def _as_complex(x):
    x = torch.as_tensor(x)
    if x.is_complex():
        return x
    return x.to(torch.complex128 if x.dtype == torch.float64
                else torch.complex64)


def fft1d(x, axis, forward=True):
    """Unnormalized c2c transform along one axis (complex in/out)."""
    x = _as_complex(x)
    return unplanar(fft1d_p(planar(x), axis, forward))


def fftn(x, axes, forward=True):
    x = _as_complex(x)
    return unplanar(fftn_p(planar(x), axes, forward))


def rfftn(x, axes):
    return unplanar(rfftn_p(torch.as_tensor(x), axes))


def irfftn(x, axes, last_size):
    return irfftn_p(planar(torch.as_tensor(x)), axes, last_size)
