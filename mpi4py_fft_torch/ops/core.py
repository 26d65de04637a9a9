"""Serial transform math on tensors (FFTW conventions, unnormalized).

Port of ``mpi4py_fft_tpu/ops/core.py``: the complex transforms ``c2c``,
``r2c``, ``c2r`` (:63-100) on the port's engine (``ops/matfft.py``) and
the real-to-real transforms ``r2r`` (:414): DCT/DST I-IV, DHT and the
halfcomplex R2HC/HC2R.  Every r2r kind but the dense basis is glue around
the planar engine's r2c and c2r (``matfft.rfftn_p``/``irfftn_p``), which
run the kernels B and C (float64: their fp64 builds) on a CUDA tensor and
their plain versions on a CPU one:

* DCT/DST II and III by Makhoul's N-point real-FFT method (:248-316); at
  the kernel lengths that 4 divides, DCT-II and DCT-III are one launch of
  ``butterfly.dct2_axis_p``/``dct3_axis_p`` each, B's and C's bodies with
  the glue in their read and write (the plain version, on a CPU tensor,
  is the glue around B's and C's plain versions);
* type I by the even (DCT) or odd (DST) extension to 2(N -+ 1) points
  (:325, :339);
* type IV by a pre-twiddle, a DCT-II and an alternating cumulative sum
  (:368, :384);
* DHT as Re - Im of the Hermitian-extended half spectrum (:392).

Below N = 16 (``_use_fft_r2r``, or everywhere under ``set_r2r_impl
('dense')``) a kind is one product with its dense basis (``_r2r_basis``,
built in float64 with numpy and cast, as the JAX package does), at full
float32 (``matfft._full_f32``, the counterpart of ``Precision.HIGHEST``).
Every table, the index tensors of the gathers included, is uploaded once
per dtype and device (``matfft._const``).

The JAX package's ``'xla'`` engine (``jnp.fft``) has no counterpart:
``torch.fft`` is the port's test oracle, never its engine.
"""
import os

import numpy as np
import torch

from . import butterfly, matfft
from ..utils.profiling import annotate
from .kinds import (
    FFTW_R2HC, FFTW_HC2R, FFTW_DHT,
    FFTW_REDFT00, FFTW_REDFT01, FFTW_REDFT10, FFTW_REDFT11,
    FFTW_RODFT00, FFTW_RODFT01, FFTW_RODFT10, FFTW_RODFT11,
)

__all__ = ['c2c', 'r2c', 'c2r', 'r2r', 'r2r_output_length',
           'get_fft_impl', 'set_fft_impl', 'set_r2r_impl']


# ---------------------------------------------------------------------------
# complex transforms
# ---------------------------------------------------------------------------

def set_fft_impl(impl):
    """Select the complex-FFT engine.  Only ``'matmul'`` (the port's
    kernels and engine) exists: the JAX package's ``'xla'`` would be
    ``torch.fft``, which the port keeps as a test oracle only."""
    if impl == 'xla':
        raise NotImplementedError(
            "set_fft_impl('xla'): torch.fft is the port's test oracle, "
            "never its engine; 'matmul' runs the port's kernels")
    if impl != 'matmul':
        raise ValueError(f"unknown FFT engine {impl!r}")


def get_fft_impl():
    return 'matmul'


def c2c(x, axes, forward=True):
    """Unnormalized complex-to-complex FFT over ``axes``; backward is
    *not* scaled (FFTW convention)."""
    return matfft.fftn(x, axes, forward)


def r2c(x, axes):
    """Unnormalized real-to-complex FFT; ``axes[-1]`` is halved to
    N//2+1 (FFTW's r2c layout)."""
    return matfft.rfftn(x, axes)


def c2r(x, axes, last_size):
    """Unnormalized complex-to-real inverse FFT; the output has
    ``last_size`` points along ``axes[-1]``."""
    return matfft.irfftn(x, axes, last_size)


# ---------------------------------------------------------------------------
# tables (numpy, built in float64 and cast; uploaded by matfft._const)
# ---------------------------------------------------------------------------

def r2r_output_length(N, kind):
    """Logical output length of a 1-D r2r transform of input length N.
    All FFTW r2r kinds are length-preserving."""
    return N


def _r2r_basis(N, kind, dtype_str):
    """Dense (N_out, N_in) basis matrix of an FFTW r2r kind, built in
    float64 (FFTW's unnormalized definitions)."""
    n = np.arange(N)[None, :].astype(np.float64)   # input index
    k = np.arange(N)[:, None].astype(np.float64)   # output index
    if kind == FFTW_REDFT00:                       # DCT-I
        if N < 2:
            raise ValueError("REDFT00 requires N >= 2")
        B = 2.0 * np.cos(np.pi * n * k / (N - 1))
        B[:, 0] *= 0.5
        B[:, -1] *= 0.5
    elif kind == FFTW_REDFT10:                     # DCT-II
        B = 2.0 * np.cos(np.pi * (n + 0.5) * k / N)
    elif kind == FFTW_REDFT01:                     # DCT-III
        B = 2.0 * np.cos(np.pi * n * (k + 0.5) / N)
        B[:, 0] *= 0.5
    elif kind == FFTW_REDFT11:                     # DCT-IV
        B = 2.0 * np.cos(np.pi * (n + 0.5) * (k + 0.5) / N)
    elif kind == FFTW_RODFT00:                     # DST-I
        B = 2.0 * np.sin(np.pi * (n + 1) * (k + 1) / (N + 1))
    elif kind == FFTW_RODFT10:                     # DST-II
        B = 2.0 * np.sin(np.pi * (n + 0.5) * (k + 1) / N)
    elif kind == FFTW_RODFT01:                     # DST-III
        B = 2.0 * np.sin(np.pi * (n + 1) * (k + 0.5) / N)
        B[:, -1] *= 0.5
    elif kind == FFTW_RODFT11:                     # DST-IV
        B = 2.0 * np.sin(np.pi * (n + 0.5) * (k + 0.5) / N)
    elif kind == FFTW_DHT:                         # discrete Hartley
        B = np.cos(2 * np.pi * n * k / N) + np.sin(2 * np.pi * n * k / N)
    else:
        raise ValueError(f"no dense basis for r2r kind {kind}")
    return B.astype(np.dtype(dtype_str))


def _makhoul_idx(N):
    """Makhoul's permutation for any N: even input indices ascending,
    then odd indices descending (v[n] = x[2n], v[N-1-n] = x[2n+1])."""
    hi = N - 1 if N % 2 == 0 else N - 2      # largest odd index
    return np.concatenate([np.arange(0, N, 2), np.arange(hi, 0, -2)])


def _index(which, N, dtype_str):
    """Index table ``which`` of the gathers along an axis of N points."""
    k = np.arange(N)
    if which == 'makhoul':
        a = _makhoul_idx(N)
    elif which == 'unmakhoul':                 # x[2n] = v[n], x[2n+1] = v[N-1-n]
        a = np.argsort(_makhoul_idx(N))
    elif which == 'refl':                      # V[k > N/2] = conj(V[N-k])
        a = np.where(k <= N // 2, k, N - k)
    elif which == 'back':                      # y[N-k], k <= N/2 (y[N] masked)
        a = (N - np.arange(N // 2 + 1)) % N
    elif which == 'r2hc':                      # i_{(N+1)//2-1} .. i_1
        a = np.arange((N + 1) // 2 - 1, 0, -1)
    else:                                      # 'hc2r': the same rows read back
        a = np.arange(N - 1, N - 1 - ((N + 1) // 2 - 1), -1)
    return a.astype(dtype_str)


def _weights(which, N, dtype_str):
    """Row of weights ``which`` along an axis of N points (float64-built,
    cast)."""
    k = np.arange(N)
    if which == 'cos':                          # Makhoul cos(pi k / 2N)
        w = np.cos(np.pi * k / (2.0 * N))
    elif which == 'sin':
        w = np.sin(np.pi * k / (2.0 * N))
    elif which == 'sgn':                        # the reflection's Im sign
        w = np.where(k <= N // 2, 1.0, -1.0)
    elif which == 'mask':                       # y[N] := 0 in DCT-III
        w = np.ones(N // 2 + 1)
        w[0] = 0.0
    elif which == 'alt':                        # (-1)^n
        w = (-1.0) ** k
    elif which == 'dct4_pre':                   # 2 cos(pi (2n+1) / 4N)
        w = 2.0 * np.cos(np.pi * (2 * k + 1) / (4.0 * N))
    else:                                       # 'dct4_w': signed cumsum
        w = np.full(N, 2.0)
        w[0] = 1.0
        w *= (-1.0) ** k
    return w.astype(np.dtype(dtype_str))


def _take(x, which, N, axis):
    """``x`` gathered along ``axis`` by index table ``which``."""
    return x.index_select(
        axis, matfft._const(_index, (which, N), torch.int64, x.device))


def _row(which, N, x, axis):
    """Weights ``which`` shaped to broadcast along ``axis`` of ``x``."""
    w = matfft._const(_weights, (which, N), x.dtype, x.device)
    sh = [1] * x.dim()
    sh[axis] = w.numel()
    return w.reshape(sh)


def _apply_basis(x, B, axis):
    """Contract ``axis`` of x with the basis B (N_out, N_in), at full
    float32."""
    with matfft._full_f32():
        y = torch.tensordot(x, B, dims=([axis], [1]))
    return y.movedim(-1, axis).contiguous()


# ---------------------------------------------------------------------------
# halfcomplex (R2HC/HC2R) on the planar engine
# ---------------------------------------------------------------------------

def _r2hc_1d(x, axis):
    """FFTW halfcomplex forward along one axis: output layout
    [r0..r_{N/2}, i_{(N+1)//2-1}..i_1]."""
    N = x.shape[axis]
    P = matfft.rfftn_p(x, (axis,))        # planar (2, ..., N//2+1)
    if (N + 1) // 2 - 1 > 0:
        return torch.cat([P[0], _take(P[1], 'r2hc', N, axis)], dim=axis)
    return P[0]


def _hc2r_1d(x, axis):
    """FFTW halfcomplex unnormalized inverse along one axis."""
    N = x.shape[axis]
    re = x.narrow(axis, 0, N // 2 + 1)
    n_im = (N + 1) // 2 - 1
    if n_im > 0:
        im = _take(x, 'hc2r', N, axis)
        pad = [0, 0] * (x.dim() - 1 - axis) + [1, N // 2 - n_im]
        im = torch.nn.functional.pad(im, pad)
    else:
        im = torch.zeros_like(re)
    return matfft.irfftn_p(torch.stack([re, im]), (axis,), N)


# ---------------------------------------------------------------------------
# FFT-backed kinds (Makhoul's N-point real-FFT method and its relatives):
# O(N log N) on the planar engine, i.e. on the kernels B and C on a card
# ---------------------------------------------------------------------------

# r2r engine: 'dense' = the basis product; 'fft' = the FFT-backed kinds;
# 'auto' = fft from N = 16 on, dense below
_R2R_IMPL = os.environ.get('MPI4PY_FFT_TORCH_R2R', 'auto')


def set_r2r_impl(impl):
    global _R2R_IMPL
    if impl not in ('auto', 'fft', 'dense'):
        raise ValueError(f"unknown r2r engine {impl!r}")
    _R2R_IMPL = impl


def _use_fft_r2r(N, kind):
    """Every FFTW r2r kind has an O(N log N) path here; the dense basis
    remains for tiny axes and for the forced 'dense' engine."""
    if _R2R_IMPL == 'dense' or kind not in _FFT_R2R_FN:
        return False
    if _R2R_IMPL == 'fft':
        return True
    return N >= 16


def _dct2_glue(x, axis, rfft):
    """REDFT10: X[k] = 2 sum x[n] cos(pi (n+1/2) k / N)  (Makhoul 1980).

    v = [x[0], x[2], ..., x[N-1], ..., x[3], x[1]];  V = rfft(v);
    X[k] = 2 Re(e^{-i pi k/2N} V[k]), Hermitian-extended past N/2.
    ``rfft(v, axis)``: the planar half spectrum of v along ``axis``.
    """
    N = x.shape[axis]
    P = rfft(_take(x, 'makhoul', N, axis), axis)
    # full-length spectrum by Hermitian reflection V[k>N/2] = conj(V[N-k])
    Vr = _take(P[0], 'refl', N, axis)
    Vi = _take(P[1], 'refl', N, axis) * _row('sgn', N, x, axis)
    return 2.0 * (Vr * _row('cos', N, x, axis)
                  + Vi * _row('sin', N, x, axis))


def _dct3_glue(y, axis, irfft):
    """REDFT01 (unnormalized DCT-III, the transpose of REDFT10):
    X[n] = y[0] + 2 sum_{k>=1} y[k] cos(pi k (n+1/2) / N).

    Inverse Makhoul: the unnormalized c2r of W[k] = (y[k] - i y[N-k])
    e^{+i pi k/2N} (y[N] := 0), k = 0..N/2, is the even/odd-reordered
    result.  W's imaginary part is exactly 0 at k = 0 (sin 0 = 0, y[N]
    masked), and at k = N/2 it is y[N/2] (sin - cos)(pi/4): 0 in float32,
    an ulp in float64; every c2r of the port reads both as 0, as the JAX
    CPU path does.  ``irfft(W, axis, N)``: the unnormalized c2r of the
    planar half spectrum W along ``axis``.
    """
    N = y.shape[axis]
    nh = N // 2 + 1
    c = _row('cos', N, y, axis).narrow(axis, 0, nh)
    s = _row('sin', N, y, axis).narrow(axis, 0, nh)
    yk = y.narrow(axis, 0, nh)
    ynk = _take(y, 'back', N, axis) * _row('mask', N, y, axis)
    # V = (yk - i*ynk) * (c + i s) = (yk*c + ynk*s) + i(yk*s - ynk*c)
    Wr = yk * c + ynk * s
    Wi = yk * s - ynk * c
    v = irfft(torch.stack([Wr, Wi]), axis, N)
    return _take(v, 'unmakhoul', N, axis)


def _dct2_fft(x, axis):
    """REDFT10 in one pass of ``butterfly.dct2_axis_p`` (the glue fused
    into B's bodies) where it takes the length, else the glue around the
    engine's r2c."""
    if butterfly.supported_dct(tuple(x.shape), axis):
        return butterfly.dct2_axis_p(x, axis)
    return _dct2_glue(x, axis, lambda v, a: matfft.rfftn_p(v, (a,)))


def _dct3_fft(y, axis):
    """REDFT01 in one pass of ``butterfly.dct3_axis_p`` (the glue fused
    into C's bodies) where it takes the length, else the glue around the
    engine's c2r."""
    if butterfly.supported_dct(tuple(y.shape), axis):
        return butterfly.dct3_axis_p(y, axis)
    return _dct3_glue(y, axis,
                      lambda w, a, n: matfft.irfftn_p(w, (a,), n))


def _dst2_fft(x, axis):
    """RODFT10 via REDFT10: DST-II(x)[k] = DCT-II(u)[N-1-k] with
    u[n] = (-1)^n x[n]."""
    N = x.shape[axis]
    return _dct2_fft(x * _row('alt', N, x, axis), axis).flip(axis)


def _dst3_fft(y, axis):
    """RODFT01 via REDFT01: DST-III(y)[n] = (-1)^n DCT-III(y[N-1-k])[n]."""
    N = y.shape[axis]
    return _dct3_fft(y.flip(axis), axis) * _row('alt', N, y, axis)


def _dct1_fft(x, axis):
    """REDFT00 (DCT-I): X[k] = x[0] + (-1)^k x[N-1]
    + 2 sum_{1<=n<=N-2} x[n] cos(pi n k / (N-1)).

    The even extension v = [x[0..N-1], x[N-2..1]] of length 2(N-1) has a
    real DFT V[k] = X[k], whose rfft has exactly N rows: X = Re(rfft(v))."""
    N = x.shape[axis]
    v = torch.cat([x, x.narrow(axis, 1, N - 2).flip(axis)], dim=axis)
    return matfft.rfftn_p(v, (axis,))[0]


def _dst1_fft(x, axis):
    """RODFT00 (DST-I): X[k] = 2 sum x[n] sin(pi (n+1)(k+1) / (N+1)).

    The odd extension v = [0, x[0..N-1], 0, -x[N-1..0]] of length 2(N+1)
    has DFT V[k] = -i X[k-1], so X = -Im(rfft(v))[1:N+1]."""
    N = x.shape[axis]
    zshape = list(x.shape)
    zshape[axis] = 1
    z = x.new_zeros(zshape)
    v = torch.cat([z, x, z, -x.flip(axis)], dim=axis)
    P = matfft.rfftn_p(v, (axis,))               # (2, ..., N+2)
    return -P[1].narrow(axis, 1, N)


def _dct4_fft(x, axis):
    """REDFT11 (DCT-IV): X[k] = 2 sum x[n] cos(pi (2n+1)(2k+1) / (4N)).

    DCT2(2 x[n] cos(pi(2n+1)/4N))[k] = X[k] + X[k-1] with X[-1] = V[0]:
    X[0] = V[0] and X[k] = 2 V[k] - X[k-1], an alternating-sign
    cumulative sum, so the kind rides the FFT-backed DCT-II at any N.
    The cumulative sum's rounding grows with N in float32."""
    N = x.shape[axis]
    V = _dct2_fft(x * _row('dct4_pre', N, x, axis), axis) * 0.5
    S = torch.cumsum(V * _row('dct4_w', N, x, axis), dim=axis)
    return S * _row('alt', N, x, axis)


def _dst4_fft(x, axis):
    """RODFT11 via REDFT11: DST-IV(x)[k] = DCT-IV((-1)^n x)[N-1-k]."""
    N = x.shape[axis]
    return _dct4_fft(x * _row('alt', N, x, axis), axis).flip(axis)


def _dht_fft(x, axis):
    """FFTW_DHT: X[k] = sum x[n] (cos + sin)(2 pi n k / N) = Re V[k] -
    Im V[k] for V = DFT(x): one rfft and the Hermitian reflection (Im
    flips sign past N/2)."""
    N = x.shape[axis]
    P = matfft.rfftn_p(x, (axis,))
    Vr = _take(P[0], 'refl', N, axis)
    Vi = _take(P[1], 'refl', N, axis) * _row('sgn', N, x, axis)
    return Vr - Vi


_FFT_R2R_FN = {FFTW_REDFT10: _dct2_fft, FFTW_REDFT01: _dct3_fft,
               FFTW_RODFT10: _dst2_fft, FFTW_RODFT01: _dst3_fft,
               FFTW_REDFT00: _dct1_fft, FFTW_RODFT00: _dst1_fft,
               FFTW_REDFT11: _dct4_fft, FFTW_RODFT11: _dst4_fft,
               FFTW_DHT: _dht_fft}


def r2r(x, axes, kinds):
    """Separable real-to-real transform: ``kinds[i]`` applied along
    ``axes[i]``, one FFTW kind per transformed axis, each axis in the
    span ``r2r``."""
    if len(axes) != len(kinds):
        raise ValueError(f"r2r: {len(axes)} axes and {len(kinds)} kinds")
    for axis, kind in zip(axes, kinds):
        with annotate('r2r'):
            x = x.contiguous()
            axis %= x.dim()
            N = x.shape[axis]
            if kind == FFTW_R2HC:
                x = _r2hc_1d(x, axis)
            elif kind == FFTW_HC2R:
                x = _hc2r_1d(x, axis)
            elif _use_fft_r2r(N, kind):
                x = _FFT_R2R_FN[kind](x, axis)
            else:
                B = matfft._const(_r2r_basis, (N, kind), x.dtype, x.device)
                x = _apply_basis(x, B, axis)
    return x
