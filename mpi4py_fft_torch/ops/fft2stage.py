"""J: the two-stage planar FFT along the last axis, for N = S*128.

Port of ``mpi4py_fft_tpu/ops/pallas_fft.py`` (``supported_length`` :51,
``fft2stage_p`` :158, its kernel ``_kernel`` :56 and ``_call`` :128): the
engine's transform of a last axis of N = S*128 points (S <= 8) in one
pass over device memory.  With n = n1*128 + n2:

    a[k1, n2] = sum_n1 W_S[k1, n1] x[n1, n2]        (stage 1, radix S)
    t[k1, n2] = a[k1, n2] exp(sign*2i*pi*k1*n2/N)     (twiddle)
    c[k1, k2] = sum_n2 t[k1, n2] W_128[n2, k2]        (stage 2, 128 points)
    X[k2*S + k1] = c[k1, k2]

The JAX wrapper's final swap of (k1, k2) is folded into the kernel's
store.  Stage 1 is the direct S-point DFT with ``_dft_matrix(S)``, as the
JAX kernel computes it; stage 2 is a 128-point Stockham where the JAX
kernel takes a product with the 128 x 128 DFT matrix on the MXU: in the
plain version the plan and twiddles of ``butterfly._stage_plan(128)``, in
the CUDA kernel radix 16 then radix 8 (the same function; the rounding
differs within the kernels' tolerance).  Unnormalized, float32 only (the
JAX package dispatches it for f32 only; f64 lengths take the engine's
matrix stages).

The CUDA kernel is a line kernel: one warp a line, the line's points in
registers, stage 1 and the twiddle in the thread that holds a column,
stage 2's exchanges through the warp's own buffer in shared memory (see
``csrc/fft2stage.cu``).  It loads and stores 16-byte vectors, so a CUDA
input whose storage does not start on a 16-byte boundary is copied
first.

On a CPU tensor ``fft2stage_p`` runs ``fft2stage_plain``, which repeats the
kernel's arithmetic; on a CUDA tensor it launches ``csrc/fft2stage.cu`` or
raises.
"""
import functools
import math

import numpy as np
import torch

from . import _build, butterfly

__all__ = ['supported_length', 'fft2stage_p', 'fft2stage_plain']

_LANE = 128
_MAX_S = 8


def supported_length(N):
    """True if J takes length N (N = S*128, 1 <= S <= 8)."""
    return N % _LANE == 0 and 1 <= N // _LANE <= _MAX_S


@functools.lru_cache(maxsize=None)
def _tables(S, sign):
    """float32 tables of one (S, sign), built in numpy float64 and cast
    as the JAX package builds them: the S-point DFT matrix (2, S, S), the
    twiddle (2, S, 128), and the 128-point Stockham twiddles (2, T)."""
    from .matfft import _dft_matrix, _twiddle
    return (_dft_matrix(S, sign, 'float32'), _twiddle(S, _LANE, sign,
                                                      'float32'),
            butterfly._tw_pack(_LANE, sign, 'float32'))


@functools.lru_cache(maxsize=None)
def _table_tensor(S, sign, device):
    """The kernel's tables of ``_tables`` side by side in one (2, row)
    float32 tensor, real parts in row 0 and imaginary parts in row 1: the
    twiddle (S*128), then the 128-point stage twiddles padded to 128, so
    that both blocks start on 16-byte boundaries; uploaded once per
    device.  The kernel takes W1's values as constants."""
    _, tw, t128 = _tables(S, sign)
    t128 = np.pad(t128, ((0, 0), (0, _LANE - t128.shape[1])))
    flat = np.concatenate([tw.reshape(2, -1), t128], axis=1)
    return torch.tensor(flat, dtype=torch.float32, device=device)


def fft2stage_plain(p, sign):
    """Plain PyTorch version of ``fft2stage_p``: stage 1 as the JAX kernel
    writes it (products with the DFT matrix summed over n1 in order), the
    twiddle, and the 128-point Stockham of ``butterfly._butterfly``."""
    shape = tuple(p.shape)
    N = shape[-1]
    S = N // _LANE
    B = math.prod(shape[1:-1])
    w1, tw, _ = (torch.from_numpy(t) for t in _tables(S, sign))
    w1, tw = w1.to(p.device), tw.to(p.device)
    t128 = butterfly._tw_tensor(_LANE, sign, False, torch.float32, p.device)
    x = p.reshape(2, B, S, _LANE)
    out = torch.empty_like(x)
    step = max(1, butterfly._PLAIN_CHUNK // N)
    for b0 in range(0, B, step):
        xr, xi = x[0, b0:b0 + step], x[1, b0:b0 + step]   # (b, S, 128)
        tr, ti = [], []
        for k1 in range(S):
            ar = ai = None
            for n1 in range(S):
                wr, wi = float(w1[0, k1, n1]), float(w1[1, k1, n1])
                pr = wr * xr[:, n1] - wi * xi[:, n1]
                pi = wr * xi[:, n1] + wi * xr[:, n1]
                ar = pr if ar is None else ar + pr
                ai = pi if ai is None else ai + pi
            tr.append(ar * tw[0, k1] - ai * tw[1, k1])
            ti.append(ar * tw[1, k1] + ai * tw[0, k1])
        # stage 2 on the (b*S, 128) rows c[k1, :]
        cr, ci = butterfly._butterfly(
            torch.stack(tr, 1).reshape(-1, _LANE, 1),
            torch.stack(ti, 1).reshape(-1, _LANE, 1), t128, _LANE, sign)
        # X[k2*S + k1] = c[k1, k2]
        nb = xr.shape[0]
        out[0, b0:b0 + nb] = cr.reshape(nb, S, _LANE).transpose(1, 2) \
            .reshape(nb, S, _LANE)
        out[1, b0:b0 + nb] = ci.reshape(nb, S, _LANE).transpose(1, 2) \
            .reshape(nb, S, _LANE)
    return out.reshape(shape)


def fft2stage_p(p, sign):
    """Unnormalized planar FFT along the last axis of (2, ..., N),
    N = S*128 with S <= 8; sign=-1 forward, +1 unscaled inverse."""
    what = 'fft2stage_p'
    butterfly._check_planar(p, what)
    N = p.shape[-1]
    if not supported_length(N):
        raise ValueError(f"{what}: last-axis length {N} is not S*128 with "
                         f"S <= {_MAX_S}")
    if butterfly._plain_ok(p, what):
        return fft2stage_plain(p, sign)
    if p.dtype != torch.float32:
        raise TypeError(f"{what}: the kernel takes float32, got {p.dtype}")
    if p.data_ptr() % 16:
        p = p.clone()
    out = torch.empty_like(p)
    if out.numel() == 0:
        return out
    S = N // _LANE
    B = out.numel() // (2 * N)
    tab = _table_tensor(S, int(sign), p.device)
    butterfly._launch(what, _build.load().fft2stage_f32, p,
                      butterfly._ptr(p), butterfly._ptr(out),
                      butterfly._ptr(tab), tab.shape[1], B, S, int(sign))
    return out
