"""Stockham mixed-radix FFT along one axis of planar data.

Port of ``mpi4py_fft_tpu/ops/pallas_butterfly.py``: the stage-plan and
twiddle tables, a plain PyTorch version of each kernel, and the wrappers
of the CUDA kernels on the single-device path:

* ``fft_axis_p``      (csrc/fft_axis.cu)  planar c2c along one axis;
* ``rfft_axis_p``     (csrc/rfft_axis.cu) real -> Hermitian half spectrum;
* ``irfft_axis_p``    (csrc/rfft_axis.cu) half spectrum -> real;
* ``fft_axis2_p``     (csrc/fft_axis2.cu) planar c2c along an axis split
  across two tensors (the quartered schedule, ``oop3d.py``);
* ``fft_axis_pair_p`` (csrc/fft_axis2.cu) the same entry on the two
  halves of one tensor: axes of 1536 and 2048 (above 1024 both take the
  entry's two-CTA cluster kernel);
* ``fft_axis_tp``     (csrc/fft_axis_tp.cu) planar c2c along one axis with
  the 3/2-rule truncation fused into the write or the zero-padding into
  the read;
* ``fft_plane_p``, ``fft_plane_large_p`` (csrc/fft_plane.cu) planar c2c
  over the last two axes in one launch (entry points; nothing dispatches
  them, as in the JAX package).

The two-stage last-axis kernel of the engine, J, is in ``fft2stage.py``.

All but the pair and plane kernels take float32 and float64 tensors:
their kernels have an fp64 build (the port of the double-single tier
``pallas_ds``), which the wrappers launch for float64 and count under
``<name>_f64``.  The pair kernel is float32 only for now; the plane
kernels are float32 only, as in the JAX package.

Stockham autosort recurrence (DIF, self-sorting, no bit reversal): the
state of one line has shape (L, M) with L*M = N.  A radix-r stage splits
it into r slabs of Lq = L/r rows, takes the r-point DFT across the slabs,
multiplies output k by w_L^(k*l) and concatenates the outputs along M,
giving an (Lq, r*M) state.  After the last stage the M index is the output
frequency in natural order.

Every function works on the ``(2, pre, N, post)`` view of its tensor:
``pre``/``post`` are the products of the dims before and after the axis.
On a CPU tensor a wrapper runs the plain version, which follows the same
stage plan and twiddle offsets as the kernel and so repeats its
arithmetic.  On a CUDA tensor it launches the kernel or raises.
"""
import ctypes
import functools
import math

import numpy as np
import torch

from . import _build

__all__ = ['fft_axis_p', 'rfft_axis_p', 'irfft_axis_p', 'fft_axis2_p',
           'fft_axis_pair_p', 'pair_max_active_clusters', 'fft_axis_tp',
           'supported_axis',
           'supported_r2c', 'supported_c2r', 'supported_axis_split',
           'supported_axis_tp', 'fft_axis_plain', 'rfft_axis_plain',
           'irfft_axis_plain', 'fft_axis2_plain', 'fft_axis_pair_plain',
           'fft_axis_tp_plain', 'fft_plane_p', 'fft_plane_large_p',
           'supported_plane', 'supported_plane_large', 'fft_plane_plain',
           'fft_plane_large_plain', 'plane_max_active_clusters', 'LAUNCHES',
           'reset_launches']

_MAX_N_AXIS = 1024
_MAX_N_PAIR = 2048

# kernel launches since the last reset, one count per wrapper and build
# (float32 under the wrapper's name, float64 under the name with _f64); a
# wrapper adds one where it launches its kernel and nowhere else
LAUNCHES = {'fft_axis_p': 0, 'rfft_axis_p': 0, 'irfft_axis_p': 0,
            'fft_axis2_p': 0, 'fft_axis_pair_p': 0, 'fft_axis_p_f64': 0,
            'rfft_axis_p_f64': 0, 'irfft_axis_p_f64': 0, 'fft_axis_tp': 0,
            'fft_axis_tp_f64': 0, 'fft2stage_p': 0, 'fft_plane_p': 0,
            'fft_plane_large_p': 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# tables (built in numpy float64, then cast, as the JAX package does)
# ---------------------------------------------------------------------------

def _is_pow2(n):
    return n >= 2 and (n & (n - 1)) == 0


def _supported_len(n):
    """Kernel-supported transform lengths: 2^a, or 3*2^a (one radix-3
    stage), which covers the 3/2-rule dealiasing extents."""
    if _is_pow2(n):
        return True
    return n % 3 == 0 and _is_pow2(n // 3)


@functools.lru_cache(maxsize=None)
def _stage_plan(N):
    """Radices per Stockham stage: radix-16 stages with one small
    remainder stage last for N >= 512, radix 4 (with one leading radix 2
    for odd powers) below; lengths 3*2^a append one radix-3 stage, always
    last.

    This choice came from an A/B on a TPU v5e, where each stage is one
    sweep over VMEM.  On Hopper each stage is one sweep over shared
    memory, and the best plan has not been measured yet: it is an open
    choice."""
    M, tail = (N // 3, (3,)) if N % 3 == 0 else (N, ())
    if N >= 512:
        plan = []
        L = M
        while L >= 16:
            plan.append(16)
            L //= 16
        if L > 1:
            plan.append(L)
        return tuple(plan) + tail
    plan = []
    L = M
    if (L.bit_length() - 1) % 2:
        plan.append(2)
        L //= 2
    while L > 1:
        plan.append(4)
        L //= 4
    return tuple(plan) + tail


@functools.lru_cache(maxsize=None)
def _tw_len(N):
    """Row count of _tw_pack(N, ...)."""
    t, L = 0, N
    for r in _stage_plan(N):
        t += (r - 1) * (L // r)
        L //= r
    return t


@functools.lru_cache(maxsize=None)
def _tw_pack_packed(N, sign, dtype_str):
    """Twiddles for the packed r2c/c2r kernels: the N/2-point stage pack
    with (cos, sin)(2*pi*k/N), k = 0..N/2, appended as unpack rows."""
    N2 = N // 2
    base = _tw_pack(N2, sign, dtype_str)         # (2, T2)
    k = np.arange(N2 + 1)
    ang = 2.0 * np.pi * k / N
    extra = np.stack([np.cos(ang), np.sin(ang)]).astype(dtype_str)
    return np.concatenate([base, extra], axis=1)


@functools.lru_cache(maxsize=None)
def _tw_pack(N, sign, dtype_str):
    """All stage twiddles as a (2, T) array: per stage of radix r at
    length L, rows hold w_L^(j*l) for j = 1..r-1 concatenated (l < L/r),
    in descending L."""
    rows_r, rows_i = [], []
    L = N
    for r in _stage_plan(N):
        Lq = L // r
        for j in range(1, r):
            ang = sign * 2.0 * np.pi * j * np.arange(Lq) / L
            rows_r.append(np.cos(ang))
            rows_i.append(np.sin(ang))
        L //= r
    cr = np.concatenate(rows_r)
    ci = np.concatenate(rows_i)
    return np.stack([cr, ci]).astype(dtype_str)


@functools.lru_cache(maxsize=None)
def _tw_pack_pair(N, sign, dtype_str):
    """Twiddles for the pair kernel's cluster pass (N = 1536, 2048): the
    N/2-point stage pack, then the N/2 cross twiddles
    (cos, sin)(sign * 2*pi*k/N), k = 0..N/2-1, of the radix-2 step
    across the two halves."""
    h = N // 2
    base = _tw_pack(h, sign, dtype_str)
    ang = sign * 2.0 * np.pi * np.arange(h) / N
    extra = np.stack([np.cos(ang), np.sin(ang)]).astype(dtype_str)
    return np.concatenate([base, extra], axis=1)


@functools.lru_cache(maxsize=None)
def _tw_pack_powers(N, sign, dtype_str):
    """Every power of w_N: (cos, sin)(sign * 2*pi*e/N), e = 0..N-1, as
    (2, N): the twiddles of the plane-holding kernel's stages and its
    cluster step over an N-point axis."""
    ang = sign * 2.0 * np.pi * np.arange(N) / N
    return np.stack([np.cos(ang), np.sin(ang)]).astype(dtype_str)


@functools.lru_cache(maxsize=None)
def _tw_pack_axis(N, sign, dtype_str):
    """Twiddles for fft_axis_p and the pair kernel at N <= 1024: the
    stage pack of _tw_pack(N, sign), which the tile kernels read, then
    the N powers of w_N of _tw_pack_powers(N, sign), which the line and
    band kernels read."""
    return np.concatenate([_tw_pack(N, sign, dtype_str),
                           _tw_pack_powers(N, sign, dtype_str)], axis=1)


@functools.lru_cache(maxsize=None)
def _tw_tensor(N, sign, packed, dtype, device):
    """The twiddle table of one (N, sign, packed) as a contiguous tensor,
    uploaded once per dtype and device."""
    name = str(dtype).replace('torch.', '')
    tab = _tw_pack_packed(N, sign, name) if packed else \
        _tw_pack(N, sign, name)
    return torch.tensor(tab, dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _tw_tensor_axis(N, sign, dtype, device):
    """_tw_pack_axis(N, sign) as a contiguous tensor, uploaded once per
    dtype and device."""
    name = str(dtype).replace('torch.', '')
    return torch.tensor(_tw_pack_axis(N, sign, name), dtype=dtype,
                        device=device)


@functools.lru_cache(maxsize=None)
def _tw_tensor_pair(N, sign, dtype, device):
    """_tw_pack_pair(N, sign) as a contiguous tensor, uploaded once per
    dtype and device."""
    name = str(dtype).replace('torch.', '')
    return torch.tensor(_tw_pack_pair(N, sign, name), dtype=dtype,
                        device=device)


@functools.lru_cache(maxsize=None)
def _tw_tensor_powers(N, sign, dtype, device):
    """_tw_pack_powers(N, sign) as a contiguous tensor, uploaded once per
    dtype and device."""
    name = str(dtype).replace('torch.', '')
    return torch.tensor(_tw_pack_powers(N, sign, name), dtype=dtype,
                        device=device)


# ---------------------------------------------------------------------------
# plain PyTorch versions: the state of a chunk of lines is (pre, L, M, post)
# ---------------------------------------------------------------------------

def _dft_slabs(qs, sign):
    """R-point DFT across a list of (re, im) slab pairs as a recursive
    radix-2 network whose twiddles are float constants."""
    R = len(qs)
    if R == 1:
        return qs
    ev = _dft_slabs(qs[0::2], sign)
    od = _dft_slabs(qs[1::2], sign)
    H = R // 2
    out = [None] * R
    for k in range(H):
        er, ei = ev[k]
        orr, oi = od[k]
        if k == 0:                      # w = 1
            tr, ti = orr, oi
        elif 4 * k == R:                # w = exp(sign*i*pi/2)
            tr, ti = -sign * oi, sign * orr
        else:
            ang = sign * 2.0 * math.pi * k / R
            wr, wi = math.cos(ang), math.sin(ang)
            tr = orr * wr - oi * wi
            ti = orr * wi + oi * wr
        out[k] = (er + tr, ei + ti)
        out[k + H] = (er - tr, ei - ti)
    return out


def _stage_apply(qr, qi, r, L, off, tw, sign):
    """One Stockham stage from r slabs (each (pre, Lq, M, post)) to the
    concatenated (pre, Lq, r*M, post) state."""
    Lq = L // r

    def w(k):
        s = off + (k - 1) * Lq
        return (tw[0, s:s + Lq].view(1, Lq, 1, 1),
                tw[1, s:s + Lq].view(1, Lq, 1, 1))

    if r == 2:
        ar, br = qr
        ai, bi = qi
        ys = [(ar + br, ai + bi), (ar - br, ai - bi)]
    elif r == 3:
        q0r, q1r, q2r = qr
        q0i, q1i, q2i = qi
        # w3 = exp(sign*2i*pi/3) = c + i*s; w3^2 = conj(w3)
        c = -0.5
        s = sign * 0.8660254037844386          # sqrt(3)/2
        ar, ai = q1r + q2r, q1i + q2i
        br, bi = q1r - q2r, q1i - q2i
        ys = [(q0r + ar, q0i + ai),
              (q0r + c * ar - s * bi, q0i + c * ai + s * br),
              (q0r + c * ar + s * bi, q0i + c * ai - s * br)]
    elif r == 4:
        q0r, q1r, q2r, q3r = qr
        q0i, q1i, q2i, q3i = qi
        t0r, t0i = q0r + q2r, q0i + q2i
        t1r, t1i = q1r + q3r, q1i + q3i
        t2r, t2i = q0r - q2r, q0i - q2i
        t3r, t3i = q1r - q3r, q1i - q3i
        # w4 = exp(sign*i*pi/2): w4*z = (-sign*zi, sign*zr)
        u3r, u3i = -sign * t3i, sign * t3r
        ys = [(t0r + t1r, t0i + t1i), (t2r + u3r, t2i + u3i),
              (t0r - t1r, t0i - t1i), (t2r - u3r, t2i - u3i)]
    else:
        ys = _dft_slabs(list(zip(qr, qi)), sign)
    outs_r, outs_i = [ys[0][0]], [ys[0][1]]
    for k in range(1, r):
        yr, yi = ys[k]
        if Lq > 1:                  # the last stage of a length has w = 1
            wr, wi = w(k)
            yr, yi = yr * wr - yi * wi, yr * wi + yi * wr
        outs_r.append(yr)
        outs_i.append(yi)
    return torch.cat(outs_r, dim=2), torch.cat(outs_i, dim=2)


def _butterfly(xr, xi, tw, N, sign, scale=None):
    """Stockham FFT along dim 1 of (pre, N, post) pairs; ``tw`` holds the
    N-point stage twiddles in its first _tw_len(N) columns."""
    xr = xr.unsqueeze(2)
    xi = xi.unsqueeze(2)
    L = N
    off = 0
    for r in _stage_plan(N):
        Lq = L // r
        qr = [xr[:, j * Lq:(j + 1) * Lq] for j in range(r)]
        qi = [xi[:, j * Lq:(j + 1) * Lq] for j in range(r)]
        xr, xi = _stage_apply(qr, qi, r, L, off, tw, sign)
        off += (r - 1) * Lq
        L = Lq
    return _finish(xr, xi, scale)


def _finish(xr, xi, scale):
    if scale is not None:
        xr = xr * scale
        xi = xi * scale
    return xr[:, 0], xi[:, 0]


def _herm_trunc_rows(r, i, trunc):
    """Hermitian spectral truncation to ``trunc`` rows: keep the first
    rows; for even ``trunc`` double the folded Nyquist real part and zero
    its imaginary part."""
    if trunc % 2 == 0:
        return (torch.cat([r[:, :trunc - 1], 2.0 * r[:, trunc - 1:trunc]],
                          dim=1),
                torch.cat([i[:, :trunc - 1], torch.zeros_like(i[:, :1])],
                          dim=1))
    return r[:, :trunc], i[:, :trunc]


def _herm_pad_rows(hr, hi, nh):
    """Hermitian zero-padding from Nt = hr.shape[1] rows to ``nh`` rows:
    halve the even-Nt Nyquist real part, zero its imaginary part,
    zero-fill the tail."""
    Nt = hr.shape[1]
    if Nt >= nh:
        return hr[:, :nh], hi[:, :nh]
    z = hr.new_zeros((hr.shape[0], nh - Nt, hr.shape[2]))
    if Nt % 2 == 0:
        return (torch.cat([hr[:, :Nt - 1], 0.5 * hr[:, Nt - 1:Nt], z], dim=1),
                torch.cat([hi[:, :Nt - 1], torch.zeros_like(hi[:, :1]), z],
                          dim=1))
    return torch.cat([hr, z], dim=1), torch.cat([hi, z], dim=1)


def _pad_tail(r, i, hext):
    if hext > r.shape[1]:
        z = r.new_zeros((r.shape[0], hext - r.shape[1], r.shape[2]))
        r = torch.cat([r, z], dim=1)
        i = torch.cat([i, z], dim=1)
    return r, i


def _r2c_rows_full(x, tw, N, nh, hext, scale, trunc=None):
    """Real rows (pre, N, post) -> half-spectrum rows (pre, hext, post)
    by a full N-point c2c with zero imaginary part (N = 2)."""
    r, i = _butterfly(x, torch.zeros_like(x), tw, N, -1, scale)
    r, i = r[:, :nh], i[:, :nh]
    if trunc is not None and trunc < nh:
        r, i = _herm_trunc_rows(r, i, trunc)
    return _pad_tail(r, i, hext)


def _r2c_rows(x, tw, N, nh, hext, scale, trunc=None):
    """Real rows (pre, N, post) -> half-spectrum rows (pre, hext, post) by
    the packed N/2-point method: z[m] = x[2m] + i x[2m+1] is one N/2-point
    c2c, unpacked with
        E[k] = (Z[k] + conj(Z[-k]))/2,  O[k] = -i/2 (Z[k] - conj(Z[-k])),
        X[k] = E[k] + w_N^k O[k],  k = 0..N/2.
    ``tw``: [:, :T2] N/2-point stage twiddles, [:, T2:] (cos, sin)(2 pi k/N)
    unpack rows (see _tw_pack_packed)."""
    N2 = N // 2
    if N2 < 2:
        return _r2c_rows_full(x, tw, N, nh, hext, scale, trunc)
    pair = x.reshape(x.shape[0], N2, 2, x.shape[2])
    Zr, Zi = _butterfly(pair[:, :, 0], pair[:, :, 1], tw, N2, -1, None)
    # Z at k = 0..N2 (Z[N2] = Z[0]) and its index reversal Z[(N2-k)%N2]
    Zr_e = torch.cat([Zr, Zr[:, :1]], dim=1)
    Zi_e = torch.cat([Zi, Zi[:, :1]], dim=1)
    Zr_r = torch.cat([Zr[:, :1], Zr[:, 1:].flip(1), Zr[:, :1]], dim=1)
    Zi_r = torch.cat([Zi[:, :1], Zi[:, 1:].flip(1), Zi[:, :1]], dim=1)
    Er = 0.5 * (Zr_e + Zr_r)
    Ei = 0.5 * (Zi_e - Zi_r)
    Or = 0.5 * (Zi_e + Zi_r)
    Oi = 0.5 * (Zr_r - Zr_e)
    T2 = _tw_len(N2)
    cw = tw[0, T2:T2 + nh].view(1, nh, 1)     # cos(2 pi k / N)
    sw = tw[1, T2:T2 + nh].view(1, nh, 1)     # sin(2 pi k / N)
    # X = E + w^k O, w^k = cw - i sw
    r = Er + cw * Or + sw * Oi
    i = Ei + cw * Oi - sw * Or
    if scale is not None:
        r = r * scale
        i = i * scale
    if trunc is not None and trunc < nh:
        r, i = _herm_trunc_rows(r, i, trunc)
    return _pad_tail(r, i, hext)


def _c2r_rows(hr, hi, tw, N, scale):
    """Half-spectrum rows (pre, >= N//2+1, post) -> real rows by a full
    N-point inverse (N = 2)."""
    r, _ = _butterfly(hr[:, :N], hi[:, :N], tw, N, +1, scale)
    return r


def _c2r_rows_packed(hr, hi, tw, N, scale):
    """Half-spectrum rows (pre, >= N/2+1, post) -> real rows (pre, N, post)
    by the packed N/2-point inverse: repack the Hermitian spectrum into
        Z[k] = E[k] + i O[k],  E = (X[k]+conj(X[-k]))/2,
        O = conj(w_N^k) (X[k]-conj(X[-k]))/2,   k = 0..N/2-1,
    one N/2-point inverse butterfly, and interleave Re/Im as even/odd
    output rows (x2: unnormalized FFTW c2r returns N*x, the packed inverse
    N/2)."""
    N2 = N // 2
    nh = N2 + 1
    Xr, Xi = hr[:, :nh], hi[:, :nh]
    Xr_rev = Xr[:, 1:nh].flip(1)               # X[N2-k], k = 0..N2-1
    Xi_rev = Xi[:, 1:nh].flip(1)
    Xr_h, Xi_h = Xr[:, :N2], Xi[:, :N2]
    Er = 0.5 * (Xr_h + Xr_rev)
    Ei = 0.5 * (Xi_h + Xi_rev * -1.0)
    Dr = Xr_h - Xr_rev
    Di = Xi_h + Xi_rev
    T2 = _tw_len(N2)
    cw = tw[0, T2:T2 + N2].view(1, N2, 1)
    sw = tw[1, T2:T2 + N2].view(1, N2, 1)
    ORe = 0.5 * (cw * Dr - sw * Di)
    OIm = 0.5 * (cw * Di + sw * Dr)
    Zr = Er - OIm
    Zi = Ei + ORe
    sc = 2.0 if scale is None else 2.0 * scale
    zr, zi = _butterfly(Zr, Zi, tw, N2, +1, sc)
    # out[2m] = zr[m], out[2m+1] = zi[m]
    out = torch.stack([zr, zi], dim=2)
    return out.reshape(zr.shape[0], N, zr.shape[2])


# elements of one plane that the plain versions transform at a time: the
# stage temporaries of a chunk stay small next to a full volume
_PLAIN_CHUNK = 1 << 24


def _chunks(pre, n, post):
    """(pre, post) slices that cut a (pre, n, post) view into chunks of
    about _PLAIN_CHUNK elements; lines are independent."""
    line = max(1, n * post)
    sp = max(1, _PLAIN_CHUNK // line)
    sq = max(1, post if line <= _PLAIN_CHUNK else _PLAIN_CHUNK // n)
    for a in range(0, pre, sp):
        for b in range(0, post, sq):
            yield slice(a, a + sp), slice(b, b + sq)


def _pre_post(shape, axis):
    pre = math.prod(shape[:axis])
    post = math.prod(shape[axis + 1:])
    return pre, post


def _r2c_out_rows(N, hext, trunc):
    nh = N // 2 + 1
    eff = nh if trunc is None else int(trunc)
    hext = eff if hext is None else int(hext)
    if hext < eff:
        raise ValueError(f"hext={hext} is below the spectrum's {eff} rows")
    return nh, hext


def fft_axis_plain(p, axis, forward=True, scale=None):
    """Plain PyTorch version of ``fft_axis_p``."""
    shape = tuple(p.shape[1:])
    axis = axis % len(shape)
    N = shape[axis]
    pre, post = _pre_post(shape, axis)
    sign = -1 if forward else +1
    tw = _tw_tensor(N, sign, False, p.dtype, p.device)
    x = p.reshape(2, pre, N, post)
    out = torch.empty_like(x)
    for a, b in _chunks(pre, N, post):
        r, i = _butterfly(x[0, a, :, b], x[1, a, :, b], tw, N, sign, scale)
        out[0, a, :, b] = r
        out[1, a, :, b] = i
    return out.reshape(p.shape)


def fft_axis2_plain(pa, pb, axis, forward=True, scale=None):
    """Plain PyTorch version of ``fft_axis2_p`` (out of place).  JAX's
    split-input core ``_butterfly2`` takes its first-stage slabs from the
    two halves and then runs ``_butterfly``'s stages, which is the same
    arithmetic as ``_butterfly`` on the rebuilt line."""
    d = 1 + axis % (pa.dim() - 1)
    h = pa.shape[d]
    y = fft_axis_plain(torch.cat([pa, pb], dim=d), d - 1, forward, scale)
    return y.narrow(d, 0, h).contiguous(), y.narrow(d, h, h).contiguous()


def fft_axis_pair_plain(p, axis, forward=True, scale=None):
    """Plain PyTorch version of ``fft_axis_pair_p``: the same function as
    ``fft_axis_plain`` (see ``fft_axis2_plain``)."""
    return fft_axis_plain(p, axis, forward, scale)


def _trunc_rows(r, i, N, Nt):
    """Spectral truncation of (pre, N, post) rows to Nt rows: keep the
    lowest |k| modes and fold row N - Nt/2 onto row Nt/2 for even Nt
    (``_trunc_rows`` of the JAX package, pallas_butterfly.py:455)."""
    def rows(v):
        if Nt % 2 == 0:
            h = Nt // 2
            return torch.cat([v[:, :h], v[:, h:h + 1] + v[:, N - h:N - h + 1],
                              v[:, N - h + 1:]], dim=1)
        m = Nt // 2
        return torch.cat([v[:, :m + 1], v[:, N - m:]], dim=1)
    return rows(r), rows(i)


def _pad_rows(r, i, N):
    """Spectral zero-padding of (pre, Nt, post) rows to N rows, row Nt/2
    split in halves for even Nt (``_pad_rows`` of the JAX package,
    pallas_butterfly.py:469)."""
    Nt = r.shape[1]

    def rows(v):
        if Nt % 2 == 0:
            h = Nt // 2
            half = v[:, h:h + 1] * 0.5
            z = v.new_zeros((v.shape[0], N - Nt - 1, v.shape[2]))
            return torch.cat([v[:, :h], half, z, half, v[:, h + 1:]], dim=1)
        m = Nt // 2
        z = v.new_zeros((v.shape[0], N - Nt, v.shape[2]))
        return torch.cat([v[:, :m + 1], z, v[:, m + 1:]], dim=1)
    return rows(r), rows(i)


def _tp_rows(p, axis, trunc, pad):
    """(N, Nt, Nin, Nout) of a fft_axis_tp pass along ``axis`` of the
    complex shape of planar ``p``."""
    if (trunc is None) == (pad is None):
        raise ValueError("fft_axis_tp: give exactly one of trunc and pad")
    Nin = p.shape[1 + axis]
    if trunc is not None:
        return Nin, int(trunc), Nin, int(trunc)
    return int(pad), Nin, Nin, int(pad)


def fft_axis_tp_plain(p, axis, forward=True, trunc=None, pad=None,
                      scale=None):
    """Plain PyTorch version of ``fft_axis_tp``: the scaled transform,
    then the truncation; or the padding, then the scaled transform, as
    the JAX kernel orders them."""
    shape = tuple(p.shape[1:])
    axis = axis % len(shape)
    N, Nt, Nin, Nout = _tp_rows(p, axis, trunc, pad)
    pre, post = _pre_post(shape, axis)
    sign = -1 if forward else +1
    tw = _tw_tensor(N, sign, False, p.dtype, p.device)
    x = p.reshape(2, pre, Nin, post)
    out = p.new_empty((2, pre, Nout, post))
    for a, b in _chunks(pre, N, post):
        r, i = x[0, a, :, b], x[1, a, :, b]
        if pad is not None:
            r, i = _pad_rows(r, i, N)
        r, i = _butterfly(r, i, tw, N, sign, scale)
        if trunc is not None:
            r, i = _trunc_rows(r, i, N, Nt)
        out[0, a, :, b] = r
        out[1, a, :, b] = i
    return out.reshape((2,) + shape[:axis] + (Nout,) + shape[axis + 1:])


def rfft_axis_plain(x, axis, hext=None, scale=None, trunc=None):
    """Plain PyTorch version of ``rfft_axis_p``."""
    shape = tuple(x.shape)
    axis = axis % len(shape)
    N = shape[axis]
    nh, hext = _r2c_out_rows(N, hext, trunc)
    pre, post = _pre_post(shape, axis)
    packed = N // 2 >= 2
    tw = _tw_tensor(N, -1, packed, x.dtype, x.device)
    xv = x.reshape(pre, N, post)
    out = x.new_empty((2, pre, hext, post))
    rows = _r2c_rows if packed else _r2c_rows_full
    for a, b in _chunks(pre, N, post):
        r, i = rows(xv[a, :, b], tw, N, nh, hext, scale, trunc)
        out[0, a, :, b] = r
        out[1, a, :, b] = i
    return out.reshape((2,) + shape[:axis] + (hext,) + shape[axis + 1:])


def irfft_axis_plain(p, axis, n, scale=None):
    """Plain PyTorch version of ``irfft_axis_p``."""
    shape = tuple(p.shape[1:])
    axis = axis % len(shape)
    N = int(n)
    nh = N // 2 + 1
    Hin = shape[axis]
    pre, post = _pre_post(shape, axis)
    packed = N // 2 >= 2
    tw = _tw_tensor(N, +1, packed, p.dtype, p.device)
    h = p.reshape(2, pre, Hin, post)
    out = p.new_empty((pre, N, post))
    for a, b in _chunks(pre, max(Hin, N), post):
        hr, hi = _herm_pad_rows(h[0, a, :, b], h[1, a, :, b], nh)
        if packed:
            out[a, :, b] = _c2r_rows_packed(hr, hi, tw, N, scale)
        else:
            out[a, :, b] = _c2r_rows(hr, hi, tw, N, scale)
    return out.reshape(shape[:axis] + (N,) + shape[axis + 1:])


# ---------------------------------------------------------------------------
# gates and wrappers
# ---------------------------------------------------------------------------

def _length_ok(N):
    return _supported_len(N) and N <= _MAX_N_AXIS


def _pair_length_ok(N):
    return N % 2 == 0 and _supported_len(N) and N <= _MAX_N_PAIR


def _unsupported_length(what, N, takes):
    return ValueError(
        f"{what}: axis length {N} is not {takes}, a length of this "
        f"kernel; the engine (ops/matfft.py: fft1d_p, rfftn_p, irfftn_p) "
        f"takes any length")


def _require_len(N, what):
    if not _length_ok(N):
        raise _unsupported_length(what, N,
                                 f"2^a or 3*2^a up to {_MAX_N_AXIS}")


def _require_pair_len(N, what):
    if not _pair_length_ok(N):
        raise _unsupported_length(what, N,
                                 f"an even 2^a or 3*2^a up to {_MAX_N_PAIR}")


def supported_axis(shape, axis):
    """True if ``fft_axis_p`` takes this axis (complex shape, no planar
    dim).  A length gate only: any ``pre``/``post`` is taken."""
    return _length_ok(shape[axis % len(shape)])


def supported_r2c(shape, axis):
    """Gate for ``rfft_axis_p``: shape is the real input shape."""
    return supported_axis(shape, axis)


def supported_c2r(shape, axis, n):
    """Gate for ``irfft_axis_p``: ``n`` is the real output length; any
    spectrum extent >= 1 is taken (short ones are Hermitian zero-padded
    in the read, rows past n//2+1 are ignored)."""
    return _length_ok(int(n)) and shape[axis % len(shape)] >= 1


def supported_axis_split(shape, axis):
    """Gate for ``fft_axis2_p``: ``shape`` is the complex shape of ONE
    half (the split axis carries N/2).  A length gate only."""
    return _pair_length_ok(2 * shape[axis % len(shape)])


def supported_axis_tp(shape, axis, dtype, trunc=None, pad=None):
    """Gate for ``fft_axis_tp``: a c2c pass with the truncation to
    ``trunc`` rows or the padding to ``pad`` rows fused in, along ``axis``
    of the complex ``shape``.  The transform length N (the input extent,
    or ``pad``) must be a kernel length, and the other extent lie in
    (0, N); float32 or float64.  Any axis position and any pre/post."""
    if (trunc is None) == (pad is None):
        raise ValueError("supported_axis_tp: give exactly one of trunc "
                         "and pad")
    if isinstance(dtype, torch.dtype):
        if dtype not in (torch.float32, torch.float64):
            return False
    elif np.dtype(dtype) not in (np.float32, np.float64):
        return False
    n = shape[axis % len(shape)]
    N, Nt = (n, int(trunc)) if trunc is not None else (int(pad), n)
    return _length_ok(N) and 0 < Nt < N


def _no_f64_pair(what):
    return NotImplementedError(
        f"{what}: float64 on CUDA takes axes up to {_MAX_N_AXIS}; longer "
        f"ones arrive with the fp64 build of the pair kernel (ROADMAP "
        f"Queue 2, D64)")


def _plain_ok(t, what, contiguous=True, f64=True):
    """True for a CPU tensor (the plain version runs); False for a CUDA
    tensor the kernel takes: float32, or float64 when the kernel has an
    fp64 build (``f64``); raises for anything else.  ``contiguous``: the
    kernel needs a contiguous tensor (else any layout passes here and the
    caller checks it)."""
    if t.device.type == 'cpu':
        if not t.is_floating_point():
            raise TypeError(f"{what}: needs a real floating tensor, "
                            f"got {t.dtype}")
        return True
    if t.device.type != 'cuda':
        raise ValueError(f"{what}: tensor on {t.device}; the kernels take "
                         f"CUDA tensors and the plain versions CPU tensors")
    if t.dtype == torch.float64 and not f64:
        raise _no_f64_pair(what)
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: the kernels take float32 and float64, "
                        f"got {t.dtype}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{what}: the kernel takes a contiguous tensor")
    return False


def _check_planar(p, what):
    if p.dim() < 2 or p.shape[0] != 2:
        raise ValueError(f"{what}: planar input must have shape (2,) + S, "
                         f"got {tuple(p.shape)}")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _launch(what, fn, t, *args):
    """Run one kernel's C entry on ``t``'s device and current stream;
    raise if CUDA refused the launch."""
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = fn(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"{rc} ({_build.error_string(rc)})")
    LAUNCHES[what] += 1


def _build_of(what, entry, t):
    """The launch counter and C entry of the build for t's dtype: the
    wrapper's name and ``<entry>_f32``, or ``<what>_f64`` and
    ``<entry>_f64``."""
    k = _build.load()
    if t.dtype == torch.float64:
        return what + '_f64', getattr(k, entry + '_f64')
    return what, getattr(k, entry + '_f32')


def _plan_args(W):
    plan = _stage_plan(W)
    return (ctypes.c_int * len(plan))(*plan), len(plan)


def fft_axis_p(p, axis, forward=True, scale=None, out=None):
    """Planar c2c FFT along ``axis`` (complex coords) of (2, ...) data.

    Unnormalized unless ``scale`` is given (applied in the last stage).
    forward=False is the unscaled inverse.  ``out``: a contiguous tensor
    like ``p`` to write into (a new one by default), ``p`` itself for in
    place: every kernel loads each line whole before it stores it, and no
    other block touches it.

    Which kernel runs is decided before the launch, by shape and
    alignment.  float32 (A) takes the tile kernel.  float64 (A64) at
    N = 512, 768 and 1024 takes the line kernel on whole lines (the last
    axis) when ``p`` and the output are 16-byte aligned, and the column
    band kernel on inner axes (16-byte vectors where the dims after the
    axis have an even size and both tensors are 16-byte aligned, else
    single elements); every other float64 call takes the tile kernel.
    All count as ``fft_axis_p`` / ``fft_axis_p_f64``."""
    what = 'fft_axis_p'
    _check_planar(p, what)
    shape = tuple(p.shape[1:])
    axis = axis % len(shape)
    N = shape[axis]
    _require_len(N, what)
    if out is not None and (out.shape != p.shape or out.dtype != p.dtype or
                            out.device != p.device or
                            not out.is_contiguous()):
        raise ValueError(f"{what}: out {tuple(out.shape)} {out.dtype} on "
                         f"{out.device} is not a contiguous "
                         f"{tuple(p.shape)} {p.dtype} on {p.device}")
    if _plain_ok(p, what):
        y = fft_axis_plain(p, axis, forward, scale)
        return y if out is None else out.copy_(y)
    pre, post = _pre_post(shape, axis)
    sign = -1 if forward else +1
    out = torch.empty_like(p) if out is None else out
    if out.numel() == 0:
        return out
    tw = (_tw_tensor_axis(N, sign, p.dtype, p.device)
          if p.dtype == torch.float64
          else _tw_tensor(N, sign, False, p.dtype, p.device))
    plan, nst = _plan_args(N)
    _launch(*_build_of(what, 'fft_axis', p), p,
            _ptr(p), _ptr(out), _ptr(tw), tw.shape[1], pre, N, post, sign,
            plan, nst, 1.0 if scale is None else float(scale))
    return out


def rfft_axis_p(x, axis, hext=None, scale=None, trunc=None):
    """Real tensor -> planar Hermitian half spectrum along ``axis``.

    Output extent is ``hext`` (default N//2+1, or ``trunc`` when given)
    with exact zero rows beyond the spectrum.  ``trunc`` (< N//2+1)
    applies the 3/2-rule Hermitian truncation in the kernel's write
    (Nyquist fold for even ``trunc``).  Packed N/2-point method.

    Which kernel runs is decided before the launch, by layout: a CUDA
    tensor along its last axis (whole lines) at N >= 4 whose data is
    aligned to a packed point (16 bytes in float64, 8 in float32) takes
    the line kernel (a warp-resident group of threads a line); every
    other case, N = 2 (not packed), an inner axis, or misaligned data,
    takes the tile kernel.  Both count as ``rfft_axis_p`` /
    ``rfft_axis_p_f64``."""
    what = 'rfft_axis_p'
    shape = tuple(x.shape)
    if not shape:
        raise ValueError(f"{what}: needs at least one dim")
    axis = axis % len(shape)
    N = shape[axis]
    _require_len(N, what)
    nh, hext = _r2c_out_rows(N, hext, trunc)
    if _plain_ok(x, what):
        return rfft_axis_plain(x, axis, hext, scale, trunc)
    pre, post = _pre_post(shape, axis)
    packed = N // 2 >= 2
    out = x.new_empty((2,) + shape[:axis] + (hext,) + shape[axis + 1:])
    if out.numel() == 0:
        return out
    tw = _tw_tensor(N, -1, packed, x.dtype, x.device)
    plan, nst = _plan_args(N // 2 if packed else N)
    nrows = nh if trunc is None else min(nh, int(trunc))
    fold = trunc is not None and int(trunc) < nh and int(trunc) % 2 == 0
    _launch(*_build_of(what, 'rfft_axis', x), x,
            _ptr(x), _ptr(out), _ptr(tw), tw.shape[1], pre, N, post, hext,
            nrows, int(fold), int(packed), plan, nst,
            1.0 if scale is None else float(scale))
    return out


def irfft_axis_p(p, axis, n, scale=None):
    """Planar Hermitian half spectrum -> real tensor of length ``n`` along
    ``axis``.  Input rows beyond n//2+1 are ignored; fewer rows are
    Hermitian zero-padded in the read.  Unscaled inverse (FFTW's c2r:
    N*x) unless ``scale`` is given.  Packed N/2-point method."""
    what = 'irfft_axis_p'
    _check_planar(p, what)
    shape = tuple(p.shape[1:])
    axis = axis % len(shape)
    N = int(n)
    _require_len(N, what)
    Hin = shape[axis]
    if Hin < 1:
        raise ValueError(f"{what}: empty spectrum axis")
    if _plain_ok(p, what):
        return irfft_axis_plain(p, axis, N, scale)
    pre, post = _pre_post(shape, axis)
    packed = N // 2 >= 2
    out = p.new_empty(shape[:axis] + (N,) + shape[axis + 1:])
    if out.numel() == 0:
        return out
    tw = _tw_tensor(N, +1, packed, p.dtype, p.device)
    plan, nst = _plan_args(N // 2 if packed else N)
    # the packed inverse returns N/2 * x: its scale carries the x2
    sc = 1.0 if scale is None else float(scale)
    if packed:
        sc = 2.0 * sc
    _launch(*_build_of(what, 'irfft_axis', p), p,
            _ptr(p), _ptr(out), _ptr(tw), tw.shape[1], pre, Hin, N, post,
            int(packed), plan, nst, sc)
    return out


def _half_strides(t, pre, h, post, what):
    """(plane, pre) strides of an operand of the pair kernel viewed as
    (2, pre, h, post); its rows must be ``post`` apart and its columns
    adjacent."""
    try:
        v = t.view(2, pre, h, post)
    except RuntimeError:
        v = None
    if v is None or (h > 1 and v.stride(2) != post) or \
            (post > 1 and v.stride(3) != 1):
        raise ValueError(f"{what}: the kernel takes halves whose dims after "
                         f"the axis are contiguous and whose dims before it "
                         f"merge into one; got strides {t.stride()}")
    return [v.stride(0), v.stride(1)]


def _launch_pair(what, a, b, oa, ob, axis, forward, scale):
    """The pair kernel on input halves a, b into output halves oa, ob
    (any of them views), along complex axis ``axis``.  N <= 1024 takes
    the line, band or tile kernel (the N-point plan and the table of
    _tw_pack_axis; fft_axis2_p names the rule); N = 1536 and 2048 take
    the cluster kernel, two CTAs a line group, one radix-2 step across
    the halves and the h = N/2-point plan in each (the h-point plan and
    the table of _tw_pack_pair)."""
    shape = tuple(a.shape[1:])
    h = shape[axis]
    N = 2 * h
    pre, post = _pre_post(shape, axis)
    strides = []
    for t in (a, b, oa, ob):
        strides += _half_strides(t, pre, h, post, what)
    sign = -1 if forward else +1
    if N > _MAX_N_AXIS:
        tw = _tw_tensor_pair(N, sign, a.dtype, a.device)
        plan, nst = _plan_args(h)
    else:
        tw = _tw_tensor_axis(N, sign, a.dtype, a.device)
        plan, nst = _plan_args(N)
    _launch(what, _build.load().fft_axis2_f32, a,
            _ptr(a), _ptr(b), _ptr(oa), _ptr(ob),
            (ctypes.c_longlong * 8)(*strides), _ptr(tw), tw.shape[1], pre,
            N, post, sign, plan, nst, 1.0 if scale is None else float(scale))


def fft_axis2_p(pa, pb, axis, forward=True, scale=None, alias=False,
                out=None):
    """Planar c2c FFT along ``axis`` (complex coords) where that axis is
    split across two (2, ...) tensors: ``pa`` holds rows 0..N/2 and ``pb``
    rows N/2..N.  Returns the two output halves, in natural order.

    Unnormalized unless ``scale`` is given (applied in the last write).
    ``alias=True`` writes each output over its input half and returns the
    inputs; ``out=(oa, ob)`` writes into two tensors like the halves
    instead of new ones.  The halves need not be contiguous: the dims
    after the axis must be, and the dims before it must merge into one.

    Which kernel runs is decided before the launch, by shape and
    alignment.  At N <= 1024, when all four halves start 16-byte aligned
    and their plane and pre strides are multiples of 4 elements: whole
    lines (the last axis) at N = 512, 768 and 1024 take the line kernel,
    and inner axes at N = 512, 768 and 1024 whose dims after the axis
    have a size that is a multiple of 4 take the band kernel (a cluster of
    four CTAs, the first two loading rows of ``pa``, the others of
    ``pb``).  Every other call at N <= 1024
    takes A's tile.  N = 1536 and 2048 take the cluster kernel.  All
    count as one ``fft_axis2_p`` launch."""
    what = 'fft_axis2_p'
    _check_planar(pa, what)
    _check_planar(pb, what)
    if pa.shape != pb.shape or pa.dtype != pb.dtype or \
            pa.device != pb.device:
        raise ValueError(f"{what}: halves of {tuple(pa.shape)} {pa.dtype} "
                         f"on {pa.device} and {tuple(pb.shape)} {pb.dtype} "
                         f"on {pb.device} do not match")
    shape = tuple(pa.shape[1:])
    axis = axis % len(shape)
    _require_pair_len(2 * shape[axis], what)
    if out is not None:
        if alias:
            raise ValueError(f"{what}: alias=True and out= together")
        for o in out:
            if o.shape != pa.shape or o.dtype != pa.dtype or \
                    o.device != pa.device:
                raise ValueError(f"{what}: out half {tuple(o.shape)} "
                                 f"{o.dtype} on {o.device} is not a "
                                 f"{tuple(pa.shape)} {pa.dtype} on "
                                 f"{pa.device}")
    plain = _plain_ok(pa, what, contiguous=False, f64=False)
    _plain_ok(pb, what, contiguous=False, f64=False)
    if plain:
        oa, ob = fft_axis2_plain(pa, pb, axis, forward, scale)
        if alias:
            out = (pa, pb)
        if out is not None:
            out[0].copy_(oa)
            out[1].copy_(ob)
            return tuple(out)
        return oa, ob
    if alias:
        oa, ob = pa, pb
    elif out is not None:
        oa, ob = out
    else:
        oa = torch.empty(pa.shape, dtype=pa.dtype, device=pa.device)
        ob = torch.empty_like(oa)
    if oa.numel() == 0:
        return oa, ob
    _launch_pair(what, pa, pb, oa, ob, axis, forward, scale)
    return oa, ob


def fft_axis_pair_p(p, axis, forward=True, scale=None):
    """Planar c2c FFT along a long ``axis`` (an even 2^a or 3*2^a up to
    2048) of (2, ...) data as one pass of the pair kernel, which reads and
    writes the two halves of the axis as views of ``p`` and of the
    output: no slice copy and no concat.  Unnormalized unless ``scale``
    is given.  The kernel is fft_axis2_p's, by its rule."""
    what = 'fft_axis_pair_p'
    _check_planar(p, what)
    shape = tuple(p.shape[1:])
    axis = axis % len(shape)
    N = shape[axis]
    _require_pair_len(N, what)
    if _plain_ok(p, what, f64=False):
        return fft_axis_pair_plain(p, axis, forward, scale)
    out = torch.empty_like(p)
    if out.numel() == 0:
        return out
    d, h = 1 + axis, N // 2
    _launch_pair(what, p.narrow(d, 0, h), p.narrow(d, h, h),
                 out.narrow(d, 0, h), out.narrow(d, h, h), axis, forward,
                 scale)
    return out


def pair_max_active_clusters(N):
    """How many two-CTA clusters of the pair kernel's N-point pass
    (N = 1536 or 2048) the current CUDA device holds at once
    (cudaOccupancyMaxActiveClusters); 0 if none fits there."""
    if N not in (1536, 2048):
        raise ValueError(f"pair_max_active_clusters: N = {N}; the cluster "
                         f"pass takes 1536 and 2048")
    count = ctypes.c_int(0)
    rc = _build.load().fft_axis2_clusters_f32(N, ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"pair_max_active_clusters: CUDA error {rc} "
                           f"({_build.error_string(rc)})")
    return count.value


def fft_axis_tp(p, axis, forward=True, trunc=None, pad=None, scale=None):
    """Planar c2c FFT along ``axis`` (complex coords) of (2, ...) data with
    the 3/2-rule dealiasing boundary fused into the pass: ``trunc=Nt``
    truncates the N-point spectrum to Nt rows in the write (Nyquist fold
    for even Nt), ``pad=Np`` zero-pads an Nt-row spectrum to the Np-point
    transform in the read (Nyquist split for even Nt).  Exactly one of
    them.  Unnormalized unless ``scale`` is given (folded into the write).
    Out of place: the extents differ."""
    what = 'fft_axis_tp'
    _check_planar(p, what)
    shape = tuple(p.shape[1:])
    axis = axis % len(shape)
    N, Nt, Nin, Nout = _tp_rows(p, axis, trunc, pad)
    _require_len(N, what)
    if not 0 < Nt < N:
        raise ValueError(f"{what}: the truncated extent {Nt} must lie in "
                         f"(0, {N})")
    if _plain_ok(p, what):
        return fft_axis_tp_plain(p, axis, forward, trunc, pad, scale)
    pre, post = _pre_post(shape, axis)
    sign = -1 if forward else +1
    out = p.new_empty((2,) + shape[:axis] + (Nout,) + shape[axis + 1:])
    if out.numel() == 0:
        return out
    tw = _tw_tensor(N, sign, False, p.dtype, p.device)
    plan, nst = _plan_args(N)
    _launch(*_build_of(what, 'fft_axis_tp', p), p,
            _ptr(p), _ptr(out), _ptr(tw), tw.shape[1], pre, N, Nt,
            int(pad is not None), post, sign, plan, nst,
            1.0 if scale is None else float(scale))
    return out


# ---------------------------------------------------------------------------
# H and I: c2c over the last two axes in one launch
# ---------------------------------------------------------------------------

_MAX_N_PLANE = 256          # H's axes (the JAX package's _MAX_N)


def _plane_ok(shape, dtype, cap):
    """True for float32 planes whose last two axes are powers of two of
    at most ``cap`` points each."""
    if isinstance(dtype, torch.dtype):
        f32 = dtype == torch.float32
    else:
        f32 = np.dtype(dtype) == np.float32
    return (f32 and len(shape) >= 2 and _is_pow2(shape[-2]) and
            _is_pow2(shape[-1]) and max(shape[-2], shape[-1]) <= cap)


def supported_plane(shape, dtype):
    """Gate for ``fft_plane_p`` (H): the last two axes of the complex
    ``shape`` are powers of two of at most 256 points, float32.  The
    JAX gate's block rules (pre % T, N2 % 128) are TPU layout and are
    not ported: any leading extent is taken."""
    return _plane_ok(shape, dtype, _MAX_N_PLANE)


def supported_plane_large(shape, dtype):
    """Gate for ``fft_plane_large_p`` (I): the last two axes are powers
    of two the Stockham core takes (at most 1024 points each, so
    N1 * N2 <= 2^20 as the JAX gate asks), float32.  The JAX gate's
    128-multiples are not ported."""
    return _plane_ok(shape, dtype, _MAX_N_AXIS)


def fft_plane_plain(p, forward=True, scale=None):
    """Plain PyTorch version of ``fft_plane_p``: the plain A on the last
    axis, then on the second-to-last with the scale."""
    n = p.dim() - 1
    y = fft_axis_plain(p, n - 1, forward)
    return fft_axis_plain(y, n - 2, forward, scale)


def fft_plane_large_plain(p, forward=True, scale=None):
    """Plain PyTorch version of ``fft_plane_large_p``: the same function
    as ``fft_plane_plain``."""
    return fft_plane_plain(p, forward, scale)


def _plane(what, p, forward, scale, gate, plain):
    """The plane kernels, chosen by shape: planes whose two axes are both
    at most 256 points (every plane of H's gate) on the plane-holding
    kernel, any other (I's larger planes) on the row line kernel and the
    column band kernel, launched together."""
    _check_planar(p, what)
    shape = tuple(p.shape[1:])
    if not gate(shape, p.dtype):
        raise ValueError(f"{what}: the last two axes of {shape} {p.dtype} "
                         f"are not a plane this kernel takes (see "
                         f"{gate.__name__})")
    if _plain_ok(p, what):
        return plain(p, forward, scale)
    N1, N2 = shape[-2], shape[-1]
    if p.data_ptr() % 16:
        p = p.clone()
    out = torch.empty_like(p)
    if out.numel() == 0:
        return out
    P = math.prod(shape[:-2])
    sign = -1 if forward else +1
    sc = 1.0 if scale is None else float(scale)
    tw2 = _tw_tensor_powers(N2, sign, p.dtype, p.device)
    tw1 = _tw_tensor_powers(N1, sign, p.dtype, p.device)
    hold = max(N1, N2) <= _MAX_N_PLANE
    entry = _build.load().fft_plane_f32 if hold else \
        _build.load().fft_plane_large_f32
    _launch(what, entry, p, _ptr(p), _ptr(out), _ptr(tw2), _ptr(tw1), P,
            N1, N2, sign, sc)
    return out


def fft_plane_p(p, forward=True, scale=None):
    """Planar c2c FFT over both of the last two axes of (2, ...) float32
    data in one launch (H: axes of at most 256 points).  Unnormalized
    unless ``scale`` is given (folded into the last write).

    On CUDA every plane takes the plane-holding kernel: a plane of at most
    8192 points is held whole by one CTA (several planes a CTA), a larger
    one by a cluster of N1 * N2 / 8192 CTAs; each plane crosses device
    memory once each way."""
    return _plane('fft_plane_p', p, forward, scale, supported_plane,
                  fft_plane_plain)


def fft_plane_large_p(p, forward=True, scale=None):
    """Planar c2c FFT over both of the last two axes of (2, ...) float32
    data in one launch (I: planes of N1 * N2 <= 2^20 points, each axis at
    most 1024).  Unnormalized unless ``scale`` is given.

    On CUDA the kernel is chosen by shape: a plane whose two axes are
    both at most 256 points takes H's plane-holding kernel, any other the
    row line kernel (a group of threads a row, held in registers), then
    the column band kernel (adjacent columns over all of a plane's rows
    held in shared memory, by a cluster of two CTAs at 1024 rows, in
    place), both launched by one C entry and counted as one launch."""
    return _plane('fft_plane_large_p', p, forward, scale,
                  supported_plane_large, fft_plane_large_plain)


def plane_max_active_clusters(N1, N2):
    """(K, count) for N1 x N2 planes on the plane-holding kernel: the
    CTAs of a plane, and how many clusters of K (K > 1;
    cudaOccupancyMaxActiveClusters) or single CTAs (K = 1) the current
    CUDA device holds at once; count is 0 if none fits there."""
    if not supported_plane((N1, N2), torch.float32):
        raise ValueError(f"plane_max_active_clusters: ({N1}, {N2}) is not "
                         f"a plane of H's gate")
    k, count = ctypes.c_int(0), ctypes.c_int(0)
    rc = _build.load().fft_plane_clusters_f32(N1, N2, ctypes.byref(k),
                                              ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"plane_max_active_clusters: CUDA error {rc} "
                           f"({_build.error_string(rc)})")
    return k.value, count.value
