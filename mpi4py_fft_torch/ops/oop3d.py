"""Quartered out-of-place 3-D c2c transform.

Port of ``mpi4py_fft_tpu/ops/oop3d.py``.  The volume is held as four
quarters, split along the first (x) and last (z) complex axes:

    Q[i][j] = volume[:, i*X/2:(i+1)*X/2, :, j*Z/2:(j+1)*Z/2]

and every axis pass runs out of place:

    y pass (mid):  per quarter,  fft_axis_p         (axis fully local)
    x pass (lead): per z-half,   fft_axis2_p pair   (x split across i)
    z pass (last): per x-half,   fft_axis2_p pair   (z split across j)

The state stays quartered across chained transforms; split and assemble
happen only at the boundaries.  The eighths schedule (``split_8``,
``fft3_8``) halves all three axes and runs every pass as a pair.

Memory: PyTorch runs eagerly, so a quarter is freed when its last
reference goes.  ``fft3_q``/``fft3_8`` rebind each piece as soon as its
pass is done, and when given a list they empty it, taking over the
caller's references: then at most two outputs are in flight beside the
four quarters (1.5 volumes).  Given a tuple, the caller's input pieces
stay alive to the end.
"""
import numpy as np
import torch

from . import butterfly as bf

__all__ = ['supported_q', 'split_q', 'assemble_q', 'fft3_q',
           'supported_8', 'split_8', 'assemble_8', 'fft3_8']


def supported_q(shape, dtype):
    """True if ``fft3_q`` takes a planar volume of complex shape ``shape``
    (3-D, no planar dim) for this dtype: float32 and lengths the kernels
    take."""
    if len(shape) != 3 or np.dtype(dtype) != np.float32:
        return False
    X, Y, Z = shape
    if X % 2 or Z % 2:
        return False
    q = (X // 2, Y, Z // 2)
    return (bf.supported_axis(q, 1) and bf.supported_axis_split(q, 0)
            and bf.supported_axis_split(q, 2))


def split_q(p):
    """Planar volume (2, X, Y, Z) -> tuple of 4 contiguous quarters
    Q[i][j], in the order Q00, Q01, Q10, Q11."""
    hx, hz = p.shape[1] // 2, p.shape[3] // 2
    return tuple(p[:, i * hx:(i + 1) * hx, :, j * hz:(j + 1) * hz]
                 .contiguous() for i in (0, 1) for j in (0, 1))


def assemble_q(qs):
    """Inverse of ``split_q``."""
    q00, q01, q10, q11 = qs
    return torch.cat([torch.cat([q00, q01], dim=3),
                      torch.cat([q10, q11], dim=3)], dim=1)


def _take(pieces):
    """The pieces as a list; a list given is emptied (the caller hands
    its references over)."""
    out = list(pieces)
    if isinstance(pieces, list):
        pieces.clear()
    return out


def fft3_q(qs, forward=True, scale=None):
    """3-D c2c transform of a quartered planar volume; returns the
    transformed quarters.  ``scale`` (if given) is folded into the last
    pass."""
    q00, q01, q10, q11 = _take(qs)
    # y pass (mid axis, fully local to each quarter)
    q00 = bf.fft_axis_p(q00, 1, forward)
    q01 = bf.fft_axis_p(q01, 1, forward)
    q10 = bf.fft_axis_p(q10, 1, forward)
    q11 = bf.fft_axis_p(q11, 1, forward)
    # x pass (lead axis, split across the i halves)
    q00, q10 = bf.fft_axis2_p(q00, q10, 0, forward)
    q01, q11 = bf.fft_axis2_p(q01, q11, 0, forward)
    # z pass (last axis, split across the j halves; fold normalization)
    q00, q01 = bf.fft_axis2_p(q00, q01, 2, forward, scale=scale)
    q10, q11 = bf.fft_axis2_p(q10, q11, 2, forward, scale=scale)
    return (q00, q01, q10, q11)


# ---------------------------------------------------------------------------
# eighths schedule: every pass an out-of-place pair
# ---------------------------------------------------------------------------

def supported_8(shape, dtype):
    """True if ``fft3_8`` takes a planar volume of complex shape ``shape``
    (3-D) for this dtype."""
    if len(shape) != 3 or np.dtype(dtype) != np.float32:
        return False
    X, Y, Z = shape
    if X % 2 or Y % 2 or Z % 2:
        return False
    e = (X // 2, Y // 2, Z // 2)
    return all(bf.supported_axis_split(e, a) for a in (0, 1, 2))


def split_8(p):
    """Planar volume (2, X, Y, Z) -> tuple of 8 contiguous eighths
    E[i*4 + j*2 + k] = p[:, i*X/2:(i+1)*X/2, j*Y/2:.., k*Z/2:..]."""
    hx, hy, hz = p.shape[1] // 2, p.shape[2] // 2, p.shape[3] // 2
    return tuple(
        p[:, i * hx:(i + 1) * hx, j * hy:(j + 1) * hy,
          k * hz:(k + 1) * hz].contiguous()
        for i in (0, 1) for j in (0, 1) for k in (0, 1))


def assemble_8(es):
    """Inverse of ``split_8``."""
    rows = []
    for i in (0, 1):
        cols = [torch.cat([es[4 * i + 2 * j], es[4 * i + 2 * j + 1]], dim=3)
                for j in (0, 1)]
        rows.append(torch.cat(cols, dim=2))
    return torch.cat(rows, dim=1)


def fft3_8(es, forward=True, scale=None):
    """3-D c2c transform of an eighths-split planar volume; ``scale`` (if
    given) is folded into the last (z) pass."""
    es = _take(es)
    for i in (0, 1):                    # y pass: pair over j
        for k in (0, 1):
            a, b = 4 * i + k, 4 * i + 2 + k
            es[a], es[b] = bf.fft_axis2_p(es[a], es[b], 1, forward)
    for j in (0, 1):                    # x pass: pair over i
        for k in (0, 1):
            a, b = 2 * j + k, 4 + 2 * j + k
            es[a], es[b] = bf.fft_axis2_p(es[a], es[b], 0, forward)
    for i in (0, 1):                    # z pass: pair over k
        for j in (0, 1):
            a, b = 4 * i + 2 * j, 4 * i + 2 * j + 1
            es[a], es[b] = bf.fft_axis2_p(es[a], es[b], 2, forward,
                                          scale=scale)
    return tuple(es)
