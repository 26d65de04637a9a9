"""Bytes, operations and the least time of a transform, from shapes alone.

A transform's least time counts its global input read once and its
global output written once, whatever implements it, so that fusing or
splitting passes leaves the figure where it is.  Operations: 2.5 N log2 N
for each line of a real axis (r2c, c2r, a DCT or DST) and 5 N log2 N for
each line of a complex axis, the lines counted on the data as that axis
meets it (a complex axis after the r2c sees the halved axis).

Peaks: NVIDIA H100 SXM5 80GB data sheet, dense rates at the 700 W limit.
"""
import math

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # HBM3
FP64_FLOPS = 34e12               # float64 outside the tensor cores
FP32_FLOPS = 67e12               # float32 outside the tensor cores
PEAK_FLOPS = {'d': FP64_FLOPS, 'f': FP32_FLOPS}
REAL_ITEMSIZE = {'d': 8, 'f': 4}


def nbytes(shape, itemsize):
    return int(np.prod(shape, dtype=np.int64)) * itemsize


def axis_ops(shape, axis, real):
    """Operations of one axis of ``shape``: its lines times 2.5 or 5
    N log2 N."""
    n = int(shape[axis])
    lines = int(np.prod(shape, dtype=np.int64)) // n
    return lines * (2.5 if real else 5.0) * n * math.log2(n)


def real_transform(grid, order, kinds, dtype):
    """Bytes and operations of a transform between a real ``grid`` and
    its spectrum.

    ``order``: the axes in the order the forward direction applies
    them; ``kinds``: for each, ``'r2r'`` (a real axis that stays real),
    ``'r2c'`` (halves the axis to N//2 + 1 complex points) or ``'c2c'``.
    The real grid is the input of the forward and the output of the
    backward; both directions move the same bytes and do the same
    operations.  ``grid`` is the grid the transforms run on (for a
    dealiased plan, the padded grid); the spectrum is ``spectrum``'s
    shape, returned with the counts."""
    it = REAL_ITEMSIZE[dtype]
    shape = list(grid)
    ops = 0.0
    complex_ = False
    for ax, kind in zip(order, kinds):
        ops += axis_ops(shape, ax, real=kind in ('r2r', 'r2c'))
        if kind == 'r2c':
            shape[ax] = shape[ax] // 2 + 1
            complex_ = True
    return {'real_shape': tuple(grid), 'spectrum_shape': tuple(shape),
            'spectrum_complex': complex_, 'ops': ops,
            'real_bytes': nbytes(grid, it),
            'spectrum_bytes': nbytes(shape, 2 * it if complex_ else it)}


def dealiased(N, padding, dtype):
    """The dealiased r2c plan of ``N`` (the real axis last) with the
    3/2 rule: the padded real grid on one side, the truncated spectrum
    (N0, N1, N2 // 2 + 1) on the other; operations on the padded grid."""
    grid = [int(round(n * p)) for n, p in zip(N, padding)]
    nd = len(N)
    w = real_transform(grid, list(range(nd))[::-1],
                       ['r2c'] + ['c2c'] * (nd - 1), dtype)
    spec = list(N[:-1]) + [N[-1] // 2 + 1]
    w['spectrum_shape'] = tuple(spec)
    w['spectrum_bytes'] = nbytes(spec, 2 * REAL_ITEMSIZE[dtype])
    return w


def least_seconds(nbytes_, ops, dtype):
    """(seconds, 'bytes' or 'operations'): the larger of the two
    bounds and which one holds."""
    tb = nbytes_ / HBM_BYTES_PER_S
    to = ops / PEAK_FLOPS[dtype]
    return (tb, 'bytes') if tb >= to else (to, 'operations')


def transform_least(work, dtype):
    """Least seconds of one transform (either direction) of ``work``,
    and the bound that holds."""
    return least_seconds(work['real_bytes'] + work['spectrum_bytes'],
                         work['ops'], dtype)
