"""Overlap of the pencil exchanges with the transform stages.

Port of ``mpi4py_fft_tpu/parallel/overlap.py`` (``chunk_count`` :50,
``resolve`` :58, ``overlapped`` :69).  A pipeline step (an exchange and
the stage beside it) is cut into chunks along an axis that takes part in
neither, and chunk k+1's ``all_to_all_single`` is issued (``async_op``)
before chunk k's stage runs, so that the stage runs while the exchange
is in flight.  Each element's computation is the same with and without
chunks, so the results are bit-identical.

The chunk count is ``a2a_chunks`` of the plan, else the environment
variable ``MPI4PY_FFT_TORCH_A2A_CHUNKS``: ``auto`` (4 chunks where each
still moves at least 4 MiB, else 1) or an int.
"""
import os

import torch

__all__ = ['chunk_count', 'resolve', 'overlapped']

_MIN_CHUNK_BYTES = 4 * 2 ** 20


def chunk_count(override=None):
    """The configured chunk count (0 = auto)."""
    if override is not None:
        return int(override)
    v = os.environ.get('MPI4PY_FFT_TORCH_A2A_CHUNKS', 'auto')
    return 0 if v == 'auto' else int(v)


def resolve(cfg, nbytes, ext):
    """Chunks for one exchange: ``cfg`` (0 = auto), the local block's
    bytes and the extent of the chunk axis; the count divides the
    extent."""
    if cfg == 0:
        cfg = 4 if nbytes >= 4 * _MIN_CHUNK_BYTES else 1
    c = max(1, min(int(cfg), ext))
    while c > 1 and ext % c:
        c -= 1
    return c


def overlapped(p, axis_c, nchunks, pre, start, post, out_axis=None):
    """One pipeline step over ``nchunks`` slices of ``p`` along
    ``axis_c``: ``pre`` (a stage before the exchange, or None),
    ``start`` (issues the exchange, returns a handle whose ``wait()``
    gives its result) and ``post`` (a stage after it, or None), then the
    chunks joined along ``out_axis`` (``axis_c`` by default; the stage
    may change the planar rank).  Chunk k+1's exchange is in flight while
    chunk k's ``post`` runs."""
    pre = pre or (lambda x: x)
    post = post or (lambda x: x)
    if nchunks <= 1 or p.shape[axis_c] % nchunks:
        return post(start(pre(p)).wait())
    # the kernels take contiguous tensors: each chunk is copied out
    parts = [c.contiguous() for c in
             torch.split(p, p.shape[axis_c] // nchunks, dim=axis_c)]
    pending = start(pre(parts[0]))
    done = []
    for k in range(nchunks):
        nxt = start(pre(parts[k + 1])) if k + 1 < nchunks else None
        done.append(post(pending.wait()))
        pending = nxt
    return torch.cat(done, dim=axis_c if out_axis is None else out_axis)
