"""Probe kernels: the port of the JAX package's TPU microbenchmarks
(``scripts/tpu_*.py``), each a hand-written CUDA kernel with its plain
PyTorch version beside it:

* ``block_copy`` (csrc/probe_copy.cu): a copy of a contiguous float32
  tensor box by box, in the caller's box shape and grid order, in place
  or out of place, one stream or two (``block_copy_route``: 16-byte
  vectors or single floats);
* ``move`` (csrc/probe_copy.cu): a gather copy along one axis (even, odd,
  reverse, roll), the moves of the packed r2c kernel (``move_route``:
  whole lines in registers or staged in shared memory, rows of 16-byte
  vectors, or single floats; ``move_bytes``: its least traffic);
* ``bfly`` (csrc/probe_bfly.cu): A's kernels (its line and band kernels
  at N = 512, 768 and 1024, its tile elsewhere or with ``lines=``) with
  the work between their load and their store chosen by a mode (copy,
  moves, adds, full) and run ``reps`` times;
* ``fma_chain`` (csrc/probe_fma.cu): ``acc <- acc * a + b`` repeated, the
  card's FMA rate, float32 and float64.

The modules of ``mpi4py_fft_torch.probes`` time them (and A itself,
``butterfly.fft_axis_p`` with ``out=``).  On a CPU tensor a wrapper runs
the plain version; on a CUDA tensor it launches its kernel or raises.
Each launch adds one to its count in ``LAUNCHES`` and runs in the span
``kernel.<name>`` with the bytes it cannot avoid moving (each element it
reads and each it writes, once); a plain version runs in that span in the
kernel's place.
"""
import ctypes
import math

import torch

from . import _build
from . import butterfly as bf
from ..utils import profiling

__all__ = ['block_copy', 'block_copy_plain', 'block_copy_route',
           'COPY_ROUTES', 'move', 'move_plain', 'move_route', 'move_bytes',
           'MOVE_ROUTES', 'bfly', 'bfly_plain',
           'bfly_route', 'BFLY_ROUTES', 'tile_lines', 'fma_chain',
           'fma_chain_plain',
           'MOVES', 'MODES', 'FMA_A', 'FMA_B', 'LAUNCHES', 'reset_launches']

# kernel launches since the last reset; a wrapper adds one where it
# launches its kernel and nowhere else
LAUNCHES = {'block_copy': 0, 'move': 0, 'bfly': 0, 'fma_chain': 0,
            'fma_chain_f64': 0}

MOVES = ('even', 'odd', 'reverse', 'roll')
# block_copy's routes by the C entry's number (mff_block_copy_route_f32)
COPY_ROUTES = ('scalar', 'vector')
# move's routes by the C entry's number (mff_move_route_f32)
MOVE_ROUTES = ('scalar', 'rows', 'lines', 'lines_shared')
# bfly's routes by the C entry's number (mff_bfly_route_f32)
BFLY_ROUTES = ('tile', 'lines', 'band')
MODES = ('copy', 'moves', 'adds', 'full')
# the constants of scripts/tpu_vpu_peak.py:53-54
FMA_A, FMA_B = 1.0000001, 1e-9
_FMA_ACC = (1, 4, 8, 16)


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _plain_ok(t, what, dtypes=(torch.float32,)):
    """True for a CPU tensor (the plain version runs); False for a
    contiguous CUDA tensor of a type the kernel takes; raises for
    anything else."""
    if t.device.type == 'cpu':
        return True
    if t.device.type != 'cuda':
        raise ValueError(f"{what}: tensor on {t.device}; the kernels take "
                         f"CUDA tensors and the plain versions CPU tensors")
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: the kernel takes "
                        f"{', '.join(str(d) for d in dtypes)}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: the kernel takes a contiguous tensor")
    return False


def _launch(what, fn, t, *args, nbytes):
    """Run one probe kernel's C entry on ``t``'s device and current
    stream, in the span ``kernel.<what>`` of ``nbytes``; raise if CUDA
    refused the launch."""
    with torch.cuda.device(t.device), \
            profiling.annotate('kernel.' + what, nbytes):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = fn(*args, ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"{what}: kernel launch failed with CUDA "
                               f"error {rc} ({_build.error_string(rc)})")
        profiling.launched()
    LAUNCHES[what] += 1


def _target(x, out, shape, what):
    """``out`` checked against the result's shape, type and device, or a
    new tensor."""
    if out is None:
        return x.new_empty(shape)
    if tuple(out.shape) != tuple(shape) or out.dtype != x.dtype or \
            out.device != x.device or not out.is_contiguous():
        raise ValueError(f"{what}: out {tuple(out.shape)} {out.dtype} on "
                         f"{out.device} is not a contiguous {tuple(shape)} "
                         f"{x.dtype} on {x.device}")
    return out


def _same(a, b, what):
    if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
        raise ValueError(f"{what}: {tuple(a.shape)} {a.dtype} on {a.device} "
                         f"and {tuple(b.shape)} {b.dtype} on {b.device} do "
                         f"not match")


# ---------------------------------------------------------------------------
# block_copy
# ---------------------------------------------------------------------------

def block_copy_plain(x):
    """Plain PyTorch version of ``block_copy``: the boxes only order the
    work, so the function is a copy."""
    return x.clone()


def _box_args(x, box, order, what):
    nd = x.dim()
    box = tuple(int(b) for b in box)
    order = tuple(range(nd)) if order is None else tuple(int(o)
                                                         for o in order)
    if not 1 <= nd <= 5 or len(box) != nd or \
            any(b < 1 or s % b for s, b in zip(x.shape, box)):
        raise ValueError(f"{what}: box {box} does not tile {tuple(x.shape)} "
                         f"(at most 5 dims)")
    if sorted(order) != list(range(nd)):
        raise ValueError(f"{what}: grid order {order} is not a permutation "
                         f"of the {nd} axes")
    return box, order


def _copy_args(x, box, order, out, x2, out2):
    """The C entry's pointers, dims, box and order; a missing output is
    taken as the new tensor block_copy allocates (16-byte aligned)."""
    nd = x.dim()
    ptrs = [bf._ptr(x), bf._ptr(x if out is None else out)]
    if x2 is not None:
        ptrs += [bf._ptr(x2), bf._ptr(x2 if out2 is None else out2)]
    else:
        ptrs += [None, None]
    return (*ptrs, (ctypes.c_longlong * nd)(*x.shape),
            (ctypes.c_longlong * nd)(*box), (ctypes.c_int * nd)(*order), nd)


def block_copy_route(x, box, order=None, out=None, x2=None, out2=None):
    """The route ``block_copy`` takes on these tensors on the card:
    'vector' (16-byte vectors) or 'scalar' (a base not 16-byte aligned,
    or a box run not a multiple of 4 floats), by the C entry's own rule
    (the built kernel library answers; nothing is launched)."""
    what = 'block_copy'
    box, order = _box_args(x, box, order, what)
    rc = _build.load().block_copy_route_f32(
        *_copy_args(x, box, order, out, x2, out2))
    if rc < 0:
        raise ValueError(f"{what}: no route for {tuple(x.shape)} in boxes "
                         f"{box}")
    return COPY_ROUTES[rc]


def block_copy(x, box, order=None, out=None, x2=None, out2=None):
    """Copy contiguous float32 ``x`` into ``out`` (a new tensor, or ``x``
    itself for in place) in boxes of shape ``box``, one CTA a box at a
    time, the boxes enumerated over the grid axes ``order`` (slowest
    first; default row-major, the last axis fastest).  With ``x2`` the
    same boxes of ``x2`` go to ``out2`` in the same launch (2-in/2-out).
    Returns ``out``, or ``(out, out2)``."""
    what = 'block_copy'
    box, order = _box_args(x, box, order, what)
    pair = x2 is not None
    if pair:
        _same(x, x2, what)
    plain = _plain_ok(x, what)
    if pair:
        _plain_ok(x2, what)
    out = _target(x, out, x.shape, what)
    out2 = _target(x2, out2, x.shape, what) if pair else None
    nbytes = 2 * (1 + pair) * x.numel() * x.element_size()
    if plain:
        def copies():
            out.copy_(block_copy_plain(x))
            if pair:
                out2.copy_(block_copy_plain(x2))
        bf._plain(what, nbytes, copies)
    elif x.numel():
        _launch(what, _build.load().block_copy_f32, x,
                *_copy_args(x, box, order, out, x2, out2), nbytes=nbytes)
    return (out, out2) if pair else out


# ---------------------------------------------------------------------------
# move
# ---------------------------------------------------------------------------

def _move_shape(x, axis, kind, what):
    if kind not in MOVES:
        raise ValueError(f"{what}: kind {kind!r} is not one of {MOVES}")
    axis = axis % x.dim()
    N = x.shape[axis]
    if kind in ('even', 'odd') and N % 2:
        raise ValueError(f"{what}: {kind} takes an even axis, got {N}")
    shape = list(x.shape)
    if kind in ('even', 'odd'):
        shape[axis] = N // 2
    return axis, tuple(shape)


def move_plain(x, axis, kind, shift=0):
    """Plain PyTorch version of ``move``: slicing (even ``x[0::2]``, odd
    ``x[1::2]``), flip or roll along ``axis``, then a clone."""
    axis = axis % x.dim()
    idx = [slice(None)] * x.dim()
    if kind == 'even':
        idx[axis] = slice(0, None, 2)
        return x[tuple(idx)].clone()
    if kind == 'odd':
        idx[axis] = slice(1, None, 2)
        return x[tuple(idx)].clone()
    if kind == 'reverse':
        return x.flip(axis)
    return torch.roll(x, int(shift), axis)


def _span(t):
    """The first and one past the last byte address of ``t``'s
    elements."""
    a = t.data_ptr()
    last = sum((s - 1) * st for s, st in zip(t.shape, t.stride()))
    return a, a + (last + 1) * t.element_size()


def _check_apart(x, out, what):
    """Raise where ``out``'s address span overlaps ``x``'s: in place, a
    kernel's threads would overwrite elements of ``x`` that others have
    still to read, so no move runs in place, on the card or on the CPU.
    The spans are compared, not the elements: on the CPU two views that
    interleave without sharing a byte are refused too (on the card both
    are contiguous, and spans and bytes agree)."""
    if out is None or not x.numel() or not out.numel() or \
            out.device != x.device:
        return
    (a0, a1), (b0, b1) = _span(x), _span(out)
    if a0 < b1 and b0 < a1:
        raise ValueError(f"{what}: out's span overlaps x's; a move does "
                         f"not run in place")


def _move_args(x, axis, kind, shift):
    """P, N, Q of the (P, N, Q) view, the kind's number and the shift in
    [0, N)."""
    N = x.shape[axis]
    return (math.prod(x.shape[:axis]), N, math.prod(x.shape[axis + 1:]),
            MOVES.index(kind), int(shift) % N)


def move_route(x, axis, kind, shift=0, out=None):
    """The route ``move`` takes on these tensors on the card, by the C
    entry's own rule (the built kernel library answers; nothing is
    launched): 'lines' (the last axis, even and odd: 16-byte vectors
    gathered in registers), 'lines_shared' (the last axis, reverse and
    roll: whole lines staged in shared memory), 'rows' (another axis, rows of a
    multiple of 4 floats as 16-byte vectors) or 'scalar' (a base not
    16-byte aligned, rows of other lengths, lines too long to stage).
    ``out`` None: a new tensor."""
    what = 'move'
    axis, shape = _move_shape(x, axis, kind, what)
    _check_apart(x, out, what)
    rc = _build.load().move_route_f32(
        bf._ptr(x), None if out is None else bf._ptr(out),
        *_move_args(x, axis, kind, shift))
    if rc < 0:
        raise ValueError(f"{what}: no route for {kind} along axis {axis} of "
                         f"{tuple(x.shape)}")
    return MOVE_ROUTES[rc]


def move_bytes(x, axis, kind):
    """The least bytes the card moves for ``move`` of contiguous ``x``:
    the output written once, plus every 32-byte sector of ``x`` that holds
    a gathered element, read once.  Reverse and roll read all of ``x``;
    even and odd read the sectors of every other row of Q elements along
    ``axis``: all of ``x`` on the last axis, half of it for rows that fill
    whole sectors."""
    axis = axis % x.dim()
    e = x.element_size()
    if kind not in ('even', 'odd'):
        return 2 * x.numel() * e
    row = math.prod(x.shape[axis + 1:]) * e         # bytes a row
    rows = x.numel() * e // (2 * row)               # rows gathered
    o = x.data_ptr() % 32
    total = 0
    # the sectors of gathered row m and their overlap with row m + 1's
    # depend on m mod 4 alone (two rows apart are 2 * row bytes apart)
    for m in range(min(rows, 4)):
        a = o + (2 * m + (kind == 'odd')) * row
        first, last = a // 32, (a + row - 1) // 32
        shared = max(0, last - (a + 2 * row) // 32 + 1)
        count = (rows - m + 3) // 4
        total += count * (last - first + 1) - (count - (
            m == (rows - 1) % 4)) * shared
    return x.numel() * e // 2 + 32 * total


def move(x, axis, kind, shift=0, out=None):
    """Gather copy of contiguous float32 ``x`` along ``axis``: ``kind``
    'even' (``x[0::2]``), 'odd' (``x[1::2]``), 'reverse' or 'roll' by
    ``shift`` (``torch.roll``'s sense), into ``out`` (a new tensor, or one
    whose address span does not overlap ``x``'s).  Exact."""
    what = 'move'
    axis, shape = _move_shape(x, axis, kind, what)
    _check_apart(x, out, what)
    # each element written is one read
    nbytes = 2 * math.prod(shape) * x.element_size()
    if _plain_ok(x, what):
        y = bf._plain(what, nbytes, move_plain, x, axis, kind, shift)
        return y if out is None else _target(x, out, shape, what).copy_(y)
    out = _target(x, out, shape, what)
    if out.numel():
        _launch(what, _build.load().move_f32, x, bf._ptr(x), bf._ptr(out),
                *_move_args(x, axis, kind, shift), nbytes=nbytes)
    return out


# ---------------------------------------------------------------------------
# bfly
# ---------------------------------------------------------------------------

def _radix4_lines(xr, xi, N, dft, sign):
    """The radix-4 Stockham stage loop on (pre, N, post) lines, restated
    term for term from scripts/tpu_bfly_dissect.py: body_concat (dft
    False: slabs concatenated along M, no arithmetic) and body_adds (dft
    True: the 4-point network, twiddles skipped; sign -1 there)."""
    xr = xr.unsqueeze(2)                    # (pre, L, M, post)
    xi = xi.unsqueeze(2)
    L = N
    while L > 1:
        Lq = L // 4
        qr = [xr[:, j * Lq:(j + 1) * Lq] for j in range(4)]
        qi = [xi[:, j * Lq:(j + 1) * Lq] for j in range(4)]
        if dft:
            t0r, t0i = qr[0] + qr[2], qi[0] + qi[2]
            t1r, t1i = qr[1] + qr[3], qi[1] + qi[3]
            t2r, t2i = qr[0] - qr[2], qi[0] - qi[2]
            t3r, t3i = qr[1] - qr[3], qi[1] - qi[3]
            u3r, u3i = -sign * t3i, sign * t3r
            qr = [t0r + t1r, t2r + u3r, t0r - t1r, t2r - u3r]
            qi = [t0i + t1i, t2i + u3i, t0i - t1i, t2i - u3i]
        xr = torch.cat(qr, dim=2)
        xi = torch.cat(qi, dim=2)
        L = Lq
    return xr[:, 0], xi[:, 0]


def tile_lines(N):
    """Lines of A's float32 tile at length N: the largest power of two up
    to 1024 with N lines of 8192 points (butterfly.cuh tile_log2_lines)."""
    c = 1
    while c < 1024 and 2 * c * N <= 8192:
        c *= 2
    return c


def _is_pow4(n):
    return bf._is_pow2(n) and (n.bit_length() - 1) % 2 == 0


def bfly_plain(p, axis, mode='full', reps=1, forward=True):
    """Plain PyTorch version of ``bfly``: a copy; the radix-4 stage loop
    without arithmetic or without twiddles (``reps`` times); or
    ``fft_axis_plain`` ``reps`` times."""
    if mode == 'copy':
        return p.clone()
    if mode == 'full':
        y = p
        for _ in range(reps):
            y = bf.fft_axis_plain(y, axis, forward)
        return y
    shape = tuple(p.shape[1:])
    axis = axis % len(shape)
    N = shape[axis]
    pre, post = bf._pre_post(shape, axis)
    sign = -1 if forward else 1
    y = p.reshape(2, pre, N, post).clone()
    for a, b in bf._chunks(pre, N, post):
        r, i = y[0, a, :, b], y[1, a, :, b]
        for _ in range(reps):
            r, i = _radix4_lines(r, i, N, mode == 'adds', sign)
        y[0, a, :, b] = r
        y[1, a, :, b] = i
    return y.reshape(p.shape)


def bfly_route(p, axis, lines=None, out=None):
    """The kernel ``bfly`` runs on planar ``p`` along ``axis`` into
    ``out`` (``p`` when None) with ``lines``: 'lines' or 'band' (A's line
    and band kernels) or 'tile', by the C entry's own rule (the built
    kernel library answers; nothing is launched)."""
    shape = tuple(p.shape[1:])
    axis = axis % len(shape)
    pre, post = bf._pre_post(shape, axis)
    lc = -1 if lines is None else int(lines).bit_length() - 1
    q = p if out is None else out
    return BFLY_ROUTES[_build.load().bfly_route_f32(
        bf._ptr(p), bf._ptr(q), pre, shape[axis], post, lc)]


def bfly(p, axis, mode='full', reps=1, lines=None, out=None, forward=True):
    """A's kernels along ``axis`` (complex coords) of planar float32
    ``p``: load each line, band or tile of lines, run ``mode`` ``reps``
    times, store it into ``out`` (a new tensor, or ``p`` for in place).
    ``mode``: 'copy', 'moves' (the radix-4 data flow alone), 'adds'
    (radix-4 with twiddles at 1) or 'full' (A's transform); moves and adds
    take N = 4^k.  At N = 512, 768 and 1024 the pass takes A's route
    (``bfly_route``: its line or band kernel); ``lines``: A's tile of that
    many lines (a power of two up to A's own) at any N, as every other
    length takes A's own tile."""
    what = 'bfly'
    bf._check_planar(p, what)
    if mode not in MODES or int(reps) < 1:
        raise ValueError(f"{what}: mode {mode!r} (one of {MODES}), reps "
                         f"{reps} >= 1")
    shape = tuple(p.shape[1:])
    axis = axis % len(shape)
    N = shape[axis]
    bf._require_len(N, what)
    if mode in ('moves', 'adds') and not _is_pow4(N):
        raise ValueError(f"{what}: mode {mode} takes N = 4^k, got {N}")
    lc = -1
    if lines is not None:
        lc = int(lines).bit_length() - 1
        if lines < 1 or 1 << lc != lines or (N << lc) % 16 or \
                lines > tile_lines(N):
            raise ValueError(f"{what}: {lines} lines of {N} points is no "
                             f"tile of A's")
    nbytes = 2 * p.numel() * p.element_size()
    if _plain_ok(p, what):
        y = bf._plain(what, nbytes, bfly_plain, p, axis, mode, reps, forward)
        return y if out is None else _target(p, out, p.shape, what).copy_(y)
    out = _target(p, out, p.shape, what)
    if out.numel():
        pre, post = bf._pre_post(shape, axis)
        sign = -1 if forward else 1
        tw = bf._tw_tensor_axis(N, sign, p.dtype, p.device)
        plan, nst = bf._plan_args(N)
        _launch(what, _build.load().bfly_f32, p, bf._ptr(p), bf._ptr(out),
                bf._ptr(tw), tw.shape[1], pre, N, post, sign, plan, nst,
                MODES.index(mode), int(reps), lc, nbytes=nbytes)
    return out


# ---------------------------------------------------------------------------
# fma_chain
# ---------------------------------------------------------------------------

def fma_chain_plain(x, iters, a=FMA_A, b=FMA_B):
    """Plain PyTorch version of ``fma_chain``: ``iters`` steps of
    ``acc * a + b`` (a multiply and an add, each rounded)."""
    acc = x.clone()
    for _ in range(int(iters)):
        acc = acc * a + b
    return acc


def fma_chain(x, iters, acc=8, a=FMA_A, b=FMA_B, out=None):
    """For each element of contiguous float32 or float64 ``x``, ``iters``
    fused steps ``acc <- acc * a + b`` with ``acc`` independent
    accumulators a thread (1, 4, 8 or 16), into ``out`` (new, or
    ``x``)."""
    what = 'fma_chain'
    if int(acc) not in _FMA_ACC or int(iters) < 0:
        raise ValueError(f"{what}: acc {acc} (one of {_FMA_ACC}), iters "
                         f"{iters} >= 0")
    nbytes = 2 * x.numel() * x.element_size()
    if _plain_ok(x, what, (torch.float32, torch.float64)):
        y = bf._plain(bf._name_of(what, x), nbytes, fma_chain_plain, x,
                      iters, a, b)
        return y if out is None else _target(x, out, x.shape, what).copy_(y)
    out = _target(x, out, x.shape, what)
    if x.dtype == torch.float64:
        name, fn = what + '_f64', _build.load().fma_chain_f64
    else:
        name, fn = what, _build.load().fma_chain_f32
    if x.numel():
        _launch(name, fn, x, bf._ptr(x), bf._ptr(out), x.numel(),
                int(iters), int(acc), float(a), float(b), nbytes=nbytes)
    return out
