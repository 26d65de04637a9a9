"""Tracing and per-stage profiling.

Port of ``mpi4py_fft_tpu/utils/profiling.py``, with the port's spans:

* :func:`trace` (:28): ``torch.profiler.profile`` around the enclosed
  block (the card's kernels too, where there is one), written as a Chrome
  trace into ``logdir``; it starts a new session of spans;
* :func:`annotate` (:34): the port's one span.  While no profiler
  records (PyTorch's own flag), a call reads that flag and returns a
  shared no-op context: no range, no event, no allocation.  While one
  records, a span is a ``torch.profiler.record_function`` range, so it
  lies on the profiler's timeline beside the kernels, and it is timed
  between two CUDA events on the current stream (on the host clock where
  CUDA is not in use, as on the CPU every call runs to its end);
* :func:`launched`: one launch of the port's kernels, counted in the
  innermost span open;
* :func:`session`: the newest session's table, a row a span name;
* :func:`routes`: the same sums for the spans that name a route (a
  kernel wrapper's path, ``annotate(..., route=)``), a row a span name
  and route;
* :func:`stage_times` (:72): each stage and each exchange of a ``PFFT``
  :class:`~mpi4py_fft_torch.parallel.mpifft.Transform` timed on its own,
  beside the whole transform, so that the kernels' share and the
  exchanges' share are visible.

A session holds the spans recorded while one profiler ran: it begins at
the first span that finds a profiler recording after a span found none,
or where :func:`trace` starts.  Spans nest on one host thread.  The
events are resolved when :func:`session` is read, never while the
profiler runs.
"""
import contextlib
import os
import tempfile
import time

import numpy as np
import torch
from torch.autograd import profiler as _torch_profiler

__all__ = ['trace', 'annotate', 'launched', 'session', 'routes',
           'stage_times']

_OFF = contextlib.nullcontext()


class _Session(object):
    """The spans of one session, a record each in the order they opened:
    ``[name, nbytes, start, end, launches, parent, route]``, ``start`` and
    ``end`` CUDA events or host-clock seconds, ``parent`` the index of
    the enclosing span's record (None at the top), ``route`` the path
    the span names or None; ``open`` the indices of the spans open now,
    innermost last."""

    def __init__(self):
        self.records = []
        self.open = []


_session = _Session()
# no span has found a profiler recording since one last found none
_fresh = True


def _start_session():
    global _session, _fresh
    _session = _Session()
    _fresh = False


def _mark(cuda):
    """A point on a span's clock: a CUDA event recorded on the current
    stream, or the host clock."""
    if cuda:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _seconds(start, end):
    if isinstance(start, float):
        return end - start
    end.synchronize()
    return start.elapsed_time(end) * 1e-3


class _Span(object):
    """One span while a profiler records: its range, then its start mark
    and record; at the end its end mark, then the range closed."""

    __slots__ = ('_name', '_nbytes', '_route', '_range', '_session',
                 '_index')

    def __init__(self, name, nbytes, route):
        self._name = name
        self._nbytes = int(nbytes)
        self._route = route

    def __enter__(self):
        self._range = torch.profiler.record_function(self._name)
        self._range.__enter__()
        s = self._session = _session
        self._index = len(s.records)
        # the card's clock where CUDA is in use, else the host's
        start = _mark(torch.cuda.is_initialized())
        s.records.append([self._name, self._nbytes, start, None, 0,
                          s.open[-1] if s.open else None, self._route])
        s.open.append(self._index)
        return self

    def __exit__(self, *exc):
        s = self._session
        rec = s.records[self._index]
        rec[3] = _mark(not isinstance(rec[2], float))
        s.open.pop()
        self._range.__exit__(*exc)
        return False


@contextlib.contextmanager
def trace(logdir=None):
    """Profile the enclosed block (host ranges, and the card's kernels
    where there is a card) and write it as a Chrome trace,
    ``trace_<pid>_<n>.json``, into ``logdir`` (by default a directory
    under the temporary directory); yields ``logdir``.  The spans of the
    block make a new session (:func:`session`)."""
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), 'mpi4py_fft_torch_trace')
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        _start_session()
        yield logdir
    prof.export_chrome_trace(os.path.join(
        logdir, f'trace_{os.getpid()}_{time.monotonic_ns()}.json'))


def annotate(name, nbytes=0, route=None):
    """The span ``name``, a context manager.  ``nbytes``: the bytes its
    work cannot avoid moving (each element of its input read and of its
    output written once), added to its row of the session.  ``route``:
    the path this call took (a kernel wrapper's choice of kernel), which
    :func:`routes` sums apart; the span's row in :func:`session` is the
    same with or without it.  Off while no profiler records (the shared
    no-op context); see the module's docstring."""
    global _fresh
    if not _torch_profiler._is_profiler_enabled:
        _fresh = True
        return _OFF
    if _fresh:
        _start_session()
    return _Span(name, nbytes, route)


def launched():
    """Count one launch of the port's kernels (or of a plain version in a
    kernel's place) in the innermost span open; nothing where none is."""
    s = _session
    if s.open:
        s.records[s.open[-1]][4] += 1


def _sums(key):
    """The newest session's closed spans summed by ``key(record)`` (a
    key of None leaves the span out)."""
    recs = _session.records
    secs = [0.0 if r[3] is None else _seconds(r[2], r[3]) for r in recs]
    inner = [0.0] * len(recs)
    for r, t in zip(recs, secs):
        if r[5] is not None:
            inner[r[5]] += t
    table = {}
    for r, t, t_in in zip(recs, secs, inner):
        k = key(r)
        if r[3] is None or k is None:
            continue
        row = table.setdefault(k, {'calls': 0, 'device_s': 0.0,
                                   'self_s': 0.0, 'bytes': 0,
                                   'launches': 0})
        row['calls'] += 1
        row['device_s'] += t
        row['self_s'] += t - t_in
        row['bytes'] += r[1]
        row['launches'] += r[4]
    return table


def session():
    """The newest session's table: ``{name: {'calls', 'device_s',
    'self_s', 'bytes', 'launches'}}``, summed over the span's calls.
    ``device_s``: seconds between each call's two marks; ``self_s``: less
    those of its direct child spans; ``launches``: the port's kernel
    launches made while it was the innermost span.  Waits for the device
    to reach the session's events; spans still open are left out."""
    return _sums(lambda r: r[0])


def routes():
    """The newest session's spans that name a route, summed as in
    :func:`session` by name and route: ``{name: {route: {'calls',
    'device_s', 'self_s', 'bytes', 'launches'}}}``.  The routes of a name
    split its row of :func:`session` (where every call names one, they
    add up to it)."""
    out = {}
    for (name, route), row in _sums(
            lambda r: None if r[6] is None else (r[0], r[6])).items():
        out.setdefault(name, {})[route] = row
    return out


def _timed(fn, v, reps, dev):
    """(fn(v), seconds per call): the mean of ``reps`` calls after three,
    between two CUDA events on a card, on the host clock on the CPU."""
    for _ in range(3):
        y = fn(v)
    if dev.type == 'cuda':
        with torch.cuda.device(dev):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                y = fn(v)
            b.record()
            b.synchronize()
        return y, a.elapsed_time(b) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        y = fn(v)
    return y, (time.perf_counter() - t0) / reps


def stage_times(transform, x=None, reps=3):
    """Time each stage and each exchange of a ``PFFT`` transform on its
    own, in the forward direction of ``transform``.

    The chain runs as the executor runs it (``Transform._impl``): the
    block at its pencil's padded local shape, logically complex data
    planar, each exchange an ``all_to_all_single`` over its group (on
    several ranks, this rank's part of it; every rank must call this
    function), each stage on its axes cut to their true extents; only
    the chunking of the exchanges is left out.

    Returns ``{'stage0': s, 'transpose0': s, 'stage1': s, ...,
    'fused_total': s, '_staged_result': y, '_fused_result': y}``:
    seconds per call, and the two outputs (``fused_total`` is the whole
    transform, ``fn_p``)."""
    from ..distarray import DistArray
    from ..ops import matfft
    from ..parallel.pencil import fit_axis, fit_block
    if x is None:
        x = transform.input_array
    if isinstance(x, DistArray):
        x = x.v
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    dev = transform.device
    x = x.to(dev)
    pl = transform._planars
    if pl[0] and x.is_complex():
        x = matfft.planar(x)
    normalize = transform._default_normalize

    out = {}
    cur = fit_block(x, transform._pencil[0].padded_local_shape(), int(pl[0]))
    for i, stage in enumerate(transform._stages):
        rin = int(pl[i])
        if i > 0:
            start = transform._steps[i - 1][0]
            cur, out[f'transpose{i - 1}'] = _timed(
                lambda v, start=start, rin=rin: start(v, rank=rin).wait(),
                cur, reps, dev)

        def run(v, i=i, stage=stage, rin=rin):
            for ax, n in transform._slices[i]:
                v = fit_axis(v, rin + ax, n)
            return stage(v.contiguous(), normalize)
        cur, out[f'stage{i}'] = _timed(run, cur, reps, dev)
    out['_staged_result'] = fit_block(cur, transform._pencil[1].subshape,
                                      int(pl[-1]))
    out['_fused_result'], out['fused_total'] = _timed(
        lambda v: transform.fn_p(v, normalize), x, reps, dev)
    return out
