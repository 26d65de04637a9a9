"""Tracing and per-stage profiling.

Port of ``mpi4py_fft_tpu/utils/profiling.py``:

* :func:`trace` (:28): ``torch.profiler.profile`` around the enclosed
  block (the card's kernels too, where there is one), written as a Chrome
  trace into ``logdir``;
* :func:`annotate` (:34): a named range in that trace
  (``torch.profiler.record_function``); each stage of a ``PFFT`` transform
  runs inside one, ``pfft_stage<i>``;
* :class:`Timer` (:39): wall-clock laps, each after the device of the
  tensor it is given has finished;
* :func:`stage_times` (:72): each stage and each exchange of a ``PFFT``
  :class:`~mpi4py_fft_torch.parallel.mpifft.Transform` timed on its own,
  beside the whole transform, so that the kernels' share and the
  exchanges' share are visible.
"""
import contextlib
import os
import tempfile
import time

import numpy as np
import torch

from ..parallel.pencil import fit_axis, fit_block

__all__ = ['trace', 'Timer', 'stage_times', 'annotate']


@contextlib.contextmanager
def trace(logdir=None):
    """Profile the enclosed block (host ranges, and the card's kernels
    where there is a card) and write it as a Chrome trace,
    ``trace_<pid>_<n>.json``, into ``logdir`` (by default a directory
    under the temporary directory); yields ``logdir``."""
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), 'mpi4py_fft_torch_trace')
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(
        logdir, f'trace_{os.getpid()}_{time.monotonic_ns()}.json'))


def annotate(name):
    """A named range in the profiler's trace."""
    return torch.profiler.record_function(name)


class Timer(object):
    """Wall-clock timer with named laps; a lap given a CUDA tensor waits
    for that tensor's device first."""

    def __init__(self):
        self.laps = {}
        self._t0 = time.perf_counter()

    def lap(self, name, value=None):
        """Record the time since the last lap under ``name``; returns
        ``value``."""
        if isinstance(value, torch.Tensor) and value.is_cuda:
            torch.cuda.synchronize(value.device)
        t = time.perf_counter()
        self.laps.setdefault(name, []).append(t - self._t0)
        self._t0 = t
        return value

    def report(self):
        lines = []
        for name, ts in self.laps.items():
            ts = np.asarray(ts)
            lines.append(f"{name:30s} n={len(ts):4d} "
                         f"mean={ts.mean()*1e3:9.3f} ms  "
                         f"min={ts.min()*1e3:9.3f} ms")
        return "\n".join(lines)


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
