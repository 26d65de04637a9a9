"""The traced part of a window, and its summary.

``torch.profiler`` over CPU and CUDA activities around a steady run of
units (the idea of ``mpi4py_fft_torch.utils.profiling.trace``, not a call
to it).  The events stay in memory; only the summary leaves the process,
and a Chrome trace only where one is asked for.

Device kernels are classified by a rule that names no kernel of the
port: a kernel whose qualified name lies in PyTorch's or CUDA's library
namespaces, or names a kernel family of cuFFT, or a copy or fill of the
runtime, is ``torch``; every other kernel is the port's.
"""
import bisect

import torch

WINDOW = 'fftbench.window'
UNIT = 'fftbench.unit'

# PyTorch's and CUDA's libraries, and the runtime's copies and fills
TORCH_MARKS = ('at::', 'at_cuda_detail', 'c10::', 'cub::', 'thrust::',
               'cutlass', 'cublas', 'cufft', 'cudnn', 'nvjet', 'gemm',
               'xmma', 'Memcpy', 'Memset', 'memcpy', 'memset')
# cuFFT's kernels carry no namespace: they are known by their families
CUFFT_KERNELS = ('regular_fft', 'vector_fft', 'composite_2way_fft',
                 'dpRadix', 'spRadix', 'dpVector', 'spVector')


def qualified_name(name):
    """A device activity's own qualified name: its demangled signature
    without the return type, the template arguments and the parameter
    list (``(anonymous namespace)::`` taken out first)."""
    name = name.replace('(anonymous namespace)::', '')
    name = name.split('<', 1)[0].split('(', 1)[0].strip()
    return name[len('void '):] if name.startswith('void ') else name


def kind_of(name):
    """``'torch'`` or ``'port'``, by the qualified name alone."""
    q = qualified_name(name)
    if any(m in q for m in TORCH_MARKS) \
            or q.split('::')[-1].startswith(CUFFT_KERNELS):
        return 'torch'
    return 'port'


class TracedRun(object):
    """The profiler around the units a window traces.  ``start()`` opens
    the profiler and the window's range after the device has drained;
    ``stop()`` drains the device inside the range, closes both and
    keeps the events."""

    def __init__(self, sync):
        self._sync = sync
        self._prof = None
        self._range = None
        self.units = 0

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._sync()
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()

    def unit(self):
        """A range around one unit's calls into the program."""
        return torch.profiler.record_function(UNIT)

    def stop(self, units):
        self._sync()
        self._range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.units = units

    @property
    def events(self):
        """The profiler's events, parsed when first asked for (seconds
        of host work, so after the window, not inside it)."""
        return self._prof.events()

    def export(self, path):
        self._prof.export_chrome_trace(str(path))


def _is_device(e):
    dt = getattr(e, 'device_type', None)
    return dt is not None and getattr(dt, 'name', str(dt)).endswith('CUDA')


def _union(intervals):
    """Total length and merged list of ``(t0, t1)`` intervals."""
    merged = []
    for t0, t1 in sorted(intervals):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    return sum(t1 - t0 for t0, t1 in merged), merged


def summarize(events, units, top=10):
    """The traced window's summary, times in seconds.

    ``window_s``: the window range, from the first unit's enqueue to the
    device drained; ``busy_s``: the union of device activity within it;
    ``kernels``: ``(name, seconds, kind)`` for each device activity;
    ``device_ops`` and ``idle_gaps``: the ten largest sums by kernel
    name and by the innermost host range open when the device went
    idle."""
    cpu = [e for e in events if not _is_device(e)]
    win = [e for e in cpu if e.name == WINDOW]
    if not win:
        raise RuntimeError("the trace holds no window range")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    user = {e.name for e in cpu if getattr(e, 'is_user_annotation', False)}
    user |= {WINDOW, UNIT}
    dev = []
    for e in events:
        if not _is_device(e) or getattr(e, 'is_user_annotation', False) \
                or e.name in user:
            continue
        t0 = max(e.time_range.start, w0)
        t1 = min(e.time_range.end, w1)
        if t1 > t0:
            dev.append((e.name, t0, t1))
    busy_us, merged = _union([(t0, t1) for _, t0, t1 in dev])
    by_name = {}
    for name, t0, t1 in dev:
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0) * 1e-6
    # idle gaps inside the window, named by the innermost host range
    # (not the window itself) open at the gap's start
    gaps = []
    edge = w0
    for t0, t1 in merged:
        if t0 > edge:
            gaps.append((edge, t0))
        edge = max(edge, t1)
    if w1 > edge:
        gaps.append((edge, w1))
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in cpu if e.name != WINDOW)
    starts = [h[0] for h in host]
    by_host = {}
    for g0, g1 in gaps:
        # ranges nest on the host thread, so the open range that
        # started last is the innermost
        name = 'python (no range open)'
        i = bisect.bisect_right(starts, g0)
        for h0, h1, hname in reversed(host[max(0, i - 512):i]):
            if h1 >= g0:
                name = hname
                break
        by_host[name] = by_host.get(name, 0.0) + (g1 - g0) * 1e-6
    return {
        'window_s': (w1 - w0) * 1e-6,
        'busy_s': busy_us * 1e-6,
        'units': units,
        'kernels': [(n, (t1 - t0) * 1e-6, kind_of(n)) for n, t0, t1 in dev],
        'device_ops': sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        'idle_gaps': sorted(by_host.items(), key=lambda kv: -kv[1])[:top],
    }

