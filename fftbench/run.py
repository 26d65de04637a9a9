"""Run one cell of the benchmark on one CUDA card and print its result.

    python3 fftbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(``python3 -m fftbench.run`` works the same.)  Builds the port's side of
the cell from the seed, warms it up (set-up), runs the window for
``--seconds``, then frees the port's state and compares what the window
produced with the plain reference.  The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(with ``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``, each number compared beside its limit; the same numbers
are the last lines of standard error.  Without a card, or with fewer
cards than the cell asks for, it prints no result and exits with 2.
"""
import os
import sys
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
if __package__ in (None, ''):
    # run as a script: import the package from the checkout's root
    # rather than this folder
    sys.path[:] = [p for p in sys.path
                   if Path(p or '.').resolve() != _HERE]
    sys.path.insert(0, str(_HERE.parent))

# every cache a library may write goes to a fixed folder of the checkout
_CACHE = _HERE / '_cache'
os.environ['TRITON_CACHE_DIR'] = str(_CACHE / 'triton')
os.environ['TORCH_EXTENSIONS_DIR'] = str(_CACHE / 'torch_extensions')
os.environ['CUDA_CACHE_PATH'] = str(_CACHE / 'nv')

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402

import torch  # noqa: E402

# set-up is counted from here: PyTorch's own import (8-12 s on the card's
# host, and most of the spread of a count from the process's start) is
# the same for every version of the port
_T_TORCH = time.time()

from fftbench import catalog, tracewin  # noqa: E402

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'mpi4py_fft_tpu')


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX
    package's (whole names compared)."""
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Device(object):
    """Drains and marks the device a cell runs on: CUDA events on a
    card; on the CPU, which runs each call to its end, nothing."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == 'cuda'

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def mark(self):
        """An event after the work enqueued so far (``None`` on the
        CPU)."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def reset_peak(self):
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak_bytes(self):
        return (torch.cuda.max_memory_allocated(self.device)
                if self.cuda else None)

    def free(self):
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


def window(side, seconds, dev, tracer=None, skip=1, count=1):
    """Run ``side.unit()`` back to back for ``seconds``, one call in
    flight behind the host, then drain the device.  Returns (units,
    seconds): all the units completed and all the time of the window.
    With a tracer, the profiler wraps ``count`` calls after the first
    ``skip`` (the window runs on until they are done)."""
    dev.sync()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    units = calls = traced = 0
    prev = None
    while True:
        if tracer is not None and calls == skip:
            tracer.start()
        if tracer is not None and skip <= calls < skip + count:
            with tracer.unit():
                u = side.unit()
            traced += u
        else:
            u = side.unit()
        units += u
        calls += 1
        if tracer is not None and calls == skip + count:
            tracer.stop(traced)
        ev = dev.mark()
        if prev is not None:
            prev.synchronize()
        prev = ev
        if time.perf_counter() >= deadline and (
                tracer is None or calls >= skip + count):
            break
    dev.sync()
    return units, time.perf_counter() - t0


def power_limit():
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def run_cell(name, seed, seconds, trace, device, bench=None, cfg_over=None,
             side_factory=None, t0=None, export=None):
    """One run of cell ``name`` on ``device``: set-up, window,
    comparison.  Returns the result line (a dict), checks last.

    ``cfg_over`` (keys of the configuration to replace) and
    ``side_factory`` (in place of the traffic's ``Side``) are for tests
    that run a tiny copy on the CPU; the command uses neither.
    ``t0``: where set-up starts (by default, this call); ``export``: a
    path for the traced window's Chrome trace."""
    t0 = time.time() if t0 is None else t0
    bench = catalog.benchmark() if bench is None else bench
    cell = catalog.workload(name)
    cfg = dict(catalog.config(cell['config']), **(cfg_over or {}))
    tr = catalog.traffic(cell['traffic'])
    params = cell['params']
    e2e, per_layer = catalog.metrics_of(bench, name)
    dev = Device(device)

    marks = [time.time()]
    made = tr.inputs(cfg, params, seed, dev.device)
    dev.sync()
    marks.append(time.time())
    dev.reset_peak()
    side = (side_factory or tr.Side)(cfg, params, dev.device, made)
    del made
    dev.sync()
    marks.append(time.time())
    side.warm()
    dev.sync()
    marks.append(time.time())
    setup_s = marks[-1] - t0
    parts = dict(zip(('start_s', 'inputs_s', 'build_s', 'warm_s'),
                     [b - a for a, b in zip([t0] + marks, marks)]))

    tracer = tracewin.TracedRun(dev.sync) if trace else None
    units, window_s = window(side, seconds, dev, tracer, skip=1,
                             count=int(params['trace_units']))
    peak = dev.peak_bytes()
    if export is not None:
        export.parent.mkdir(parents=True, exist_ok=True)
        tracer.export(export)
    result = side.result()
    result['units'] = units
    side.close()
    del side
    dev.free()
    limit_w = power_limit() if dev.cuda else None

    # no window can finish its units faster than their least time: where
    # it seems to, the units did not run, and no reference is worth
    # running for them
    least = tr.least_seconds(cfg)
    checks = {}
    if least is not None:
        checks['bound_share'] = (units * least[0] / window_s, 1.0)
    if not checks or checks['bound_share'][0] <= 1.0:
        checks.update(tr.judge(cfg, params, seed, result, dev.device,
                               cell['limits']))
    del result
    dev.free()
    correct = all(math.isfinite(v) and v <= lim for v, lim in checks.values())

    metrics = {}
    line = {'correct': correct, 'attempted': units,
            'failed': 0 if correct else units}
    if not trace:
        have = {'setup_s': setup_s, tr.METRIC: window_s / units * 1e3,
                'peak_gb': peak / 1e9 if peak is not None else None}
        for m in e2e:
            if have.get(m['name']) is None:
                if not dev.cuda:
                    continue        # a CPU run reads no device memory
                raise RuntimeError(f"cell {name} reports {m['name']}, "
                                   f"which this run did not measure")
            metrics[m['name']] = {'value': have[m['name']],
                                  'unit': m['unit']}
    else:
        summary = tracewin.summarize(tracer.events, tracer.units)
        ctx = {'least_s': least[0] if least else None}
        for m in per_layer:
            v = catalog.reader(m['name']).read(summary, ctx)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
        line['breakdown'] = {
            'device_ops': [[n, s] for n, s in summary['device_ops']],
            'idle_gaps': [[n, s] for n, s in summary['idle_gaps']]}
        if least:
            line['roofline_bound'] = least[1]
    line['setup_parts'] = parts
    line['metrics'] = metrics
    line['device'] = {
        'platform': 'gpu' if dev.cuda else 'cpu',
        'kind': torch.cuda.get_device_name(dev.device) if dev.cuda
        else 'cpu',
        'count': 1, 'memory_peak_bytes': peak, 'power_limit': limit_w}
    if trace:
        line['device']['busy_s'] = summary['busy_s']
        line['device']['window_s'] = summary['window_s']
    line['checks'] = {k: {'value': v, 'limit': lim}
                      for k, (v, lim) in checks.items()}
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    ap.add_argument('--export-trace', action='store_true',
                    help="with --trace 1, also write the profiler's Chrome "
                         "trace to fftbench/_traces/<cell>-<seed>.json")
    args = ap.parse_args(argv)
    bench = catalog.benchmark()
    chips = catalog.cell_entry(bench, args.workload)['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"fftbench: cell {args.workload} needs {chips} CUDA card(s), "
              f"this machine has {n}: nothing measured", file=sys.stderr)
        return 2
    export = (_HERE / '_traces' / f'{args.workload}-{args.seed}.json'
              if args.export_trace and args.trace else None)
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                    'cuda:0', bench=bench, t0=_T_TORCH, export=export)
    found = forbidden_modules()
    if found:
        print(f"fftbench: the run loaded {', '.join(found)}: no result",
              file=sys.stderr)
        return 3
    for k, c in line['checks'].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
