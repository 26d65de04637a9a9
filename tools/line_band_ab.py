#!/usr/bin/env python3
"""A/B of design variants of C's c2r line kernel, the dealiasing band
kernel of E and E64, and the route of the real kernels' inner axes, on
one card.

Each variant is a copy of this checkout's ``mpi4py_fft_torch`` under
``build/ab/<variant>`` with one constant of its CUDA sources changed by a
string patch; every tree is timed in a fresh process (its own build), in
turns: this tree, the variants, the variants in reverse, this tree.  A
run times C (``irfft_axis_p``) on a (2, 768, 768, 385) float32 spectrum
back to the 768^3 real volume, and E64 (``fft_axis_tp`` on float64) at
the four passes of the dealiased 512^3 ``'d'`` plan on its 768^3 grid
(forward axes 1 and 0 truncating to 512 rows, backward axes 0 and 1
padding back), and E (``fft_axis_tp`` on float32) at the same four
passes of the ``'f'`` plan and at the six of the ``'F'`` plan (forward
axes 2, 1, 0, backward 0, 1, 2), each pass held first against its plain
version on one slab, and prints one JSON line with the times (CUDA
events, median of 9 after 2 warm-ups) and the ``ptxas`` lines of the C
384-point instance and of E's and E64's band and line instances:

    python3 tools/line_band_ab.py            # every variant, in turns
    python3 tools/line_band_ab.py e_round8   # the named variants only
    python3 tools/line_band_ab.py --one TREE # one tree (the child run)
    python3 tools/line_band_ab.py --real real_tile

``--real`` times, in place of C, E and E64, the inner-axis passes of the
r2r cell's plan at 512^3, float64 and float32: the r2c (``rfft_axis_p``)
and the c2r on its spectrum along axis 0, DCT-II and DCT-III along axis
1, each held first against its plain version on a slab of 32 columns.

The variants (against this tree's constants):

* ``c_bound3``: the line kernels bound to three blocks an SM at float32
  (``kLineMinBlocks``, ``rfft_axis.cu``) in place of four;
* ``round2``, ``round4``: E64's band loading two or four chunks a round
  (``TpBandBudget``, ``fft_axis_tp.cu``) in place of eight;
* ``k8``: E64's band on clusters of eight CTAs of 96 rows and 32
  columns (``kTpBandK``) in place of four of 192 rows and 16 (E's on
  eight of 96 rows and 64 columns);
* ``e_round4``, ``e_round8``: E's band (float32) loading four chunks a
  round (A's) or eight (all of a thread's vectors at once) on every
  pass, in place of eight but four on padding reads of single elements;
* ``e_threads512``: E's band on lines.cuh's ``BandBudget<float>`` (D's:
  512 threads, two CTAs an SM) in place of A's ``AxisBandBudget`` (256
  threads, three CTAs an SM);
* ``real_tile``: the real kernels' inner axes on the tile kernel, as
  before the column band (``band_length`` false, ``rfft_axis.cu``; time
  it with ``--real``).
"""
import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = Path('mpi4py_fft_torch') / 'ops' / 'csrc'
# E's chunks a round (TpBandBudget, fft_axis_tp.cu)
_E_ROUND = ('sizeof(T) == 4 && !kVec && Map::kMode == mff::PadRows::kMode '
            '? 4 : 8;')
VARIANTS = {
    'c_bound3': ('rfft_axis.cu',
                 'constexpr int kLineMinBlocks = sizeof(T) == 4 ? 4 : 1;',
                 'constexpr int kLineMinBlocks = sizeof(T) == 4 ? 3 : 1;'),
    'round2': ('fft_axis_tp.cu', 'static constexpr int kRound = 8;',
               'static constexpr int kRound = 2;'),
    'round4': ('fft_axis_tp.cu', 'static constexpr int kRound = 8;',
               'static constexpr int kRound = 4;'),
    'k8': ('fft_axis_tp.cu', 'constexpr int kTpBandK = 4;',
           'constexpr int kTpBandK = 8;'),
    'e_round4': ('fft_axis_tp.cu', _E_ROUND, 'sizeof(T) == 4 ? 4 : 8;'),
    'e_round8': ('fft_axis_tp.cu', _E_ROUND, '8;'),
    'e_threads512': ('fft_axis_tp.cu',
                     'struct TpBandBudget : mff::AxisBandBudget<T> {',
                     'struct TpBandBudget : mff::BandBudget<T> {'),
    'real_tile': ('rfft_axis.cu',
                  'return W == 256 || W == 384 || W == 512;',
                  'return false;'),
}


def _variant(name):
    """The patched copy of this tree's package for variant ``name``."""
    f, old, new = VARIANTS[name]
    d = ROOT / 'build' / 'ab' / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(ROOT / 'mpi4py_fft_torch', d / 'mpi4py_fft_torch',
                    ignore=shutil.ignore_patterns('__pycache__'))
    p = d / CSRC / f
    s = p.read_text()
    if s.count(old) != 1:
        raise RuntimeError(f"{name}: {old!r} is not in {f} once")
    p.write_text(s.replace(old, new))
    return d


def _ptxas(log):
    """The ptxas lines of the C 384-point instance and of E's and E64's
    band and line instances."""
    out, cur = {}, None
    for text in log.values():
        for ln in text.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", ln)
            if m:
                cur = m.group(1)
            elif cur and ('irfft_lines_kernelIfLi384' in cur or
                          'tp_band' in cur or 'tp_lines' in cur) and (
                              'registers' in ln or 'spill' in ln):
                key = re.sub(r'^.*?(irfft_lines_kernel|tp_band_kernel|'
                             r'tp_lines_kernel)', r'\1', cur)
                out.setdefault(key, []).append(
                    ln.split('ptxas info')[-1].strip(' :'))
    return out


def run_one(tree, real=False):
    sys.path.insert(0, str(tree))
    import torch
    from mpi4py_fft_torch.ops import _build
    from mpi4py_fft_torch.ops import butterfly as bf
    if not bf.__file__.startswith(str(tree)):
        raise RuntimeError(f"imported {bf.__file__}, not {tree}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    _build.load()
    dev = torch.device('cuda', 0)

    def med(fn, reps=9, warm=2):
        for _ in range(warm):
            fn()
        ts = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return statistics.median(ts)

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    g = torch.Generator(device=dev).manual_seed(1)
    if real:
        print(json.dumps(_real_inner(bf, dev, g, med, rel, tree)),
              flush=True)
        return
    out = {'tree': str(tree), 'ptxas': _ptxas(_build.LOG)}
    h = torch.rand((2, 768, 768, 385), generator=g, device=dev) - 0.5
    y = bf.irfft_axis_p(h, 2, 768)
    out['c_rel'] = rel(y[:32], bf.irfft_axis_plain(h[:, :32], 2, 768))
    out['c_ms'] = med(lambda: bf.irfft_axis_p(h, 2, 768))
    del h, y
    sc = 1 / 768
    f_passes = (('fwd1', 1, True, dict(trunc=512, scale=sc)),
                ('fwd0', 0, True, dict(trunc=512, scale=sc)),
                ('bwd0', 0, False, dict(pad=768)),
                ('bwd1', 1, False, dict(pad=768)))
    c2c_passes = ((('fwd2', 2, True, dict(trunc=512, scale=sc)),) +
                  f_passes + (('bwd2', 2, False, dict(pad=768)),))
    for tag, shape, dtype, passes, tol in (
            ('e64', (2, 768, 768, 257), torch.float64, f_passes, 2e-13),
            ('e_f', (2, 768, 768, 257), torch.float32, f_passes, 5e-6),
            ('e_F', (2, 768, 768, 768), torch.float32, c2c_passes, 5e-6)):
        inp = torch.rand(shape, generator=g, device=dev, dtype=dtype) - 0.5
        total = 0.0
        for name, ax, fwd, kw in passes:
            k = bf.fft_axis_tp(inp, ax, fwd, **kw)
            sd = 2 if ax == 0 else 1
            r = rel(k.narrow(sd, 0, 32), bf.fft_axis_tp_plain(
                inp.narrow(sd, 0, 32), ax, fwd, **kw))
            if r > tol:
                raise RuntimeError(f"{tag} {name}: rel L2 {r} against its "
                                   f"plain version")
            out[f'{tag}_{name}_ms'] = med(
                lambda: bf.fft_axis_tp(inp, ax, fwd, **kw))
            total += out[f'{tag}_{name}_ms']
            inp = k
        out[f'{tag}_ms'] = total
        del inp, k
        torch.cuda.empty_cache()
    if out['c_rel'] > 5e-6:
        raise RuntimeError(f"C disagrees with its plain version: {out}")
    print(json.dumps(out), flush=True)


def _real_inner(bf, dev, g, med, rel, tree):
    """The r2r cell's inner-axis passes at 512^3 (``--real``), float64
    and float32, each held on a slab of 32 columns, then timed; with the
    route each would name (a tree without ``real_route``: the tile)."""
    import torch
    out = {'tree': str(tree)}
    n = 512
    for dtype, tag, tol in ((torch.float64, 'd', 2e-13),
                            (torch.float32, 'f', 5e-6)):
        x = torch.rand((n,) * 3, generator=g, device=dev, dtype=dtype) - 0.5
        h = bf.rfft_axis_p(x, 0)
        passes = (
            ('r2c_ax0', lambda: bf.rfft_axis_p(x, 0), 0,
             lambda y: (y[..., :32], bf.rfft_axis_plain(x[..., :32], 0))),
            ('c2r_ax0', lambda: bf.irfft_axis_p(h, 0, n), 0,
             lambda y: (y[..., :32],
                        bf.irfft_axis_plain(h[..., :32], 0, n))),
            ('dct2_ax1', lambda: bf.dct2_axis_p(x, 1), 1,
             lambda y: (y[:32], bf.dct2_axis_plain(x[:32], 1))),
            ('dct3_ax1', lambda: bf.dct3_axis_p(x, 1), 1,
             lambda y: (y[:32], bf.dct3_axis_plain(x[:32], 1))))
        for name, fn, ax, pair in passes:
            r = rel(*pair(fn()))
            if r > tol:
                raise RuntimeError(f"{tag} {name}: rel L2 {r} against its "
                                   f"plain version")
            route = getattr(bf, 'real_route', None)
            out[f'{tag}_{name}_route'] = (
                route((n,) * 3, ax, n, dtype) if route else 'tile')
            out[f'{tag}_{name}_ms'] = med(fn)
        del x, h
        torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--one', metavar='TREE', help="time one tree")
    ap.add_argument('--real', action='store_true',
                    help="time the r2r cell's inner-axis passes in place "
                         "of C, E and E64")
    ap.add_argument('variants', nargs='*', metavar='VARIANT',
                    help="the variants to time beside this tree (default: "
                         f"all: {', '.join(VARIANTS)})")
    args = ap.parse_args()
    unknown = set(args.variants) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    if args.one:
        run_one(Path(args.one).resolve(), args.real)
        return 0
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    trees = [ROOT] + [_variant(v) for v in args.variants or VARIANTS]
    rows = {}
    for t in trees + trees[::-1]:
        r = subprocess.run([sys.executable, __file__, '--one', str(t)] +
                           (['--real'] if args.real else []),
                           capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stdout, r.stderr, file=sys.stderr)
            return 1
        line = r.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        o = json.loads(line)
        name = 'tree' if t == ROOT else t.name
        rows.setdefault(name, []).append({k: o[k] for k in o
                                          if k.endswith('_ms')})
    print(json.dumps({'summary': {n: {k: [min(r[k] for r in rs),
                                          max(r[k] for r in rs)]
                                      for k in rs[0]}
                                  for n, rs in rows.items()}}), flush=True)
    return 0


if __name__ == '__main__':
    os.chdir(ROOT)
    sys.exit(main())
