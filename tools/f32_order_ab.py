#!/usr/bin/env python3
"""A/B of the f32 end-to-end times between two trees of the port, and of
the machine code of their kernels.

Times, in one process, the f32 plans that ``chip_smoke.py`` times (the
1024^3 ``'F'`` transform unquartered and quartered, the (2048, 1024, 512)
and (4096, 1024, 256) plans) with the ``mpi4py_fft_torch`` package of the
tree given: first on a card that has been idle, then again after a load
of about ``--load-s`` seconds of complex128 cuFFT passes over a 17.2 GB
volume (the same for every tree, standing in for the float64 phases that
``chip_smoke.py`` runs before its f32 times).  Prints one JSON line with
both sets of times and the card's clocks, temperature and power after
each.  Run it once for each tree, alternating (parent, change, change,
parent), on one card:

    python3 tools/f32_order_ab.py TREE

With ``--sass PARENT CHANGE`` it compares instead the SASS of every
kernel instance, float32 and float64, in the two trees' built libraries
(``cuobjdump -sass``, names demangled by ``cu++filt``, an instance keyed
by its kernel and template arguments; build both first) and prints one
JSON line: for each instance, whether its instructions are the same and
how many there are.
"""
import argparse
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _smi():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit,power.draw,'
         'temperature.gpu,clocks.sm,clocks.mem', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def _times(cs, dev):
    """ms per transform (forward + backward, halved; median of 5 after 2)
    of the f32 plans, as chip_smoke.phase_times measures them."""
    import torch
    from mpi4py_fft_torch import PlanarPFFT
    from mpi4py_fft_torch.ops import oop3d
    n = cs.NORTH_N
    pfft = PlanarPFFT(None, (n,) * 3, dtype='F')
    x = cs._rand((2, n, n, n), dev, cs.SEED + 2)
    out = {'north': cs._median_ms(
        lambda: pfft.backward(pfft.forward(x)), reps=5) / 2}
    state = [list(oop3d.split_q(x))]
    del x

    def chain():
        state[0] = list(pfft.backward_fn_q(list(pfft.forward_fn_q(
            state[0]))))

    out['quartered'] = cs._median_ms(chain, reps=5) / 2
    del state
    torch.cuda.empty_cache()
    out.update(cs._times_long(dev))
    out['smi'] = _smi()
    return out


def _load(seconds, dev):
    """complex128 cuFFT passes over a (1024,)^3 volume for ``seconds``."""
    import torch
    z = torch.randn((1024,) * 3, dtype=torch.complex128, device=dev)
    t0, k = time.perf_counter(), 0
    while time.perf_counter() - t0 < seconds:
        y = torch.fft.fft(z, dim=k % 3)
        torch.cuda.synchronize()
        del y
        k += 1
    del z
    torch.cuda.empty_cache()
    return k


def run(tree, load_s):
    """Times with the package of ``tree`` and the timing code of this
    checkout's chip_smoke.py, whatever the tree."""
    import importlib.util
    import torch
    sys.path.insert(0, str(Path(tree).resolve()))
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  ROOT / 'chip_smoke.py')
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from mpi4py_fft_torch.ops import _build
    _build.load()
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    cold = _times(cs, dev)
    passes = _load(load_s, dev)
    warm = _times(cs, dev)
    import mpi4py_fft_torch
    print(json.dumps({'tree': str(tree),
                      'package': mpi4py_fft_torch.__file__,
                      'cold_ms': cold, 'load_passes': passes,
                      'after_load_ms': warm}), flush=True)


def _tool(name):
    w = shutil.which(name)
    return w if w else f'/usr/local/cuda/bin/{name}'


def _sass(tree):
    """{instance (library: kernel<template arguments>): [instructions]}
    of the kernels of a tree."""
    out = {}
    for lib in sorted((Path(tree) / 'build' / 'torch_kernels').glob('*.so')):
        text = subprocess.run([_tool('cuobjdump'), '-sass', str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        for fn in text.split('Function : ')[1:]:
            name, _, body = fn.partition('\n')
            dem = subprocess.run([_tool('cu++filt'), name.strip()],
                                 capture_output=True, text=True,
                                 check=True).stdout.strip()
            m = re.search(r'(\w+(?:<[^()]*>)?)\(', dem)
            key = f"{lib.name.split('-')[0]}: {m.group(1) if m else dem}"
            out[key] = re.findall(
                r'/\*[0-9a-f]{4,}\*/\s+([^;]*;)', body)
    return out


def sass(parent, change):
    a, b = _sass(parent), _sass(change)
    print(json.dumps({'sass': {
        k: {'same': a[k] == b.get(k), 'instructions': len(a[k]),
            'instructions_change': len(b.get(k, []))} for k in sorted(a)},
        'only_in_change': sorted(set(b) - set(a))}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('tree', nargs='?', default=str(ROOT))
    ap.add_argument('--load-s', type=float, default=15.0)
    ap.add_argument('--sass', nargs=2, metavar=('PARENT', 'CHANGE'))
    args = ap.parse_args()
    if args.sass:
        sass(*args.sass)
    else:
        run(args.tree, args.load_s)


if __name__ == '__main__':
    main()
