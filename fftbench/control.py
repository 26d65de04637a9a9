"""Readings that set a cell's limits: the port on many seeds, the control
on a few, each a whole run of the cell at its own size and load, in one
process.

    python3 fftbench/control.py --workload <cell> --seeds <s,s,...> \
        --control-seeds <s,s,s> [--seconds <s>]

Each seed is one ``run.run_cell`` (set-up, a window of ``--seconds``,
by default BENCHMARK.json's ``run_seconds``, and the comparison); for a
control seed the traffic's ``control_side``, which computes one
precision below the configuration's, takes the port's place.  One JSON
line a seed: ``correct`` and the numbers compared beside their limits.
Every sound seed of the port has to come out correct and every control
seed not.  A benchmark run never calls this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ''):
    _HERE = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or '.').resolve() != _HERE]
    sys.path.insert(0, str(_HERE.parent))

import torch  # noqa: E402

from fftbench import catalog, run  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', default='')
    ap.add_argument('--control-seeds', default='')
    ap.add_argument('--seconds', type=float,
                    default=catalog.benchmark()['run_seconds'])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    tr = catalog.traffic(catalog.workload(args.workload)['traffic'])
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for s in [int(x) for x in seeds.split(',') if x]:
            t0 = time.perf_counter()
            line = run.run_cell(
                args.workload, s, args.seconds, False, 'cuda:0',
                side_factory=tr.control_side if control else None)
            print(json.dumps({'workload': args.workload, 'control': control,
                              'seed': s, 'correct': line['correct'],
                              'attempted': line['attempted'],
                              'checks': line['checks'],
                              'seconds': time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
