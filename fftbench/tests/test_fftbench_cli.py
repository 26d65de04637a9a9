"""The command refuses to measure without a card: an exit code other than
0 and no result line."""
import json
import subprocess
import sys

import pytest
import torch

from fftbench import catalog

CELLS = [w['name'] for w in catalog.benchmark()['workloads']]


@pytest.mark.parametrize('form', ['script', 'module'])
@pytest.mark.parametrize('name', CELLS)
def test_refuses_without_a_card(name, form):
    if torch.cuda.is_available():
        pytest.skip('this machine has a card')
    cmd = (['fftbench/run.py'] if form == 'script'
           else ['-m', 'fftbench.run'])
    out = subprocess.run(
        [sys.executable] + cmd + ['--workload', name, '--seed',
                                  str(2 ** 31 + 5), '--seconds', '1',
                                  '--trace', '0'],
        cwd=catalog.ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert 'CUDA card' in out.stderr
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_unknown_cell_is_refused():
    out = subprocess.run(
        [sys.executable, 'fftbench/run.py', '--workload', 'no_such.cell',
         '--seed', '1', '--seconds', '1', '--trace', '0'],
        cwd=catalog.ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and not out.stdout.strip()
