"""Every piece that BENCHMARK.json names is a file found by its name, and a
new cell, traffic, reference and metric run as new files alone."""
import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from fftbench import catalog

ROOT = catalog.ROOT
BENCH = catalog.benchmark()


def test_configs_load_by_name():
    for c in BENCH['configs']:
        cfg = catalog.config(c['name'])
        assert c['file'] == f"fftbench/configs/{c['name']}.json"
        assert cfg['source'] == c['source']
        assert cfg['reduced'] == c['reduced']
        ref = catalog.reference(c['name'])
        assert ref.__name__ == f"fftbench.reference.{c['name']}"


@pytest.mark.parametrize('entry', BENCH['workloads'],
                         ids=[w['name'] for w in BENCH['workloads']])
def test_cells_load_by_name(entry):
    cell = catalog.workload(entry['name'])
    for k in ('config', 'traffic', 'chips', 'why'):
        assert cell[k] == entry[k], k
    tr = catalog.traffic(cell['traffic'])
    for attr in ('UNIT', 'METRIC', 'inputs', 'Side', 'judge',
                 'least_seconds', 'control_side'):
        assert hasattr(tr, attr), attr
    e2e, per_layer = catalog.metrics_of(BENCH, entry['name'])
    names = {m['name'] for m in e2e}
    assert {'setup_s', 'peak_gb', tr.METRIC} <= names
    assert per_layer, "every cell reports a per-layer metric"
    assert all(m['moves'] in names for m in per_layer)


@pytest.mark.parametrize('metric', BENCH['per_layer'],
                         ids=[m['name'] for m in BENCH['per_layer']])
def test_metric_readers_load_by_name(metric):
    assert callable(catalog.reader(metric['name']).read)


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        catalog.workload('no_such.cell')
    with pytest.raises(KeyError):
        catalog.config('no_such_config')
    with pytest.raises(KeyError):
        catalog.reader('no_such_metric.step')


TOY_TRAFFIC = '''
"""A throwaway traffic kind: adds one to a vector."""
import torch

from fftbench import catalog, compare

UNIT = 'call'
METRIC = 'toy_ms'


def inputs(cfg, params, seed, device):
    g = torch.Generator(device=device).manual_seed(int(seed))
    return {'x': torch.randn(cfg['n'], generator=g, device=device)}


class Side(object):
    def __init__(self, cfg, params, device, inputs):
        self.x, self.calls = inputs.pop('x'), 0

    def warm(self):
        pass

    def unit(self):
        self.x = self.x + 1
        self.calls += 1
        return 1

    def result(self):
        return {'x': self.x, 'calls': self.calls}

    def close(self):
        self.x = None


control_side = Side


def judge(cfg, params, seed, result, device, limits):
    ref = catalog.reference(cfg['name'])
    want = ref.run(inputs(cfg, params, seed, device)['x'], result['calls'])
    return {'gap': (compare.rel_l2(result['x'], want), limits['gap'])}


def least_seconds(cfg):
    return None
'''

TOY_REFERENCE = '''
def run(x, calls):
    return x + calls
'''

TOY_METRIC = '''
def read(summary, ctx):
    return float(summary['units'])
'''


def test_new_cell_traffic_and_metric_are_new_files_only(tmp_path):
    """A copy of the folder gains a configuration, a cell, a traffic
    kind, a reference and a metric as new files and entries of
    BENCHMARK.json; the copy runs the cell, traced and not, and every
    file that was there is unchanged."""
    shutil.copytree(ROOT / 'fftbench', tmp_path / 'fftbench',
                    ignore=shutil.ignore_patterns('__pycache__', '_cache'))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / 'fftbench').rglob('*') if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    fb = tmp_path / 'fftbench'
    (fb / 'configs' / 'toy.json').write_text(json.dumps(
        {'name': 'toy', 'source': 'https://example.org/toy', 'n': 64,
         'reduced': []}))
    (fb / 'workloads' / 'toy.double.json').write_text(json.dumps(
        {'name': 'toy.double', 'config': 'toy', 'traffic': 'toy',
         'chips': 1, 'params': {'trace_units': 3},
         'limits': {'gap': 1e-6}, 'why': 'a throwaway cell'}))
    (fb / 'traffic' / 'toy.py').write_text(TOY_TRAFFIC)
    (fb / 'reference' / 'toy.py').write_text(TOY_REFERENCE)
    (fb / 'metrics' / 'toy_units.py').write_text(TOY_METRIC)
    bench['configs'].append({'name': 'toy', 'source': 'x',
                             'file': 'fftbench/configs/toy.json',
                             'reduced': [], 'why': 'x'})
    bench['workloads'].append({'name': 'toy.double', 'config': 'toy',
                               'traffic': 'toy', 'chips': 1, 'why': 'x'})
    bench['end_to_end'].append({'name': 'toy_ms', 'unit': 'ms',
                                'better': 'lower', 'bound': 0.05,
                                'source': 'host_clock',
                                'workloads': ['toy.double']})
    bench['per_layer'].append({'name': 'toy_units.call', 'unit': 'units',
                               'better': 'higher', 'source': 'device_trace',
                               'layer': 'Device', 'moves': 'toy_ms'})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))
    code = textwrap.dedent('''
        import json, sys
        from fftbench import run
        for trace in (0, 1):
            line = run.run_cell('toy.double', 7, 0.05, trace, 'cpu')
            print(json.dumps(line))
    ''')
    out = subprocess.run([sys.executable, '-c', code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={'PATH': '/usr/bin:/bin',
                              'PYTHONPATH': str(tmp_path)})
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = [json.loads(s) for s in out.stdout.splitlines()
                     if s.startswith('{')]
    assert plain['correct'] and traced['correct']
    assert 'toy_ms' in plain['metrics'] and 'setup_s' in plain['metrics']
    assert traced['metrics']['toy_units.call']['value'] == 3.0
    assert list(traced)[-1] == 'checks'
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / 'fftbench').rglob('*')
             if p.is_file() and '__pycache__' not in p.parts}
    assert all(after[k] == v for k, v in before.items())
