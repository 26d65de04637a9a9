"""Find the benchmark's pieces by name.

``BENCHMARK.json`` at the root of the checkout lists the cells and the
metrics; each cell, configuration, traffic kind, reference and per-layer
reader is a file of its own under this folder, so that a new one is a
new file and no existing file changes.
"""
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    """``BENCHMARK.json`` of the checkout at ``root``."""
    return _json(Path(root) / 'BENCHMARK.json')


def workload(name, here=HERE):
    """The cell ``name``: ``workloads/<name>.json``."""
    path = Path(here) / 'workloads' / f'{name}.json'
    if not path.is_file():
        raise KeyError(f"no cell {name!r} (no {path})")
    cell = _json(path)
    if cell.get('name') != name:
        raise ValueError(f"{path} names the cell {cell.get('name')!r}")
    return cell


def config(name, here=HERE):
    """The configuration ``name``: ``configs/<name>.json``."""
    path = Path(here) / 'configs' / f'{name}.json'
    if not path.is_file():
        raise KeyError(f"no configuration {name!r} (no {path})")
    cfg = _json(path)
    if cfg.get('name') != name:
        raise ValueError(f"{path} names the configuration "
                         f"{cfg.get('name')!r}")
    return cfg


def traffic(name):
    """The traffic module ``traffic/<name>.py``."""
    return importlib.import_module(f'fftbench.traffic.{name}')


def reference(config_name):
    """The plain reference of a configuration: ``reference/<name>.py``."""
    return importlib.import_module(f'fftbench.reference.{config_name}')


def reader(metric):
    """The reader of a per-layer metric: ``metrics/<base>.py``, where
    ``base`` is the name before its first dot (``torch_ops_ms.step``,
    a quantity split by cell, is read by ``metrics/torch_ops_ms.py``)."""
    base = metric.split('.')[0]
    path = HERE / 'metrics' / f'{base}.py'
    if not path.is_file():
        raise KeyError(f"no reader for the metric {metric!r} (no {path})")
    spec = importlib.util.spec_from_file_location(
        f'fftbench.metrics.{base}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric, cell, reported):
    """Whether ``metric`` (an entry of BENCHMARK.json) belongs to
    ``cell``: listed in its ``workloads``, or, without that key, moving
    an end-to-end metric that the cell reports."""
    if 'workloads' in metric:
        return cell in metric['workloads']
    return reported is None or metric.get('moves') in reported


def metrics_of(bench, cell):
    """(end-to-end entries, per-layer entries) that ``cell`` reports."""
    e2e = [m for m in bench['end_to_end'] if _applies(m, cell, None)]
    names = {m['name'] for m in e2e}
    per_layer = [m for m in bench['per_layer'] if _applies(m, cell, names)]
    return e2e, per_layer


def cell_entry(bench, name):
    """The entry of ``name`` in BENCHMARK.json's ``workloads``."""
    for w in bench['workloads']:
        if w['name'] == name:
            return w
    raise KeyError(f"BENCHMARK.json has no cell {name!r}")
