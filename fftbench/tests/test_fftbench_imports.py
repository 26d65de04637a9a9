"""No module of the benchmark imports JAX or the JAX package, none reads
the JAX-era benchmark files, and no reference imports the port."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
MODULES = sorted(p for p in HERE.rglob('*.py') if '__pycache__' not in p.parts)
JAX = {'jax', 'jaxlib', 'flax', 'mpi4py_fft_tpu'}
JAX_ERA = ('bench.py', 'bench_milestones', 'BENCH_', 'MULTICHIP_',
           'BASELINE')


def imported(path):
    """Top-level names (the part before the first dot, whole) of every
    import in ``path``, at any depth of the module."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
    return names


def test_the_walk_compares_whole_names(tmp_path):
    p = tmp_path / 'm.py'
    p.write_text('import mpi4py_fft_torch.ops\nfrom jax.numpy import x\n'
                 'def f():\n    import mpi4py_fft_tpux\n')
    assert imported(p) == {'mpi4py_fft_torch', 'jax', 'mpi4py_fft_tpux'}


@pytest.mark.parametrize('path', MODULES,
                         ids=[str(p.relative_to(HERE)) for p in MODULES])
def test_no_jax(path):
    assert not imported(path) & JAX
    if path.parent.name != 'tests':
        text = path.read_text()
        assert not [w for w in JAX_ERA if w in text]


@pytest.mark.parametrize(
    'path', sorted((HERE / 'reference').glob('*.py')),
    ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    names = imported(path)
    assert 'mpi4py_fft_torch' not in names and 'fftbench' not in names
    assert names <= {'math', 'numpy', 'torch'}
