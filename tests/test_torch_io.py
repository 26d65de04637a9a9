"""The port's snapshot IO (``mpi4py_fft_torch/io/``) on one rank against
files the JAX package writes on the CPU from the same numpy input.

The cases of tests/test_io.py: 2-D and 3-D arrays (the (12, 13, 14)
shape and its 2-D cut) under the three domain variants of :22-29,
tensors of rank 0-2 with and without ``as_scalar``, whole arrays plus the
global slices ``[:, 4, :]`` and ``[:, 4, 4]``, steps 0 and 1, complex
data in HDF5, and reading back into another alignment.  Each pair of
files is written under one file name in two directories, so that:

* HDF5: the two trees are equal — the same groups and datasets, equal
  attributes (``shape``, ``rank``), equal ``domain``/``mesh`` datasets
  and dataset bytes (``h5_tree``);
* NetCDF: the files are byte-identical (the scipy NC3 writer, as the
  JAX package's, since netCDF4 is absent), and the port's file passes
  the NC3 conformance checks of tests/test_io.py:183- (tests/nc3_parser.py);
* XDMF: ``generate_xdmf`` writes the same text as the JAX package's, in
  both axis orders, with ``periodic`` True, False and (True, False,
  True).

tests/test_torch_dist_io.py runs the multi-rank writes and reads.
"""
import os

import numpy as np
import pytest

import mpi4py_fft_tpu as jpkg
from mpi4py_fft_tpu.io import nc_file as jnc_file

import mpi4py_fft_torch as tpkg
from mpi4py_fft_torch import DistArray, HDF5File, NCFile, generate_xdmf
from mpi4py_fft_torch.io import nc_file

h5py = pytest.importorskip('h5py')

N = (12, 13, 14)
DOMS = {3: [((0, np.pi), (0, 2 * np.pi), (0, 3 * np.pi)),
            tuple(np.linspace(0, (i + 1) * np.pi, N[i]) for i in range(3)),
            None]}
DOMS[2] = [d[:2] if d is not None else None for d in DOMS[3]]
SLICES = {3: [[slice(None), 4, slice(None)], [slice(None), 4, 4]],
          2: [[slice(None), 4]]}
NAME = {'h5': 'snap.h5', 'nc': 'snap.nc'}


def h5_tree(path):
    """Every group and dataset of an HDF5 file: its kind, attributes and,
    for a dataset, shape, dtype and bytes."""
    out = {}

    def visit(name, obj):
        attrs = tuple(sorted((k, np.asarray(v).dtype.str,
                              np.asarray(v).tobytes())
                             for k, v in obj.attrs.items()))
        if isinstance(obj, h5py.Dataset):
            out[name] = ('dataset', obj.shape, obj.dtype.str,
                         np.asarray(obj[()]).tobytes(), attrs)
        else:
            out[name] = ('group', attrs)
    with h5py.File(path, 'r') as f:
        f.visititems(visit)
    return out


def rand(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.random(shape)
    if np.dtype(dtype).kind == 'c':
        a = a + 1j * rng.random(shape)
    return a.astype(dtype)


def arrays(X, rank=0, alignment=0):
    """The port's and the JAX package's DistArray holding X."""
    t = DistArray(X.shape, dtype=X.dtype, alignment=alignment, rank=rank,
                  device='cpu')
    t[...] = X
    j = jpkg.DistArray(X.shape, dtype=X.dtype, alignment=alignment,
                       rank=rank)
    j[...] = X
    return t, j


def write_pair(tmp_path, kind, X, fields_of, domain=None, steps=(0, 1),
               rank=0, **kw):
    """Write ``fields_of(array)`` at each step with the port (directory
    ``port``) and the JAX package (``jax``); the two file paths."""
    paths = []
    for pkg, arr in zip(('port', 'jax'), arrays(X, rank)):
        d = tmp_path / pkg
        d.mkdir(exist_ok=True)
        path = str(d / NAME[kind])
        mod = tpkg if pkg == 'port' else jpkg
        cls = mod.HDF5File if kind == 'h5' else mod.NCFile
        f = cls(path, domain=domain, mode='w')
        for step in steps:
            f.write(step, fields_of(arr), **kw)
        paths.append(path)
    return paths


def same_file_bytes(a, b):
    with open(a, 'rb') as fa, open(b, 'rb') as fb:
        return fa.read() == fb.read()


@pytest.fixture(autouse=True)
def scipy_nc(monkeypatch):
    """Both packages on the scipy NC3 writer (netCDF4 is absent here;
    this keeps the test meaningful where it is installed)."""
    monkeypatch.setattr(nc_file, '_HAVE_NC4', False)
    monkeypatch.setattr(jnc_file, '_HAVE_NC4', False)


def test_exports():
    from mpi4py_fft_torch import io
    assert (HDF5File, NCFile, generate_xdmf) == (
        io.HDF5File, io.NCFile, io.generate_xdmf)
    for name in ('HDF5File', 'NCFile', 'generate_xdmf'):
        assert name in tpkg.__all__


@pytest.mark.parametrize('kind', ['h5', 'nc'])
@pytest.mark.parametrize('idom', range(3))
@pytest.mark.parametrize('dim', [2, 3])
def test_write_slices_vs_jax(tmp_path, kind, idom, dim):
    """Whole arrays and global slices at steps 0 and 1; the files equal
    JAX's; read back (the port's file and JAX's) into another
    alignment."""
    X = rand(N[:dim], 'd', 10 * dim + idom)

    def fields(u):
        return {'u': [u] + [(u, s) for s in SLICES[dim]]}
    pt, jx = write_pair(tmp_path, kind, X, fields, DOMS[dim][idom])
    if kind == 'h5':
        tree = h5_tree(pt)
        assert tree == h5_tree(jx)
        assert f'u/{dim}D/1' in tree and f'u/{dim - 1}D/' \
            f'{"slice_4_slice" if dim == 3 else "slice_4"}/1' in tree
    else:
        assert same_file_bytes(pt, jx)
    for path in (pt, jx):
        v = DistArray(X.shape, dtype='d', alignment=dim - 1, device='cpu')
        v.read(path, 'u', step=1)
        assert np.array_equal(np.asarray(v), X)


@pytest.mark.parametrize('kind', ['h5', 'nc'])
@pytest.mark.parametrize('as_scalar', [False, True])
@pytest.mark.parametrize('rank', [0, 1, 2])
def test_tensors_vs_jax(tmp_path, kind, as_scalar, rank):
    """Tensors of rank 0-2, whole, as one dataset or exploded into scalar
    components (``v0``, ``v01`` ...)."""
    X = rand((3,) * rank + N, 'd', 40 + rank)
    pt, jx = write_pair(tmp_path, kind, X, lambda u: {'v': [u]},
                        rank=rank, as_scalar=as_scalar, steps=(0,))
    if kind == 'h5':
        tree = h5_tree(pt)
        assert tree == h5_tree(jx)
        names = [f'v{"".join(map(str, i))}/3D/0' for i in
                 np.ndindex(*(3,) * rank)] if as_scalar else ['v/3D/0']
        assert all(n in tree for n in names)
    else:
        assert same_file_bytes(pt, jx)
    if not as_scalar:
        v = DistArray(X.shape, dtype='d', alignment=1, rank=rank,
                      device='cpu')
        v.read(pt, 'v', step=0)
        assert np.array_equal(np.asarray(v), X)


def test_complex_h5_vs_jax(tmp_path):
    """Complex data (a spectrum) in HDF5, with a slice."""
    X = rand(N, 'D', 50)
    pt, jx = write_pair(tmp_path, 'h5', X,
                        lambda u: {'c': [u, (u, SLICES[3][0])]})
    assert h5_tree(pt) == h5_tree(jx)
    v = DistArray(N, dtype='D', alignment=2, device='cpu')
    v.read(pt, 'c', step=1)
    assert np.array_equal(np.asarray(v), X)


@pytest.mark.parametrize('kind', ['h5', 'nc'])
def test_darray_write_read_vs_jax(tmp_path, kind):
    """``DistArray.write``/``read`` (a file name: HDF5 by its extension,
    else NetCDF), with and without a global slice."""
    X = rand(N, 'd', 60)
    paths = []
    for pkg, arr in zip(('port', 'jax'), arrays(X, alignment=1)):
        (tmp_path / pkg).mkdir()
        path = str(tmp_path / pkg / NAME[kind])
        arr.write(path, 'field', 0)
        arr.write(path, 'field', 1, global_slice=SLICES[3][0])
        paths.append(path)
    if kind == 'h5':
        assert h5_tree(paths[0]) == h5_tree(paths[1])
    else:
        assert same_file_bytes(*paths)
    v = DistArray(N, dtype='d', alignment=0, device='cpu')
    v.read(paths[0], 'field', 0)
    assert np.array_equal(np.asarray(v), X)


XDMF = [(order, periodic) for order in ('paraview', 'visit')
        for periodic in (True, False, (True, False, True))]


@pytest.mark.parametrize('order,periodic', XDMF)
@pytest.mark.parametrize('idom', range(3))
@pytest.mark.parametrize('dim', [2, 3])
def test_xdmf_vs_jax(tmp_path, monkeypatch, dim, idom, order, periodic):
    """``generate_xdmf`` on the two HDF5 files of one snapshot series
    (the same name in two directories): the same XDMF files, the same
    text."""
    X = rand(N[:dim], 'd', 70 + dim)
    pt, jx = write_pair(tmp_path, 'h5', X,
                        lambda u: {'u': [u] + [(u, s) for s in SLICES[dim]]},
                        DOMS[dim][idom])
    texts = []
    for path, gen in ((pt, generate_xdmf), (jx, jpkg.generate_xdmf)):
        d = os.path.dirname(path)
        monkeypatch.chdir(d)
        gen(NAME['h5'], periodic=periodic, order=order)
        texts.append({n: open(os.path.join(d, n)).read()
                      for n in sorted(os.listdir(d)) if n.endswith('.xdmf')})
    assert texts[0] == texts[1]
    want = {'snap.xdmf'} | ({'snap_slice_4_slice.xdmf'} if dim == 3
                            else set())
    assert set(texts[0]) == want


def test_nc3_format_conformance(tmp_path):
    """The port's NetCDF bytes against the NetCDF classic format spec
    (tests/nc3_parser.py), as tests/test_io.py:183- holds the JAX
    package's."""
    from nc3_parser import parse
    X = rand(N, 'd', 11)
    u, _ = arrays(X, alignment=1)
    fname = str(tmp_path / "conform.nc")
    f = NCFile(fname, mode='w')
    f.write(0, {'u': [u]})
    f.write(1, {'u': [u]})
    nc = parse(fname)
    dims = dict(nc['dims'])
    assert dims['time'] == 0                      # record (unlimited)
    assert (dims['x'], dims['y'], dims['z']) == N
    v = nc['variables']['u']
    assert v['dims'] == ['time', 'x', 'y', 'z']
    assert nc['numrecs'] == 2
    assert v['data'].shape == (2,) + N
    assert np.array_equal(v['data'][0], X)
    assert np.array_equal(v['data'][1], X)
    for name, ext in zip('xyz', N):
        assert nc['variables'][name]['data'].shape == (ext,)


def test_blocks_and_slice_parts_one_rank():
    """On one rank the array's block is the whole array: it owns it, and
    a slice's part is the whole slice, cut out with ``pack_block``."""
    from mpi4py_fft_torch.io import file_base as fb
    X = rand(N, 'd', 12)
    u, _ = arrays(X)
    assert fb.group_of(u) is None
    assert fb.owned_blocks(u) == [(0, tuple(slice(0, n) for n in N))]
    assert fb.owns_block(u)
    host = fb.host_block(u)
    assert np.array_equal(host, X)
    region, part = fb.slice_part(u, [slice(None), 4, slice(None)], host)
    assert region == (slice(0, 12), slice(0, 14))
    assert np.array_equal(part, X[:, 4, :]) and part.flags['C_CONTIGUOUS']
    region, part = fb.slice_part(u, [3, 4, 5], host)
    assert region == () and part == X[3, 4, 5]
