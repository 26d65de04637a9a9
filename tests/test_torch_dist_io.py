"""The port's snapshot IO on 2 and 4 torch.distributed gloo ranks against
the JAX package's single-process files.

Three gloo groups run the IO jobs of tests/torch_dist_worker.py (one
fresh process a rank, no JAX in them), one launch each: 2 ranks write
(HDF5 in ``vds``, ``serial`` and ``repack`` modes, NetCDF in turns) and
read the port's one-rank files; 4 ranks write the same and read the
2-rank and one-rank files; 2 ranks read the 4-rank files.  The pytest
process writes the JAX package's files and the port's one-rank files of
the same numpy input first, and reads the 2- and 4-rank files on one
rank last.  The ranks run from the checkout's root, not the files'
directory, so their reads of the ``vds`` files resolve the sidecars'
relative names against the main file's directory.

Held: every HDF5 file's tree (groups, attributes, dataset bytes) equals
JAX's; ``vds`` datasets are virtual over one sidecar a writing rank,
``repack`` ones contiguous with no sidecar left
(tests/multiproc_worker.py:104-155); the NetCDF file written in turns
equals JAX's byte for byte; each rank's block read back equals the
input's block, whichever rank count and alignment wrote it; no slice
write gathered more than one part of a slice from a rank.
"""
import glob
import os

import numpy as np
import pytest

import mpi4py_fft_tpu as jpkg
from mpi4py_fft_tpu.io import nc_file as jnc_file

import mpi4py_fft_torch as tpkg
from mpi4py_fft_torch import DistArray
from mpi4py_fft_torch import HDF5File as THDF5File
from mpi4py_fft_torch import NCFile as TNCFile
from mpi4py_fft_torch.io import nc_file

from test_torch_dist import rand, run_group, sl
from test_torch_io import h5_tree

h5py = pytest.importorskip('h5py')

SHAPE = (12, 13, 14)
DOMAIN = ((0, np.pi), (0, 2 * np.pi), (0, 3 * np.pi))
H5 = ('vds', 'serial', 'repack')


def io_fields(u):
    """tests/torch_dist_worker.py's ``io_fields``."""
    return {'u': [u, (u, [slice(None), 4, slice(None)]),
                  (u, [slice(None), 4, 4])]}


def write_files(pkg, out, X, W, **kw):
    """The writes of the worker's ``io_write`` on one process: one
    HDF5 file and one NetCDF file; their paths."""
    os.makedirs(out)
    u = pkg.DistArray(X.shape, dtype='d', alignment=2, **kw)
    u[...] = X
    w = pkg.DistArray(W.shape, dtype='d', alignment=2, rank=1, **kw)
    w[...] = W
    h5, nc = os.path.join(out, 'one.h5'), os.path.join(out, 'one.nc')
    f = pkg.HDF5File(h5, domain=DOMAIN, mode='w')
    for step in (0, 1):
        f.write(step, io_fields(u))
    f.write(0, {'w': [w]}, as_scalar=True)
    f = pkg.NCFile(nc, mode='w')
    for step in (0, 1):
        f.write(step, io_fields(u))
    f.write(0, {'w': [w]})
    return {'h5': h5, 'nc': nc}


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The JAX and one-rank files, then the three launches."""
    X, W = rand(SHAPE, 'd', 90), rand((3,) + SHAPE, 'd', 91)
    tmp = str(tmp_path_factory.mktemp('io'))
    # the scipy NC3 writer on both sides, as the ranks use it
    saved = nc_file._HAVE_NC4, jnc_file._HAVE_NC4
    nc_file._HAVE_NC4 = jnc_file._HAVE_NC4 = False
    try:
        jax = write_files(jpkg, os.path.join(tmp, 'jax'), X, W)
        one = write_files(tpkg, os.path.join(tmp, 'one'), X, W,
                          device='cpu')
    finally:
        nc_file._HAVE_NC4, jnc_file._HAVE_NC4 = saved
    assert not nc_file._HAVE_NC4, "the ranks would write netCDF4"
    res = {}
    for n, reads in ((2, list(one.values())), (4, None), ('2r', None)):
        d = os.path.join(tmp, f'g{n}')
        os.makedirs(d)
        cases = {}
        if n != '2r':
            cases['write'] = ('io_write', {'X': X, 'W': W, 'out': d,
                                           'domain': DOMAIN})
        if reads is None:
            reads = list(res[2][0]['write']['files'].values()) \
                if n == 4 else list(res[4][0]['write']['files'].values())
            if n == 4:
                reads += list(one.values())
        cases['read'] = ('io_read', {'files': reads, 'shape': SHAPE})
        res[n] = run_group(2 if n == '2r' else n, cases, d)
    return X, jax, one, res


@pytest.mark.parametrize('mode', H5)
@pytest.mark.parametrize('n', (2, 4))
def test_h5_modes_vs_jax(runs, n, mode):
    """Every HDF5 write mode on n ranks: the file's tree equals the JAX
    package's single-process file, and the port's one-rank file."""
    X, jax, one, res = runs
    path = res[n][0]['write']['files'][mode]
    assert all(r['write']['files'][mode] == path for r in res[n])
    tree = h5_tree(path)
    assert tree == h5_tree(jax['h5'])
    assert tree == h5_tree(one['h5'])
    assert np.array_equal(np.frombuffer(tree['u/3D/1'][3]).reshape(SHAPE),
                          X)


@pytest.mark.parametrize('n', (2, 4))
def test_vds_virtual_over_sidecars(runs, n):
    """``vds``: the main file's datasets are virtual, one sidecar a
    writing rank beside it; ``serial``: ordinary datasets, no sidecar."""
    _, _, _, res = runs
    files = res[n][0]['write']['files']
    with h5py.File(files['vds'], 'r') as f:
        assert f['u/3D/0'].is_virtual and f['w1/3D/0'].is_virtual
        assert not f['u/2D/slice_4_slice/0'].is_virtual
    assert sorted(glob.glob(files['vds'] + '.p*.h5')) == sorted(
        f"{files['vds']}.p{r}.h5" for r in range(n))
    with h5py.File(files['serial'], 'r') as f:
        assert not f['u/3D/0'].is_virtual
    assert not glob.glob(files['serial'] + '.p*.h5')


@pytest.mark.parametrize('n', (2, 4))
def test_repack_self_contained(runs, n):
    """``repack``: contiguous datasets, every sidecar drained and
    removed, bytes equal to the ``serial`` file's."""
    _, _, _, res = runs
    files = res[n][0]['write']['files']
    assert not glob.glob(files['repack'] + '.p*.h5')
    with h5py.File(files['repack'], 'r') as fr, \
            h5py.File(files['serial'], 'r') as fs:
        for name in ('u/3D/0', 'u/3D/1', 'w0/3D/0', 'w2/3D/0'):
            assert not fr[name].is_virtual
            assert fr[name][()].tobytes() == fs[name][()].tobytes()


@pytest.mark.parametrize('n', (2, 4))
def test_nc_turns_vs_jax(runs, n):
    """NetCDF written in turns on n ranks: byte for byte the JAX
    package's file."""
    _, jax, _, res = runs
    with open(res[n][0]['write']['files']['nc'], 'rb') as a, \
            open(jax['nc'], 'rb') as b:
        assert a.read() == b.read()


@pytest.mark.parametrize('n', (2, 4))
def test_slice_parts_not_gathered_whole(runs, n):
    """Slice writes moved parts of the slice only: no rank gathered the
    whole array (the worker refuses ``get``/``_gathered``), and each
    part ``gather_object`` carried is at most the rank's share of a 2-D
    slice; vds and repack gather each slice once a step."""
    X, _, _, res = runs
    for got in res[n]:
        sent = got['write']['sent']
        assert len(sent) == 2 * 2 * 2          # modes x steps x slices
        b = sl(got['write']['block'])
        share = X[b][:, 0, :].nbytes
        assert max(sent) <= share


READS = [('one', 2), ('one', 4), (2, 4), (4, '2r')]


@pytest.mark.parametrize('writer,reader', READS)
def test_read_other_ranks(runs, writer, reader):
    """Files written on one rank count read back on another, each rank
    its own block, under alignments 0 and 2: equal to the input's
    block."""
    X, _, one, res = runs
    want = list(one.values()) if writer == 'one' else \
        list(res[writer][0]['write']['files'].values())
    for got in res[reader]:
        reads = got['read']
        assert {p for p, _ in reads} >= set(want)
        for path in want:
            for align in (0, 2):
                b, block = reads[(path, align)]
                np.testing.assert_array_equal(block, X[sl(b)])


@pytest.mark.parametrize('n', (2, 4))
def test_read_on_one_rank(runs, n):
    """The n-rank files read back on one rank (this process, whose
    working directory is not the files'), under both alignments."""
    X, _, _, res = runs
    for path in res[n][0]['write']['files'].values():
        for align in (0, 2):
            v = DistArray(SHAPE, dtype='d', alignment=align, device='cpu')
            v.read(path, 'u', step=1)
            np.testing.assert_array_equal(np.asarray(v), X)


@pytest.mark.parametrize('n', (2, 4, '2r'))
def test_io_workers_import_no_jax(runs, n):
    """No rank of the IO launches imported JAX or the JAX package, and
    none launched a kernel."""
    for got in runs[3][n]:
        assert got['_modules'] == []
        assert all(v == 0 for v in got['_launches'].values())


def test_h5_mode_refused(monkeypatch, tmp_path):
    """An unknown ``MPI4PY_FFT_TORCH_H5_MODE`` is refused, not taken for
    the default."""
    from mpi4py_fft_torch.io import h5py_file
    monkeypatch.setenv('MPI4PY_FFT_TORCH_H5_MODE', 'mpio')
    with pytest.raises(ValueError, match='MPI4PY_FFT_TORCH_H5_MODE'):
        h5py_file._h5_mode()
    monkeypatch.setenv('MPI4PY_FFT_TORCH_H5_MODE', 'serial')
    assert h5py_file._h5_mode() == 'serial'
    assert THDF5File.backend() == 'hdf5'
    assert TNCFile.backend() in ('netcdf4', 'netcdf3-scipy')
