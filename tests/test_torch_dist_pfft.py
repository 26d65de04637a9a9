"""The port's PFFT feature matrix on 8 torch.distributed gloo ranks against
the JAX package's per-shard executor on the 8-device CPU mesh.

The seven cases of tests/test_shmap_executor.py:47-57 (r2c, c2c, uneven
extents, a 2-D slab, 4-D on a (2, 4) grid, dealiasing, collapse groups)
and two plans with r2r stages (the 5-D plan of tests/test_mpifft.py:
200-233, the transforms example's collapsed slab plan),
the pencils of the (2, 4) grid and two PlanarPFFT plans, run as in
tests/test_torch_dist.py: one gloo group of 8 ranks
(tests/torch_dist_worker.py, no JAX in it) runs every case on its
blocks; the JAX references run once in the pytest process.  Each rank's
block is held against the ceil-div block of the JAX global result:
max abs error over the largest value 2e-10 (float64), 5e-5 (float32),
chunked against unchunked bit for bit.
"""
import functools

import numpy as np
import pytest

import mpi4py_fft_tpu as jpkg
from mpi4py_fft_torch import fftw as tfftw
from mpi4py_fft_tpu.parallel.pencil import Pencil as JPencil
from mpi4py_fft_tpu.parallel.pencil import Subcomm as JSubcomm

from test_torch_dist import (SHAPES, TOL, close, jcomm, jplanar, jslice,
                             pencil_cases, planar_name, rand, run_group, sl)

N = 8

# tests/test_shmap_executor.py:47-57
CASES = [
    dict(shape=(16, 16, 16), dtype='d'),
    dict(shape=(16, 16, 16), dtype='D'),
    dict(shape=(12, 13, 14), dtype='D'),
    dict(shape=(18, 19), dtype='d'),
    dict(shape=(12, 13, 12, 13), dtype='D', kw=dict(grid=(2, 4))),
    dict(shape=(16, 16, 16), dtype='d', kw=dict(padding=[1.5, 1.5, 1.5])),
    dict(shape=(12, 13, 14, 15), dtype='D',
         kw=dict(grid=(2, 4), collapse=True)),
    # r2r stages, real blocks through the exchanges: the 5-D plan of
    # tests/test_mpifft.py:200-233 (axis 0, 9 points over 8 ranks) and
    # the transforms example's collapsed slab plan
    dict(shape=(9, 10, 11, 12, 13), dtype='d',
         kw=dict(axes=((0,), (1, 2), (3, 4)), grid=(-1,)),
         r2r={(1, 2): 'dct', (3, 4): 'dst'}),
    dict(shape=(18, 18, 18), dtype='d',
         kw=dict(axes=None, collapse=True, grid=(-1,)),
         r2r={(1, 2): 'dct'}),
]
PLANAR = [((12, 13, 14), 'f', False), ((16, 16, 16), 'd', 1.5)]


def case_name(i):
    return f'pfft8-{i}'


def plan_kw(c, fftw):
    """The case's plan keywords, its r2r dict (type-3 planners of
    ``fftw``, the port's or the JAX package's) included."""
    kw = dict(c.get('kw', {}))
    if 'r2r' in c:
        kw['transforms'] = {
            axes: (functools.partial(getattr(fftw, f'{t}n'), type=3),
                   functools.partial(getattr(fftw, f'i{t}n'), type=3))
            for axes, t in c['r2r'].items()}
    return kw


def cases8():
    cases = pencil_cases([(2, 4)])
    for i, c in enumerate(CASES):
        pad = c.get('kw', {}).get('padding') or [1] * len(c['shape'])
        phys = tuple(int(m * f) for m, f in zip(c['shape'], pad))
        cases[case_name(i)] = ('pfft', {
            'shape': c['shape'], 'dtype': c['dtype'],
            'kw': plan_kw(c, tfftw), 'X': rand(phys, c['dtype'], 60 + i)})
    for i, (s, dt, p) in enumerate(PLANAR):
        phys = tuple(int(np.floor(m * p)) if p else m for m in s)
        real = np.float32 if dt in 'fF' else np.float64
        cases[planar_name(N, s, dt, p)] = ('planar', {
            'shape': s, 'dtype': dt, 'padding': p,
            'X': rand(phys if dt in 'fd' else (2,) + phys, real, 70 + i)})
    return cases


@pytest.fixture(scope='module')
def group8(tmp_path_factory):
    cases = cases8()
    return cases, run_group(N, cases, str(tmp_path_factory.mktemp('g8')))


_JPFFT = {}


def jpfft(i, X):
    if i not in _JPFFT:
        c = CASES[i]
        jf = jpkg.PFFT(jcomm(N), c['shape'], dtype=c['dtype'],
                       **plan_kw(c, jpkg.fftw))
        y = np.asarray(jf.forward(X.copy()))
        _JPFFT[i] = (jf, y, np.asarray(jf.backward(y.copy())))
    return _JPFFT[i]


@pytest.mark.parametrize('i', range(len(CASES)))
def test_pfft_vs_jax(group8, i):
    """PFFT's buffer call on DistArrays: each rank's spectrum block and
    its backward against the JAX PFFT (shard_map executor) on 8 devices,
    at the JAX ``local_slice`` of device r."""
    cases, res = group8
    X = cases[case_name(i)][1]['X']
    jf, y, z = jpfft(i, X)
    assert jf.executor == 'shard_map'
    for r, got in enumerate(res):
        for c in (1, 2):
            g = got[case_name(i)][c]
            assert g['executor'] == 'shard_map'
            assert g['y_slice'] == tuple(
                (s.start, s.stop) for s in jf.local_slice(True, r))
            assert g['x_slice'] == tuple(
                (s.start, s.stop) for s in jf.local_slice(False, r))
            assert g['local'] == (tuple(jf.local_shape(False, r)),
                                  tuple(jf.local_shape(True, r)))
            assert close(g['y'], y[sl(g['y_slice'])], TOL['d'])
            assert close(g['z'], z[sl(g['x_slice'])], TOL['d'])


@pytest.mark.parametrize('i', range(len(CASES)))
def test_pfft_chunked_bit_identical(group8, i):
    """a2a_chunks=2 against 1: every rank's blocks bit for bit."""
    cases, res = group8
    for got in res:
        one, two = got[case_name(i)][1], got[case_name(i)][2]
        np.testing.assert_array_equal(one['y'], two['y'])
        np.testing.assert_array_equal(one['z'], two['z'])


@pytest.mark.parametrize('shape', SHAPES)
def test_pencil_ownership_2x4(group8, shape):
    """The (2, 4) grid's pencils: every rank's block is JAX's of device r,
    and Transfer moves each rank's block to its partner pencil's."""
    cases, res = group8
    name = f'pencil-{(2, 4)}-{shape}'
    X = cases[name][1]['X']
    jsub = JSubcomm(jcomm(N), [2, 4])
    ja = JPencil(jsub, shape, len(shape) - 1)
    jb = ja.pencil(0)
    for r, got in enumerate(res):
        g = got[name]
        for axis, o in g['own'].items():
            jp = JPencil(jsub, shape, axis)
            assert o['shape'] == jp.local_shape(device_index=r)
            assert o['start'] == jp.local_start(device_index=r)
        assert g['fwd_slice'] == jslice(jb, r)
        np.testing.assert_array_equal(g['fwd'], X[sl(g['fwd_slice'])])
        np.testing.assert_array_equal(g['bwd'], X[sl(g['bwd_slice'])])


@pytest.mark.parametrize('shape,dtype,padding', PLANAR)
def test_planar_on_8_ranks_vs_jax(group8, shape, dtype, padding):
    """PlanarPFFT on the (4, 2) default grid of 8 ranks."""
    cases, res = group8
    name = planar_name(N, shape, dtype, padding)
    X = cases[name][1]['X']
    jp, y, z = jplanar(N, shape, dtype, padding, X)
    tol = TOL[dtype.lower()]
    for r, got in enumerate(res):
        g = got[name][1]
        assert g['y_slice'] == jslice(jp.pencils[-1], r, 1)
        assert close(g['y'], y[sl(g['y_slice'])], tol)
        assert close(g['z'], z[sl(g['x_slice'])], tol)
        np.testing.assert_array_equal(g['y'], got[name][2]['y'])


def test_workers_import_no_jax_8(group8):
    for got in group8[1]:
        assert got['_modules'] == []
