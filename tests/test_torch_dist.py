"""The port's distributed layer on 2 and 4 torch.distributed gloo ranks
against the JAX package's per-shard executor on the CPU mesh.

Each group size starts one gloo group (``mpi4py_fft_torch.dryrun.launch``,
one fresh process a rank, tests/torch_dist_worker.py, no JAX in it) that
runs every case of this module on its blocks.  The JAX references run
once here, in the pytest process, on the first N devices of the 8-device
CPU mesh of tests/conftest.py (``PlanarPFFT``/``PFFT`` take their
``shard_map`` executor on several devices), on the same numpy inputs,
made from a seed.  Each rank's block is held against the ceil-div block
(``blockdist``) of the JAX global result, and the block's place against
the JAX pencil's ``local_start``/``local_shape`` of device r: rank r owns
what the JAX mesh puts on device r.  Tolerances, max abs error over the
largest value: 5e-5 f32, 2e-10 f64; chunked against unchunked (a2a_chunks
2 against 1) bit for bit.  tests/test_torch_dist_pfft.py runs the PFFT
feature matrix on 8 ranks.
"""
import functools
import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import mpi4py_fft_tpu as jpkg
from mpi4py_fft_tpu.parallel import DeviceComm as JComm
from mpi4py_fft_tpu.parallel.pencil import Pencil as JPencil
from mpi4py_fft_tpu.parallel.pencil import Subcomm as JSubcomm
from mpi4py_fft_tpu.parallel.planar import PlanarPFFT as JPlanarPFFT

from mpi4py_fft_torch import dryrun, PFFT, PlanarPFFT
from mpi4py_fft_torch import fftw as tfftw
from mpi4py_fft_torch.parallel import multihost

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = {'f': 5e-5, 'd': 2e-10}
SHAPES = ((16, 16, 16), (12, 13, 14))


def jcomm(n):
    return JComm(jax.devices()[:n])


def rand(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape)
    if np.dtype(dtype).kind == 'c':
        a = a + 1j * rng.standard_normal(shape)
    return a.astype(dtype)


def sl(pairs):
    return tuple(slice(a, b) for a, b in pairs)


def jslice(pencil, r, lead=0):
    """Rank r's block of a JAX pencil, as (start, stop) pairs."""
    return ((0, 2),) * lead + tuple(
        (s, s + n) for s, n in zip(pencil.local_start(device_index=r),
                                   pencil.local_shape(device_index=r)))


def close(got, ref, tol):
    scale = float(np.abs(ref).max(initial=0)) or 1.0
    return got.shape == ref.shape and \
        float(np.abs(got - ref).max(initial=0)) <= tol * scale


def run_group(nranks, cases, tmp):
    """Run ``cases`` ({name: (kind, args)}) on one gloo group of
    ``nranks``; the per-rank results."""
    job = os.path.join(tmp, 'job.pkl')
    with open(job, 'wb') as f:
        pickle.dump(cases, f)
    dryrun.launch(nranks, 'torch_dist_worker:run', {'job': job, 'out': tmp},
                  device='cpu', timeout=600, path=[HERE])
    out = []
    for r in range(nranks):
        with open(os.path.join(tmp, f'{r}.pkl'), 'rb') as f:
            out.append(pickle.load(f))
    return out


# -- the cases --------------------------------------------------------------

def pencil_cases(grids):
    return {f'pencil-{g}-{s}': ('pencil', {'shape': s, 'grid': g,
                                           'X': rand(s, 'd', 1)})
            for g in grids for s in SHAPES}


PLANAR = {2: [(s, dt, False) for s in SHAPES for dt in 'fFdD'] +
          [((16, 16, 16), 'f', 1.5), ((12, 13, 14), 'd', 1.5)],
          4: [(s, dt, p) for s in SHAPES for dt in 'fFdD'
              for p in (False, 1.5)]}


def planar_name(n, s, dt, p):
    return f'planar{n}-{s}-{dt}-{p}'


def planar_cases(n):
    out = {}
    for i, (s, dt, p) in enumerate(PLANAR[n]):
        phys = tuple(int(np.floor(m * p)) if p else m for m in s)
        real = np.float32 if dt in 'fF' else np.float64
        X = rand(phys if dt in 'fd' else (2,) + phys, real, 10 + i)
        out[planar_name(n, s, dt, p)] = ('planar', {
            'shape': s, 'dtype': dt, 'padding': p, 'X': X})
    return out


def redistribute_cases():
    out = {}
    for i, (gs, align, axis, rank) in enumerate((
            ((12, 13, 14), 2, 0, 0), ((12, 13, 14), 2, 1, 0),
            ((3, 12, 13, 14), 2, 0, 1), ((16, 16, 16), 0, 2, 0))):
        out[f'redistribute-{gs}-{align}-{axis}'] = ('redistribute', {
            'X': rand(gs, 'd', 40 + i), 'alignment': align, 'axis': axis,
            'rank': rank})
    return out


def group_cases(n):
    cases = {}
    cases.update(pencil_cases({2: [(2,), (2, 1), (1, 2)],
                               4: [(2, 2), (4, 1)]}[n]))
    cases.update(planar_cases(n))
    cases.update(redistribute_cases())
    cases['dns'] = ('dns', {'n': 8, 'seed': 0})
    if n == 4:
        for s, dt in (((16, 16, 16), 'd'), ((12, 13, 14), 'D')):
            cases[f'pfft4-{s}-{dt}'] = ('pfft', {
                'shape': s, 'dtype': dt, 'kw': {},
                'X': rand(s, dt, 50 + len(s) + ord(dt))})
    else:
        cases['refusals'] = ('refusals', {})
        cases['examples'] = ('examples', {})
        cases['staged'] = ('staged', {
            'shape': (18, 18, 18), 'dtype': 'd',
            'kw': dict(axes=((0,), (1, 2)), grid=(-1,),
                       transforms=dct3(tfftw)),
            'X': rand((18, 18, 18), 'd', 80)})
    return cases


def dct3(fftw):
    """The transforms example's dict: DCT-III on axes 1 and 2, with the
    planners of ``fftw`` (the port's or the JAX package's)."""
    return {(1, 2): (functools.partial(fftw.dctn, type=3),
                     functools.partial(fftw.idctn, type=3))}


@pytest.fixture(scope='module')
def groups(tmp_path_factory):
    """Each group size's cases and per-rank results, made once."""
    out = {}
    for n in (2, 4):
        cases = group_cases(n)
        out[n] = (cases, run_group(n, cases,
                                   str(tmp_path_factory.mktemp(f'g{n}'))))
    return out


# -- the JAX references ---------------------------------------------------

_JREF = {}


def jplanar(n, s, dt, p, X):
    key = (n, s, dt, p)
    if key not in _JREF:
        jp = JPlanarPFFT(jcomm(n), s, dtype=dt, padding=p)
        y = jp.forward(jnp.asarray(X))
        _JREF[key] = (jp, np.asarray(y), np.asarray(jp.backward(y)))
    return _JREF[key]


# -- the tests --------------------------------------------------------------

OWN = [(n, g, s) for n, gs in ((2, [(2,), (2, 1), (1, 2)]),
                               (4, [(2, 2), (4, 1)]))
       for g in gs for s in SHAPES]


@pytest.mark.parametrize('n,grid,shape', OWN)
def test_pencil_ownership(groups, n, grid, shape):
    """Every pencil of a grid: rank r's block shape and start, asked on
    rank r and of rank r from every rank, are JAX's of device r."""
    cases, res = groups[n]
    jsub = JSubcomm(jcomm(n), list(grid))
    for r, got in enumerate(res):
        own = got[f'pencil-{grid}-{shape}']['own']
        assert own, "no pencil"
        for axis, o in own.items():
            jp = JPencil(jsub, shape, axis)
            assert o['shape'] == jp.local_shape(device_index=r)
            assert o['start'] == jp.local_start(device_index=r)
            for q, (lshape, lstart) in enumerate(o['all']):
                assert lshape == jp.local_shape(device_index=q)
                assert lstart == jp.local_start(device_index=q)


@pytest.mark.parametrize('n,grid,shape', OWN)
def test_transfer_arrays(groups, n, grid, shape):
    """Transfer.forward/backward on this rank's blocks (reference
    semantics): the blocks of the partner pencil, and back."""
    cases, res = groups[n]
    name = f'pencil-{grid}-{shape}'
    X = cases[name][1]['X']
    jsub = JSubcomm(jcomm(n), list(grid))
    ja = JPencil(jsub, shape, len(shape) - 1)
    jb = ja.pencil(0)
    for r, got in enumerate(res):
        g = got[name]
        assert g['fwd_slice'] == jslice(jb, r)
        assert g['bwd_slice'] == jslice(ja, r)
        np.testing.assert_array_equal(g['fwd'], X[sl(g['fwd_slice'])])
        np.testing.assert_array_equal(g['bwd'], X[sl(g['bwd_slice'])])


PLANAR_IDS = [(n, s, dt, p) for n in (2, 4) for (s, dt, p) in PLANAR[n]]


@pytest.mark.parametrize('n,shape,dtype,padding', PLANAR_IDS)
def test_planar_vs_jax(groups, n, shape, dtype, padding):
    """PlanarPFFT per shard: each rank's forward and backward blocks
    against the JAX per-shard executor's global results, at its
    ceil-div block; the executor is the per-shard one."""
    cases, res = groups[n]
    name = planar_name(n, shape, dtype, padding)
    X = cases[name][1]['X']
    jp, y, z = jplanar(n, shape, dtype, padding, X)
    assert jp.executor == 'shard_map'
    tol = TOL[dtype.lower()]
    lead = 0 if dtype in 'fd' else 1
    for r, got in enumerate(res):
        g = got[name][1]
        assert g['executor'] == 'shard_map'
        assert g['global'] == (tuple(jp.global_shape(False)),
                               tuple(jp.global_shape(True)))
        assert g['y_slice'] == jslice(jp.pencils[-1], r, 1)
        assert g['x_slice'] == jslice(jp.pencil[0], r, lead)
        assert close(g['y'], y[sl(g['y_slice'])], tol), name
        assert close(g['z'], z[sl(g['x_slice'])], tol), name


@pytest.mark.parametrize('n,shape,dtype,padding', PLANAR_IDS)
def test_planar_chunked_bit_identical(groups, n, shape, dtype, padding):
    """a2a_chunks=2 against 1: every block bit for bit."""
    cases, res = groups[n]
    name = planar_name(n, shape, dtype, padding)
    for got in res:
        one, two = got[name][1], got[name][2]
        np.testing.assert_array_equal(one['y'], two['y'])
        np.testing.assert_array_equal(one['z'], two['z'])


REDIST = [(n, name) for n in (2, 4) for name in redistribute_cases()]


@pytest.mark.parametrize('n,name', REDIST)
def test_redistribute(groups, n, name):
    """DistArray.redistribute(axis) and (out=) move each rank's block to
    its block of the other pencil (the JAX DistArray's at device r);
    ``get`` gathers the global array on every rank."""
    cases, res = groups[n]
    args = cases[name][1]
    X, rank, axis = args['X'], args['rank'], args['axis']
    dims = [0] * (X.ndim - rank)
    dims[args['alignment']] = 1
    jsub = JSubcomm(jcomm(n), dims)
    jb = JPencil(jsub, X.shape[rank:], args['alignment']).pencil(axis)
    for r, got in enumerate(res):
        g = got[name]
        assert g['b_align'] == axis
        assert g['b_slice'] == ((0, X.shape[0]),) * rank + jslice(jb, r)
        np.testing.assert_array_equal(g['b'], X[sl(g['b_slice'])])
        np.testing.assert_array_equal(g['c'], X[sl(g['c_slice'])])
        np.testing.assert_array_equal(g['o'], g['b'])
        np.testing.assert_array_equal(g['get'], X)


def nyquist_free(U, n):
    """The spectral state (3, 2, n, n, n//2+1) with its Nyquist modes
    (index n//2 of each axis) zeroed.

    The step's c2r passes get i K U: where K is a Nyquist wavenumber the
    DC and Nyquist rows of the c2r axis are not real.  Every c2r of the
    port reads their imaginary parts as 0, as the JAX package's CPU path
    and numpy do, so the step agrees from the full state (``out``) and
    from this one (``out0``), whose c2r inputs are all Hermitian."""
    U = U.copy()
    for ax in range(3):
        idx = [slice(None)] * U.ndim
        idx[2 + ax] = n // 2
        U[tuple(idx)] = 0
    return U


def jax_dryrun(n, nranks, seed=0):
    """The JAX dry run's steps (__graft_entry__.py:35-120) on the first
    ``nranks`` devices, returning what it asserts on."""
    comm = jcomm(nranks)
    sizes = [c.Get_size() for c in JSubcomm(comm, [0, 0, 1])]
    N = (n,) * 3
    pfft = JPlanarPFFT(comm, N, dtype='d', grid=tuple(sizes))
    nu, dt = dryrun.NU, dryrun.DT
    k = [np.fft.fftfreq(m, 1. / m) for m in N[:-1]]
    k.append(np.fft.rfftfreq(N[-1], 1. / N[-1]))
    Ks = np.meshgrid(*k, indexing='ij', sparse=True)
    spec_shape = pfft.global_shape(True)[1:]
    K = np.array([np.broadcast_to(ki, spec_shape) for ki in Ks], dtype=float)
    K2 = np.sum(K * K, 0)
    KoK2 = K / np.where(K2 == 0, 1, K2)
    Kj, K2j, KoK2j = jnp.asarray(K), jnp.asarray(K2), jnp.asarray(KoK2)
    fwd, bck = pfft.forward_fn, pfft.backward_fn

    def pmul_i(K_ax, p):
        return jnp.stack([-K_ax * p[1], K_ax * p[0]])

    @jax.jit
    def train_step(U_hat):
        u = [bck(U_hat[j]) for j in range(3)]
        w = [bck(pmul_i(Kj[1], U_hat[2]) - pmul_i(Kj[2], U_hat[1])),
             bck(pmul_i(Kj[2], U_hat[0]) - pmul_i(Kj[0], U_hat[2])),
             bck(pmul_i(Kj[0], U_hat[1]) - pmul_i(Kj[1], U_hat[0]))]
        rhs = jnp.stack([fwd(u[1] * w[2] - u[2] * w[1]),
                         fwd(u[2] * w[0] - u[0] * w[2]),
                         fwd(u[0] * w[1] - u[1] * w[0])])
        P_hat = jnp.sum(rhs * KoK2j[:, None], 0)
        rhs = rhs - P_hat * Kj[:, None]
        rhs = rhs - nu * K2j * U_hat
        return U_hat + dt * rhs

    rng = np.random.default_rng(seed)
    u0 = [jnp.asarray(rng.random(N)) for _ in range(3)]
    U_hat = jax.jit(lambda *u: jnp.stack([fwd(v) for v in u]))(*u0)
    out = train_step(U_hat)
    out0 = train_step(jnp.asarray(nyquist_free(np.asarray(U_hat), n)))
    fft = jpkg.PFFT(comm, (n, n + 1, n), dtype='d', grid=tuple(sizes),
                    a2a_chunks=2)
    x = jnp.asarray(rng.random((n, n + 1, n)))
    y = jax.jit(lambda v: fft.backward.fn_p(fft.forward.fn_p(v, True),
                                            False))(x)
    szs = [s for s in sizes if s > 1][:2] or [1]
    pds = JPlanarPFFT(comm, (64,) * 3, dtype='D', grid=tuple(szs))
    xz = jnp.asarray(rng.standard_normal((2, 64, 64, 64)))
    yz = jax.jit(lambda v: pds.backward_fn(pds.forward_fn(v, True),
                                           False))(xz)
    return {'U_hat': np.asarray(U_hat), 'out': np.asarray(out),
            'out0': np.asarray(out0),
            'executor': fft.executor, 'pfft_y': np.asarray(y),
            'c2c_y': np.asarray(yz), 'pencil': pfft.pencils[-1]}


@pytest.mark.parametrize('n', (2, 4))
def test_dryrun_vs_jax(groups, n):
    """dryrun_multichip's steps on n ranks: the DNS step (the state it
    starts from, the step from that state with its Nyquist modes, and
    the step from that state without them), the uneven PFFT's round trip
    on its per-shard executor and the f64 c2c round trip, each rank's
    block against the JAX dry run's on n devices (2e-10);
    dryrun_multichip's own checks pass."""
    cases, res = groups[n]
    ref = jax_dryrun(8, n)
    assert ref['executor'] == 'shard_map'
    for r, got in enumerate(res):
        g = got['dns']
        assert g['spec_slice'] == jslice(ref['pencil'], r, 1)
        s = (slice(None),) + sl(g['spec_slice'])
        assert close(g['U_hat'], ref['U_hat'][s], TOL['d'])
        assert close(g['out0'], ref['out0'][s], TOL['d'])
        assert g['out'].shape == ref['out'][s].shape
        assert np.isfinite(g['out']).all()
        assert close(g['out'], ref['out'][s], TOL['d'])
        assert g['pfft_executor'] == 'shard_map'
        assert close(g['pfft_y'], ref['pfft_y'][sl(g['pfft_slice'])],
                     TOL['d'])
        assert close(g['c2c_y'], ref['c2c_y'][sl(g['c2c_slice'])],
                     TOL['d'])
        summ = g['summary']
        assert summ['ranks'] == n and summ['rank'] == r
        assert summ['executor'] == summ['pfft_executor'] == 'shard_map'
        assert summ['pfft_round_trip_err'] <= 1e-8
        assert summ['c2c_round_trip_err'] <= 2e-10


@pytest.mark.parametrize('shape,dtype', [((16, 16, 16), 'd'),
                                         ((12, 13, 14), 'D')])
def test_pfft_on_4_ranks_vs_jax(groups, shape, dtype):
    """PFFT's buffer call on 4 ranks against the JAX PFFT on 4 devices."""
    cases, res = groups[4]
    name = f'pfft4-{shape}-{dtype}'
    X = cases[name][1]['X']
    jf = jpkg.PFFT(jcomm(4), shape, dtype=dtype)
    assert jf.executor == 'shard_map'
    y = np.asarray(jf.forward(X.copy()))
    for r, got in enumerate(res):
        for c in (1, 2):
            g = got[name][c]
            assert g['executor'] == 'shard_map'
            assert g['y_slice'] == tuple(
                (s.start, s.stop) for s in jf.local_slice(True, r))
            assert close(g['y'], y[sl(g['y_slice'])], TOL['d'])
            assert close(g['z'], X[sl(g['x_slice'])], TOL['d'])
        np.testing.assert_array_equal(got[name][1]['y'], got[name][2]['y'])


@pytest.mark.parametrize('n', (2, 4))
def test_workers_import_no_jax(groups, n):
    """No rank imported JAX or the JAX package, and no kernel launched:
    on CPU tensors the wrappers run their plain versions."""
    for got in groups[n][1]:
        assert got['_modules'] == []
        assert got['_launches'] == {k: 0 for k in got['_launches']}


def test_cuda_plan_on_unnamed_gloo_group_raises(groups):
    """A plan on CUDA over a gloo group the caller did not name is
    refused (gloo copies CUDA tensors through host memory)."""
    for got in groups[2][1]:
        for msg in got['refusals']:
            assert msg is not None and 'gloo' in msg


def test_nccl_more_ranks_than_cards_raises():
    """NCCL puts one rank on a card: more ranks than cards are refused
    before anything starts, by the launcher and by initialize."""
    import torch
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match='one rank on a card'):
        dryrun.launch(n, 'torch_dist_worker:run', device='cuda',
                      backend='nccl')
    with pytest.raises(ValueError, match='one rank on a card'):
        multihost.initialize('tcp://localhost:1', world_size=n, rank=0,
                             backend='nccl', device='cuda')
    assert not multihost.process_count() > 1


def test_one_rank_group_in_process():
    """A one-rank gloo group in this process: COMM_WORLD is the group,
    the plans take the one-rank path, and a CUDA plan on the gloo group
    is refused unless gloo was named."""
    import torch
    from mpi4py_fft_torch.parallel.comm import COMM_WORLD
    port = dryrun._free_port()
    multihost.initialize(f'tcp://localhost:{port}', world_size=1, rank=0,
                         device='cpu')
    try:
        assert COMM_WORLD.distributed and COMM_WORLD.Get_size() == 1
        assert COMM_WORLD.backend == 'gloo' and COMM_WORLD.device.type == 'cpu'
        with pytest.raises(ValueError, match='gloo'):
            PlanarPFFT(None, (8, 8, 8), device='cuda')
        with pytest.raises(ValueError, match='gloo'):
            PFFT(None, (8, 8, 8), device='cuda')
        fft = PFFT(None, (8, 8, 8), dtype='d')
        assert fft.device.type == 'cpu' and fft.executor == 'gspmd'
        x = torch.rand((8, 8, 8), dtype=torch.float64)
        assert torch.allclose(fft.backward.fn(fft.forward.fn(x)), x)
    finally:
        multihost.finalize()
    assert not COMM_WORLD.distributed


def test_examples_on_2_ranks(groups):
    """The ported transforms and darray examples on 2 ranks: each rank
    returns the OK line and rank 0 prints it; the transforms example's
    collapse on a slab grid keeps two stages, as the JAX example's on a
    mesh of several devices."""
    for r, got in enumerate(groups[2][1]):
        for name, line in (('transforms', 'transforms demo OK'),
                           ('darray', 'darray demo OK')):
            res, printed = got['examples'][name]
            assert res['message'] == line and res['rank'] == r
            assert res['ranks'] == 2
            assert printed == (line + '\n' if r == 0 else '')
        assert got['examples']['transforms'][0]['axes'] == [[0], [1, 2]]


def test_stage_times_on_2_ranks_vs_jax(groups):
    """stage_times of the transforms example's r2r plan on 2 ranks (real
    blocks through the exchange): each rank times its exchange, the staged
    chain equals the fused transform bit for bit, and the block is the
    JAX PFFT's on 2 devices."""
    cases, res = groups[2]
    X = cases['staged'][1]['X']
    jf = jpkg.PFFT(jcomm(2), (18, 18, 18), axes=((0,), (1, 2)), grid=(-1,),
                   transforms=dct3(jpkg.fftw), dtype='d')
    y = np.asarray(jf.forward(X.copy()))
    for r, got in enumerate(res):
        g = got['staged']
        assert g['keys'] == ['fused_total', 'stage0', 'stage1',
                             'transpose0']
        assert g['equal']
        assert g['y_slice'] == tuple(
            (s.start, s.stop) for s in jf.local_slice(True, r))
        # the fused result is planar: (2,) + the complex block
        assert close(g['y'][0] + 1j * g['y'][1], y[sl(g['y_slice'])],
                     TOL['d'])
