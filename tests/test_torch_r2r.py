"""The port's r2r transforms (mpi4py_fft_torch/ops/core.py: DCT/DST I-IV,
DHT, R2HC/HC2R; the r2r planners; ``libfft.FFT`` and ``PFFT`` with
``transforms=``) against the JAX package's, on the CPU.

The JAX side runs as its own tests run it (tests/test_fftw.py:221-271):
``core.r2r`` is glue around its einsum engine, with no Pallas kernel, on
the CPU, each reference jitted once.  The port runs with
``device='cpu'`` or on CPU tensors, so every kernel wrapper (B and C
under the FFT-backed kinds) runs its plain version.  Both get the same
numpy inputs, made from a seed.  Tolerances are the JAX suite's:
max abs over max(1, largest value) < 2e-5 (float32), < 1e-12 (float64)
for the serial transforms (tests/test_fftw.py:243); relative L2 5e-5 /
2e-10 for the parallel plans (tests/test_torch_dist.py's ``TOL``).  The
N of the cases take every route: the dense basis below 16 (8, 13), the
FFT-backed glue from 16 on (20, 31; DHT also 64), and at kernel lengths
that 4 divides (16, 24, 96) the one-pass DCT-II/III wrappers
(``dct2_axis_p``, ``dct3_axis_p``), under DCT-II/III, DST-II/III and
DCT-IV, also held against scipy.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import mpi4py_fft_tpu as jpkg
from mpi4py_fft_tpu import libfft as jlibfft
from mpi4py_fft_tpu.ops import core as jcore
from mpi4py_fft_tpu.ops import xfftn as jxfftn
from mpi4py_fft_torch import PFFT, fftw as tfftw, libfft as tlibfft
from mpi4py_fft_torch.ops import core as tcore
from mpi4py_fft_torch.ops import xfftn as txfftn
from mpi4py_fft_torch.ops import kinds as K

SERIAL_TOL = {'float32': 2e-5, 'float64': 1e-12}
PIPE_TOL = {'f': 5e-5, 'd': 2e-10}

NAMES = {K.FFTW_REDFT00: 'dct1', K.FFTW_REDFT10: 'dct2',
         K.FFTW_REDFT01: 'dct3', K.FFTW_REDFT11: 'dct4',
         K.FFTW_RODFT00: 'dst1', K.FFTW_RODFT10: 'dst2',
         K.FFTW_RODFT01: 'dst3', K.FFTW_RODFT11: 'dst4',
         K.FFTW_DHT: 'dht', K.FFTW_R2HC: 'r2hc', K.FFTW_HC2R: 'hc2r'}
KINDS = list(NAMES)
AXES = (0, 1, 2)
NS = (8, 13, 20, 31)
DTYPES = ('float32', 'float64')


def _input(N, dtype, axis):
    """A random (N along ``axis``, 3 and 4 elsewhere) array."""
    shape = [3, 4]
    shape.insert(axis, N)
    rng = np.random.default_rng(1000 * N + 10 * axis + len(dtype))
    return rng.standard_normal(shape).astype(dtype)


_JREF = {}


def _jref(N, dtype):
    """JAX ``core.r2r`` of every kind along every axis at this N and
    dtype, from one jitted program."""
    if (N, dtype) not in _JREF:
        kinds = KINDS if N in NS else [K.FFTW_DHT]
        xs = tuple(_input(N, dtype, ax) for ax in AXES)

        def f(xs):
            return {(k, ax): jcore.r2r(xs[ax], (ax,), (k,))
                    for k in kinds for ax in AXES}
        out = jax.jit(f)(tuple(jnp.asarray(x) for x in xs))
        _JREF[N, dtype] = {key: np.asarray(v) for key, v in out.items()}
    return _JREF[N, dtype]


def _err(got, ref):
    return float(np.abs(np.asarray(got, np.float64) - ref).max()) / \
        max(1.0, float(np.abs(ref).max()))


CASES = [(k, N, dt, ax) for k in KINDS for N in NS for dt in DTYPES
         for ax in AXES] + \
    [(K.FFTW_DHT, 64, dt, ax) for dt in DTYPES for ax in AXES]


@pytest.mark.parametrize(
    'kind,N,dtype,axis', CASES,
    ids=[f'{NAMES[k]}-{N}-{dt}-ax{ax}' for k, N, dt, ax in CASES])
def test_r2r_vs_jax(kind, N, dtype, axis):
    x = _input(N, dtype, axis)
    got = tcore.r2r(torch.from_numpy(x), (axis,), (kind,))
    assert got.dtype == torch.from_numpy(x).dtype
    assert tuple(got.shape) == x.shape
    assert _err(got.numpy(), _jref(N, dtype)[kind, axis]) < \
        SERIAL_TOL[dtype]


@pytest.mark.parametrize('kind', [k for k in KINDS if k not in
                                  (K.FFTW_R2HC, K.FFTW_HC2R)],
                         ids=lambda k: NAMES[k])
def test_r2r_dense_against_fft(kind):
    """``set_r2r_impl('dense')`` against ``'fft'`` at N = 20, both
    precisions, and back to the default."""
    try:
        for dtype in DTYPES:
            x = torch.from_numpy(_input(20, dtype, 1))
            tcore.set_r2r_impl('fft')
            a = tcore.r2r(x, (1,), (kind,))
            tcore.set_r2r_impl('dense')
            b = tcore.r2r(x, (1,), (kind,))
            assert _err(a.numpy(), b.numpy().astype(np.float64)) < \
                SERIAL_TOL[dtype]
    finally:
        tcore.set_r2r_impl('auto')
    assert tcore._use_fft_r2r(16, kind) and not tcore._use_fft_r2r(15, kind)
    with pytest.raises(ValueError):
        tcore.set_r2r_impl('xla')


def test_r2r_several_axes_and_engine_surface():
    """Two kinds on two axes in one call, against JAX; the complex
    transforms of ``core``; the JAX package's 'xla' engine refused."""
    x = _input(20, 'float64', 1)[:, :, None, :].repeat(18, axis=2)
    kinds = (K.FFTW_REDFT01, K.FFTW_RODFT11)
    ref = np.asarray(jcore.r2r(jnp.asarray(x), (1, 2), kinds))
    got = tcore.r2r(torch.from_numpy(x), (1, 2), kinds)
    assert _err(got.numpy(), ref) < 1e-12
    z = np.random.default_rng(3).standard_normal((6, 8)) + 0j
    assert np.allclose(tcore.c2c(torch.from_numpy(z), (0, 1)).numpy(),
                       np.fft.fftn(z))
    r = z.real.copy()
    h = tcore.r2c(torch.from_numpy(r), (0, 1))
    assert np.allclose(h.numpy(), np.fft.rfftn(r))
    assert np.allclose(tcore.c2r(h, (0, 1), 8).numpy(), r * 48)
    assert tcore.get_fft_impl() == 'matmul'
    with pytest.raises(NotImplementedError, match='oracle'):
        tcore.set_fft_impl('xla')
    assert tcore.r2r_output_length(13, K.FFTW_DHT) == 13


# the kinds that ride on the one-pass DCT-II/III (dct2_axis_p,
# dct3_axis_p) at kernel lengths that 4 divides, with and without radix 3
FUSED_KINDS = (K.FFTW_REDFT10, K.FFTW_REDFT01, K.FFTW_RODFT10,
               K.FFTW_RODFT01, K.FFTW_REDFT11)
FUSED_NS = (16, 24, 96)
_JFUSED = {}


def _jfused(N, dtype):
    """JAX ``core.r2r`` of the fused kinds along every axis at this N
    and dtype, from one jitted program."""
    if (N, dtype) not in _JFUSED:
        xs = tuple(_input(N, dtype, ax) for ax in AXES)

        def f(xs):
            return {(k, ax): jcore.r2r(xs[ax], (ax,), (k,))
                    for k in FUSED_KINDS for ax in AXES}
        out = jax.jit(f)(tuple(jnp.asarray(x) for x in xs))
        _JFUSED[N, dtype] = {key: np.asarray(v) for key, v in out.items()}
    return _JFUSED[N, dtype]


def _scipy_r2r(x, kind, axis):
    """scipy.fft's unnormalized dct/dst of the kind (FFTW's), in
    float64."""
    import scipy.fft
    name, t = {K.FFTW_REDFT10: ('dct', 2), K.FFTW_REDFT01: ('dct', 3),
               K.FFTW_RODFT10: ('dst', 2), K.FFTW_RODFT01: ('dst', 3),
               K.FFTW_REDFT11: ('dct', 4)}[kind]
    return getattr(scipy.fft, name)(x.astype(np.float64), type=t, axis=axis)


FUSED_CASES = [(k, N, dt, ax) for k in FUSED_KINDS for N in FUSED_NS
               for dt in DTYPES for ax in AXES]


@pytest.mark.parametrize(
    'kind,N,dtype,axis', FUSED_CASES,
    ids=[f'{NAMES[k]}-{N}-{dt}-ax{ax}' for k, N, dt, ax in FUSED_CASES])
def test_r2r_kernel_lengths_vs_scipy_and_jax(kind, N, dtype, axis,
                                             monkeypatch):
    """At kernel lengths the DCT-II/III kinds and those that ride on them
    (DST-II/III by sign and flip, DCT-IV by its pre-twiddle and
    alternating sum) take one dct2_axis_p or dct3_axis_p call an axis
    (their plain versions here), and agree with scipy and with JAX."""
    from mpi4py_fft_torch.ops import butterfly as bf
    calls = []
    for name in ('dct2_axis_p', 'dct3_axis_p'):
        monkeypatch.setattr(bf, name, lambda x, a, _f=getattr(bf, name),
                            _n=name: calls.append(_n) or _f(x, a))
    x = _input(N, dtype, axis)
    got = tcore.r2r(torch.from_numpy(x), (axis,), (kind,))
    assert got.dtype == torch.from_numpy(x).dtype
    assert tuple(got.shape) == x.shape
    tol = SERIAL_TOL[dtype]
    assert _err(got.numpy(), _scipy_r2r(x, kind, axis)) < tol
    assert _err(got.numpy(), _jfused(N, dtype)[kind, axis]) < tol
    two = kind in (K.FFTW_REDFT10, K.FFTW_RODFT10, K.FFTW_REDFT11)
    assert calls == ['dct2_axis_p' if two else 'dct3_axis_p']


def test_roundtrip_plan_runs_one_dct_pass_an_axis():
    """The transforms example's plan at 16^3 'd' (the benchmark's r2r
    configuration, cut down): a forward and a backward count, in the
    kernels' spans, 2 DCT-III and 2 DCT-II passes (one an r2r axis) and
    one r2c and one c2r (axis 0), 3 launches a transform; the engine's
    glue runs at a length no kernel takes (18)."""
    from mpi4py_fft_torch.utils import profiling
    rows = {}
    for n in (16, 18):
        fft = PFFT(None, (n,) * 3, axes=((0,), (1, 2)), dtype='d',
                   device='cpu', transforms={(1, 2): _dct_pair(tfftw)})
        u = torch.rand((n,) * 3, dtype=torch.float64)
        with profiling.annotate('off'):
            pass
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            back = fft.backward.fn(fft.forward.fn(u))
        assert _rel(back.numpy(), u.numpy()) <= PIPE_TOL['d']
        rows[n] = {k: v['launches'] for k, v in profiling.session().items()
                   if k.startswith('kernel.')}
    assert rows[16] == {'kernel.dct3_axis_p_f64': 2,
                        'kernel.dct2_axis_p_f64': 2,
                        'kernel.rfft_axis_p_f64': 1,
                        'kernel.irfft_axis_p_f64': 1}
    assert 'kernel.dct2_axis_p_f64' not in rows[18]
    assert 'kernel.dct3_axis_p_f64' not in rows[18]


# ---------------------------------------------------------------------------
# the planners and libfft.FFT with transforms=
# ---------------------------------------------------------------------------

PLANNERS = [(name, t, dt) for name in ('dctn', 'idctn', 'dstn', 'idstn')
            for t in (1, 2, 3, 4) for dt in 'fd']


@pytest.mark.parametrize('name,type_,dtype', PLANNERS)
def test_r2r_planners_vs_jax(name, type_, dtype):
    """Output and normalization against JAX ``fftw.*``; the normalized
    round trip through the inverse planner."""
    u = np.random.default_rng(type_).standard_normal((6, 20, 18)).astype(
        dtype)
    axes = (1, 2)
    jplan = getattr(jxfftn, name)(u.copy(), axes=axes, type=type_)
    tplan = getattr(txfftn, name)(u.copy(), axes=axes, type=type_,
                                  device='cpu')
    assert tplan.kind == jplan.kind and tplan.axes == jplan.axes
    assert tplan.get_normalization() == pytest.approx(
        jplan.get_normalization(), rel=1e-15)
    assert tplan.output_array.dtype == jplan.output_array.dtype
    assert not tplan.input_planar and not tplan.output_planar
    tol = SERIAL_TOL[np.dtype(dtype).name]
    ref = np.array(jplan(u))
    got = tplan(u)
    assert got is tplan.output_array
    assert _err(got, ref.astype(np.float64)) < tol
    inv = txfftn.inverse[getattr(txfftn, name)](
        got.copy(), axes=axes, type=type_, device='cpu')
    back = inv(got.copy(), normalize=True)
    assert _err(back, u.astype(np.float64)) < 10 * tol


def _dct_pair(fftw, type_=3):
    return (functools.partial(fftw.dctn, type=type_),
            functools.partial(fftw.idctn, type=type_))


@pytest.mark.parametrize('dtype', 'fd')
def test_libfft_fft_transforms_vs_jax(dtype):
    """``libfft.FFT`` with a transforms dict: the stage functions and the
    buffer API against JAX's; the host backend 'numpy' honours the dict
    as JAX's does."""
    shape, axes = (6, 20, 18), (1, 2)
    jf = jlibfft.FFT(shape, axes, dtype,
                     transforms={axes: _dct_pair(jpkg.fftw)})
    tf = tlibfft.FFT(shape, axes, dtype, device='cpu',
                     transforms={axes: _dct_pair(tfftw)})
    assert not tf.input_planar and not tf.output_planar
    u = np.random.default_rng(4).standard_normal(shape).astype(dtype)
    tol = SERIAL_TOL[np.dtype(dtype).name]
    ref = np.asarray(jf.forward_fn(jnp.asarray(u)))
    got = tf.forward_fn(torch.from_numpy(u))
    assert _err(got.numpy(), ref.astype(np.float64)) < tol
    assert _err(tf.backward_fn(got).numpy(),
                np.asarray(jf.backward_fn(jnp.asarray(ref)))) < 10 * tol
    assert _err(tf.forward(u), np.asarray(jf.forward(u)).astype(
        np.float64)) < tol
    hj = jlibfft.FFT(shape, axes, dtype, backend='numpy',
                     transforms={axes: _scipy_pair()})
    ht = tlibfft.FFT(shape, axes, dtype, backend='numpy',
                     transforms={axes: _scipy_pair()})
    assert _err(np.asarray(ht.forward(u)).real,
                np.asarray(hj.forward(u)).real) < tol


def _scipy_pair():
    import scipy.fft
    return (functools.partial(scipy.fft.dctn, type=3),
            functools.partial(scipy.fft.idctn, type=3))


# ---------------------------------------------------------------------------
# PFFT with transforms= on one rank, against JAX PFFT on the 8-device mesh
# ---------------------------------------------------------------------------

_JPLANS = {}

# tests/test_mpifft.py:98-112 (12, 13, 12, 13) 'd' with a DCT-III dict on
# the trailing group; the transforms example's explicit-axes plans at 18^3
PFFT_CASES = [
    ('4d-3', (12, 13, 12, 13), 'd',
     dict(axes=((0,), (1,), (2,), (3,))), (3,)),
    ('4d-23', (12, 13, 12, 13), 'd', dict(axes=((0,), (1,), (2, 3))),
     (2, 3)),
    ('4d-123', (12, 13, 12, 13), 'd', dict(axes=((0,), (1, 2, 3))),
     (1, 2, 3)),
    ('example-d', (18, 18, 18), 'd', dict(axes=((0,), (1, 2))), (1, 2)),
    ('example-f', (18, 18, 18), 'f', dict(axes=((0,), (1, 2))), (1, 2)),
    ('example-padded', (18, 18, 18), 'd',
     dict(axes=((0,), (1, 2)), padding=[1.5, 1.0, 1.0]), (1, 2)),
    # a padded r2r stage: real data truncated and padded as JAX does
    ('padded-r2r-stage', (16, 16, 16), 'd',
     dict(axes=((0,), (1,), (2,)), padding=[1.0, 1.0, 1.5]), (2,)),
]


def _rel(got, ref):
    got = np.asarray(got).astype(np.complex128)
    ref = np.asarray(ref).astype(np.complex128)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize('name,shape,dtype,kw,tkey', PFFT_CASES,
                         ids=[c[0] for c in PFFT_CASES])
def test_pfft_transforms_one_rank_vs_jax(name, shape, dtype, kw, tkey):
    if name not in _JPLANS:
        _JPLANS[name] = jpkg.PFFT(None, shape, dtype=dtype,
                                  transforms={tkey: _dct_pair(jpkg.fftw)},
                                  **kw)
    jf = _JPLANS[name]
    tf = PFFT(None, shape, dtype=dtype, device='cpu',
              transforms={tkey: _dct_pair(tfftw)}, **kw)
    assert tf.axes == tuple(map(tuple, jf.axes))
    assert tf.global_shape(True) == tuple(jf.global_shape(True))
    assert tf.dtype(True) == jf.dtype(True)
    stage = [o for o in tf.xfftn if tuple(o.axes) == tkey][0]
    assert not stage.input_planar and not stage.output_planar
    rng = np.random.default_rng(len(name))
    u = rng.random(tf.global_shape(False)).astype(dtype)
    tol = PIPE_TOL[dtype]
    ref = np.array(jf.forward(u.copy()))
    got = tf.forward(u)
    assert _rel(got, ref) <= tol
    back = tf.backward(got)
    assert _rel(back, np.array(jf.backward(ref.copy()))) <= tol
    if 'padding' not in kw:
        assert _rel(back, u) <= tol


def test_r2r_entry_points_default_to_cuda():
    """No CUDA and no device='cpu': the r2r planners and a PFFT with
    transforms= raise, never run on the CPU."""
    u = np.zeros((4, 8))
    makers = [lambda name=name: getattr(txfftn, name)(u)
              for name in ('dctn', 'idctn', 'dstn', 'idstn')]
    makers.append(lambda: PFFT(None, (8, 8, 8), axes=((0,), (1, 2)),
                               transforms={(1, 2): _dct_pair(tfftw)}))
    for make in makers:
        if torch.cuda.is_available():
            assert make().device.type == 'cuda'
            continue
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
