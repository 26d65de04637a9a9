"""The port's serial transform layer (mpi4py_fft_torch/libfft.py, ops/
xfftn.py, ops/plan.py) against the JAX package's, on the CPU.

The port's plans run with ``device='cpu'``, so every kernel wrapper runs
its plain version; the JAX side runs its CPU path.  Both get the same
numpy inputs, made from a seed.  Tolerances, relative L2: 5e-6 for
float32 (the JAX kernel tolerance, tests/test_butterfly.py:44; one or two
axes here), 1e-12 for float64 (the reference's serial d tolerance,
SURVEY.md section 4).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from mpi4py_fft_tpu import libfft as jlibfft
from mpi4py_fft_tpu.ops import xfftn as jxfftn
from mpi4py_fft_torch import libfft as tlibfft
from mpi4py_fft_torch import fftw as tfftw
from mpi4py_fft_torch.ops import butterfly as tb
from mpi4py_fft_torch.ops import matfft as tmatfft
from mpi4py_fft_torch.ops import xfftn as txfftn

TOL = {'f': 5e-6, 'd': 1e-12}


def _rel(got, ref):
    got = np.asarray(got)
    ref = np.asarray(ref)
    wide = np.complex128 if np.iscomplexobj(got) or np.iscomplexobj(ref) \
        else np.float64
    got, ref = got.astype(wide), ref.astype(wide)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _rand(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape)
    if np.dtype(dtype).kind == 'c':
        a = a + 1j * rng.standard_normal(shape)
    return a.astype(dtype)


def _spectrum(jfft, u):
    """A spectrum of the JAX plan's output shape: the forward of a field,
    so that an r2c plan's backward sees a Hermitian-consistent input."""
    return np.array(jfft.forward_fn(jnp.asarray(u)))


# (physical shape, axes, dtype, padding): c2c and r2c, f32 and f64, one or
# two axes, one padded axis with an even (32) and an odd (11) kept extent
CASES = [((8, 12, 6), (1,), 'F', False), ((8, 12, 6), (0, 2), 'D', False),
         ((6, 8, 16), (2,), 'f', False), ((6, 8, 16), (1, 2), 'd', False),
         ((4, 48, 6), (1,), 'F', 1.5), ((48, 4, 6), (0,), 'D', 1.5),
         ((4, 16, 6), (1,), 'D', 1.5), ((4, 6, 48), (2,), 'f', 1.5),
         ((4, 6, 16), (2,), 'd', 1.5)]


def _plans(shape, axes, dtype, padding, backend='jax'):
    pad = False if padding is False else [padding] * len(shape)
    jfft = jlibfft.FFT(shape, axes, dtype, pad,
                       backend='jax' if backend == 'jax' else backend)
    tfft = tlibfft.FFT(shape, axes, dtype, pad, backend=backend,
                       device='cpu')
    return jfft, tfft


@pytest.mark.parametrize('shape,axes,dtype,padding', CASES)
def test_fft_stage_functions_vs_jax(shape, axes, dtype, padding):
    jfft, tfft = _plans(shape, axes, dtype, padding)
    assert tfft.M == pytest.approx(jfft.M, rel=1e-15)
    assert tfft.forward.output_array.shape == \
        jfft.forward.output_array.shape
    assert tfft.input_planar == jfft.input_planar
    assert tfft.output_planar == jfft.output_planar
    tol = TOL[dtype.lower()]
    u = _rand(shape, dtype, 1)
    for norm in (True, False):
        ref = jfft.forward_fn(jnp.asarray(u), normalize=norm)
        got = tfft.forward_fn(torch.from_numpy(u), normalize=norm)
        assert tuple(got.shape) == tuple(ref.shape)
        assert _rel(got.numpy(), ref) <= tol
    uh = _spectrum(jfft, u)
    for norm in (False, True):
        ref = jfft.backward_fn(jnp.asarray(uh), normalize=norm)
        got = tfft.backward_fn(torch.from_numpy(uh), normalize=norm)
        assert got.numpy().dtype == np.asarray(ref).dtype
        assert _rel(got.numpy(), ref) <= tol
    # the pipeline (planar) form
    pin = tmatfft.planar(torch.from_numpy(u)) if tfft.input_planar \
        else torch.from_numpy(u)
    ref = jfft.forward_fn(jnp.asarray(u))
    got = tfft.forward_fn_p(pin)
    assert tuple(got.shape) == (2,) + tuple(ref.shape)
    assert _rel(tmatfft.unplanar(got).numpy(), ref) <= tol
    ref = jfft.backward_fn(jnp.asarray(uh))
    got = tfft.backward_fn_p(tmatfft.planar(torch.from_numpy(uh)))
    if tfft.input_planar:
        got = tmatfft.unplanar(got)
    assert _rel(got.numpy(), ref) <= tol


@pytest.mark.parametrize('shape,axes,dtype,padding',
                         [CASES[0], CASES[3], CASES[4], CASES[7]])
def test_fft_buffer_api_vs_jax(shape, axes, dtype, padding):
    """The buffer-style forward/backward on host arrays."""
    jfft, tfft = _plans(shape, axes, dtype, padding)
    u = _rand(shape, dtype, 2)
    ref = np.array(jfft.forward(u))
    got = tfft.forward(u)
    assert isinstance(got, np.ndarray) and got.shape == ref.shape
    assert _rel(got, ref) <= TOL[dtype.lower()]
    uh = _spectrum(jfft, u)
    out = np.zeros_like(u)
    res = tfft.backward(uh, out)
    assert res is out
    assert _rel(out, np.array(jfft.backward(uh))) <= TOL[dtype.lower()]


@pytest.mark.parametrize('backend', ['numpy', 'scipy'])
@pytest.mark.parametrize('shape,axes,dtype,padding',
                         [((8, 12, 6), (1,), 'D', False),
                          ((4, 48, 6), (1,), 'D', 1.5),
                          ((6, 8, 16), (1, 2), 'd', False),
                          ((4, 6, 48), (2,), 'd', 1.5)])
def test_fft_host_backends_vs_jax(backend, shape, axes, dtype, padding):
    """The host planners, kept as cross-checks: the same stage functions
    and buffers as the JAX package's host planners (scipy is complex
    only)."""
    if backend == 'scipy' and dtype == 'd':
        dtype = 'D'
    jfft, tfft = _plans(shape, axes, dtype, padding, backend)
    assert tfft.real_transform == jfft.real_transform
    u = _rand(shape, dtype, 3)
    ref = jfft.forward_fn(u)
    got = tfft.forward_fn(u)
    assert isinstance(got, np.ndarray) and _rel(got, ref) <= 1e-12
    assert _rel(tfft.backward_fn(ref), jfft.backward_fn(ref)) <= 1e-12
    assert _rel(tfft.forward(u), np.array(jfft.forward(u))) <= 1e-12
    with pytest.raises(AssertionError):
        tfft.forward_fn_p(torch.from_numpy(np.asarray(u)))


def test_padded_c2c_stages_reach_fft_axis_tp(monkeypatch):
    """A spy on butterfly.fft_axis_tp: the padded c2c stages go through the
    fused kernel, with the truncation or padding and the normalization,
    and the r2c stages through rfft_axis_p with trunc and irfft_axis_p on
    the truncated spectrum."""
    calls = []
    for name in ('fft_axis_tp', 'rfft_axis_p', 'irfft_axis_p'):
        real = getattr(tb, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append((_name, a[1], {k: v for k, v in kw.items()
                                        if v is not None}))
            return _real(*a, **kw)

        monkeypatch.setattr(tb, name, spy)
    fft = tlibfft.FFT((4, 48, 6), (1,), 'D', [1.5] * 3, device='cpu')
    p = tmatfft.planar(torch.from_numpy(_rand((4, 48, 6), 'D', 4)))
    y = fft.forward_fn_p(p)
    assert tuple(y.shape) == (2, 4, 32, 6)
    fft.backward_fn_p(y)
    assert calls == [('fft_axis_tp', 1, {'trunc': 32, 'scale': 1.0 / 48}),
                     ('fft_axis_tp', 1, {'pad': 48})]
    # the complex stage functions and the buffer call take the same kernel
    calls.clear()
    u = _rand((4, 48, 6), 'D', 4)
    fft.backward_fn(fft.forward_fn(torch.from_numpy(u)))
    fft.backward(fft.forward(u))
    assert [c[0] for c in calls] == ['fft_axis_tp'] * 4
    calls.clear()
    fft = tlibfft.FFT((4, 6, 48), (2,), 'f', [1.5] * 3, device='cpu')
    y = fft.forward_fn_p(torch.from_numpy(_rand((4, 6, 48), 'f', 5)))
    assert tuple(y.shape) == (2, 4, 6, 17)
    fft.backward_fn_p(y)
    assert calls == [('rfft_axis_p', 2, {'trunc': 17, 'scale': 1.0 / 48}),
                     ('irfft_axis_p', 2, {})]


# ---------------------------------------------------------------------------
# the planner functions (xfftn) against the JAX package's
# ---------------------------------------------------------------------------

PLANNERS = [('fftn', 'D', (0, 2)), ('ifftn', 'F', (1,)),
            ('rfftn', 'd', (1, 2)), ('irfftn', 'D', (0, 2)),
            ('hfftn', 'D', (2,)), ('ihfftn', 'd', (0, 1)),
            ('fftn', 'F', (-1,)), ('rfftn', 'f', (-1,))]


@pytest.mark.parametrize('name,dtype,axes', PLANNERS)
def test_planners_vs_jax(name, dtype, axes):
    if name in ('irfftn', 'hfftn'):
        # the half spectrum of a real (6, 8, 16) field (random spectra
        # are held in tests/test_torch_c2r.py)
        r = _rand((6, 8, 16), dtype.lower(), 7)
        u = np.fft.rfftn(r, axes=axes).astype(dtype)
    else:
        u = _rand((6, 8, 12), dtype, 7)
    jplan = getattr(jxfftn, name)(u.copy(), axes=axes)
    tplan = getattr(txfftn, name)(u.copy(), axes=axes, device='cpu')
    assert tplan.output_array.shape == jplan.output_array.shape
    assert tplan.output_array.dtype == jplan.output_array.dtype
    assert tplan.kind == jplan.kind and tplan.axes == jplan.axes
    assert tplan.get_normalization() == pytest.approx(
        jplan.get_normalization(), rel=1e-15)
    tol = TOL[dtype.lower()]
    for norm in (False, True):
        ref = np.array(jplan(u, normalize=norm))
        got = tplan(u, normalize=norm)
        assert got is tplan.output_array
        assert _rel(got, ref) <= tol
    out = np.zeros_like(tplan.output_array)
    assert tplan(u, out) is out and _rel(out, jplan(u)) <= tol


def test_get_normalization_vs_jax():
    for kind in (tfftw.FFTW_FORWARD, tfftw.FFTW_REDFT00, tfftw.FFTW_RODFT00,
                 tfftw.FFTW_REDFT10, [tfftw.FFTW_RODFT11, tfftw.R2C]):
        assert txfftn.get_normalization(kind, (6, 8, 10), (1, 2)
                                        if isinstance(kind, list) else (2,)
                                        ) == jxfftn.get_normalization(
            kind, (6, 8, 10), (1, 2) if isinstance(kind, list) else (2,))


def test_fftw_surface():
    """The port's 'fftw' module: the JAX package's names, enums and
    precision registry; the r2r planners plan their kind on every axis
    (held against JAX in tests/test_torch_r2r.py); the host torch planner
    raises, naming its ROADMAP item."""
    import mpi4py_fft_tpu.fftw as jfftw
    for name in ('fftn', 'ifftn', 'rfftn', 'irfftn', 'hfftn', 'ihfftn',
                 'dctn', 'idctn', 'dstn', 'idstn', 'get_normalization',
                 'aligned', 'aligned_like', 'get_alignment', 'fftlib',
                 'get_fftw_lib', 'get_planned_FFT', 'export_wisdom',
                 'import_wisdom', 'forget_wisdom', 'set_timelimit',
                 'cleanup', 'flag_dict', 'FFTW_MEASURE', 'FFTW_REDFT10'):
        assert hasattr(tfftw, name), name
    assert tfftw.flag_dict == jfftw.flag_dict
    for k in ('FFTW_FORWARD', 'FFTW_BACKWARD', 'FFTW_REDFT00',
              'FFTW_RODFT11', 'FFTW_DHT', 'C2C_FORWARD', 'R2C', 'C2R'):
        assert getattr(tfftw, k) == getattr(jfftw, k), k
    assert sorted(tfftw.fftlib) == ['D', 'F']
    assert tfftw.get_fftw_lib('G') is None
    assert tfftw.get_fftw_lib(np.complex64) is tfftw.FFT
    a = tfftw.aligned((3, 5), n=32, dtype='D')
    assert a.ctypes.data % 32 == 0 and a.shape == (3, 5)
    assert tfftw.get_alignment(a) == 32
    u = np.zeros((4, 8))
    for name, kind in (('dctn', tfftw.FFTW_REDFT10),
                       ('idctn', tfftw.FFTW_REDFT01),
                       ('dstn', tfftw.FFTW_RODFT10),
                       ('idstn', tfftw.FFTW_RODFT01)):
        assert getattr(tfftw, name)(u, device='cpu').kind == (kind,)
    assert tfftw.FFT(u, u.copy(), (1,), [tfftw.FFTW_REDFT10],
                     device='cpu').kind == (tfftw.FFTW_REDFT10,)
    with pytest.raises(NotImplementedError, match='Queue 1 item 8'):
        tlibfft.FFT((4, 8), (1,), 'd', backend='torch', device='cpu')
    import mpi4py_fft_torch.fftw.xfftn as tx
    assert tx is txfftn


def test_compute_dims_and_aligned_vs_jax():
    from mpi4py_fft_tpu import utils as jutils
    from mpi4py_fft_torch import utils as tutils
    for n, dims in ((8, [0, 0]), (12, [0, 0, 0]), (8, [2, 0]), (1, [0, 0]),
                    (16, [0, 1, 0]), (6, [3, 2])):
        assert tutils.compute_dims(n, dims) == jutils.compute_dims(n, dims)
    b = tutils.aligned_like(np.zeros((3, 4), np.float32), fill=1)
    assert b.dtype == np.float32 and (b == 1).all()


def test_wisdom_points_the_build_dir(tmp_path, monkeypatch):
    from mpi4py_fft_torch.ops import _build
    monkeypatch.setattr(_build, 'BUILD_DIR', _build.BUILD_DIR)
    w = tmp_path / 'plans.wisdom'
    tfftw.export_wisdom(str(w))
    assert _build.BUILD_DIR == tmp_path / 'plans.kernels'
    assert _build.BUILD_DIR.is_dir()
    tfftw.import_wisdom(str(w))
    assert _build.BUILD_DIR == tmp_path / 'plans.kernels'
    with pytest.raises(AssertionError, match='wisdom'):
        tfftw.import_wisdom(str(tmp_path / 'none'))
    tfftw.forget_wisdom()
    tfftw.set_timelimit(1.0)
    tfftw.cleanup()


def test_plans_default_to_cuda():
    """No CUDA and no device='cpu': the plans raise, never run on the
    CPU."""
    if torch.cuda.is_available():
        assert tlibfft.FFT((4, 8), (1,), 'D').device.type == 'cuda'
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlibfft.FFT((4, 8), (1,), 'D')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        txfftn.fftn(np.zeros((4, 8), 'D'))
