"""The port's float64 path against the JAX package's f64 tier, on the CPU.

* Kernel holds: ``fft_axis_p``, ``rfft_axis_p`` and ``irfft_axis_p`` on
  float64 tensors (their plain versions here; their fp64 CUDA builds on
  the card) against F, ``pallas_ds.fft_axis_ds`` and its r2c/c2r glue
  ``rfft_axis_ds``/``irfft_axis_ds``, run in interpret mode on
  double-single data (``to_ds``/``from_ds``).  Tolerance: relative L2
  2e-13, the JAX suite's own for F (tests/test_ds.py:58).  The shapes
  pass F's gates: power-of-two N <= 1024, complementary volume a
  multiple of 1024.
* Where F has no counterpart (3*2^a extents, dealiased plans): the port's
  ``PlanarPFFT(dtype='d'/'D')`` against the JAX ``PlanarPFFT`` on its CPU
  x64 einsum path, at 2e-10 (tests/test_ds.py:18); backward on the
  spectra of fields (ROADMAP Queue 3 explains why).
* Dispatch: float64 CUDA tensors reach a kernel or raise, and the pair
  kernel, which has no fp64 build yet, raises without running a plain
  version.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi4py_fft_tpu.ops import pallas_ds as ds
from mpi4py_fft_tpu.parallel import DeviceComm
from mpi4py_fft_tpu.parallel.planar import PlanarPFFT as JPlanarPFFT

from mpi4py_fft_torch import PlanarPFFT
from mpi4py_fft_torch.ops import _build
from mpi4py_fft_torch.ops import butterfly as tb
from mpi4py_fft_torch.ops import matfft as tmatfft

F_TOL = 2e-13
D_TOL = 2e-10
SHAPE = (16, 64, 128)


def _rel(got, ref):
    got = np.asarray(got)
    ref = np.asarray(ref)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _cplx(p):
    p = np.asarray(p)
    return p[0] + 1j * p[1]


@pytest.mark.parametrize('forward', [True, False])
@pytest.mark.parametrize('axis', [0, 1, 2])
def test_fft_axis_vs_ds(axis, forward):
    """Lead, mid and last axes, both signs."""
    rng = np.random.default_rng(20 + axis)
    z = rng.standard_normal(SHAPE) + 1j * rng.standard_normal(SHAPE)
    assert ds.supported_ds(SHAPE, axis)
    ref = ds.from_ds(np.asarray(ds.fft_axis_ds(ds.to_ds(z), axis, forward,
                                               interpret=True)))
    got = tb.fft_axis_p(tmatfft.planar(z), axis, forward)
    assert got.dtype == torch.float64
    assert _rel(_cplx(got), ref) < F_TOL


@pytest.mark.parametrize('hext', [None, 70])
def test_rfft_irfft_vs_ds(hext):
    """Packed r2c (with zero rows up to ``hext``) and c2r on the last axis,
    the c2r on a random half spectrum: F's glue keeps the imaginary parts
    of the DC and Nyquist rows, as the port's packed c2r does."""
    rng = np.random.default_rng(24)
    x = rng.standard_normal(SHAPE)
    X = ds.rfft_axis_ds(ds.split_real_ds(jnp.asarray(x)), 2,
                        interpret=True, hext=hext)
    ref = np.asarray(ds.join_planar_ds(X))
    got = tb.rfft_axis_p(torch.from_numpy(x), 2, hext=hext)
    assert tuple(got.shape) == ref.shape == (2, 16, 64, hext or 65)
    assert _rel(got, ref) < F_TOL
    h = rng.standard_normal((2, 16, 64, 65))
    y = ds.irfft_axis_ds(ds.split_planar_ds(jnp.asarray(h)), 2, 128,
                         scale=1.0 / 128, interpret=True)
    ref = np.asarray(ds.join_real_ds(y))
    got = tb.irfft_axis_p(torch.from_numpy(h), 2, 128, scale=1.0 / 128)
    assert got.dtype == torch.float64 and tuple(got.shape) == SHAPE
    assert _rel(got, ref) < F_TOL


# 3*2^a extents and dealiased plans: gaps of the JAX DS tier
CASES = [('D', (24, 48, 96), False), ('d', (24, 48, 96), False),
         ('D', (32, 32, 32), 1.5), ('d', (32, 16, 64), 1.5)]


@pytest.mark.parametrize('dtype,shape,padding', CASES)
def test_f64_plans_vs_jax(dtype, shape, padding):
    jp = JPlanarPFFT(DeviceComm(jax.devices()[:1]), shape, dtype=dtype,
                     padding=padding)
    tp = PlanarPFFT(None, shape, dtype=dtype, padding=padding,
                    device='cpu')
    assert tp.global_shape(False) == jp.global_shape(False)
    assert tp.global_shape(True) == jp.global_shape(True)
    rng = np.random.default_rng(25)
    x = rng.standard_normal(jp.global_shape(False))
    ref = np.array(jp.forward(jnp.asarray(x)))
    got = tp.forward(torch.from_numpy(x))
    assert got.dtype == torch.float64
    assert _rel(got, ref) < D_TOL
    raw = tp.forward(torch.from_numpy(x), normalize=False)
    assert _rel(raw, jp.forward(jnp.asarray(x), normalize=False)) < D_TOL
    # backward on the spectrum of a field
    back = tp.backward(torch.from_numpy(ref))
    assert _rel(back, jp.backward(jnp.asarray(ref))) < D_TOL


def test_f64_long_axes_on_cpu():
    """float64 axes of 2048 and 4096 take the engine's matrix stages (the
    pair pass and the four-step are float32 routes, as in the JAX
    package)."""
    rng = np.random.default_rng(26)
    for N in (2048, 4096):
        shape = (3, N, 2)
        z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        got = tmatfft.fft1d_p(tmatfft.planar(z), 1)
        ref = np.fft.fft(z, axis=1)
        assert _rel(_cplx(got), ref) < F_TOL


class _CudaStub:
    """Stands for a CUDA tensor on a machine without a card: what the
    wrappers read before they launch a kernel or raise."""

    def __init__(self, shape, dtype):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = torch.device('cuda', 0)

    def dim(self):
        return len(self.shape)

    def is_floating_point(self):
        return self.dtype.is_floating_point

    def is_contiguous(self):
        return True


@pytest.fixture
def no_plain(monkeypatch):
    """Fail if any plain version runs."""
    def refuse(*a, **k):
        raise AssertionError("a plain version ran for a CUDA tensor")

    for name in ('fft_axis_plain', 'rfft_axis_plain', 'irfft_axis_plain',
                 'fft_axis2_plain', 'fft_axis_pair_plain'):
        monkeypatch.setattr(tb, name, refuse)


def test_f64_cuda_reaches_kernels(monkeypatch):
    """A float64 CUDA tensor is taken by the kernels with an fp64 build,
    whose C entry the wrapper launches and counts under ``<name>_f64``;
    other types still raise."""
    f64 = _CudaStub((2, 8, 16), torch.float64)
    f32 = _CudaStub((2, 8, 16), torch.float32)
    assert tb._plain_ok(f64, 'fft_axis_p') is False
    assert tb._plain_ok(f32, 'fft_axis_p') is False
    monkeypatch.setattr(_build, '_kernels', SimpleNamespace(
        rfft_axis_f32='r2c f32', rfft_axis_f64='r2c f64'))
    assert tb._build_of('rfft_axis_p', 'rfft_axis', f64) == \
        ('rfft_axis_p_f64', 'r2c f64')
    assert tb._build_of('rfft_axis_p', 'rfft_axis', f32) == \
        ('rfft_axis_p', 'r2c f32')
    assert set(tb.LAUNCHES) >= {'fft_axis_p_f64', 'rfft_axis_p_f64',
                                'irfft_axis_p_f64'}
    with pytest.raises(TypeError, match='float32 and float64'):
        tb._plain_ok(_CudaStub((2, 8, 16), torch.float16), 'fft_axis_p')
    with pytest.raises(NotImplementedError, match='Queue 2, D64'):
        tb._plain_ok(f64, 'fft_axis2_p', f64=False)


def test_f64_pair_raises_on_cuda(no_plain, monkeypatch):
    """The pair kernel refuses float64 CUDA tensors, and no plain version
    runs in its place; float64 axes over 1024 take the engine instead of
    the pair pass and the four-step, as in the JAX package."""
    for N in (1536, 2048):
        p = _CudaStub((2, 4, N, 8), torch.float64)
        with pytest.raises(NotImplementedError, match='Queue 2, D64'):
            tb.fft_axis_pair_p(p, 1)
        h = _CudaStub((2, 4, N // 2, 8), torch.float64)
        with pytest.raises(NotImplementedError, match='Queue 2, D64'):
            tb.fft_axis2_p(h, h, 1)
    routes = []
    monkeypatch.setattr(tmatfft, '_fft_axis_einsum',
                        lambda p, axis, sign: routes.append(('mid', axis)))
    monkeypatch.setattr(tmatfft, '_fft_last_p',
                        lambda p, sign: routes.append(('last',)))
    for shape, axis in (((2, 4, 1536, 8), 1), ((2, 2048, 8), 0),
                        ((2, 4096, 8), 0), ((2, 8, 8192), 1)):
        tmatfft.fft1d_p(_CudaStub(shape, torch.float64), axis)
    assert routes == [('mid', 1), ('mid', 0), ('mid', 0), ('last',)]
