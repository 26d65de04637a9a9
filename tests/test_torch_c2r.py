"""Every c2r of the port on random half spectra, against numpy and the JAX
package's CPU path, on the CPU.

A random half spectrum has imaginary parts in its DC row (k = 0) and, for
an even length n, its Nyquist row (k = n/2).  A real output has no
component for them (sin(pi m) = 0 at every integer m): FFTW's c2r,
``numpy.fft.irfft`` and the JAX package's ``matfft.irfftn_p`` on the CPU
read both rows as real, and so does every c2r of the port, the kernels C
and C64 (``butterfly.irfft_axis_p``) and the engine alike.  The cases:

* the entry points ``butterfly.irfft_axis_p`` (kernel lengths) and
  ``matfft.irfftn_p`` (every length) on the last and an inner axis,
  spectra short of n//2+1 rows by an even and an odd count (the
  Hermitian zero-pad, kernel lengths only: the engine, as the JAX
  package's, takes n//2+1 rows or more), exact and long, float32 and
  float64, against ``numpy.fft.irfft(...) * n`` and JAX
  ``matfft.irfftn_p``: relative L2 5e-6 (f32), 2e-13 (f64);
* the planners ``irfftn`` and ``hfftn`` (``ops/xfftn.py``) against the
  JAX package's, 5e-6 and 1e-12 (tests/test_torch_libfft.py's);
* ``PlanarPFFT.backward`` and ``PFFT.backward`` against the JAX package's
  on one device, r2c 'f' and 'd', padding 1 and 1.5, three axis orders:
  5e-5 and 2e-10;
* a spectral derivative (i K times the spectrum of white noise) at 32^3
  float64 against the JAX package and numpy: 2e-10;
* the CUDA source ``ops/csrc/rfft_axis.cu`` in the g++ thread emulation
  of tests/test_torch_kernel_emu.py, the tile and the line kernel of both
  builds through their C entries, against numpy.
"""
import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4py_fft_tpu as jpkg
from mpi4py_fft_tpu.ops import matfft as jmatfft
from mpi4py_fft_tpu.ops import xfftn as jxfftn
from mpi4py_fft_tpu.parallel import DeviceComm
from mpi4py_fft_tpu.parallel.planar import PlanarPFFT as JPlanarPFFT

from mpi4py_fft_torch import PFFT, PlanarPFFT
from mpi4py_fft_torch.ops import butterfly as tb
from mpi4py_fft_torch.ops import matfft as tmatfft
from mpi4py_fft_torch.ops import xfftn as txfftn
from test_torch_kernel_emu import CSRC, EMU, _emu_source

KERNEL_NS = [2, 4, 6, 8, 12, 16, 64, 96, 768, 1024]
ENGINE_NS = [10, 30, 100]
TOL = {np.float32: 5e-6, np.float64: 2e-13}
PLANNER_TOL = {'F': 5e-6, 'D': 1e-12}
PLAN_TOL = {'f': 5e-5, 'd': 2e-10}


def _rel(got, ref):
    got = np.asarray(got)
    ref = np.asarray(ref)
    wide = np.complex128 if np.iscomplexobj(got) or np.iscomplexobj(ref) \
        else np.float64
    got, ref = got.astype(wide), ref.astype(wide)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _hins(n, short=True):
    """Spectrum rows to hold at length n: short of n//2+1 by an even and
    by an odd count (where there is room), exact, long."""
    nh = n // 2 + 1
    rows = [nh, nh + 3]
    if short:
        rows += [h for h in (nh - 1, nh - 2) if h >= 1]
    return rows


def _rows(a, axis, sl):
    idx = [slice(None)] * a.ndim
    idx[axis] = sl
    return tuple(idx)


def _herm_pad(c, axis, nh):
    """The complex half spectrum c cut or zero-padded to nh rows along
    ``axis``, with the Hermitian rule of a short spectrum: an even count
    of rows has its last row's real part halved and its imaginary part
    zeroed."""
    hin = c.shape[axis]
    if hin >= nh:
        return c[_rows(c, axis, slice(0, nh))]
    sh = list(c.shape)
    sh[axis] = nh
    out = np.zeros(sh, dtype=c.dtype)
    out[_rows(out, axis, slice(0, hin))] = c
    if hin % 2 == 0:
        last = _rows(out, axis, hin - 1)
        out[last] = 0.5 * out[last].real
    return out


def _numpy_ref(h, axis, n):
    """numpy.fft.irfft(...) * n of the planar spectrum h (2, ...) along
    complex axis ``axis``, after the Hermitian pad of a short spectrum."""
    c = h[0].astype(np.float64) + 1j * h[1].astype(np.float64)
    return np.fft.irfft(_herm_pad(c, axis, n // 2 + 1), n, axis=axis) * n


def _jax_ref(h, axis, n):
    """JAX ``matfft.irfftn_p`` on the CPU (its Hermitian extension) of
    the planar spectrum h, Hermitian-padded first where it is short."""
    nh = n // 2 + 1
    if h.shape[1 + axis] < nh:
        c = _herm_pad(h[0] + 1j * h[1], axis, nh)
        h = np.stack([c.real, c.imag]).astype(h.dtype)
    return np.asarray(jmatfft.irfftn_p(jnp.asarray(h), (axis,), n))


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('where', ['last', 'inner'])
@pytest.mark.parametrize('n', KERNEL_NS + ENGINE_NS)
def test_entry_points_vs_numpy_and_jax(n, where, dtype):
    """``butterfly.irfft_axis_p`` (at kernel lengths) and
    ``matfft.irfftn_p`` on random half spectra: numpy's and the JAX CPU
    path's answer, whatever the imaginary DC and Nyquist parts."""
    kernel = n in KERNEL_NS
    rng = np.random.default_rng(100 + n)
    tol = TOL[dtype]
    axis = 1
    for hin in _hins(n, short=kernel):
        shape = (3, hin) if where == 'last' else (3, hin, 5)
        h = rng.standard_normal((2,) + shape).astype(dtype)
        ref = _numpy_ref(h, axis, n)
        jref = _jax_ref(h, axis, n)
        assert _rel(jref, ref) <= tol, ('jax', hin)
        got = tmatfft.irfftn_p(torch.from_numpy(h), (axis,), n)
        assert got.dtype == torch.from_numpy(h).dtype
        assert tuple(got.shape) == ref.shape
        assert _rel(got, ref) <= tol, ('matfft', hin)
        assert _rel(got, jref) <= tol, ('matfft vs jax', hin)
        assert tb.supported_c2r(shape, axis, n) == kernel
        if kernel:
            got = tb.irfft_axis_p(torch.from_numpy(h), axis, n, scale=0.5)
            assert _rel(got, 0.5 * ref) <= tol, ('butterfly', hin)
            assert _rel(got, 0.5 * jref) <= tol, ('butterfly vs jax', hin)


@pytest.mark.parametrize('dtype', ['F', 'D'])
@pytest.mark.parametrize('name', ['irfftn', 'hfftn'])
@pytest.mark.parametrize('n', [8, 12, 16, 64, 10, 30])
def test_planners_on_random_spectra_vs_jax(n, name, dtype):
    """The planners on a random complex (4, 6, n//2+1) input over axes
    (0, 2), both normalizations; irfftn also against numpy."""
    rng = np.random.default_rng(200 + n)
    sh = (4, 6, n // 2 + 1)
    u = (rng.standard_normal(sh) + 1j * rng.standard_normal(sh)) \
        .astype(dtype)
    axes = (0, 2)
    jplan = getattr(jxfftn, name)(u.copy(), axes=axes)
    tplan = getattr(txfftn, name)(u.copy(), axes=axes, device='cpu')
    assert tplan.output_array.shape == jplan.output_array.shape == (4, 6, n)
    tol = PLANNER_TOL[dtype]
    for norm in (False, True):
        ref = np.array(jplan(u, normalize=norm))
        got = tplan(u, normalize=norm)
        assert _rel(got, ref) <= tol, norm
    if name == 'irfftn':
        ref = np.fft.irfftn(u.astype(np.complex128), axes=axes)
        assert _rel(tplan(u, normalize=True), ref) <= tol


def _jax_one():
    return DeviceComm(jax.devices()[:1])


PLAN_SHAPE = (16, 12, 8)


@pytest.mark.parametrize('axes', [(0, 1, 2), (1, 0, 2), (2, 1, 0)])
@pytest.mark.parametrize('padding', [False, 1.5])
@pytest.mark.parametrize('dtype', ['f', 'd'])
@pytest.mark.parametrize('api', ['planar', 'pfft'])
def test_plan_backward_on_random_spectra_vs_jax(api, dtype, padding, axes):
    """``PlanarPFFT.backward`` and ``PFFT.backward`` on a random spectrum
    of the plan's output shape: every c2r axis here has an even kernel
    length (8, 16 and, padded, 12, 24)."""
    rng = np.random.default_rng(300)
    if api == 'planar':
        jp = JPlanarPFFT(_jax_one(), PLAN_SHAPE, axes=axes, dtype=dtype,
                         padding=padding)
        tp = PlanarPFFT(None, PLAN_SHAPE, axes=axes, dtype=dtype,
                        padding=padding, device='cpu')
        sh = tp.global_shape(True)
        assert sh == jp.global_shape(True)
        h = rng.standard_normal(sh).astype(dtype)
        ref = np.asarray(jp.backward(jnp.asarray(h)))
        got = tp.backward(torch.from_numpy(h))
    else:
        pad = [padding] * 3 if padding else False
        jf = jpkg.PFFT(_jax_one(), PLAN_SHAPE, axes=axes, dtype=dtype,
                       padding=pad)
        tf = PFFT(None, PLAN_SHAPE, axes=axes, dtype=dtype, padding=pad,
                  device='cpu')
        sh = tf.global_shape(True)
        assert sh == tuple(jf.global_shape(True))
        ct = tf.dtype(True)
        u = (rng.standard_normal(sh) + 1j * rng.standard_normal(sh)) \
            .astype(ct)
        ref = np.array(jf.backward(u))
        got = tf.backward.fn(torch.from_numpy(u))
    assert tuple(got.shape) == ref.shape
    assert got.dtype == (torch.float32 if dtype == 'f' else torch.float64)
    assert _rel(got, ref) <= PLAN_TOL[dtype]


@pytest.mark.parametrize('axis', [0, 1, 2])
def test_derivative_vs_jax_and_numpy(axis):
    """d/dx_axis of seeded white noise at 32^3 float64: the forward
    spectrum times i K, then the backward, on both packages'
    ``PlanarPFFT`` and by numpy (i K at the Nyquist wavenumber leaves
    the c2r imaginary DC and Nyquist rows)."""
    N = (32, 32, 32)
    u = np.random.default_rng(400).standard_normal(N)
    jp = JPlanarPFFT(_jax_one(), N, dtype='d')
    tp = PlanarPFFT(None, N, dtype='d', device='cpu')
    U = tp.forward(torch.from_numpy(u)).numpy()
    assert _rel(U, np.asarray(jp.forward(jnp.asarray(u)))) <= PLAN_TOL['d']
    k = np.fft.rfftfreq(32, 1. / 32) if axis == 2 \
        else np.fft.fftfreq(32, 1. / 32)
    sh = [1, 1, 1]
    sh[axis] = k.size
    K = k.reshape(sh)
    dU = np.stack([-K * U[1], K * U[0]])
    got = tp.backward(torch.from_numpy(dU)).numpy()
    ref = np.asarray(jp.backward(jnp.asarray(dU)))
    num = np.fft.irfftn(1j * K * np.fft.rfftn(u), s=N, axes=(0, 1, 2))
    assert _rel(ref, num) <= PLAN_TOL['d']
    assert _rel(got, ref) <= PLAN_TOL['d']
    assert _rel(got, num) <= PLAN_TOL['d']


# ---------------------------------------------------------------------------
# rfft_axis.cu in the thread emulation
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def c2r_lib(tmp_path_factory):
    """rfft_axis.cu compiled by g++ against the CUDA emulation."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ to compile the kernel emulation')
    d = tmp_path_factory.mktemp('c2r_emu')
    src = d / 'rfft_axis.cpp'
    src.write_text(_emu_source(CSRC / 'rfft_axis.cu'))
    so = d / 'rfft_axis.so'
    out = subprocess.run(
        [gxx, '-std=c++20', '-O1', '-ffp-contract=off', '-shared', '-fPIC',
         '-pthread', '-I', str(EMU), '-I', str(CSRC), '-o', str(so),
         str(src)], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    lib = ctypes.CDLL(str(so))
    lib.emu_syncwarps.restype = ctypes.c_longlong
    return lib


def _c2r_entry(lib, h, n, post, y):
    """The C entry of irfft_axis_p's build for h's dtype on the planar
    spectrum h (2, pre, hin, post) into y (pre, n, post), unscaled."""
    f64 = h.dtype == torch.float64
    packed = n // 2 >= 2
    tw = tb._tw_tensor(n, +1, packed, h.dtype, h.device)
    plan, nst = tb._plan_args(n // 2 if packed else n)
    fn = lib.mff_irfft_axis_f64 if f64 else lib.mff_irfft_axis_f32
    real = ctypes.c_double if f64 else ctypes.c_float
    ptr = ctypes.c_void_p
    rc = fn(ptr(h.data_ptr()), ptr(y.data_ptr()), ptr(tw.data_ptr()),
            ctypes.c_longlong(tw.shape[1]), ctypes.c_longlong(h.shape[1]),
            ctypes.c_int(h.shape[2]), ctypes.c_int(n),
            ctypes.c_longlong(post), ctypes.c_int(int(packed)), plan,
            ctypes.c_int(nst), real(2.0 if packed else 1.0), ptr(0))
    assert rc == 0
    return y


@pytest.mark.parametrize('route', ['lines', 'tile', 'tile_misaligned'])
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('n', [2, 4, 12, 16, 96, 768, 1024])
def test_emulated_c2r_vs_numpy(c2r_lib, n, dtype, route):
    """The c2r kernels of rfft_axis.cu on random spectra: the line kernel
    (whole lines, the output aligned to a packed point; n = 2 takes the
    tile), the tile on an inner axis (post 3) and on whole lines into an
    output one element off a packed point; every hin of ``_hins``."""
    rng = np.random.default_rng(500 + n)
    post = 3 if route == 'tile' else 1
    for hin in _hins(n):
        h = rng.standard_normal((2, 2, hin, post)).astype(dtype)
        ref = _numpy_ref(h, 1, n)
        ht = torch.from_numpy(h)
        flat = torch.full((1 + 2 * n * post,), float('nan'),
                          dtype=ht.dtype)
        y = flat[1:] if route == 'tile_misaligned' else flat[:-1]
        y = y.view(2, n, post)
        w0 = c2r_lib.emu_syncwarps()
        _c2r_entry(c2r_lib, ht, n, post, y)
        lines = c2r_lib.emu_syncwarps() > w0
        assert lines == (route == 'lines' and n >= 4), hin
        assert _rel(y.numpy(), ref) <= TOL[dtype], hin
