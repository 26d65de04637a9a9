"""The port's transform engine (mpi4py_fft_torch/ops/matfft.py: the
mixed-radix matrix stages, Bluestein and the dispatch of every extent)
against the JAX package's, on the CPU.

The JAX side runs its CPU path, the einsum engine (its kernels need a
TPU); the port runs its plain versions, J's (``fft2stage_plain``) on the
f32 last axes that the JAX package gives J on a TPU.  Both get the same
numpy inputs, made from a seed.  Tolerances, relative L2: 5e-6 for one
f32 axis (the JAX kernel tolerance, tests/test_butterfly.py:44), 2e-10
for f64 (the reference's parallel d tolerance), 5e-5 for an f32 plan of
three axes (tests/test_butterfly.py:131).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import mpi4py_fft_tpu as jpkg
from mpi4py_fft_tpu import fftw as jfftw
from mpi4py_fft_tpu import libfft as jlibfft
from mpi4py_fft_tpu.ops import matfft as jmatfft
from mpi4py_fft_tpu.parallel import DeviceComm
from mpi4py_fft_tpu.parallel.planar import PlanarPFFT as JPlanarPFFT

from mpi4py_fft_torch import PFFT, PlanarPFFT
from mpi4py_fft_torch import fftw as tfftw
from mpi4py_fft_torch import libfft as tlibfft
from mpi4py_fft_torch.ops import fft2stage
from mpi4py_fft_torch.ops import matfft as tmatfft

TOL = {np.float32: 5e-6, np.float64: 2e-10}

# the JAX engine jitted: one compile a case instead of one per operation
_jfft1d = jax.jit(jmatfft.fft1d_p, static_argnums=(1, 2, 3))
_jrfftn = jax.jit(jmatfft.rfftn_p, static_argnums=(1, 2))
_jirfftn = jax.jit(jmatfft.irfftn_p, static_argnums=(1, 2, 3))
PLAN_TOL = {'f': 5e-5, 'd': 2e-10}


def _rel(got, ref):
    got = np.asarray(got).astype(np.float64)
    ref = np.asarray(ref).astype(np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def test_factorize_and_tables_equal_jax():
    for N in range(1, 4097):
        assert tmatfft._factorize(N) == jmatfft._factorize(N), N
    for dt in ('float32', 'float64'):
        for sign in (-1, 1):
            for N in (1, 2, 7, 20, 28, 32, 128):
                a, b = tmatfft._dft_matrix(N, sign, dt), \
                    jmatfft._dft_matrix(N, sign, dt)
                assert a.dtype == b.dtype and np.array_equal(a, b)
                assert np.array_equal(tmatfft._wblock(a),
                                      np.asarray(jmatfft._wblock(b)))
            for n1, n2 in ((32, 20), (5, 128), (4, 1024)):
                assert np.array_equal(tmatfft._twiddle(n1, n2, sign, dt),
                                      jmatfft._twiddle(n1, n2, sign, dt))
            for N in (37, 509, 1031):
                got = tmatfft._bluestein_consts(N, sign, dt)
                ref = jmatfft._bluestein_consts(N, sign, dt)
                assert got[2] == ref[2]
                assert np.array_equal(got[0], ref[0])
                assert np.array_equal(got[1], ref[1])
    # J's tables are the JAX kernel's, cast to float32
    for S in (1, 5, 8):
        w1, tw, _ = fft2stage._tables(S, -1)
        assert np.array_equal(w1, jmatfft._dft_matrix(S, -1, 'float32'))
        assert np.array_equal(tw, jmatfft._twiddle(S, 128, -1, 'float32'))


ENGINE_N = [5, 12, 37, 40, 100, 509, 640, 896, 1280]


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('N', ENGINE_N)
def test_fft1d_p_vs_jax(N, dtype):
    """Lead, mid and last positions, forward and backward with a scale."""
    rng = np.random.default_rng(N)
    for shape, axis in (((N, 3, 2), 0), ((2, N, 3), 1), ((3, 2, N), 2)):
        p = rng.standard_normal((2,) + shape).astype(dtype)
        for fwd, sc in ((True, None), (False, 1.0 / N)):
            ref = _jfft1d(jnp.asarray(p), axis, fwd, sc)
            got = tmatfft.fft1d_p(torch.from_numpy(p), axis, fwd, scale=sc)
            assert got.dtype == torch.from_numpy(p).dtype
            assert tuple(got.shape) == p.shape and got.is_contiguous()
            assert _rel(got, ref) <= TOL[dtype], (shape, axis, fwd)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('N,axis', [(7, 1), (100, 0), (896, 2), (2048, 2),
                                    (27, 2)])
def test_rfftn_irfftn_vs_jax(N, axis, dtype):
    """Real axes of odd, non-kernel and 2048 lengths: the stacked c2c
    route forward, the Hermitian extension backward (on the spectrum of
    a field), with ``hext`` and ``scale``."""
    rng = np.random.default_rng(3 + N)
    shape = [3, 2, 4]
    shape[axis] = N
    x = rng.standard_normal(shape).astype(dtype)
    axes = tuple(a for a in (0, 1, 2) if a != axis) + (axis,)
    ref = _jrfftn(jnp.asarray(x), axes)
    got = tmatfft.rfftn_p(torch.from_numpy(x), axes)
    assert tuple(got.shape) == tuple(ref.shape)
    assert _rel(got, ref) <= TOL[dtype]
    hext = N // 2 + 4
    got_h = tmatfft.rfftn_p(torch.from_numpy(x), axes, hext=hext)
    ref_h = _jrfftn(jnp.asarray(x), axes, hext)
    assert tuple(got_h.shape) == tuple(ref_h.shape)
    assert _rel(got_h, ref_h) <= TOL[dtype]
    spec = np.array(ref)
    back = tmatfft.irfftn_p(torch.from_numpy(spec), axes, N, scale=0.5)
    ref_b = _jirfftn(jnp.asarray(spec), axes, N, 0.5)
    assert tuple(back.shape) == x.shape and back.is_contiguous()
    assert _rel(back, ref_b) <= TOL[dtype]


@pytest.mark.parametrize('N', [7, 100, 640])
def test_c2r_fallback_on_any_input_vs_jax(N):
    """A half spectrum that is no field's (imaginary DC and Nyquist parts,
    rows past N//2+1): the port's fallback agrees with the JAX package's,
    which keeps the real part of the inverse (ROADMAP Queue 3)."""
    rng = np.random.default_rng(40 + N)
    h = rng.standard_normal((2, 3, 4, N // 2 + 3)).astype(np.float32)
    ref = _jirfftn(jnp.asarray(h), (2,), N, None)
    got = tmatfft.irfftn_p(torch.from_numpy(h), (2,), N)
    assert tuple(got.shape) == (3, 4, N)
    assert _rel(got, ref) <= TOL[np.float32]


def test_products_stay_out_of_tf32(monkeypatch):
    """With TF32 switched on for the process, every engine product runs
    with it off, and the process's setting is back afterwards."""
    seen = []
    einsum = torch.einsum

    def spy(*args):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return einsum(*args)

    monkeypatch.setattr(torch, 'einsum', spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', True)
    rng = np.random.default_rng(9)
    # 40 = 20*2 on a lead axis, 100 = 25*4 on a last one: two products
    # each (f32 Bluestein runs J, no product)
    for shape, axis in (((2, 40, 3, 2), 0), ((2, 3, 100), 1)):
        p = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        tmatfft.fft1d_p(p, axis)
    assert len(seen) == 4 and not any(seen)
    assert torch.backends.cuda.matmul.allow_tf32 is True


def _pplans(kind, shape, dtype, padding=False):
    comm = DeviceComm(jax.devices()[:1])
    if kind == 'planar':
        return (JPlanarPFFT(comm, shape, dtype=dtype, padding=padding),
                PlanarPFFT(None, shape, dtype=dtype, padding=padding,
                           device='cpu'))
    pad = [padding] * len(shape) if padding else False
    return (jpkg.PFFT(comm, shape, dtype=dtype, padding=pad),
            PFFT(None, shape, dtype=dtype, padding=pad, device='cpu'))


# (kind, shape, dtype, padding): c2c 640 (J on the last axis, the mixed
# radix 640 = 32*20 on the others), r2c 896 (the stacked real axis on J),
# a Bluestein lead axis, dealiased non-kernel extents
PLANS = [('planar', (6, 10, 640), 'F', False),
         ('planar', (6, 10, 640), 'D', False),
         ('pfft', (12, 10, 896), 'f', False),
         ('pfft', (12, 10, 896), 'd', False),
         ('planar', (37, 16, 16), 'F', False),
         ('planar', (37, 16, 16), 'D', False),
         ('planar', (10, 12, 20), 'F', 1.5),
         ('pfft', (16, 18, 16), 'D', 1.5),
         ('pfft', (10, 6, 14), 'f', 1.5)]


@pytest.mark.parametrize('kind,shape,dtype,padding', PLANS)
def test_any_extent_plans_vs_jax(kind, shape, dtype, padding):
    jp, tp = _pplans(kind, shape, dtype, padding)
    assert tuple(tp.global_shape(False)) == tuple(jp.global_shape(False))
    assert tuple(tp.global_shape(True)) == tuple(jp.global_shape(True))
    rng = np.random.default_rng(sum(shape))
    tol = PLAN_TOL[dtype.lower()]
    if kind == 'planar':
        x = rng.standard_normal(jp.global_shape(False)).astype(
            jp.rdtype if hasattr(jp, 'rdtype') else dtype.lower())
        ref = np.array(jp.forward(jnp.asarray(x)))
        got = tp.forward(torch.from_numpy(x))
        assert _rel(got, ref) <= tol
        back = tp.backward(torch.from_numpy(ref))
        assert _rel(back, jp.backward(jnp.asarray(ref))) <= tol
        if not padding:
            assert _rel(back, x) <= tol
        return
    u = rng.standard_normal(jp.global_shape(False))
    if dtype in 'FD':
        u = u + 1j * rng.standard_normal(u.shape)
    u = u.astype(np.dtype(dtype))
    ref = np.array(jp.forward(u))
    got = tp.forward.fn(torch.from_numpy(u))
    assert tuple(got.shape) == ref.shape
    assert _rel(torch.view_as_real(got), np.stack([ref.real, ref.imag], -1)) \
        <= tol
    back = tp.backward.fn(torch.from_numpy(ref))
    want = np.asarray(jp.backward(ref))
    if back.is_complex():
        back = torch.view_as_real(back)
        want = np.stack([want.real, want.imag], -1)
    assert _rel(back, want) <= tol


@pytest.mark.parametrize('N', [7, 100, 640])
def test_serial_fft_and_planners_any_length(N):
    """``libfft.FFT`` (c2c and r2c) and ``fftw.fftn``/``rfftn`` at
    non-kernel lengths, against the JAX package's."""
    rng = np.random.default_rng(50 + N)
    shape = (3, N)
    for dtype in ('D', 'F', 'd', 'f'):
        jf = jlibfft.FFT(shape, (1,), dtype)
        tf = tlibfft.FFT(shape, (1,), dtype, device='cpu')
        u = rng.standard_normal(shape)
        if dtype in 'FD':
            u = u + 1j * rng.standard_normal(shape)
        u = u.astype(np.dtype(dtype))
        tol = 5e-6 if dtype in 'fF' else 1e-12
        ref = np.asarray(jf.forward(u.copy()))
        got = np.asarray(tf.forward(u.copy())).copy()
        assert _rel(np.stack([got.real, got.imag]),
                    np.stack([ref.real, ref.imag])) <= tol
        back = np.asarray(tf.backward(ref.copy())).copy()
        want = np.asarray(jf.backward(ref.copy()))
        assert _rel(np.stack([back.real, back.imag]),
                    np.stack([want.real, want.imag])) <= tol
    z = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    tplan = tfftw.fftn(z.copy(), axes=(1,), device='cpu')
    jplan = jfftw.fftn(z.copy(), axes=(1,))
    got, ref = tplan(z), np.asarray(jplan(z))
    assert _rel(np.stack([got.real, got.imag]),
                np.stack([ref.real, ref.imag])) <= 1e-12
    r = rng.standard_normal(shape)
    tplan = tfftw.rfftn(r.copy(), axes=(1,), device='cpu')
    jplan = jfftw.rfftn(r.copy(), axes=(1,))
    got, ref = tplan(r), np.asarray(jplan(r))
    assert got.shape == ref.shape == (3, N // 2 + 1)
    assert _rel(np.stack([got.real, got.imag]),
                np.stack([ref.real, ref.imag])) <= 1e-12
