"""The port's single-device PlanarPFFT (mpi4py_fft_torch) against the JAX
package's PlanarPFFT on the CPU.

The JAX reference is pinned to one device (tests/conftest.py gives JAX an
8-device CPU mesh) and runs its Pallas kernels in interpret mode wherever
its gates allow (``set_butterfly_mode('on')``).  The port runs with
``device='cpu'``, so every kernel wrapper uses its plain version.  Both get
the same numpy inputs, made from a seed.  Tolerances: f32 relative L2
5e-5 (the 3-axis composition tolerance of tests/test_butterfly.py:131),
f64 1e-12 against JAX's x64 einsum engine.
"""
import numpy as np
import pytest

import jax
import torch

from mpi4py_fft_tpu.ops import matfft as jmatfft
from mpi4py_fft_tpu.parallel import DeviceComm
from mpi4py_fft_tpu.parallel.planar import PlanarPFFT as JPlanarPFFT

from mpi4py_fft_torch import PlanarPFFT, entry
from mpi4py_fft_torch.ops import butterfly as tb
from mpi4py_fft_torch.ops import matfft as tmatfft


def _rel(got, ref):
    got = np.asarray(got)
    ref = np.asarray(ref)
    wide = np.complex128 if np.iscomplexobj(got) or np.iscomplexobj(ref) \
        else np.float64
    got, ref = got.astype(wide), ref.astype(wide)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _plans(shape, dtype, padding=False):
    jp = JPlanarPFFT(DeviceComm(jax.devices()[:1]), shape, dtype=dtype,
                     padding=padding)
    tp = PlanarPFFT(None, shape, dtype=dtype, padding=padding,
                    device='cpu')
    return jp, tp


@pytest.fixture
def kernels_on():
    """The JAX reference on its interpret-mode kernels where gates allow."""
    jmatfft.set_butterfly_mode('on')
    try:
        yield
    finally:
        jmatfft.set_butterfly_mode('auto')


F32_CASES = [('F', (32, 64, 128), False), ('f', (64, 64, 64), False),
             ('F', (32, 32, 32), 1.5), ('f', (32, 32, 32), 1.5)]


@pytest.mark.parametrize('dtype,shape,padding', F32_CASES)
@pytest.mark.parametrize('op', ['forward', 'forward_raw', 'backward'])
def test_planar_f32_vs_jax(kernels_on, dtype, shape, padding, op):
    jp, tp = _plans(shape, dtype, padding)
    assert tp.global_shape(False) == jp.global_shape(False)
    assert tp.global_shape(True) == jp.global_shape(True)
    rng = np.random.default_rng(6)
    x = rng.standard_normal(jp.global_shape(False)).astype(np.float32)
    if op == 'backward':
        # the spectrum of a field: Hermitian-consistent for r2c, where
        # the packed c2r and the einsum c2r may treat the imaginary DC
        # and Nyquist parts of an arbitrary input differently
        x = np.array(jp.forward(jax.numpy.asarray(x)))
        ref = jp.backward(jax.numpy.asarray(x))
        got = tp.backward(torch.from_numpy(x))
    else:
        norm = op == 'forward'
        ref = jp.forward(jax.numpy.asarray(x), normalize=norm)
        got = tp.forward(torch.from_numpy(x), normalize=norm)
    assert tuple(got.shape) == tuple(ref.shape)
    assert got.dtype == torch.float32
    assert _rel(got, ref) < 5e-5


@pytest.mark.parametrize('dtype', ['D', 'd'])
def test_planar_f64_vs_jax(dtype):
    """The port's plain float64 path against JAX's x64 einsum engine."""
    jp, tp = _plans((16, 32, 32), dtype)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(jp.global_shape(False))
    ref = np.array(jp.forward(jax.numpy.asarray(x)))
    got = tp.forward(torch.from_numpy(x))
    assert got.dtype == torch.float64
    assert _rel(got, ref) < 1e-12
    back = tp.backward(torch.from_numpy(ref))
    assert _rel(back, jp.backward(jax.numpy.asarray(ref))) < 1e-12
    assert _rel(back, x) < 1e-12


@pytest.fixture(scope='module')
def jax_entry_result():
    """__graft_entry__.entry()'s forward on a seeded input, run once (it
    compiles for the 8-device mesh)."""
    import __graft_entry__
    fn, (x0,) = __graft_entry__.entry()
    x = np.random.default_rng(8).standard_normal(x0.shape) \
        .astype(np.float32)
    return x, np.asarray(fn(jax.numpy.asarray(x)))


def test_entry_vs_jax(jax_entry_result):
    x, ref = jax_entry_result
    fn, (x0,) = entry(device='cpu')
    assert tuple(x0.shape) == x.shape and x0.dtype == torch.float32
    got = fn(torch.from_numpy(x))
    assert tuple(got.shape) == ref.shape == (2, 64, 64, 33)
    assert _rel(got, ref) < 5e-5


def test_wrong_shape_and_device_raise():
    tp = PlanarPFFT(None, (8, 16, 32), dtype='F', device='cpu')
    with pytest.raises(ValueError, match='planned shape'):
        tp.forward(torch.zeros((2, 8, 16, 16)))
    with pytest.raises(ValueError, match='planned shape'):
        tp.backward(torch.zeros((2, 8, 16, 17)))
    with pytest.raises(TypeError):
        tp.forward(torch.zeros((2, 8, 16, 32), dtype=torch.float64))
    with pytest.raises(ValueError, match='meta'):
        tp.forward(torch.zeros((2, 8, 16, 32), device='meta'))


def test_unsupported_length_raises():
    """Lengths no kernel takes (10; 8192 on a c2c axis; 2048 on a real
    axis) raise nothing: the engine takes them."""
    rng = np.random.default_rng(8)
    for shape, dt in (((8, 10, 16), 'F'), ((8192, 2, 2), 'F'),
                      ((2, 2, 2048), 'f')):
        tp = PlanarPFFT(None, shape, dtype=dt, device='cpu')
        x = rng.standard_normal(tp.global_shape(False)).astype(np.float32)
        y = tp.forward(torch.from_numpy(x))
        if dt == 'F':
            ref = np.fft.fftn(x[0] + 1j * x[1]) / np.prod(shape)
        else:
            ref = np.fft.rfftn(x) / np.prod(shape)
        assert _rel(y[0].numpy() + 1j * y[1].numpy(), ref) < 5e-5


def test_several_devices_raise():
    comm = DeviceComm(jax.devices()[:2])
    with pytest.raises(NotImplementedError, match='Queue 1 item 4'):
        PlanarPFFT(comm, (8, 8, 8), device='cpu')
    with pytest.raises(NotImplementedError, match='Queue 1 item 4'):
        PlanarPFFT(None, (8, 8, 8), grid=(2, 1), device='cpu')
    with pytest.raises(NotImplementedError, match='Queue 1 item 4'):
        PlanarPFFT(None, (8, 8, 8), executor='shard_map', device='cpu')
    # one device is fine, whatever form it is given in
    PlanarPFFT(DeviceComm(jax.devices()[:1]), (8, 8, 8), grid=(1, 1),
               executor='gspmd', device='cpu')


def test_default_device_is_cuda():
    """No CUDA and no device='cpu': raise, never carry on on the CPU."""
    if torch.cuda.is_available():
        assert PlanarPFFT(None, (8, 8, 8)).device.type == 'cuda'
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PlanarPFFT(None, (8, 8, 8))
    with pytest.raises(RuntimeError):
        entry()


def test_f64_on_cuda_raises():
    """float64 plans run on CUDA like float32 ones, with and without
    padding: on a machine without CUDA a plan with no device raises
    RuntimeError (no silent CPU); with CUDA, 'd' and 'D' plans are on the
    card."""
    for dt in ('d', 'D'):
        for padding in (False, 1.5):
            if torch.cuda.is_available():
                tp = PlanarPFFT(None, (8, 8, 8), dtype=dt, padding=padding)
                assert tp.device.type == 'cuda'
                continue
            with pytest.raises(RuntimeError, match="device='cpu'"):
                PlanarPFFT(None, (8, 8, 8), dtype=dt, padding=padding)


def test_quartered_and_launches():
    shape = (16, 128, 256)
    assert PlanarPFFT(None, shape, dtype='F', device='cpu').quartered
    assert not PlanarPFFT(None, shape, dtype='f', device='cpu').quartered
    assert not PlanarPFFT(None, shape, dtype='F', padding=1.5,
                          device='cpu').quartered
    assert not PlanarPFFT(None, shape, dtype='D', device='cpu').quartered
    assert not PlanarPFFT(None, shape, axes=(1, 0, 2), dtype='F',
                          device='cpu').quartered
    tp = PlanarPFFT(None, (16, 16, 16), dtype='F', device='cpu')
    tb.reset_launches()
    x = torch.zeros(tp.global_shape(False))
    assert torch.equal(tp.backward(tp.forward(x)), x)
    assert sum(tb.LAUNCHES.values()) == 0      # CPU: plain versions only


def test_planar_helpers_vs_jax():
    rng = np.random.default_rng(9)
    z = rng.standard_normal((4, 6)) + 1j * rng.standard_normal((4, 6))
    p = tmatfft.planar(z)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jmatfft.planar(z)))
    np.testing.assert_array_equal(tmatfft.unplanar(p).numpy(), z)
    y = tmatfft.fftn_p(p, (1, 0), forward=True).numpy()
    np.testing.assert_allclose(y[0] + 1j * y[1], np.fft.fftn(z),
                               rtol=1e-12, atol=1e-12)
    q = tmatfft.planar(z[::-1].copy())
    np.testing.assert_allclose(tmatfft._pmul(p, q).numpy(),
                               np.asarray(jmatfft._pmul(jax.numpy.asarray(
                                   p.numpy()), jax.numpy.asarray(q.numpy()))),
                               rtol=1e-15, atol=1e-15)


def test_empty_axis_extent():
    """A zero extent off the transform axis gives an empty result."""
    p = torch.zeros((2, 0, 8, 3))
    assert tb.fft_axis_p(p, 1).shape == p.shape
    assert tb.rfft_axis_p(torch.zeros((0, 8)), 1).shape == (2, 0, 5)
