"""The port's long-axis routes (mpi4py_fft_torch/ops/matfft.py) against the
JAX package on the CPU: 1536 and 2048 through the pair kernel, 4096
through the four-step around the 1024-point kernel.

The JAX side runs ``matfft.fft1d_p`` with its kernels forced on
(``set_butterfly_mode('on')``, as tests/test_butterfly.py:179-200 does), so
it takes its pair kernel (N = 2048) or its four-step around kernel A
(N = 4096), both in interpret mode; the port runs its plain versions on
CPU tensors.  Both get the same numpy inputs, made from a seed.
Tolerances: relative L2 5e-6 for one axis (tests/test_butterfly.py:44),
5e-5 for a plan (tests/test_butterfly.py:131).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mpi4py_fft_tpu.ops import matfft as jmatfft
from mpi4py_fft_tpu.parallel import DeviceComm
from mpi4py_fft_tpu.parallel.planar import PlanarPFFT as JPlanarPFFT

from mpi4py_fft_torch import PlanarPFFT
from mpi4py_fft_torch.ops import butterfly as tb
from mpi4py_fft_torch.ops import matfft as tmatfft


def _rel(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


@pytest.fixture
def kernels_on():
    jmatfft.set_butterfly_mode('on')
    try:
        yield
    finally:
        jmatfft.set_butterfly_mode('auto')


# tests/test_butterfly.py:test_four_step_beyond_fused_cap's shapes
LONG_CASES = [((2048, 8, 128), 0), ((8, 2048, 128), 1),
              ((4096, 8, 128), 0), ((8, 4096, 128), 1)]


@pytest.mark.parametrize('shape,axis', LONG_CASES)
@pytest.mark.parametrize('forward', [True, False])
def test_long_axis_vs_jax(kernels_on, shape, axis, forward):
    N = shape[axis]
    x = np.random.default_rng(23).standard_normal((2,) + shape) \
        .astype(np.float32)
    split = tmatfft._four_step_split(shape, axis)
    if N == 2048:
        assert split is None
        assert tb.supported_axis_split(
            shape[:axis] + (N // 2,) + shape[axis + 1:], axis)
    else:
        # DIT with nothing before the axis, DIF otherwise, as JAX picks
        assert split == jmatfft._butterfly_large_split(shape, axis,
                                                       np.float32)
        assert split == (4, 1024, axis == 0)
    ref = jmatfft.fft1d_p(jnp.asarray(x), axis, forward)
    tb.reset_launches()
    got = tmatfft.fft1d_p(torch.from_numpy(x), axis, forward)
    assert sum(tb.LAUNCHES.values()) == 0          # CPU: plain versions
    assert got.shape == x.shape and got.dtype == torch.float32
    assert _rel(got, ref) < 5e-6


def test_long_scale_folded():
    """A scale on the four-step and the pair route equals a scale after."""
    rng = np.random.default_rng(24)
    for shape, axis in (((4, 4096, 3), 1), ((3, 2, 1536), 2)):
        p = torch.from_numpy(rng.standard_normal((2,) + shape)
                             .astype(np.float32))
        y = tmatfft.fft1d_p(p, axis, True)
        ys = tmatfft.fft1d_p(p, axis, True, scale=0.125)
        assert _rel(ys, y * 0.125) < 1e-7


def test_plan_1536_vs_jax(kernels_on):
    """A c2c plan with a 1536-long axis against the JAX plan, which takes
    its pair kernel there."""
    shape = (1536, 8, 128)
    jp = JPlanarPFFT(DeviceComm(jax.devices()[:1]), shape, dtype='F')
    tp = PlanarPFFT(None, shape, dtype='F', device='cpu')
    x = np.random.default_rng(25).standard_normal((2,) + shape) \
        .astype(np.float32)
    ref = np.asarray(jp.forward(jnp.asarray(x)))
    got = tp.forward(torch.from_numpy(x))
    assert _rel(got, ref) < 5e-5
    back = tp.backward(got)
    assert _rel(back, jp.backward(jnp.asarray(ref))) < 5e-5
    assert _rel(back, x) < 5e-5


def test_long_lengths_still_raise():
    """Lengths past the pair kernel and the four-step: the kernels still
    refuse them, and the engine (matfft) takes them."""
    rng = np.random.default_rng(31)
    for shape, axis in (((8192, 2), 0), ((3072, 2), 0), ((2, 2050), 1)):
        z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        p = tmatfft.planar(torch.from_numpy(z)).float()
        got = tmatfft.fft1d_p(p, axis)
        ref = np.fft.fft(z, axis=axis)
        assert _rel(got, np.stack([ref.real, ref.imag])) < 5e-6
    with pytest.raises(ValueError, match='engine'):
        tb.fft_axis_pair_p(torch.zeros((2, 4096, 2)), 0)
    with pytest.raises(ValueError, match='engine'):
        tb.fft_axis2_p(torch.zeros((2, 2048, 2)), torch.zeros((2, 2048, 2)),
                       0)
