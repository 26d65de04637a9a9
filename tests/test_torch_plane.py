"""H and I, the two-axis plane kernels (``fft_plane_p``/
``fft_plane_large_p`` in mpi4py_fft_torch/ops/butterfly.py), against the
JAX package's Pallas kernels in interpret mode on the CPU, and the port's
gates.

The wrappers run their plain versions on CPU tensors (the plain A on the
last axis, then on the second-to-last with the scale), whose arithmetic
the CUDA kernel repeats (tests/test_torch_kernel_emu.py).  Tolerance:
relative L2 5e-6, the JAX kernel tolerance (tests/test_butterfly.py:44).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from mpi4py_fft_tpu.ops import pallas_butterfly as pb

from mpi4py_fft_torch.ops import butterfly as tb

TOL = 5e-6
# tests/test_butterfly.py:266, H's cases in the JAX suite; then a batch
# of planes that the port's plane-holding kernel holds two to a CTA (the
# others take clusters of 8, 2 and 2 CTAs a plane)
PLANE_CASES = [(4, 256, 256), (16, 128, 128), (8, 2, 64, 256),
               (32, 32, 128)]


def _rel(got, ref):
    got = np.asarray(got).astype(np.float64)
    ref = np.asarray(ref).astype(np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _cases(shape, seed):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((2,) + shape).astype(np.float32)
    n12 = shape[-1] * shape[-2]
    return p, ((True, None), (False, None), (False, 1.0 / n12))


@pytest.mark.parametrize('shape', PLANE_CASES)
def test_plane_vs_pallas(shape):
    assert pb.supported_plane(shape, np.float32)
    assert tb.supported_plane(shape, np.float32)
    p, runs = _cases(shape, 70)
    for fwd, sc in runs:
        ref = pb.fft_plane_p(jnp.asarray(p), fwd, interpret=True, scale=sc)
        got = tb.fft_plane_p(torch.from_numpy(p), fwd, scale=sc)
        assert got.shape == p.shape and got.dtype == torch.float32
        assert _rel(got, ref) <= TOL, (fwd, sc)
        assert torch.equal(got, tb.fft_plane_plain(torch.from_numpy(p), fwd,
                                                   sc))


@pytest.mark.parametrize('shape', [(2, 128, 256)])
def test_plane_large_vs_pallas(shape):
    assert pb.supported_plane_large(shape, np.float32)
    assert tb.supported_plane_large(shape, np.float32)
    p, runs = _cases(shape, 71)
    for fwd, sc in runs:
        ref = pb.fft_plane_large_p(jnp.asarray(p), fwd, interpret=True,
                                   scale=sc)
        got = tb.fft_plane_large_p(torch.from_numpy(p), fwd, scale=sc)
        assert got.shape == p.shape and got.dtype == torch.float32
        assert _rel(got, ref) <= TOL, (fwd, sc)


def test_plane_gates():
    """The shape contract, not the TPU gates: any leading extent and any
    power-of-two axes (H up to 256, I up to 1024); float32 only."""
    f32 = np.float32
    # refused by the JAX gates for TPU layout, taken here
    for shape in ((3, 256, 256), (4, 256, 32), (1, 64, 32), (8, 2)):
        assert not pb.supported_plane(shape, f32)
        assert tb.supported_plane(shape, f32), shape
    assert tb.supported_plane_large((3, 1024, 1024), torch.float32)
    assert tb.supported_plane_large((5, 2, 1024), f32)
    assert not pb.supported_plane_large((5, 2, 1024), f32)
    # refused by both
    for shape, dt in (((4, 256, 256), np.float64), ((4, 512, 256), f32),
                      ((4, 256, 96), f32), ((256,), f32)):
        assert not tb.supported_plane(shape, dt), (shape, dt)
    for shape, dt in (((2, 2048, 256), f32), ((2, 128, 96), f32),
                      ((2, 128, 128), torch.float64)):
        assert not tb.supported_plane_large(shape, dt), (shape, dt)
    with pytest.raises(ValueError, match='supported_plane'):
        tb.fft_plane_p(torch.zeros((2, 4, 512, 256)))
    with pytest.raises(ValueError, match='supported_plane_large'):
        tb.fft_plane_large_p(torch.zeros((2, 4, 96, 256)))
    # a plane only the port's gate takes, on the plain path
    rng = np.random.default_rng(72)
    z = rng.standard_normal((3, 32, 8)) + 1j * rng.standard_normal((3, 32, 8))
    p = torch.from_numpy(np.stack([z.real, z.imag]).astype(np.float32))
    ref = np.fft.fft2(z, axes=(-2, -1))
    for fn in (tb.fft_plane_p, tb.fft_plane_large_p):
        got = fn(p).numpy()
        assert _rel(got, np.stack([ref.real, ref.imag])) <= TOL
    assert tb.LAUNCHES['fft_plane_p'] == tb.LAUNCHES['fft_plane_large_p'] == 0
