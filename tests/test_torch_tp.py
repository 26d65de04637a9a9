"""The port's fused dealiasing kernel E (``fft_axis_tp``,
mpi4py_fft_torch/ops/butterfly.py) against the JAX package on the CPU.

On CPU tensors the wrapper runs its plain version; the JAX side runs its
Pallas kernel in interpret mode (``fft_axis_tp(..., interpret=True)``), at
shapes that pass its gate.  Both get the same numpy inputs, made from a
seed.  The float64 build and the last axis, which the JAX kernel does not
take, are held against numpy's complex128 FFT with the JAX package's
``truncate_planar``/``pad_planar`` applied.  Tolerances: relative L2 5e-6
(the JAX kernel tolerance, tests/test_butterfly.py:44) for float32, 2e-13
(tests/test_ds.py:58) for float64.  The CUDA kernel is held against the
plain version by tests/test_torch_kernel_emu.py (its source in a g++
emulation) and on the card by chip_smoke.py.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from mpi4py_fft_tpu import libfft as jlibfft
from mpi4py_fft_tpu.ops import pallas_butterfly as pb
from mpi4py_fft_torch.ops import butterfly as tb

TOL = 5e-6
TOL64 = 2e-13


def _rel(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _inputs(shape, axis, nt, mode, dtype, seed=4):
    """The planar input of a trunc pass (N rows) or a pad pass (nt rows)
    along ``axis`` of the complex ``shape`` (N rows there)."""
    sh = list(shape)
    if mode == 'pad':
        sh[axis] = nt
    rng = np.random.default_rng(seed)
    return rng.standard_normal([2] + sh).astype(dtype)


def _kw(shape, axis, nt, mode):
    return dict(trunc=nt) if mode == 'trunc' else dict(pad=shape[axis])


# (complex shape, axis, Nt, mode, scale): inside the JAX gate; lead and
# mid positions, even Nt (fold and split) and odd Nt (neither), a ragged
# post, with and without a scale
JAX_CASES = [
    ((8, 48, 128), 1, 32, 'trunc', None),
    ((8, 48, 128), 1, 32, 'trunc', 1.0 / 48),
    ((8, 48, 128), 1, 32, 'pad', None),
    ((8, 48, 128), 1, 32, 'pad', 0.37),
    ((8, 48, 128), 1, 31, 'trunc', None),
    ((8, 48, 128), 1, 31, 'pad', 0.5),
    ((48, 8, 128), 0, 31, 'trunc', 1.0 / 48),
    ((48, 8, 128), 0, 31, 'pad', None),
    ((48, 8, 128), 0, 32, 'trunc', None),
    ((48, 8, 128), 0, 32, 'pad', 0.37),
    ((24, 24, 13), 0, 16, 'trunc', 0.25),
    ((24, 24, 13), 0, 16, 'pad', None),
]


@pytest.mark.parametrize('shape,axis,nt,mode,scale', JAX_CASES)
def test_tp_plain_vs_jax_interpret(shape, axis, nt, mode, scale):
    fwd = mode == 'trunc'
    kw = _kw(shape, axis, nt, mode)
    x = _inputs(shape, axis, nt, mode, np.float32)
    assert pb.supported_axis_tp(x.shape[1:], axis, np.float32, **kw)
    assert tb.supported_axis_tp(x.shape[1:], axis, torch.float32, **kw)
    ref = pb.fft_axis_tp(jnp.asarray(x), axis, fwd, interpret=True,
                         scale=scale, **kw)
    got = tb.fft_axis_tp(torch.from_numpy(x), axis, fwd, scale=scale, **kw)
    assert tuple(got.shape) == tuple(ref.shape)
    assert got.dtype == torch.float32
    assert _rel(got, ref) <= TOL


def _oracle(x, axis, N, nt, mode, scale, forward):
    """The N-point numpy complex128 FFT, then the JAX package's
    truncate_planar to nt rows; or its pad_planar to N rows, then the FFT;
    scaled."""
    if mode == 'pad':
        x = np.asarray(jlibfft.pad_planar(jnp.asarray(x, jnp.float64),
                                          1 + axis, N, hermitian=False))
    z = x[0].astype(np.float64) + 1j * x[1].astype(np.float64)
    z = np.fft.fft(z, axis=axis) if forward \
        else np.fft.ifft(z, axis=axis) * N
    if scale is not None:
        z = z * scale
    p = np.stack([z.real, z.imag])
    if mode == 'trunc':
        p = np.asarray(jlibfft.truncate_planar(jnp.asarray(p), 1 + axis, nt,
                                               hermitian=False))
    return p


# (complex shape, axis, Nt): the last axis (outside the JAX gate), lead
# and mid positions, radix 3, the 1024 tile, Nt = 1 and N - 1
F64_CASES = [((6, 5, 24), 2, 16), ((6, 5, 24), 2, 15), ((48, 8, 3), 0, 32),
             ((3, 96, 5), 1, 63), ((2, 1024), 1, 683), ((16, 4), 0, 1),
             ((4, 16, 2), 1, 15)]


@pytest.mark.parametrize('shape,axis,nt', F64_CASES)
@pytest.mark.parametrize('mode', ['trunc', 'pad'])
def test_tp_plain_f64_vs_numpy(shape, axis, nt, mode):
    kw = _kw(shape, axis, nt, mode)
    x = _inputs(shape, axis, nt, mode, np.float64, seed=5)
    fwd = mode == 'trunc'
    for scale in (None, 1.0 / shape[axis]):
        got = tb.fft_axis_tp(torch.from_numpy(x), axis, fwd, scale=scale,
                             **kw)
        assert got.dtype == torch.float64
        ref = _oracle(x, axis, shape[axis], nt, mode, scale, fwd)
        assert tuple(got.shape) == ref.shape
        assert _rel(got, ref) <= TOL64


@pytest.mark.parametrize('mode', ['trunc', 'pad'])
def test_tp_last_axis_f32(mode):
    """The last axis, which the JAX gate refuses, at float32."""
    shape, axis, nt = (8, 6, 48), 2, 32
    kw = _kw(shape, axis, nt, mode)
    x = _inputs(shape, axis, nt, mode, np.float32, seed=6)
    assert not pb.supported_axis_tp(x.shape[1:], axis, np.float32, **kw)
    assert tb.supported_axis_tp(x.shape[1:], axis, torch.float32, **kw)
    fwd = mode == 'trunc'
    got = tb.fft_axis_tp(torch.from_numpy(x), axis, fwd, scale=0.5, **kw)
    assert got.dtype == torch.float32
    ref = _oracle(x, axis, shape[axis], nt, mode, 0.5, fwd)
    assert _rel(got, ref) <= TOL


def test_supported_axis_tp():
    g = tb.supported_axis_tp
    assert g((8, 48, 128), 1, torch.float32, trunc=32)
    assert g((8, 32, 128), 1, np.float64, pad=48)
    assert g((8, 6, 48), -1, 'float32', trunc=32)       # the last axis
    assert g((8, 6, 1024), 2, torch.float64, trunc=683)
    assert not g((8, 6, 48), 2, torch.float16, trunc=32)
    assert not g((8, 6, 48), 2, np.complex64, trunc=32)
    assert not g((8, 6, 2048), 2, torch.float32, trunc=1365)  # over 1024
    assert not g((8, 6, 36), 2, torch.float32, trunc=24)      # not 2^a 3^b
    assert not g((8, 6, 48), 2, torch.float32, trunc=48)      # Nt == N
    assert not g((8, 6, 48), 2, torch.float32, pad=32)        # Np < Nt
    assert not g((8, 6, 48), 2, torch.float32, trunc=0)
    with pytest.raises(ValueError, match='exactly one'):
        g((8, 6, 48), 2, torch.float32)
    with pytest.raises(ValueError, match='exactly one'):
        g((8, 6, 48), 2, torch.float32, trunc=32, pad=64)


def test_tp_wrapper_raises_on_cpu():
    p = torch.zeros((2, 4, 48))
    with pytest.raises(ValueError, match='exactly one'):
        tb.fft_axis_tp(p, 1)
    with pytest.raises(ValueError, match=r'\(0, 48\)'):
        tb.fft_axis_tp(p, 1, trunc=48)
    with pytest.raises(ValueError, match=r'\(0, 32\)'):
        tb.fft_axis_tp(p, 1, pad=32)
    with pytest.raises(ValueError, match='engine'):
        tb.fft_axis_tp(torch.zeros((2, 4, 2048)), 1, trunc=1365)
    with pytest.raises(ValueError, match='engine'):
        tb.fft_axis_tp(p, 1, pad=36)
    with pytest.raises(ValueError, match='planar'):
        tb.fft_axis_tp(torch.zeros((3, 4, 48)), 1, trunc=32)
    with pytest.raises(TypeError, match='floating'):
        tb.fft_axis_tp(torch.zeros((2, 4, 48), dtype=torch.int32), 1,
                       trunc=32)
    assert tb.LAUNCHES['fft_axis_tp'] == tb.LAUNCHES['fft_axis_tp_f64'] == 0
