"""J, the engine's two-stage last-axis kernel (mpi4py_fft_torch/ops/
fft2stage.py), against the JAX package's Pallas kernel
(``pallas_fft.fft2stage_p``, interpret mode) on the CPU, and the engine's
rule for where J runs.

The port's wrapper runs its plain version on CPU tensors, which repeats
the CUDA kernel's arithmetic (tests/test_torch_kernel_emu.py holds the
kernel source against it).  Tolerance: relative L2 5e-6, the JAX kernel
tolerance (tests/test_butterfly.py:44).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from mpi4py_fft_tpu.ops import pallas_fft as jfft2

from mpi4py_fft_torch.ops import butterfly as tb
from mpi4py_fft_torch.ops import fft2stage
from mpi4py_fft_torch.ops import matfft as tmatfft

TOL = 5e-6


def _rel(got, ref):
    got = np.asarray(got).astype(np.float64)
    ref = np.asarray(ref).astype(np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize('S', range(1, 9))
def test_fft2stage_plain_vs_pallas(S):
    rng = np.random.default_rng(60 + S)
    p = rng.standard_normal((2, 2, 4, 128 * S)).astype(np.float32)
    for sign in (-1, +1):
        ref = jfft2.fft2stage_p(jnp.asarray(p), sign, interpret=True)
        got = fft2stage.fft2stage_p(torch.from_numpy(p), sign)
        assert got.shape == p.shape and got.dtype == torch.float32
        assert _rel(got, ref) <= TOL, sign
        assert _rel(got, fft2stage.fft2stage_plain(torch.from_numpy(p),
                                                   sign)) == 0.0


@pytest.mark.parametrize('S,lines', [(6, 7)])
def test_fft2stage_plain_vs_pallas_ragged(S, lines):
    """A line count that is not a multiple of the CUDA kernel's four lines
    a block (the last block has a warp without a line)."""
    rng = np.random.default_rng(70 + S)
    p = rng.standard_normal((2, lines, 128 * S)).astype(np.float32)
    for sign in (-1, +1):
        ref = jfft2.fft2stage_p(jnp.asarray(p), sign, interpret=True)
        got = fft2stage.fft2stage_p(torch.from_numpy(p), sign)
        assert got.shape == p.shape and got.dtype == torch.float32
        assert _rel(got, ref) <= TOL, sign


def test_fft2stage_gates():
    assert [n for n in range(1, 1200) if fft2stage.supported_length(n)] \
        == [128 * s for s in range(1, 9)]
    assert all(fft2stage.supported_length(n) == jfft2.supported_length(n)
               for n in range(1, 1200))
    with pytest.raises(ValueError, match='S\\*128'):
        fft2stage.fft2stage_p(torch.zeros((2, 3, 640 + 128 * 4)), -1)
    with pytest.raises(ValueError, match='planar'):
        fft2stage.fft2stage_p(torch.zeros((3, 640)), -1)
    assert tb.LAUNCHES['fft2stage_p'] == 0


@pytest.fixture
def j_calls(monkeypatch):
    """The lengths J is called on, and the axes A is called on."""
    calls = {'J': [], 'A': []}
    j, a = fft2stage.fft2stage_p, tb.fft_axis_p

    def spy_j(p, sign):
        calls['J'].append(p.shape[-1])
        return j(p, sign)

    def spy_a(p, axis, *args, **kw):
        calls['A'].append(p.shape[1 + axis])
        return a(p, axis, *args, **kw)

    monkeypatch.setattr(fft2stage, 'fft2stage_p', spy_j)
    monkeypatch.setattr(tb, 'fft_axis_p', spy_a)
    return calls


# (complex shape, axis, dtype, J's lengths, A's lengths): J on f32 last
# axes of S*128 points, and in f32 Bluestein on M = 1024 (two calls); A
# where it takes the axis; neither J on other axes nor at float64
DISPATCH = [((3, 640), 1, torch.float32, [640], []),
            ((3, 896), 1, torch.float32, [896], []),
            ((3, 509), 1, torch.float32, [1024, 1024], []),
            ((509, 3), 0, torch.float32, [1024, 1024], []),
            ((3, 512), 1, torch.float32, [], [512]),
            ((3, 768), 1, torch.float32, [], [768]),
            ((640, 3), 0, torch.float32, [], []),
            ((3, 640), 1, torch.float64, [], []),
            ((3, 1280), 1, torch.float32, [], []),
            ((3, 100), 1, torch.float32, [], [])]


@pytest.mark.parametrize('shape,axis,dtype,jl,al', DISPATCH)
def test_engine_dispatches_j(j_calls, shape, axis, dtype, jl, al):
    rng = np.random.default_rng(7)
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    p = tmatfft.planar(torch.from_numpy(z)).to(dtype)
    got = tmatfft.fft1d_p(p, axis)
    assert j_calls == {'J': jl, 'A': al}
    ref = np.fft.fft(z, axis=axis)
    tol = TOL if dtype == torch.float32 else 1e-12
    assert _rel(np.stack([ref.real, ref.imag]), got) <= tol
