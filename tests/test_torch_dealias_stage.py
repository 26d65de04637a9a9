"""The dealiased stage behind the engine, on the CPU.

``ops/matfft.py`` is the one place that chooses a dealiased stage's
kernel: ``fft1d_p(trunc=)``/``(pad=)``, ``rfftn_p(trunc=)`` and
``irfftn_p`` on a truncated spectrum run E, B or C with the 3/2-rule
boundary fused where the kernel takes the shape, and the same steps one
by one (``truncate_planar``/``pad_planar`` beside the transform)
elsewhere.  Each is held against those steps composed by hand, at a
kernel length (768 -> 512) and at a length only the einsum engine takes
(30 -> 20): f64 relative L2 1e-12, f32 5e-6.

``PlanarPFFT`` has one executor: on one rank its steps move nothing, so
a transform runs exactly the engine calls of its stages (the same ATen
ops, no copy added), and a padded plan takes the same kernels, in the
same order, as ``PFFT`` on the same shape and padding.  Above the engine
nothing imports the kernel layer.
"""
import ast
import contextlib
import pathlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mpi4py_fft_torch import PFFT, PlanarPFFT
from mpi4py_fft_torch.ops import butterfly as bf
from mpi4py_fft_torch.ops import matfft
from mpi4py_fft_torch.ops.matfft import pad_planar, truncate_planar

PKG = pathlib.Path(matfft.__file__).resolve().parents[1]
TOL = {torch.float64: 1e-12, torch.float32: 5e-6}
LENGTHS = [(768, 512), (30, 20)]
SCALES = [None, 0.25]


def _rel(got, ref):
    assert got.shape == ref.shape
    num = (got.double() - ref.double()).norm()
    return float(num / ref.double().norm())


def _rand(shape, dtype, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)


def _kernel_spans(monkeypatch, fn):
    """The kernel spans (``kernel.<name>``) ``fn()`` opens, in order."""
    names = []

    def record(name, nbytes=0, route=None):
        names.append(name)
        return contextlib.nullcontext()
    monkeypatch.setattr(bf.profiling, 'annotate', record)
    fn()
    return [n for n in names if n.startswith('kernel.')]


def _fused(N):
    return bf.supported_axis_tp((N,), 0, torch.float64, trunc=N // 2)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('scale', SCALES)
@pytest.mark.parametrize('N,Nt', LENGTHS)
@pytest.mark.parametrize('axis', [1, 2])
def test_fft1d_p_trunc_is_the_transform_then_truncate_planar(
        monkeypatch, axis, N, Nt, scale, dtype):
    shape = [3, 4, 5]
    shape[axis] = N
    p = _rand([2] + shape, dtype)
    spans = _kernel_spans(monkeypatch, lambda: matfft.fft1d_p(
        p, axis, True, scale=scale, trunc=Nt))
    got = matfft.fft1d_p(p, axis, True, scale=scale, trunc=Nt)
    ref = truncate_planar(matfft.fft1d_p(p, axis, True), 1 + axis, Nt,
                          hermitian=False)
    if scale is not None:
        ref = ref * scale
    assert _rel(got, ref) <= TOL[dtype]
    assert (spans == ['kernel.fft_axis_tp' + _sfx(dtype)]) == _fused(N)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('scale', SCALES)
@pytest.mark.parametrize('N,Nt', LENGTHS)
@pytest.mark.parametrize('axis', [0, 2])
def test_fft1d_p_pad_is_pad_planar_then_the_transform(
        monkeypatch, axis, N, Nt, scale, dtype):
    shape = [3, 4, 5]
    shape[axis] = Nt
    p = _rand([2] + shape, dtype)
    spans = _kernel_spans(monkeypatch, lambda: matfft.fft1d_p(
        p, axis, False, scale=scale, pad=N))
    got = matfft.fft1d_p(p, axis, False, scale=scale, pad=N)
    ref = matfft.fft1d_p(pad_planar(p, 1 + axis, N, hermitian=False), axis,
                         False)
    if scale is not None:
        ref = ref * scale
    assert _rel(got, ref) <= TOL[dtype]
    assert (spans == ['kernel.fft_axis_tp' + _sfx(dtype)]) == _fused(N)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('scale', SCALES)
@pytest.mark.parametrize('N,Nt', LENGTHS)
def test_rfftn_p_trunc_is_the_r2c_then_the_hermitian_truncation(
        monkeypatch, N, Nt, scale, dtype):
    x = _rand((3, 4, N), dtype)
    nt = Nt // 2 + 1
    spans = _kernel_spans(monkeypatch, lambda: matfft.rfftn_p(
        x, (2,), trunc=nt, scale=scale))
    got = matfft.rfftn_p(x, (2,), trunc=nt, scale=scale)
    ref = truncate_planar(matfft.rfftn_p(x, (2,)), 3, nt, hermitian=True)
    if scale is not None:
        ref = ref * scale
    assert _rel(got, ref) <= TOL[dtype]
    assert (spans == ['kernel.rfft_axis_p' + _sfx(dtype)]) == _fused(N)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('scale', SCALES)
@pytest.mark.parametrize('N,Nt', LENGTHS)
def test_irfftn_p_takes_a_truncated_spectrum(monkeypatch, N, Nt, scale,
                                              dtype):
    """A spectrum of Nt//2+1 rows to N real points: the Hermitian
    zero-padding to N//2+1 rows, then the c2r."""
    p = _rand((2, 3, 4, Nt // 2 + 1), dtype)
    spans = _kernel_spans(monkeypatch, lambda: matfft.irfftn_p(
        p, (2,), N, scale=scale))
    got = matfft.irfftn_p(p, (2,), N, scale=scale)
    ref = matfft.irfftn_p(pad_planar(p, 3, N // 2 + 1, hermitian=True),
                          (2,), N)
    if scale is not None:
        ref = ref * scale
    assert _rel(got, ref) <= TOL[dtype]
    assert (spans == ['kernel.irfft_axis_p' + _sfx(dtype)]) == _fused(N)


def _sfx(dtype):
    return '_f64' if dtype in (torch.float64, 'd', 'D') else ''


class _Ops(TorchDispatchMode):
    """The ATen ops run while it is on, by name, in order."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _ops(fn):
    with _Ops() as m:
        out = fn()
    return out, m.names


def _by_hand(plan, x, forward, padded):
    """The engine calls of a one-rank 3-D plan's stages, by hand."""
    N = plan.global_shape(False)[-3:]
    n = plan.global_shape(True)[1:]
    if forward:
        if plan.real_transform:
            p = matfft.rfftn_p(x, (2,), hext=n[2],
                               trunc=n[2] if padded else None)
        else:
            p = matfft.fft1d_p(x, 2, True, trunc=n[2] if padded else None)
        p = matfft.fft1d_p(p, 1, True, trunc=n[1] if padded else None)
        return matfft.fft1d_p(p, 0, True, scale=1.0 / float(np.prod(N)),
                              trunc=n[0] if padded else None)
    p = matfft.fft1d_p(x, 0, False, pad=N[0] if padded else None)
    p = matfft.fft1d_p(p, 1, False, pad=N[1] if padded else None)
    if plan.real_transform:
        return matfft.irfftn_p(p, (2,), N[2])
    return matfft.fft1d_p(p, 2, False, pad=N[2] if padded else None)


@pytest.mark.parametrize('padding', [False, 1.5])
@pytest.mark.parametrize('dtype', ['f', 'd', 'F', 'D'])
def test_one_rank_steps_add_no_op(dtype, padding):
    """On one rank the executor's steps move nothing: forward and
    backward run the ATen ops of their stages' engine calls and no
    other (no exchange, no fit, no copy), with equal results."""
    plan = PlanarPFFT(None, (8, 12, 8), dtype=dtype, padding=padding,
                      device='cpu')
    t = torch.float32 if dtype in 'fF' else torch.float64
    x = _rand(plan.local_shape(False), t)
    plan.backward(plan.forward(x))          # the tables, built once
    y, fops = _ops(lambda: plan.forward(x))
    yh, hops = _ops(lambda: _by_hand(plan, x, True, bool(padding)))
    assert fops == hops and torch.equal(y, yh)
    z, bops = _ops(lambda: plan.backward(y))
    zh, hops = _ops(lambda: _by_hand(plan, y, False, bool(padding)))
    assert bops == hops and torch.equal(z, zh)


@pytest.mark.parametrize('dtype', ['f', 'd', 'F', 'D'])
def test_one_rank_padded_planar_takes_pfft_kernels(monkeypatch, dtype):
    """A one-rank padded PlanarPFFT runs E (and B and C for a real plan)
    with the 3/2-rule boundary fused, the kernels PFFT runs on the same
    shape and padding, in the same order."""
    shape = (8, 16, 16)
    pl = PlanarPFFT(None, shape, dtype=dtype, padding=1.5, device='cpu')
    pf = PFFT(None, shape, dtype=dtype, padding=[1.5] * 3, device='cpu')
    t = torch.float32 if dtype in 'fF' else torch.float64
    x = _rand(pl.local_shape(False), t)

    def planar():
        pl.backward(pl.forward(x))

    def pfft():
        pf.backward.fn(pf.forward.fn(x))
    got = _kernel_spans(monkeypatch, planar)
    want = _kernel_spans(monkeypatch, pfft)
    tp = 'kernel.fft_axis_tp' + _sfx(dtype)
    if dtype in 'fd':
        first, last = ('kernel.rfft_axis_p' + _sfx(dtype),
                       'kernel.irfft_axis_p' + _sfx(dtype))
    else:
        first = last = tp
    assert got == [first, tp, tp, tp, tp, last]
    assert got == want


@pytest.mark.parametrize('path', ['parallel/planar.py', 'parallel/mpifft.py',
                                  'libfft.py'])
def test_above_the_engine_nothing_imports_the_kernels(path):
    tree = ast.parse((PKG / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            names.append(node.module or '')
            names += [a.name for a in node.names]
        elif isinstance(node, ast.Import):
            names += [a.name for a in node.names]
    assert not [n for n in names if 'butterfly' in n], path

