"""The port's quartered schedule (mpi4py_fft_torch/ops/oop3d.py) and its
pair kernels (butterfly.fft_axis2_p, fft_axis_pair_p) against the JAX
package on the CPU, mirroring tests/test_oop3d.py.

On CPU tensors the port's wrappers run their plain versions; the JAX side
runs its Pallas kernels in interpret mode.  Both get the same numpy
inputs, made from a seed.  Tolerances: relative L2 5e-6 for one kernel
pass (the JAX kernel tolerance, tests/test_butterfly.py:44) and 5e-5 for a
3-axis composition (tests/test_butterfly.py:131); splitting and assembling
are exact.  The CUDA pair kernel itself is held against these plain
versions in tests/test_torch_kernel_emu.py and, on the card, by
chip_smoke.py.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mpi4py_fft_tpu.ops import oop3d as joop
from mpi4py_fft_tpu.ops import pallas_butterfly as pb
from mpi4py_fft_tpu.parallel import DeviceComm
from mpi4py_fft_tpu.parallel.planar import PlanarPFFT as JPlanarPFFT

from mpi4py_fft_torch import PlanarPFFT
from mpi4py_fft_torch.ops import butterfly as tb
from mpi4py_fft_torch.ops import oop3d

SHAPE = (16, 128, 256)          # the JAX test's smallest quarterable shape
TOL = 5e-6
PIPE_TOL = 5e-5


def _rel(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal((2,) + shape) \
        .astype(np.float32)


def _halves(x, axis):
    h = x.shape[1 + axis] // 2
    a = np.take(x, np.arange(h), axis=1 + axis)
    b = np.take(x, np.arange(h, 2 * h), axis=1 + axis)
    return a, b


def _np(ts):
    return [np.asarray(t) for t in ts]


# full shapes of tests/test_oop3d.py:test_fft_axis2_vs_numpy
AXIS2_CASES = [((16, 128, 256), 0), ((16, 64, 128), 1), ((16, 128, 256), 2)]


@pytest.mark.parametrize('full,axis', AXIS2_CASES)
@pytest.mark.parametrize('forward,scale', [(True, None), (False, 0.25)])
def test_fft_axis2_vs_pallas(full, axis, forward, scale):
    x = _x(full, 1)
    a, b = _halves(x, axis)
    assert pb.supported_axis_split(a.shape[1:], axis, np.float32)
    assert tb.supported_axis_split(a.shape[1:], axis)
    ra, rb = pb.fft_axis2_p(jnp.asarray(a), jnp.asarray(b), axis, forward,
                            interpret=True, scale=scale)
    ga, gb = tb.fft_axis2_p(torch.from_numpy(a), torch.from_numpy(b), axis,
                            forward, scale=scale)
    assert ga.shape == a.shape and gb.shape == b.shape
    assert _rel(np.concatenate(_np([ga, gb]), 1 + axis),
                np.concatenate(_np([ra, rb]), 1 + axis)) < TOL


def test_fft_axis2_alias_matches_oop():
    """alias=True writes the same transform over its input halves."""
    x = _x((16, 64, 128), 9)
    a, b = _halves(x, 0)
    oa, ob = tb.fft_axis2_p(torch.from_numpy(a), torch.from_numpy(b), 0)
    ta, tbb = torch.from_numpy(a.copy()), torch.from_numpy(b.copy())
    aa, ab = tb.fft_axis2_p(ta, tbb, 0, alias=True)
    assert aa is ta and ab is tbb
    assert torch.equal(aa, oa) and torch.equal(ab, ob)
    ra, rb = pb.fft_axis2_p(jnp.asarray(a), jnp.asarray(b), 0,
                            interpret=True, alias=True)
    assert _rel(np.concatenate(_np([aa, ab]), 1),
                np.concatenate(_np([ra, rb]), 1)) < TOL


@pytest.mark.parametrize('full,axis', AXIS2_CASES)
def test_fft_axis_pair_vs_pallas(full, axis):
    x = _x(full, 2)
    ref = pb.fft_axis_pair_p(jnp.asarray(x), axis, False, interpret=True,
                             scale=0.5)
    got = tb.fft_axis_pair_p(torch.from_numpy(x), axis, False, scale=0.5)
    assert got.shape == x.shape
    assert _rel(got, ref) < TOL


def test_supported_gates_vs_jax():
    for shape in (SHAPE, (32, 128, 256), (1024, 1024, 1024)):
        assert oop3d.supported_q(shape, np.float32)
        assert joop.supported_q(shape, np.float32)
        # the port takes whatever JAX takes; JAX's tile gates refuse more
        assert oop3d.supported_8(shape, np.float32)
        assert joop.supported_8(shape, np.float32) == (shape != SHAPE)
    for shape, dt in (((15, 128, 256), np.float32), (SHAPE, np.float64),
                      ((16, 128), np.float32), ((8192, 8, 8), np.float32),
                      ((16, 10, 256), np.float32)):
        assert not oop3d.supported_q(shape, dt)
        assert not joop.supported_q(shape, dt)
    # the port's gates are length gates: no (8, 128) tile conditions
    assert oop3d.supported_q((6, 12, 6), np.float32)
    assert oop3d.supported_8((6, 12, 6), np.float32)
    assert not oop3d.supported_8((30, 12, 6), np.float32)


def test_split_assemble_roundtrips():
    x = _x(SHAPE, 0)
    t = torch.from_numpy(x)
    qs = oop3d.split_q(t)
    assert len(qs) == 4 and all(q.is_contiguous() for q in qs)
    assert qs[0].shape == (2, SHAPE[0] // 2, SHAPE[1], SHAPE[2] // 2)
    for q, jq in zip(qs, joop.split_q(jnp.asarray(x))):
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert torch.equal(oop3d.assemble_q(qs), t)
    es = oop3d.split_8(t)
    assert len(es) == 8 and all(e.is_contiguous() for e in es)
    for e, je in zip(es, joop.split_8(jnp.asarray(x))):
        np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    assert torch.equal(oop3d.assemble_8(es), t)


def test_fft3_q_vs_jax_and_roundtrip():
    x = _x(SHAPE, 2)
    ref = np.asarray(joop.assemble_q(
        joop.fft3_q(joop.split_q(jnp.asarray(x)), True, interpret=True)))
    qs = list(oop3d.split_q(torch.from_numpy(x)))
    ys = oop3d.fft3_q(qs, True)
    assert qs == []                     # the list was handed over
    assert _rel(oop3d.assemble_q(ys), ref) < PIPE_TOL
    zs = oop3d.fft3_q(ys, False, scale=1.0 / np.prod(SHAPE))
    assert len(ys) == 4                 # a tuple is left as it was
    assert _rel(oop3d.assemble_q(zs), x) < PIPE_TOL


def test_fft3_8_vs_jax_and_roundtrip():
    shape = (32, 128, 256)
    x = _x(shape, 5)
    ref = np.asarray(joop.assemble_8(
        joop.fft3_8(joop.split_8(jnp.asarray(x)), True, interpret=True)))
    ys = oop3d.fft3_8(oop3d.split_8(torch.from_numpy(x)), True)
    assert ys[0].shape == (2, 16, 64, 128)
    assert _rel(oop3d.assemble_8(ys), ref) < PIPE_TOL
    zs = oop3d.fft3_8(list(ys), False, scale=1.0 / np.prod(shape))
    assert _rel(oop3d.assemble_8(zs), x) < PIPE_TOL


def test_planar_quartered_vs_jax():
    """PlanarPFFT.forward_fn_q/backward_fn_q against the JAX plan's on a
    1-device comm, and the quartered path against the full-volume one."""
    jp = JPlanarPFFT(DeviceComm(jax.devices()[:1]), SHAPE, dtype='F')
    tp = PlanarPFFT(None, SHAPE, dtype='F', device='cpu')
    assert jp.quartered and tp.quartered
    x = _x(SHAPE, 3)
    ref = np.asarray(joop.assemble_q(
        jp.forward_fn_q(joop.split_q(jnp.asarray(x)))))
    ys = tp.forward_fn_q(list(oop3d.split_q(torch.from_numpy(x))))
    y = oop3d.assemble_q(ys)
    assert _rel(y, ref) < PIPE_TOL
    assert _rel(y, tp.forward(torch.from_numpy(x))) < PIPE_TOL
    jref = np.asarray(joop.assemble_q(
        jp.backward_fn_q(joop.split_q(jnp.asarray(ref)))))
    back = oop3d.assemble_q(tp.backward_fn_q(ys))
    assert _rel(back, jref) < PIPE_TOL
    assert _rel(back, x) < PIPE_TOL


def test_planar_quartered_checks():
    tp = PlanarPFFT(None, SHAPE, dtype='F', device='cpu')
    qs = oop3d.split_q(torch.zeros((2,) + SHAPE))
    with pytest.raises(ValueError, match='4 quarters'):
        tp.forward_fn_q(qs[:3])
    with pytest.raises(ValueError, match='quarter of shape'):
        tp.forward_fn_q(oop3d.split_q(torch.zeros((2, 16, 128, 128))))
    with pytest.raises(ValueError, match='float64'):
        tp.forward_fn_q(tuple(q.double() for q in qs))
    tr = PlanarPFFT(None, SHAPE, dtype='f', device='cpu')
    with pytest.raises(ValueError, match='quartered'):
        tr.forward_fn_q(qs)
