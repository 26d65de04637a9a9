"""The port's CUDA kernel sources (mpi4py_fft_torch/ops/csrc) run on the
CPU in a thread emulation, held against the plain PyTorch versions.

There is no CUDA compiler here, so the .cu files are compiled by g++
against tests/cuda_emu/cuda_runtime.h: every block runs as real threads
that meet at each __syncthreads() on a barrier (a missing barrier or a
race on the shared-memory tile gives a wrong result), and the launch
syntax is rewritten into a call.  The port's own wrappers drive them, so
the offsets, tile mapping, stage schedule, packing and the C entries'
argument checks are all exercised.  Tolerance: relative L2 5e-6 (the JAX
kernel tolerance, tests/test_butterfly.py:44) for the float32 builds,
2e-13 for the float64 builds (the JAX suite's tolerance for its f64
kernel F, tests/test_ds.py:58).  On the card, chip_smoke.py holds the
same kernels built by nvcc.
"""
import ctypes
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from mpi4py_fft_torch.ops import _build
from mpi4py_fft_torch.ops import butterfly as bf

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / 'mpi4py_fft_torch' / 'ops' / 'csrc'
EMU = pathlib.Path(__file__).resolve().parent / 'cuda_emu'
TOL = 5e-6
TOL64 = 2e-13


def _emu_source(cu):
    s = cu.read_text()
    s = re.sub(r'(\w+)<<<(.*?)>>>\(',
               lambda m: f'emu_launch({m.group(1)}, {m.group(2)}, ', s,
               flags=re.S)
    s, n = re.subn(r'extern __shared__ __align__\(16\) unsigned char '
                   r'smem\[\];', 'unsigned char* smem = emu_smem;', s)
    assert n >= 1 or '__shared__' not in s, cu     # every smem replaced
    return s


@pytest.fixture(scope='module')
def emu_kernels(tmp_path_factory):
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ to compile the kernel emulation')
    d = tmp_path_factory.mktemp('cuda_emu')
    procs = {}
    for lib in _build._ENTRIES:
        src = d / f'{lib}.cpp'
        src.write_text(_emu_source(CSRC / f'{lib}.cu'))
        cmd = [gxx, '-std=c++20', '-O1', '-ffp-contract=off', '-shared',
               '-fPIC', '-pthread', '-I', str(EMU), '-I', str(CSRC),
               '-o', str(d / f'{lib}.so'), str(src)]
        procs[lib] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    for lib, p in procs.items():
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, out
    return _build.Kernels({lib: ctypes.CDLL(str(d / f'{lib}.so'))
                           for lib in _build._ENTRIES})


@pytest.fixture
def kernel_path(emu_kernels, monkeypatch):
    """The wrappers launch the emulated kernels on CPU tensors."""
    def launch(what, fn, t, *args):
        rc = fn(*args, ctypes.c_void_p(0))
        if rc != 0:
            raise RuntimeError(f"{what}: emulated launch failed: {rc}")
        bf.LAUNCHES[what] += 1

    monkeypatch.setattr(_build, '_kernels', emu_kernels)
    monkeypatch.setattr(bf, '_launch', launch)
    plain_ok = bf._plain_ok
    monkeypatch.setattr(bf, '_plain_ok', lambda t, what, **kw: False)
    bf.reset_launches()
    yield plain_ok
    bf.reset_launches()


def _plain(plain_ok, fn, *args, **kw):
    """The plain version through the same wrapper."""
    bf._plain_ok, saved = plain_ok, bf._plain_ok
    try:
        return fn(*args, **kw)
    finally:
        bf._plain_ok = saved


def _rel(a, b):
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


def _launched():
    """The launch counters that are not 0."""
    return {k: v for k, v in bf.LAUNCHES.items() if v}


# every axis position, ragged pre/post, tiny and long lengths, radix 3
SHAPES = [((3, 96, 5), 1), ((4, 8), 0), ((2,), 0), ((7, 768), 1),
          ((1024, 3), 0), ((6, 5, 6), 2), ((5, 1024, 2), 1), ((9, 4, 33), 1),
          ((2, 384, 9), 1), ((96, 1, 130), 0), ((3, 512), 1), ((2, 12, 3), 1)]


def _hold_kernels(plain_ok, shape, axis, dtype, tol):
    """fft_axis_p (both signs, a scale), rfft_axis_p (hext, trunc with and
    without the Nyquist fold, scales) and irfft_axis_p (long, short and
    exact spectra) against their plain versions."""
    rng = np.random.default_rng(11)
    N = shape[axis]
    nh = N // 2 + 1
    p = torch.from_numpy(rng.standard_normal((2,) + shape).astype(dtype))
    for fwd, sc in ((True, None), (False, None), (True, 0.37)):
        got = bf.fft_axis_p(p, axis, fwd, scale=sc)
        ref = _plain(plain_ok, bf.fft_axis_p, p, axis, fwd, scale=sc)
        assert got.dtype == p.dtype
        assert _rel(got, ref) <= tol
    x = torch.from_numpy(rng.standard_normal(shape).astype(dtype))
    for hext, trunc, sc in ((None, None, None), (nh + 3, None, 0.5),
                            (None, max(1, nh - 2), None),
                            (nh + 1, max(1, nh - 1), 2.0)):
        got = bf.rfft_axis_p(x, axis, hext=hext, trunc=trunc, scale=sc)
        ref = _plain(plain_ok, bf.rfft_axis_p, x, axis, hext=hext,
                     trunc=trunc, scale=sc)
        assert got.shape == ref.shape and got.dtype == x.dtype
        assert _rel(got, ref) <= tol
    for hin, sc in ((nh, None), (nh + 2, 0.25), (max(1, nh - 1), None),
                    (max(1, nh - 2), None)):
        sh = list(shape)
        sh[axis] = hin
        h = torch.from_numpy(rng.standard_normal([2] + sh).astype(dtype))
        got = bf.irfft_axis_p(h, axis, N, scale=sc)
        ref = _plain(plain_ok, bf.irfft_axis_p, h, axis, N, scale=sc)
        assert got.shape == ref.shape and got.dtype == h.dtype
        assert _rel(got, ref) <= tol


@pytest.mark.parametrize('shape,axis', SHAPES)
def test_kernels_vs_plain(kernel_path, shape, axis):
    _hold_kernels(kernel_path, shape, axis, np.float32, TOL)
    assert _launched() == {'fft_axis_p': 3, 'rfft_axis_p': 4,
                           'irfft_axis_p': 4}


# the fp64 builds: lead, mid and last positions, ragged pre/post, the
# 1024-point tile of two blocks an SM, 3*2^a lengths (96, 384, 768, 12)
SHAPES64 = [((3, 96, 5), 1), ((1024, 3), 0), ((6, 5, 6), 2),
            ((2, 384, 9), 1), ((96, 1, 130), 0), ((7, 768), 1),
            ((2, 12, 3), 1), ((4, 8), 0)]


@pytest.mark.parametrize('shape,axis', SHAPES64)
def test_kernels_vs_plain_f64(kernel_path, shape, axis):
    """The float64 entries, launched for float64 tensors and counted
    under their own names."""
    _hold_kernels(kernel_path, shape, axis, np.float64, TOL64)
    assert _launched() == {'fft_axis_p_f64': 3, 'rfft_axis_p_f64': 4,
                           'irfft_axis_p_f64': 4}


# the pair kernel (full shape, axis): lead, mid and last positions, whole
# lines (post == 1), N = 2, 6, 1024, 1536 and 2048, ragged pre/post
PAIR_SHAPES = [((16, 6, 5), 0), ((3, 32, 7), 1), ((5, 4, 24), 2),
               ((2048, 3), 0), ((2, 1536), 1), ((4, 6), 1), ((2, 9), 0),
               ((2, 1024, 3), 1)]


@pytest.mark.parametrize('shape,axis', PAIR_SHAPES)
def test_pair_kernel_vs_plain(kernel_path, shape, axis):
    """fft_axis2_p on two halves sliced out of one volume (views, not
    contiguous off axis 0), fft_axis_pair_p on the whole of it, and
    fft_axis2_p with alias=True on contiguous halves."""
    rng = np.random.default_rng(12)
    d, h = 1 + axis, shape[axis] // 2
    x = torch.from_numpy(rng.standard_normal((2,) + shape)
                         .astype(np.float32))
    pa, pb = x.narrow(d, 0, h), x.narrow(d, h, h)
    for fwd, sc in ((True, None), (False, None), (True, 0.37)):
        oa, ob = bf.fft_axis2_p(pa, pb, axis, fwd, scale=sc)
        ra, rb = _plain(kernel_path, bf.fft_axis2_p, pa, pb, axis, fwd,
                        scale=sc)
        assert oa.shape == pa.shape and ob.shape == pb.shape
        assert _rel(torch.cat([oa, ob], d), torch.cat([ra, rb], d)) <= TOL
        y = bf.fft_axis_pair_p(x, axis, fwd, scale=sc)
        ref = _plain(kernel_path, bf.fft_axis_pair_p, x, axis, fwd, scale=sc)
        assert _rel(y, ref) <= TOL
        assert torch.equal(y, torch.cat([oa, ob], d))
    # aliased, with the two halves in different layouts (a view of a
    # copy of x, and a contiguous tensor)
    ca, cb = x.clone().narrow(d, 0, h), pb.contiguous()
    ga, gb = bf.fft_axis2_p(ca, cb, axis, False, alias=True)
    assert ga is ca and gb is cb
    oa, ob = bf.fft_axis2_p(pa, pb, axis, False)
    assert torch.equal(ga, oa) and torch.equal(gb, ob)
    assert _launched() == {'fft_axis2_p': 5, 'fft_axis_pair_p': 3}


# the fused dealiasing kernel E (shape of the N-row side, axis, Nt): lead,
# mid and last positions, whole lines, even and odd Nt (fold and split,
# or neither), Nt = 1 and N - 1, radix 3, the 768- and 1024-point tiles
TP_SHAPES = [((3, 48, 5), 1, 32), ((48, 8), 0, 31), ((6, 5, 24), 2, 16),
             ((4, 12), 1, 7), ((2, 768, 3), 1, 512), ((96, 1, 130), 0, 64),
             ((3, 1024), 1, 683), ((8, 3, 16), 0, 1), ((5, 16, 2), 1, 15)]


def _hold_tp(plain_ok, shape, axis, nt, dtype, tol):
    """fft_axis_tp with trunc (forward, with and without a scale) and pad
    (backward, with and without a scale) against its plain version."""
    rng = np.random.default_rng(13)
    N = shape[axis]
    p = torch.from_numpy(rng.standard_normal((2,) + shape).astype(dtype))
    sh = list(shape)
    sh[axis] = nt
    q = torch.from_numpy(rng.standard_normal([2] + sh).astype(dtype))
    for kw in (dict(trunc=nt), dict(trunc=nt, scale=1.0 / N)):
        got = bf.fft_axis_tp(p, axis, True, **kw)
        ref = _plain(plain_ok, bf.fft_axis_tp, p, axis, True, **kw)
        assert got.shape == ref.shape and got.dtype == p.dtype
        assert _rel(got, ref) <= tol, kw
    for kw in (dict(pad=N), dict(pad=N, scale=0.37)):
        got = bf.fft_axis_tp(q, axis, False, **kw)
        ref = _plain(plain_ok, bf.fft_axis_tp, q, axis, False, **kw)
        assert got.shape == ref.shape and got.dtype == q.dtype
        assert _rel(got, ref) <= tol, kw


@pytest.mark.parametrize('shape,axis,nt', TP_SHAPES)
def test_tp_kernel_vs_plain(kernel_path, shape, axis, nt):
    _hold_tp(kernel_path, shape, axis, nt, np.float32, TOL)
    assert _launched() == {'fft_axis_tp': 4}


@pytest.mark.parametrize('shape,axis,nt', TP_SHAPES[:7])
def test_tp_kernel_vs_plain_f64(kernel_path, shape, axis, nt):
    """The float64 entry, counted under fft_axis_tp_f64."""
    _hold_tp(kernel_path, shape, axis, nt, np.float64, TOL64)
    assert _launched() == {'fft_axis_tp_f64': 4}


def test_pair_kernel_refuses_layout(kernel_path):
    """Halves whose columns are not adjacent do not reach the kernel."""
    pa = torch.zeros((2, 6, 16)).transpose(1, 2)       # (2, 16, 6)
    pb = torch.zeros((2, 16, 6))
    with pytest.raises(ValueError, match='contiguous'):
        bf.fft_axis2_p(pa, pb, 0)
    assert bf.LAUNCHES['fft_axis2_p'] == 0


def test_c_entry_rejects_bad_plan(emu_kernels):
    """A plan whose radices do not multiply to n, and a length the pair
    kernel does not take (over 2048, odd), are refused by the C entries,
    before any launch."""
    x = torch.zeros((2, 4, 8))
    y = torch.empty_like(x)
    tw = bf._tw_tensor(8, -1, False, torch.float32, x.device)
    plan = (ctypes.c_int * 2)(2, 2)
    for fn in (emu_kernels.fft_axis_f32, emu_kernels.fft_axis_f64):
        rc = fn(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(y.data_ptr()),
                ctypes.c_void_p(tw.data_ptr()), tw.shape[1], 4, 8, 1, -1,
                plan, 2, 1.0, ctypes.c_void_p(0))
        assert rc != 0
    # E: a truncated extent outside (0, n), or a mode other than 0 and 1
    plan = (ctypes.c_int * 3)(2, 2, 2)
    for fn in (emu_kernels.fft_axis_tp_f32, emu_kernels.fft_axis_tp_f64):
        for nt, pad in ((0, 0), (8, 1), (9, 0), (4, 2)):
            rc = fn(ctypes.c_void_p(x.data_ptr()),
                    ctypes.c_void_p(y.data_ptr()),
                    ctypes.c_void_p(tw.data_ptr()), tw.shape[1], 4, 8, nt,
                    pad, 1, -1, plan, 3, 1.0, ctypes.c_void_p(0))
            assert rc != 0, (nt, pad)
    for n, plan in ((4096, (16, 16, 16)), (9, (3, 3)), (8, (2, 2))):
        radices = (ctypes.c_int * len(plan))(*plan)
        rc = emu_kernels.fft_axis2_f32(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(x.data_ptr()),
            ctypes.c_void_p(y.data_ptr()), ctypes.c_void_p(y.data_ptr()),
            (ctypes.c_longlong * 8)(1, 1, 1, 1, 1, 1, 1, 1),
            ctypes.c_void_p(tw.data_ptr()), tw.shape[1], 1, n, 1, -1,
            radices, len(plan), 1.0, ctypes.c_void_p(0))
        assert rc != 0, n


# J (fft2stage.cu): every S, both signs, a line count that leaves the last
# block partly empty, one line, and leading dims that flatten
J_SHAPES = [((13, 128), 1), ((5, 256), 2), ((22, 384), 3), ((3, 6, 512), 4),
            ((13, 640), 5), ((11, 768), 6), ((10, 896), 7), ((1, 1024), 8),
            ((2, 3, 1024), 8)]


@pytest.mark.parametrize('shape,S', J_SHAPES)
def test_fft2stage_kernel_vs_plain(kernel_path, shape, S):
    from mpi4py_fft_torch.ops import fft2stage
    rng = np.random.default_rng(14)
    p = torch.from_numpy(rng.standard_normal((2,) + shape)
                         .astype(np.float32))
    assert shape[-1] == 128 * S
    for sign in (-1, +1):
        got = fft2stage.fft2stage_p(p, sign)
        ref = _plain(kernel_path, fft2stage.fft2stage_p, p, sign)
        assert got.shape == p.shape and got.dtype == p.dtype
        assert _rel(got, ref) <= TOL, sign
    assert _launched() == {'fft2stage_p': 2}


# H and I (fft_plane.cu): square and oblong planes, N = 2 on either
# axis, planes smaller than one tile, the 256 x 256 plane of H, a
# 1024-long axis, one plane and several
PLANE_SHAPES = [(3, 32, 64), (2, 256, 256), (4, 8, 2), (1, 2, 1024),
                (2, 1024, 4), (2, 3, 16, 16)]


@pytest.mark.parametrize('shape', PLANE_SHAPES)
def test_plane_kernel_vs_plain(kernel_path, shape):
    """fft_plane_p where H's gate takes the plane, and fft_plane_large_p
    always: both signs, with and without a scale."""
    rng = np.random.default_rng(15)
    p = torch.from_numpy(rng.standard_normal((2,) + shape)
                         .astype(np.float32))
    h = bf.supported_plane(shape, np.float32)
    assert bf.supported_plane_large(shape, np.float32)
    for fwd, sc in ((True, None), (False, None), (True, 0.37)):
        fns = [bf.fft_plane_large_p] + ([bf.fft_plane_p] if h else [])
        for fn in fns:
            got = fn(p, fwd, scale=sc)
            ref = _plain(kernel_path, fn, p, fwd, scale=sc)
            assert got.shape == p.shape and got.dtype == p.dtype
            assert _rel(got, ref) <= TOL, (fn.__name__, fwd, sc)
    want = {'fft_plane_large_p': 3}
    if h:
        want['fft_plane_p'] = 3
    assert _launched() == want
