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
    def launch(what, fn, t, *args, nbytes, route=None):
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


def _emu_count(emu_kernels, lib, name):
    """An emulation counter of one library (tests/cuda_emu): cluster
    launches or __syncwarp() calls since it was loaded."""
    fn = getattr(emu_kernels._libs[lib], name)
    fn.restype = ctypes.c_longlong
    return fn()


def _hold_pair(plain_ok, shape, axis):
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
        ra, rb = _plain(plain_ok, bf.fft_axis2_p, pa, pb, axis, fwd,
                        scale=sc)
        assert oa.shape == pa.shape and ob.shape == pb.shape
        assert _rel(torch.cat([oa, ob], d), torch.cat([ra, rb], d)) <= TOL
        y = bf.fft_axis_pair_p(x, axis, fwd, scale=sc)
        ref = _plain(plain_ok, bf.fft_axis_pair_p, x, axis, fwd, scale=sc)
        assert _rel(y, ref) <= TOL
        assert torch.equal(y, torch.cat([oa, ob], d))
    # aliased, with the two halves in different layouts (a view of a
    # copy of x, and a contiguous tensor)
    ca, cb = x.clone().narrow(d, 0, h), pb.contiguous()
    ga, gb = bf.fft_axis2_p(ca, cb, axis, False, alias=True)
    assert ga is ca and gb is cb
    oa, ob = bf.fft_axis2_p(pa, pb, axis, False)
    assert torch.equal(ga, oa) and torch.equal(gb, ob)
    # into given halves, NaN-filled
    na = torch.full_like(pa, float('nan'))
    nb = torch.full_like(pb, float('nan'))
    ra, rb = bf.fft_axis2_p(pa, pb, axis, False, out=(na, nb))
    assert ra is na and rb is nb
    assert torch.equal(na, oa) and torch.equal(nb, ob)
    assert _launched() == {'fft_axis2_p': 6, 'fft_axis_pair_p': 3}


@pytest.mark.parametrize('shape,axis', PAIR_SHAPES)
def test_pair_kernel_vs_plain(kernel_path, emu_kernels, shape, axis):
    """The pair kernel: N <= 1024 on A's tile, N = 1536 and 2048 on the
    cluster kernel (one cluster launch each)."""
    c0 = _emu_count(emu_kernels, 'fft_axis2', 'emu_cluster_launches')
    _hold_pair(kernel_path, shape, axis)
    clusters = _emu_count(emu_kernels, 'fft_axis2',
                          'emu_cluster_launches') - c0
    assert clusters == (9 if shape[axis] > 1024 else 0)


def _routes(emu_kernels, lib):
    """A library's route counters (tests/cuda_emu): cluster launches,
    __syncwarp() calls and __ldcg() loads so far."""
    return {k: _emu_count(emu_kernels, lib, f'emu_{k}')
            for k in ('cluster_launches', 'syncwarps', 'ldcg_loads')}


def _route_delta(c0, c1):
    return {k: c1[k] - c0[k] for k in c0}


# D at N <= 1024 by route (full shape, axis, route): whole lines at 1024
# (four lines a block over five: a ragged block), at 512 (a group of 16
# threads) and at 768 (24 points a thread, radix 3 first) on the line
# kernel; lead axes at 1024 with fewer lines than a band's 32 and at 512
# over a ragged second band of 64, a mid axis at 1024 whose bands
# straddle pre rows, and 768 (a radix-3 column stage first) on the band
# kernel (a cluster of four CTAs); 96 on an inner axis and a post that is
# not a multiple of 4 on A's tile
D_ROUTES = [((5, 1024), 1, 'lines'), ((3, 2, 512), 2, 'lines'),
            ((2, 768), 1, 'lines'), ((1024, 8), 0, 'band'),
            ((512, 68), 0, 'band'), ((2, 1024, 12), 1, 'band'),
            ((768, 8), 0, 'band'), ((2, 768, 4), 1, 'band'),
            ((96, 8), 0, 'tile'), ((2, 512, 6), 1, 'tile')]


@pytest.mark.parametrize('shape,axis,route', D_ROUTES)
def test_pair_lines_band_vs_plain(kernel_path, emu_kernels, shape, axis,
                                  route):
    """fft_axis2_p and fft_axis_pair_p at N <= 1024 (both signs, a scale,
    views, the whole tensor, alias=True and out=) on the kernel the rule
    picks by shape: the line kernel (__syncwarp calls, no cluster
    launch), the band kernel (a cluster launch each, no __syncwarp) or A's
    tile (neither)."""
    c0 = _routes(emu_kernels, 'fft_axis2')
    _hold_pair(kernel_path, shape, axis)
    d = _route_delta(c0, _routes(emu_kernels, 'fft_axis2'))
    assert d['cluster_launches'] == (9 if route == 'band' else 0)
    assert (d['syncwarps'] > 0) == (route == 'lines')
    assert (d['ldcg_loads'] > 0) == (route == 'band')


def test_pair_misaligned_takes_tile(kernel_path, emu_kernels):
    """Halves that start 4 bytes off a 16-byte boundary take A's tile,
    with the same result, where aligned ones take the line kernel (whole
    lines at N = 1024) or the band kernel (a lead axis of 1024)."""
    rng = np.random.default_rng(21)
    for shape, axis in (((3, 1024), 1), ((1024, 8), 0)):
        m = int(np.prod(shape))
        flat = torch.from_numpy(rng.standard_normal(1 + 2 * m)
                                .astype(np.float32))
        x = flat[1:].view((2,) + shape)
        assert x.data_ptr() % 16 == 4
        d, h = 1 + axis, shape[axis] // 2
        pa, pb = x.narrow(d, 0, h), x.narrow(d, h, h)
        for sc in (None, 0.5):
            c0 = _routes(emu_kernels, 'fft_axis2')
            oa, ob = bf.fft_axis2_p(pa, pb, axis, False, scale=sc)
            assert _routes(emu_kernels, 'fft_axis2') == c0
            ra, rb = _plain(kernel_path, bf.fft_axis2_p, pa, pb, axis,
                            False, scale=sc)
            assert _rel(torch.cat([oa, ob], d),
                        torch.cat([ra, rb], d)) <= TOL
    assert _launched() == {'fft_axis2_p': 4}


# A64 by route (shape, axis, route): whole lines at 512 (a warp a line),
# 768 (24 points a thread, radix 3 first) and 1024 (a warp a line, 32
# points a thread) on the line kernel; an odd post at 512 and 1024 rows
# (the DNS's mid pass, post = 257, at a small size: single elements),
# lead axes of 512, 1024 and 768 rows (radix 3 first) and a mid axis of
# 768 rows (vectors of 2 columns) on the band kernel, clusters of two
# CTAs at 512 rows and four above; whole lines of 64 and 384 points, an
# odd post at 64 rows, lead axes of 128 and 96 rows and inner axes of 32
# and 48 points on the tile kernel
A64_ROUTES = [((3, 512), 1, 'lines'), ((5, 768), 1, 'lines'),
              ((3, 1024), 1, 'lines'), ((2, 512, 5), 1, 'band'),
              ((2, 1024, 3), 1, 'band'), ((512, 6), 0, 'band'),
              ((1024, 2), 0, 'band'), ((768, 3), 0, 'band'),
              ((2, 768, 2), 1, 'band'), ((9, 64), 1, 'tile'),
              ((3, 384), 1, 'tile'), ((4, 64, 5), 1, 'tile'),
              ((128, 4, 2), 0, 'tile'), ((96, 4), 0, 'tile'),
              ((2, 32, 5), 1, 'tile'), ((48, 4), 0, 'tile')]


def _hold_axis64(plain_ok, shape, axis):
    """fft_axis_p on float64 (both signs, a scale) against its plain
    version, and in place (out=p) bit for bit against out of place into
    a NaN-filled tensor; five launches."""
    rng = np.random.default_rng(22)
    p = torch.from_numpy(rng.standard_normal((2,) + shape))
    for fwd, sc in ((True, None), (False, None), (True, 0.37)):
        got = bf.fft_axis_p(p, axis, fwd, scale=sc)
        ref = _plain(plain_ok, bf.fft_axis_p, p, axis, fwd, scale=sc)
        assert got.dtype == torch.float64
        assert _rel(got, ref) <= TOL64, (fwd, sc)
    q = p.clone()
    assert bf.fft_axis_p(q, axis, False, scale=0.5, out=q) is q
    n = torch.full_like(p, float('nan'))
    bf.fft_axis_p(p, axis, False, scale=0.5, out=n)
    assert torch.equal(q, n)


@pytest.mark.parametrize('shape,axis,route', A64_ROUTES)
def test_axis64_lines_band_vs_plain(kernel_path, emu_kernels, shape, axis,
                                    route):
    """fft_axis_p on float64 on the kernel the rule picks by shape: the
    line kernel (__syncwarp calls), the band kernel (__ldcg loads and a
    cluster launch each) or the tile kernel (none of these)."""
    c0 = _routes(emu_kernels, 'fft_axis')
    _hold_axis64(kernel_path, shape, axis)
    d = _route_delta(c0, _routes(emu_kernels, 'fft_axis'))
    assert d['cluster_launches'] == (5 if route == 'band' else 0)
    assert (d['syncwarps'] > 0) == (route == 'lines')
    assert (d['ldcg_loads'] > 0) == (route == 'band')
    assert _launched() == {'fft_axis_p_f64': 5}


def test_axis64_misaligned(kernel_path, emu_kernels):
    """A float64 tensor that starts 8 bytes off a 16-byte boundary: whole
    lines take the tile kernel, a lead axis the band kernel's single
    elements; the same results."""
    rng = np.random.default_rng(23)
    for shape, axis, band in (((3, 512), 1, False), ((512, 4), 0, True)):
        m = int(np.prod(shape))
        flat = torch.from_numpy(rng.standard_normal(1 + 2 * m))
        p = flat[1:].view((2,) + shape)
        assert p.data_ptr() % 16 == 8
        c0 = _routes(emu_kernels, 'fft_axis')
        got = bf.fft_axis_p(p, axis, True, scale=0.25)
        d = _route_delta(c0, _routes(emu_kernels, 'fft_axis'))
        assert d['syncwarps'] == 0 and (d['ldcg_loads'] > 0) == band
        assert d['cluster_launches'] == (1 if band else 0)
        ref = _plain(kernel_path, bf.fft_axis_p, p, axis, True, scale=0.25)
        assert _rel(got, ref) <= TOL64
    assert _launched() == {'fft_axis_p_f64': 2}


# A (float32) by route (shape, axis, route): whole lines at 512, 768 (24
# points a thread, radix 3 first) and 1024 on the line kernel; an odd
# post at 768 and 1024 rows (the dealiased 'f' plan's mid pass, post =
# 257, at a small size: single elements, bands across pre rows), lead
# axes of 512, 1024 and 768 rows (radix 3 first) and mid axes of 768
# and 512 rows on the band kernel with vectors of 4 columns (clusters of
# four CTAs); whole lines of 64 and 384 points, lead axes of 128 and 96
# rows and an inner axis of 32 points on the tile kernel
A32_ROUTES = [((3, 512), 1, 'lines'), ((5, 768), 1, 'lines'),
              ((3, 1024), 1, 'lines'), ((2, 768, 5), 1, 'elements'),
              ((2, 1024, 3), 1, 'elements'), ((512, 8), 0, 'vectors'),
              ((1024, 4), 0, 'vectors'), ((768, 4), 0, 'vectors'),
              ((2, 768, 8), 1, 'vectors'), ((3, 512, 4), 1, 'vectors'),
              ((9, 64), 1, 'tile'), ((3, 384), 1, 'tile'),
              ((128, 4, 2), 0, 'tile'), ((96, 4), 0, 'tile'),
              ((2, 32, 5), 1, 'tile')]


def _hold_axis(plain_ok, shape, axis, dtype, tol, seed):
    """fft_axis_p (both signs, a scale) against its plain version, and in
    place (out=p) bit for bit against out of place into a NaN-filled
    tensor; five launches."""
    rng = np.random.default_rng(seed)
    p = torch.from_numpy(rng.standard_normal((2,) + shape).astype(dtype))
    for fwd, sc in ((True, None), (False, None), (True, 0.37)):
        got = bf.fft_axis_p(p, axis, fwd, scale=sc)
        ref = _plain(plain_ok, bf.fft_axis_p, p, axis, fwd, scale=sc)
        assert got.dtype == p.dtype
        assert _rel(got, ref) <= tol, (fwd, sc)
    q = p.clone()
    assert bf.fft_axis_p(q, axis, False, scale=0.5, out=q) is q
    n = torch.full_like(p, float('nan'))
    bf.fft_axis_p(p, axis, False, scale=0.5, out=n)
    assert torch.equal(q, n)
    return p.numel()


@pytest.mark.parametrize('shape,axis,route', A32_ROUTES)
def test_axis32_lines_band_vs_plain(kernel_path, emu_kernels, shape, axis,
                                    route):
    """fft_axis_p on float32 on the kernel the rule picks by shape: the
    line kernel (__syncwarp calls), the band kernel (a cluster launch
    each, its __ldcg loads one a 16-byte vector of each plane, or one an
    element) or the tile kernel (none of these)."""
    c0 = _routes(emu_kernels, 'fft_axis')
    numel = _hold_axis(kernel_path, shape, axis, np.float32, TOL, 24)
    d = _route_delta(c0, _routes(emu_kernels, 'fft_axis'))
    band = route in ('vectors', 'elements')
    assert d['cluster_launches'] == (5 if band else 0)
    assert (d['syncwarps'] > 0) == (route == 'lines')
    loads = {'vectors': 5 * numel // 4, 'elements': 5 * numel}
    assert d['ldcg_loads'] == loads.get(route, 0)
    assert _launched() == {'fft_axis_p': 5}


def test_axis32_misaligned(kernel_path, emu_kernels):
    """A float32 tensor that starts 4 bytes off a 16-byte boundary: whole
    lines take the tile kernel, a lead axis the band kernel's single
    elements; the same results."""
    rng = np.random.default_rng(25)
    for shape, axis, band in (((3, 1024), 1, False), ((768, 4), 0, True)):
        m = int(np.prod(shape))
        flat = torch.from_numpy(rng.standard_normal(1 + 2 * m)
                                .astype(np.float32))
        p = flat[1:].view((2,) + shape)
        assert p.data_ptr() % 16 == 4
        c0 = _routes(emu_kernels, 'fft_axis')
        got = bf.fft_axis_p(p, axis, True, scale=0.25)
        d = _route_delta(c0, _routes(emu_kernels, 'fft_axis'))
        assert d['syncwarps'] == 0
        assert d['ldcg_loads'] == (2 * m if band else 0)
        assert d['cluster_launches'] == (1 if band else 0)
        ref = _plain(kernel_path, bf.fft_axis_p, p, axis, True, scale=0.25)
        assert _rel(got, ref) <= TOL
    assert _launched() == {'fft_axis_p': 2}


# the cluster kernel of G (N = 1536 and 2048): lead rows over whole
# line groups and with a ragged post, mid rows over two clusters and with
# a cluster across two pre rows, last-axis whole lines, a ragged mid pass
# of one cluster
CLUSTER_SHAPES = [((2048, 8), 0), ((1536, 5), 0), ((2, 1536, 8), 1),
                  ((2, 2048, 4), 1), ((3, 2048), 1), ((2, 1536, 3), 1)]


@pytest.mark.parametrize('shape,axis', CLUSTER_SHAPES)
def test_pair_cluster_kernel_vs_plain(kernel_path, emu_kernels, shape,
                                      axis):
    """Both signs, a scale, views, the whole tensor and alias=True on the
    two-CTA cluster kernel, each launch a cluster launch."""
    c0 = _emu_count(emu_kernels, 'fft_axis2', 'emu_cluster_launches')
    _hold_pair(kernel_path, shape, axis)
    assert _emu_count(emu_kernels, 'fft_axis2',
                      'emu_cluster_launches') - c0 == 9


@pytest.mark.parametrize('N', [1536, 2048])
def test_pair_max_active_clusters(kernel_path, N):
    """The cluster query answers for the two lengths of the cluster pass
    (the emulation holds one cluster whose tile fits) and refuses
    others."""
    assert bf.pair_max_active_clusters(N) == 1
    with pytest.raises(ValueError):
        bf.pair_max_active_clusters(N // 2)


# the r2c on whole lines (the line kernel): W = N/2 of one thread (N =
# 4, 16), of a group of 2, 32 and 16 threads with radix 3 (N = 96, 768)
# and without (N = 512, 1024)
LINE_NS = [4, 16, 96, 512, 768, 1024]


def _hold_lines(plain_ok, emu_kernels, N, dtype, tol, seed):
    """rfft_axis_p on whole lines: hext, even (Nyquist fold) and odd
    trunc, the 3/2 rule's trunc = N//3 + 1, scales, on an input aligned to
    a packed point (a line-kernel launch each: __syncwarp calls) and on
    one an element off it (the tile kernel, held the same way)."""
    rng = np.random.default_rng(seed)
    nh = N // 2 + 1
    ev = nh - 1 if (nh - 1) % 2 == 0 else nh - 2
    od = nh - 1 if (nh - 1) % 2 == 1 else nh - 2
    flat = torch.from_numpy(rng.standard_normal(1 + 6 * N).astype(dtype))
    x = flat[:6 * N].view(2, 3, N)
    xm = flat[1:].view(2, 3, N)
    point = 2 * flat.element_size()
    assert x.data_ptr() % point == 0 and xm.data_ptr() % point != 0
    cases = ((None, None, None), (nh + 3, None, 0.5), (None, ev, None),
             (nh + 2, od, 2.0), (None, N // 3 + 1, 1.0 / N))
    for t, lines in ((x, True), (xm, False)):
        for hext, trunc, sc in cases:
            w0 = _emu_count(emu_kernels, 'rfft_axis', 'emu_syncwarps')
            got = bf.rfft_axis_p(t, 2, hext=hext, trunc=trunc, scale=sc)
            ran = _emu_count(emu_kernels, 'rfft_axis', 'emu_syncwarps') > w0
            ref = _plain(plain_ok, bf.rfft_axis_p, t, 2, hext=hext,
                         trunc=trunc, scale=sc)
            assert got.shape == ref.shape and got.dtype == t.dtype
            assert _rel(got, ref) <= tol, (hext, trunc, sc)
            assert ran == lines, (hext, trunc, sc)
    return 2 * len(cases)


@pytest.mark.parametrize('N', LINE_NS)
def test_rfft_lines_f64_vs_plain(kernel_path, emu_kernels, N):
    """rfft_axis_p on float64 whole lines, each case a line-kernel
    launch; an input 8 bytes off a 16-byte boundary takes the tile
    kernel."""
    n = _hold_lines(kernel_path, emu_kernels, N, np.float64, TOL64, 16)
    assert _launched() == {'rfft_axis_p_f64': n}


@pytest.mark.parametrize('N', LINE_NS)
def test_rfft_lines_f32_vs_plain(kernel_path, emu_kernels, N):
    """rfft_axis_p on float32 whole lines (one float2 a packed point),
    the cases of the float64 test; an input 4 bytes off an 8-byte
    boundary takes the tile kernel."""
    n = _hold_lines(kernel_path, emu_kernels, N, np.float32, TOL, 20)
    assert _launched() == {'rfft_axis_p': n}


def _c2r_into(emu_kernels, h, N, sc, y):
    """irfft_axis_p's C entry (packed; float64 or float32 as h) on the
    spectrum h (2, pre, hin) along its last axis, into the given output y
    (pre, N)."""
    tw = bf._tw_tensor(N, +1, True, h.dtype, h.device)
    plan, nst = bf._plan_args(N // 2)
    f64 = h.dtype == torch.float64
    fn = emu_kernels.irfft_axis_f64 if f64 else emu_kernels.irfft_axis_f32
    real = ctypes.c_double if f64 else ctypes.c_float
    rc = fn(ctypes.c_void_p(h.data_ptr()), ctypes.c_void_p(y.data_ptr()),
            ctypes.c_void_p(tw.data_ptr()), tw.shape[1], h.shape[1],
            h.shape[2], N, 1, 1, plan, nst,
            real(2.0 * (1.0 if sc is None else sc)), ctypes.c_void_p(0))
    assert rc == 0
    return y


def _hold_c2r_lines(plain_ok, emu_kernels, N, seed, dtype=np.float64,
                    tol=TOL64):
    """irfft_axis_p on whole lines (float64 by default): the full
    spectrum (hin = N//2 + 1) with and without a scale, shorter ones of
    even (the last row halved) and odd hin, the 3/2 rule's hin = N//3 +
    1, and a longer one (rows past N//2 + 1 ignored), on an input aligned
    to a packed point and on one an element off it (the spectrum is read
    an element at a time: a c2r line-kernel launch each, __syncwarp
    calls), and through the C entry into an output an element off a
    packed point (the tile kernel, held the same way).  The spectra are
    random, not Hermitian-consistent, so the hold covers the reading of
    the DC and Nyquist rows as real."""
    rng = np.random.default_rng(seed)
    nh = N // 2 + 1
    ev = nh - 1 if (nh - 1) % 2 == 0 else nh - 2
    od = nh - 1 if (nh - 1) % 2 == 1 else nh - 2
    cases = ((nh, None), (nh, 1.0 / N), (max(1, ev), None),
             (max(1, od), 0.25), (N // 3 + 1, 1.0 / N), (nh + 3, None))
    for hin, sc in cases:
        flat = torch.from_numpy(rng.standard_normal(1 + 6 * hin)
                                .astype(dtype))
        h = flat[:6 * hin].view(2, 3, hin)
        for t in (flat[1:].view(2, 3, hin), h):
            w0 = _emu_count(emu_kernels, 'rfft_axis', 'emu_syncwarps')
            got = bf.irfft_axis_p(t, 1, N, scale=sc)
            ran = _emu_count(emu_kernels, 'rfft_axis', 'emu_syncwarps') > w0
            ref = _plain(plain_ok, bf.irfft_axis_p, t, 1, N, scale=sc)
            assert got.shape == ref.shape == (3, N)
            assert got.dtype == t.dtype
            assert _rel(got, ref) <= tol, (hin, sc)
            assert ran, (hin, sc)
        ym = torch.full((1 + 3 * N,), float('nan'), dtype=h.dtype)[1:]
        assert ym.data_ptr() % (2 * ym.element_size()) != 0
        w0 = _emu_count(emu_kernels, 'rfft_axis', 'emu_syncwarps')
        got = _c2r_into(emu_kernels, h, N, sc, ym).view(3, N)
        assert _emu_count(emu_kernels, 'rfft_axis', 'emu_syncwarps') == w0
        assert _rel(got, ref) <= tol, (hin, sc)
    return 2 * len(cases)


@pytest.mark.parametrize('N', LINE_NS)
def test_irfft_lines_f64_vs_plain(kernel_path, emu_kernels, N):
    """irfft_axis_p on float64 whole lines, each case a c2r line-kernel
    launch, also on an input 8 bytes off a 16-byte boundary; an output 8
    bytes off it takes the tile kernel."""
    n = _hold_c2r_lines(kernel_path, emu_kernels, N, 26)
    assert _launched() == {'irfft_axis_p_f64': n}


@pytest.mark.parametrize('N', LINE_NS)
def test_irfft_lines_f32_vs_plain(kernel_path, emu_kernels, N):
    """irfft_axis_p on float32 whole lines (one float2 a packed point),
    the cases of the float64 test, each a c2r line-kernel launch, also on
    an input 4 bytes off an 8-byte boundary; an output 4 bytes off it
    takes the tile kernel.  Then a spectrum that is zero but for the
    imaginary parts of its DC and Nyquist rows: a real output has no
    component for them, so the line kernel, as its plain version,
    returns zeros."""
    n = _hold_c2r_lines(kernel_path, emu_kernels, N, 27, np.float32, TOL)
    h = torch.zeros((2, 3, N // 2 + 1))
    h[1, :, 0] = torch.tensor([1.0, -0.5, 0.25])
    h[1, :, N // 2] = torch.tensor([0.75, 2.0, -1.0])
    w0 = _emu_count(emu_kernels, 'rfft_axis', 'emu_syncwarps')
    got = bf.irfft_axis_p(h, 1, N)
    assert _emu_count(emu_kernels, 'rfft_axis', 'emu_syncwarps') > w0
    ref = _plain(kernel_path, bf.irfft_axis_p, h, 1, N)
    assert got.shape == ref.shape == (3, N)
    assert float(ref.abs().max()) == 0.0
    assert float(got.abs().max()) == 0.0
    assert _launched() == {'irfft_axis_p': n + 1}


# DCT-II and DCT-III in one pass (B's and C's bodies with the row map
# DctRows): packed lengths that 4 divides, W = N/2 of a group of 1, 2,
# 32 and 16 threads, with radix 3 (24, 48, 96, 768) and without
DCT_NS = [16, 24, 48, 96, 512, 768, 1024]


def _dct_into(emu_kernels, x, y, inverse):
    """The C entry of DCT-II (or DCT-III) on x (pre, N) along its last
    axis, into the given output y: any alignment."""
    N = x.shape[-1]
    tw = bf._tw_tensor_dct(N, 1 if inverse else -1, x.dtype, x.device)
    plan, nst = bf._plan_args(N // 2)
    fn = getattr(emu_kernels, ('dct3' if inverse else 'dct2') + '_axis_'
                 + ('f64' if x.dtype == torch.float64 else 'f32'))
    rc = fn(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(y.data_ptr()),
            ctypes.c_void_p(tw.data_ptr()), tw.shape[1], x.shape[0], N, 1,
            plan, nst, ctypes.c_void_p(0))
    assert rc == 0
    return y


def _hold_dct(plain_ok, emu_kernels, N, dtype, tol, seed):
    """dct2_axis_p and dct3_axis_p against their plain versions and
    scipy.fft.dct (types 2 and 3, unnormalized: FFTW's REDFT10 and
    REDFT01) on whole lines aligned to a packed point (the line kernels:
    __syncwarp calls), on an inner axis and on the middle one of three
    (the tile: none), on whole lines an element off a packed point
    (DCT-II's read takes the tile; DCT-III reads an element at a time and
    takes the line kernel), and through the C entries into an output an
    element off a packed point (DCT-III's tile).  Returns the launches
    of each wrapper."""
    import scipy.fft
    rng = np.random.default_rng(seed)
    flat = torch.from_numpy(rng.standard_normal(1 + 3 * N).astype(dtype))
    cases = ((flat[:3 * N].view(3, N), 1, True, True),
             (flat[1:].view(3, N), 1, False, True),
             (torch.from_numpy(rng.standard_normal((N, 6)).astype(dtype)),
              0, False, False),
             (torch.from_numpy(rng.standard_normal((2, N, 5))
                               .astype(dtype)), 1, False, False))
    assert cases[0][0].data_ptr() % (2 * flat.element_size()) == 0
    assert cases[1][0].data_ptr() % (2 * flat.element_size()) != 0
    for x, axis, lines2, lines3 in cases:
        for fn, t, lines in ((bf.dct2_axis_p, 2, lines2),
                             (bf.dct3_axis_p, 3, lines3)):
            w0 = _emu_count(emu_kernels, 'rfft_axis', 'emu_syncwarps')
            got = fn(x, axis)
            ran = _emu_count(emu_kernels, 'rfft_axis', 'emu_syncwarps') > w0
            ref = _plain(plain_ok, fn, x, axis)
            sp = torch.from_numpy(scipy.fft.dct(x.double().numpy(), type=t,
                                                axis=axis))
            assert got.shape == x.shape and got.dtype == x.dtype
            assert _rel(got, ref) <= tol, (t, axis)
            assert _rel(got, sp) <= tol, (t, axis)
            assert ran == lines, (t, axis)
    x = cases[0][0]
    ym = torch.full((1 + 3 * N,), float('nan'), dtype=x.dtype)[1:]
    for t in (2, 3):
        w0 = _emu_count(emu_kernels, 'rfft_axis', 'emu_syncwarps')
        got = _dct_into(emu_kernels, x, ym, t == 3).view(3, N)
        ran = _emu_count(emu_kernels, 'rfft_axis', 'emu_syncwarps') > w0
        sp = torch.from_numpy(scipy.fft.dct(x.double().numpy(), type=t))
        assert _rel(got, sp) <= tol, t
        assert ran == (t == 2), t
    return len(cases)


@pytest.mark.parametrize('N', DCT_NS)
def test_dct_lines_tile_f64_vs_plain(kernel_path, emu_kernels, N):
    """dct2_axis_p and dct3_axis_p on float64: one launch a call, the
    line kernel or the tile as the layout decides."""
    n = _hold_dct(kernel_path, emu_kernels, N, np.float64, TOL64, 28)
    assert _launched() == {'dct2_axis_p_f64': n, 'dct3_axis_p_f64': n}


@pytest.mark.parametrize('N', DCT_NS)
def test_dct_lines_tile_f32_vs_plain(kernel_path, emu_kernels, N):
    """dct2_axis_p and dct3_axis_p on float32 (one float2 a packed
    point), the cases of the float64 test."""
    n = _hold_dct(kernel_path, emu_kernels, N, np.float32, TOL, 29)
    assert _launched() == {'dct2_axis_p': n, 'dct3_axis_p': n}


def test_dct_refuses(kernel_path, emu_kernels):
    """A length that 4 does not divide or that no kernel takes raises,
    pointing at the engine; the C entries refuse such a length and a
    table too short to hold the DCT rows."""
    for N in (18, 20, 2048):
        with pytest.raises(ValueError, match='engine'):
            bf.dct2_axis_p(torch.zeros((2, N)), 1)
        with pytest.raises(ValueError, match='engine'):
            bf.dct3_axis_p(torch.zeros((N, 2)), 0)
    x = torch.zeros((2, 12))
    tw = bf._tw_tensor(12, -1, True, x.dtype, x.device)
    plan, nst = bf._plan_args(6)
    for n, tl in ((12, tw.shape[1]), (6, tw.shape[1] + 4)):
        rc = emu_kernels.dct2_axis_f32(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(x.data_ptr()),
            ctypes.c_void_p(tw.data_ptr()), tl, 2, n, 1, plan, nst,
            ctypes.c_void_p(0))
        assert rc != 0, n
    assert _launched() == {}


# real_route (shape, axis, n, dtype, aligned, route): the last axis is
# 'lines' whatever its length and alignment; inner axes of 512, 768 and
# 1024 (the c2r's spectrum side too) take the band where the dims after
# the axis hold whole 16-byte vectors (2 doubles, 4 floats) and both
# tensors are 16-byte aligned; other lengths, a ragged post and a
# misaligned tensor take the tile
REAL_ROUTES = [((512, 512, 512), 0, 512, torch.float64, True, 'band'),
               ((512, 512, 512), 1, 512, torch.float64, True, 'band'),
               ((512, 512, 512), 2, 512, torch.float64, True, 'lines'),
               ((257, 512, 512), 0, 512, torch.float64, True, 'band'),
               ((3, 1024), 1, 1024, torch.float64, False, 'lines'),
               ((768, 2), 0, 768, torch.float64, True, 'band'),
               ((2, 1024, 6), 1, 1024, torch.float64, True, 'band'),
               ((2, 1024, 6), 1, 1024, torch.float32, True, 'tile'),
               ((2, 1024, 8), 1, 1024, torch.float32, True, 'band'),
               ((512, 3), 0, 512, torch.float64, True, 'tile'),
               ((512, 4), 0, 512, torch.float64, False, 'tile'),
               ((256, 4), 0, 256, torch.float64, True, 'tile'),
               ((384, 8), 0, 384, torch.float32, True, 'tile'),
               ((2, 4), 0, 2, torch.float64, True, 'tile')]


@pytest.mark.parametrize('shape,axis,n,dtype,aligned,route', REAL_ROUTES)
def test_real_route(shape, axis, n, dtype, aligned, route):
    assert bf.real_route(shape, axis, n, dtype, aligned) == route


# the column band of the r2c, c2r, DCT-II and DCT-III on inner axes
# (dtype, N, layout): float64 and float32 at N = 512, 768 (a radix-3
# column stage first) and 1024, on a mid axis whose lines (36) leave a
# ragged last band that straddles pre rows (float64 16 columns at 512, 8
# at 768 and 1024; float32 32 and 16); then the tile, on a float64
# operand 8 bytes off a 16-byte boundary and at a length the band does
# not take (N = 256)
REAL_BAND = [(np.float64, 512, 'band'), (np.float64, 768, 'band'),
             (np.float64, 1024, 'band'), (np.float32, 512, 'band'),
             (np.float32, 768, 'band'), (np.float32, 1024, 'band'),
             (np.float64, 512, 'misaligned'), (np.float64, 256, 'length')]


def _band_operand(rng, dtype, N, layout, rows=None):
    """A (pre, rows, post) operand (rows = N by default; a planar one with
    a leading 2 when rows is given) of the REAL_BAND case, and its route:
    pre 2, post 18 in float64, pre 3, post 12 in float32; misaligned: 8
    bytes off a 16-byte boundary."""
    pre, post = (2, 18) if dtype == np.float64 else (3, 12)
    shape = ((pre, N, post) if rows is None else (2, pre, rows, post))
    m = int(np.prod(shape))
    flat = torch.from_numpy(rng.standard_normal(1 + m).astype(dtype))
    t = flat[1:] if layout == 'misaligned' else flat[:m]
    t = t.view(shape)
    assert (t.data_ptr() % 16 == 0) == (layout != 'misaligned')
    return t, ('band' if layout == 'band' else 'tile')


def _ran_band(emu_kernels, c0, route):
    """The kernels since the counters c0 of rfft_axis: __ldcg loads (the
    band) exactly when the route is 'band', and no __syncwarp (no line
    kernel)."""
    d = _route_delta(c0, _routes(emu_kernels, 'rfft_axis'))
    assert (d['ldcg_loads'] > 0) == (route == 'band'), (route, d)
    assert d['syncwarps'] == 0 and d['cluster_launches'] == 0, d


def _tols(dtype):
    return (TOL64, '_f64') if dtype == np.float64 else (TOL, '')


@pytest.mark.parametrize('dtype,N,layout', REAL_BAND)
def test_rfft_band_vs_plain(kernel_path, emu_kernels, dtype, N, layout):
    """rfft_axis_p on a mid axis: hext, an even (Nyquist fold) and an odd
    trunc, the 3/2 rule's trunc = N//3 + 1, scales, each a launch of the
    route real_route names (the band: __ldcg loads), against the plain
    version."""
    tol, sfx = _tols(dtype)
    rng = np.random.default_rng(40)
    x, route = _band_operand(rng, dtype, N, layout)
    assert bf.real_route(tuple(x.shape), 1, N, x.dtype,
                         layout != 'misaligned') == route
    nh = N // 2 + 1
    ev = nh - 1 if (nh - 1) % 2 == 0 else nh - 2
    od = nh - 1 if (nh - 1) % 2 == 1 else nh - 2
    cases = ((None, None, None), (nh + 3, None, 0.5), (None, ev, None),
             (nh + 2, od, 2.0), (None, N // 3 + 1, 1.0 / N))
    for hext, trunc, sc in cases:
        c0 = _routes(emu_kernels, 'rfft_axis')
        got = bf.rfft_axis_p(x, 1, hext=hext, trunc=trunc, scale=sc)
        _ran_band(emu_kernels, c0, route)
        ref = _plain(kernel_path, bf.rfft_axis_p, x, 1, hext=hext,
                     trunc=trunc, scale=sc)
        assert got.shape == ref.shape and got.dtype == x.dtype
        assert _rel(got, ref) <= tol, (hext, trunc, sc)
    assert _launched() == {'rfft_axis_p' + sfx: len(cases)}


@pytest.mark.parametrize('dtype,N,layout', REAL_BAND)
def test_irfft_band_vs_plain(kernel_path, emu_kernels, dtype, N, layout):
    """irfft_axis_p on a mid axis: random spectra (non-zero imaginary
    parts in the DC and Nyquist rows, read as real) of N//2 + 1 rows with
    and without a scale, shorter ones of even (the last row halved) and
    odd rows, the 3/2 rule's N//3 + 1 and a longer one (rows past
    N//2 + 1 ignored), each a launch of the route real_route names,
    against the plain version."""
    tol, sfx = _tols(dtype)
    rng = np.random.default_rng(41)
    nh = N // 2 + 1
    ev = nh - 1 if (nh - 1) % 2 == 0 else nh - 2
    od = nh - 1 if (nh - 1) % 2 == 1 else nh - 2
    cases = ((nh, None), (nh, 1.0 / N), (ev, None), (od, 0.25),
             (N // 3 + 1, 1.0 / N), (nh + 3, None))
    for hin, sc in cases:
        h, route = _band_operand(rng, dtype, N, layout, rows=hin)
        assert bf.real_route(tuple(h.shape[1:]), 1, N, h.dtype,
                             layout != 'misaligned') == route
        c0 = _routes(emu_kernels, 'rfft_axis')
        got = bf.irfft_axis_p(h, 1, N, scale=sc)
        _ran_band(emu_kernels, c0, route)
        ref = _plain(kernel_path, bf.irfft_axis_p, h, 1, N, scale=sc)
        assert got.shape == ref.shape and got.dtype == h.dtype
        assert _rel(got, ref) <= tol, (hin, sc)
    assert _launched() == {'irfft_axis_p' + sfx: len(cases)}


def _hold_dct_band(plain_ok, emu_kernels, fn, t, dtype, N, layout):
    """dct2_axis_p (t = 2) or dct3_axis_p (t = 3) on a mid axis, a launch
    of the route real_route names, against its plain version and
    scipy.fft.dct; the same on a lead axis (pre 1) when the layout takes
    the band."""
    import scipy.fft
    tol, sfx = _tols(dtype)
    rng = np.random.default_rng(42 + t)
    x, route = _band_operand(rng, dtype, N, layout)
    xs = [(x, 1)]
    if layout == 'band':
        xs.append((x.reshape(-1, N, x.shape[2])[0].contiguous(), 0))
    for v, axis in xs:
        assert bf.real_route(tuple(v.shape), axis, N, v.dtype,
                             layout != 'misaligned') == route
        c0 = _routes(emu_kernels, 'rfft_axis')
        got = fn(v, axis)
        _ran_band(emu_kernels, c0, route)
        ref = _plain(plain_ok, fn, v, axis)
        sp = torch.from_numpy(scipy.fft.dct(v.double().numpy(), type=t,
                                            axis=axis))
        assert got.shape == v.shape and got.dtype == v.dtype
        assert _rel(got, ref) <= tol, axis
        assert _rel(got, sp) <= tol, axis
    assert _launched() == {f'dct{t}_axis_p' + sfx: len(xs)}


@pytest.mark.parametrize('dtype,N,layout', REAL_BAND)
def test_dct2_band_vs_plain(kernel_path, emu_kernels, dtype, N, layout):
    """dct2_axis_p on inner axes: the r2c's band with Makhoul's order in
    its read and the twiddle combine in its write."""
    _hold_dct_band(kernel_path, emu_kernels, bf.dct2_axis_p, 2, dtype, N,
                   layout)


@pytest.mark.parametrize('dtype,N,layout', REAL_BAND)
def test_dct3_band_vs_plain(kernel_path, emu_kernels, dtype, N, layout):
    """dct3_axis_p on inner axes: the c2r's band with the combine of y[k]
    and y[N-k] in its read and the inverse Makhoul order in its write."""
    _hold_dct_band(kernel_path, emu_kernels, bf.dct3_axis_p, 3, dtype, N,
                   layout)


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


# E64 by route (shape of the N-row side, axis, Nt, route of the
# truncation, route of the padding): at N = 768 a lead axis with vectors
# of two columns, a mid axis (single elements), an odd Nt and an even Nt
# whose folded rows fall in different CTAs (N - Nt = 258, not a multiple
# of the cluster's 4: the truncation takes the tile; the padding, whose
# split row each CTA reads itself, the band) on the band kernel; whole
# lines and other lengths on the tile
TP64_ROUTES = [((768, 4), 0, 512, 'vectors', 'vectors'),
               ((2, 768, 3), 1, 512, 'elements', 'elements'),
               ((768, 2), 0, 511, 'vectors', 'vectors'),
               ((768, 2), 0, 510, 'tile', 'vectors'),
               ((3, 768), 1, 512, 'tile', 'tile'),
               ((96, 4), 0, 64, 'tile', 'tile')]


def _tp_loads(route, rows, lines, V):
    """__ldcg loads of a band pass that reads `rows` rows of `lines`
    lines, both planes: one a 16-byte vector of V columns, or one an
    element; none on the line kernel or the tile."""
    per = {'vectors': 2 * rows * lines // V, 'elements': 2 * rows * lines}
    return per.get(route, 0)


def _hold_tp_routes(plain_ok, emu_kernels, shape, axis, nt, routes, p, q,
                    tol):
    """fft_axis_tp with trunc (forward) and pad (backward), each with and
    without a scale, on p (N rows) and q (nt rows), against the plain
    version, each call on the route given for its direction: the band
    kernel (a cluster launch and the __ldcg loads of the rows its map
    reads: the padding reads each kept row once, the split row of an even
    nt twice, and no zero row), the line kernel (__syncwarp calls, no
    cluster launch, no __ldcg load) or the tile (none of these)."""
    N = shape[axis]
    lines = p.numel() // 2 // N
    V = 16 // p.element_size()
    reads = {'trunc': N, 'pad': nt + (1 - nt % 2)}
    for mode, route in zip(('trunc', 'pad'), routes):
        for sc in (None, 1.0 / N):
            kw = {mode: nt if mode == 'trunc' else N, 'scale': sc}
            x, fwd = (p, True) if mode == 'trunc' else (q, False)
            c0 = _routes(emu_kernels, 'fft_axis_tp')
            got = bf.fft_axis_tp(x, axis, fwd, **kw)
            d = _route_delta(c0, _routes(emu_kernels, 'fft_axis_tp'))
            ref = _plain(plain_ok, bf.fft_axis_tp, x, axis, fwd, **kw)
            assert got.shape == ref.shape and got.dtype == x.dtype
            assert _rel(got, ref) <= tol, (mode, sc)
            band = route in ('vectors', 'elements')
            assert d['cluster_launches'] == int(band), (mode, sc)
            assert d['ldcg_loads'] == _tp_loads(route, reads[mode], lines,
                                                V), (mode, sc)
            assert (d['syncwarps'] > 0) == (route == 'lines'), (mode, sc)


def _tp_inputs(shape, axis, nt, dtype, seed):
    rng = np.random.default_rng(seed)
    sh = list(shape)
    sh[axis] = nt
    p = torch.from_numpy(rng.standard_normal((2,) + shape).astype(dtype))
    q = torch.from_numpy(rng.standard_normal([2] + sh).astype(dtype))
    return p, q


@pytest.mark.parametrize('shape,axis,nt,trunc_route,pad_route', TP64_ROUTES)
def test_tp64_band_vs_plain(kernel_path, emu_kernels, shape, axis, nt,
                            trunc_route, pad_route):
    """fft_axis_tp on float64 on the kernel the rule picks by shape: at
    N = 768 on an inner axis the column band kernel (a cluster launch, its
    loads one a vector or one an element, the row map in its read or its
    write), else the tile (whole lines included)."""
    p, q = _tp_inputs(shape, axis, nt, np.float64, 28)
    _hold_tp_routes(kernel_path, emu_kernels, shape, axis, nt,
                    (trunc_route, pad_route), p, q, TOL64)
    assert _launched() == {'fft_axis_tp_f64': 4}


def _misaligned(t):
    """A copy of t that starts one element past a 16-byte boundary."""
    m = torch.empty(1 + t.numel(), dtype=t.dtype)[1:].view(t.shape)
    m.copy_(t)
    assert m.data_ptr() % 16 == t.element_size()
    return m


def test_tp64_band_misaligned(kernel_path, emu_kernels):
    """E64 at N = 768 on a lead axis whose tensors start 8 bytes off a
    16-byte boundary: the band kernel's single elements, the same
    results."""
    shape, axis, nt = (768, 4), 0, 512
    p, q = _tp_inputs(shape, axis, nt, np.float64, 29)
    _hold_tp_routes(kernel_path, emu_kernels, shape, axis, nt,
                    ('elements', 'elements'), _misaligned(p),
                    _misaligned(q), TOL64)
    assert _launched() == {'fft_axis_tp_f64': 4}


# E (float32) by route (shape of the N-row side, axis, Nt, route of the
# truncation, route of the padding).  At N = 768 on inner axes the band
# kernel: a lead axis with vectors of four columns (post 8; post 36, a
# ragged second band of 32 columns), a mid axis with vectors (post 8), a
# mid axis of odd post (single elements, bands across pre rows), post 2
# (single elements) with an odd Nt, and an even Nt whose folded rows fall
# in different CTAs (N - Nt = 258: the truncation takes the tile, the
# padding the band).  Whole lines at N = 768 on the line kernel where h'
# = Nt/2 and N - Nt are multiples of 4: Nt = 512 (the 3/2 rule: the split
# vectors at rows 256 and 512 and the fold at output row 256), Nt = 200
# (h' = 100, output vectors past Nt skipped) and Nt = 8; whole lines
# whose Nt breaks that rule (N - Nt = 258; h' = 258 with N - Nt = 252;
# odd Nt) and other lengths on the tile.  The first six shapes are
# test_tp64_band_vs_plain's.
TP32_ROUTES = [((768, 8), 0, 512, 'vectors', 'vectors'),
               ((2, 768, 3), 1, 512, 'elements', 'elements'),
               ((768, 2), 0, 511, 'elements', 'elements'),
               ((768, 2), 0, 510, 'tile', 'elements'),
               ((3, 768), 1, 512, 'lines', 'lines'),
               ((96, 4), 0, 64, 'tile', 'tile'),
               ((768, 36), 0, 512, 'vectors', 'vectors'),
               ((2, 768, 8), 1, 512, 'vectors', 'vectors'),
               ((5, 768), 1, 200, 'lines', 'lines'),
               ((2, 3, 768), 2, 8, 'lines', 'lines'),
               ((2, 768), 1, 510, 'tile', 'tile'),
               ((2, 768), 1, 516, 'tile', 'tile'),
               ((2, 768), 1, 511, 'tile', 'tile'),
               ((3, 1024), 1, 683, 'tile', 'tile')]


@pytest.mark.parametrize('shape,axis,nt,trunc_route,pad_route', TP32_ROUTES)
def test_tp32_lines_band_vs_plain(kernel_path, emu_kernels, shape, axis, nt,
                                  trunc_route, pad_route):
    """fft_axis_tp on float32 on the kernel the rule picks by shape: at
    N = 768 the column band kernel on inner axes (a cluster launch, its
    loads one a 16-byte vector of four columns or one an element, the row
    map in its read or its write) and the line kernel on whole lines
    (__syncwarp calls, the map in its vector read or write), else the
    tile.  (The float32 half of test_tp64_band_vs_plain, which held
    float32 E on the tile at its shapes, moved here.)"""
    p, q = _tp_inputs(shape, axis, nt, np.float32, 28)
    _hold_tp_routes(kernel_path, emu_kernels, shape, axis, nt,
                    (trunc_route, pad_route), p, q, TOL)
    assert _launched() == {'fft_axis_tp': 4}


def test_tp32_misaligned(kernel_path, emu_kernels):
    """E at N = 768 on tensors that start 4 bytes off a 16-byte boundary:
    a lead axis takes the band kernel's single elements, whole lines the
    tile; the same results."""
    for shape, axis, route in (((768, 8), 0, 'elements'),
                               ((3, 768), 1, 'tile')):
        p, q = _tp_inputs(shape, axis, 512, np.float32, 30)
        _hold_tp_routes(kernel_path, emu_kernels, shape, axis, 512,
                        (route, route), _misaligned(p), _misaligned(q), TOL)
    assert _launched() == {'fft_axis_tp': 8}


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


# J (fft2stage.cu): every S, both signs, line counts that leave warps of
# the last block without a line (13, 5, 22, 18, 13, 11, 10 and 6 lines,
# four warps a block), one line, and leading dims that flatten
J_SHAPES = [((13, 128), 1), ((5, 256), 2), ((22, 384), 3), ((3, 6, 512), 4),
            ((13, 640), 5), ((11, 768), 6), ((10, 896), 7), ((1, 1024), 8),
            ((2, 3, 1024), 8), ((2, 3, 768), 6)]

def _j_warp_syncs(S):
    """The __syncwarp() calls of one line: after stage 1, after the
    radix-16 stage, between the radix-8 stage's butterflies of a lane
    (16 S of them over 32 lanes), and after its reads and its writes."""
    return 3 + (16 * S + 31) // 32



@pytest.mark.parametrize('shape,S', J_SHAPES)
def test_fft2stage_kernel_vs_plain(kernel_path, emu_kernels, shape, S):
    """The line kernel, a warp a line: every lane of every warp that has a
    line meets each of its __syncwarp() barriers, and no other warp
    does."""
    from mpi4py_fft_torch.ops import fft2stage
    rng = np.random.default_rng(14)
    p = torch.from_numpy(rng.standard_normal((2,) + shape)
                         .astype(np.float32))
    assert shape[-1] == 128 * S
    lines = int(np.prod(shape[:-1]))
    for sign in (-1, +1):
        w0 = _emu_count(emu_kernels, 'fft2stage', 'emu_syncwarps')
        got = fft2stage.fft2stage_p(p, sign)
        syncs = _emu_count(emu_kernels, 'fft2stage', 'emu_syncwarps') - w0
        ref = _plain(kernel_path, fft2stage.fft2stage_p, p, sign)
        assert got.shape == p.shape and got.dtype == p.dtype
        assert _rel(got, ref) <= TOL, sign
        assert syncs == lines * 32 * _j_warp_syncs(S), sign
    assert _launched() == {'fft2stage_p': 2}


def test_misaligned_inputs_are_copied(kernel_path):
    """J and H load 16-byte vectors: an input whose storage starts 4
    bytes off a 16-byte boundary is copied first, with the same result."""
    from mpi4py_fft_torch.ops import fft2stage
    rng = np.random.default_rng(19)
    flat = torch.from_numpy(rng.standard_normal(1 + 2 * 3 * 640)
                            .astype(np.float32))
    p = flat[1:].view(2, 3, 640)
    assert p.data_ptr() % 16 == 4
    got = fft2stage.fft2stage_p(p, -1)
    assert _rel(got, _plain(kernel_path, fft2stage.fft2stage_p, p, -1)) \
        <= TOL
    flat = torch.from_numpy(rng.standard_normal(1 + 2 * 3 * 16 * 32)
                            .astype(np.float32))
    q = flat[1:].view(2, 3, 16, 32)
    got = bf.fft_plane_p(q, False, scale=0.5)
    assert _rel(got, _plain(kernel_path, bf.fft_plane_p, q, False,
                            scale=0.5)) <= TOL
    assert _launched() == {'fft2stage_p': 1, 'fft_plane_p': 1}


@pytest.fixture
def plane_entries(emu_kernels, monkeypatch):
    """Calls of the plane-holding C entry and of the one that launches the
    row line and column band kernels."""
    calls = {'hold': 0, 'large': 0}
    for key, name in (('hold', 'fft_plane_f32'),
                      ('large', 'fft_plane_large_f32')):
        fn = getattr(emu_kernels, name)

        def spy(*args, _fn=fn, _key=key):
            calls[_key] += 1
            return _fn(*args)

        monkeypatch.setattr(emu_kernels, name, spy)
    return calls


# H and I (fft_plane.cu): square and oblong planes, N = 2 on either
# axis, planes smaller than one tile, the 256 x 256 plane of H, a
# 1024-long axis, one plane and several; I's thin and oblong planes:
# rows of 8 points a thread each under a 1024-row band, 1024-point rows
# (a warp a row) over 8-row bands, 64-point rows of a two-thread group
# under 512-row bands of 16 columns, and 1024-row bands of 16 columns on
# clusters of 2 CTAs
PLANE_SHAPES = [(3, 32, 64), (2, 256, 256), (4, 8, 2), (1, 2, 1024),
                (2, 1024, 4), (2, 3, 16, 16), (1, 1024, 8), (1, 8, 1024),
                (1, 512, 64), (1, 1024, 32)]


@pytest.mark.parametrize('shape', PLANE_SHAPES)
def test_plane_kernel_vs_plain(kernel_path, emu_kernels, plane_entries,
                               shape):
    """fft_plane_p where H's gate takes the plane, and fft_plane_large_p
    always: both signs, with and without a scale.  The route is by shape:
    planes of H's gate on the plane-holding kernel from either entry (a
    cluster launch each when the plane is larger than 8192 points), I's
    larger planes on the row line and column band kernels (one C entry,
    one counted launch a call; the band a cluster launch when the plane
    has 1024 rows of 16 points or more)."""
    rng = np.random.default_rng(15)
    p = torch.from_numpy(rng.standard_normal((2,) + shape)
                         .astype(np.float32))
    h = bf.supported_plane(shape, np.float32)
    assert bf.supported_plane_large(shape, np.float32)
    c0 = _emu_count(emu_kernels, 'fft_plane', 'emu_cluster_launches')
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
    assert plane_entries == ({'hold': 6, 'large': 0} if h else
                             {'hold': 0, 'large': 3})
    clusters = _emu_count(emu_kernels, 'fft_plane',
                          'emu_cluster_launches') - c0
    band_clusters = not h and shape[-2] == 1024 and shape[-1] >= 16
    assert clusters == (6 if h and shape[-1] * shape[-2] > 8192 else
                        3 if band_clusters else 0)


# H's plane-holding kernel (shape, CTAs a plane): one-CTA planes with
# several planes a CTA and a ragged last CTA (T = 2 over 5 planes, T = 16
# over 7, T = 2048 over 9), clusters of the smallest K on oblong planes
# (rows of 256 and of 64 points), K = 4, and the largest K on one
# 256 x 256 plane
HOLD_SHAPES = [((5, 64, 64), 1), ((7, 16, 32), 1), ((9, 2, 2), 1),
               ((2, 64, 256), 2), ((1, 256, 64), 2), ((1, 256, 128), 4),
               ((1, 256, 256), 8)]


@pytest.mark.parametrize('shape,K', HOLD_SHAPES)
def test_plane_hold_kernel_vs_plain(kernel_path, emu_kernels, plane_entries,
                                    shape, K):
    """fft_plane_p on the plane-holding kernel: both signs and a scale,
    one cluster launch a call when a plane takes K > 1 CTAs."""
    rng = np.random.default_rng(18)
    p = torch.from_numpy(rng.standard_normal((2,) + shape)
                         .astype(np.float32))
    assert bf.plane_max_active_clusters(*shape[-2:])[0] == K
    c0 = _emu_count(emu_kernels, 'fft_plane', 'emu_cluster_launches')
    for fwd, sc in ((True, None), (False, None), (False, 0.37)):
        got = bf.fft_plane_p(p, fwd, scale=sc)
        ref = _plain(kernel_path, bf.fft_plane_p, p, fwd, scale=sc)
        assert got.shape == p.shape and got.dtype == p.dtype
        assert _rel(got, ref) <= TOL, (fwd, sc)
    assert _launched() == {'fft_plane_p': 3}
    assert plane_entries == {'hold': 3, 'large': 0}
    assert _emu_count(emu_kernels, 'fft_plane', 'emu_cluster_launches') \
        - c0 == (3 if K > 1 else 0)


@pytest.mark.parametrize('N1,N2,K', [(64, 64, 1), (256, 64, 2),
                                     (256, 256, 8)])
def test_plane_max_active_clusters(kernel_path, N1, N2, K):
    """The occupancy query of the plane-holding kernel: K and one cluster
    (K > 1) or one block on each of the emulated device's two SMs; a
    plane beyond H's gate is refused."""
    assert bf.plane_max_active_clusters(N1, N2) == (K, 1 if K > 1 else 2)
    with pytest.raises(ValueError):
        bf.plane_max_active_clusters(N1, 512)


def test_plane_entry_refuses(emu_kernels):
    """The plane-holding kernel's C entry refuses an axis above 256 or not
    a power of two, a sign other than +-1, and an input or output off a
    16-byte boundary, before any launch."""
    x = torch.zeros(2 * 256 * 256 + 4)
    y = torch.zeros_like(x)
    tw = bf._tw_tensor_powers(256, -1, torch.float32, x.device)

    def call(xp, yp, n1, n2, sign=-1):
        t = ctypes.c_void_p(tw.data_ptr())
        return emu_kernels.fft_plane_f32(
            ctypes.c_void_p(xp), ctypes.c_void_p(yp), t, t, 1, n1, n2, sign,
            1.0, ctypes.c_void_p(0))

    xb, yb = x.data_ptr(), y.data_ptr()
    assert xb % 16 == 0 and yb % 16 == 0
    for args in ((xb, yb, 512, 256), (xb, yb, 256, 96), (xb, yb, 1, 256),
                 (xb, yb, 256, 256, 0), (xb + 4, yb, 256, 256),
                 (xb, yb + 8, 64, 64)):
        assert call(*args) != 0, args
    assert bf.LAUNCHES['fft_plane_p'] == 0
