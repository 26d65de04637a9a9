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
