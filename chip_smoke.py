#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (``mpi4py_fft_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. build     the kernels from ``mpi4py_fft_torch/ops/csrc`` with nvcc;
2. holds     every kernel against its plain PyTorch version on the card
             (relative L2 <= 5e-6), the pair kernels at lead, mid and last
             positions for N up to 2048;
3. entry     the port's ``entry()``: a 64^3 r2c f32 forward;
4. north     ``PlanarPFFT(None, (1024,)*3, dtype='F')``: normalized
             forward and backward against ``torch.fft.fftn`` (oracle only)
             and the round trip (relative L2 <= 5e-5), 3 ``fft_axis_p``
             launches per transform;
5. quartered the same plan on its quartered schedule (``forward_fn_q``/
             ``backward_fn_q`` on ``oop3d.split_q`` quarters): against the
             unquartered forward and ``torch.fft.fftn``, the round trip,
             4 ``fft_axis_p`` + 4 ``fft_axis2_p`` launches per transform,
             and the schedule's peak device memory;
6. long      ``PlanarPFFT`` at (2048, 1024, 512) (one ``fft_axis_pair_p``
             pass on axis 0) and (4096, 1024, 256) (the four-step around
             ``fft_axis_p`` on axis 0): forward against ``torch.fft.fftn``
             and the round trip;
7. dealias   ``PlanarPFFT(None, (512,)*3, dtype='f', padding=1.5)`` (a
             768^3 grid): the kernel path against the port's plain path on
             the card and the forward against a ``torch.fft.rfftn`` oracle;
8. times     each kernel at the main path's shapes (CUDA events, median of
             7 after 2 warm-ups) beside its plain version, the one PyTorch
             call that computes the same function, and its bound; and the
             end-to-end 1024^3 c2c transform, unquartered and quartered.
             Every main-path shape of a kernel is also held against its
             plain version at <= 5e-6, and so are the pair kernels at the
             N = 2048 passes of every axis position.

Phases 3 to 7 are the main path: the launch counters are set to 0 just
before phase 3 and read after phase 7.  Each phase prints one JSON line;
then come the ``{"kernels": [...]}`` line, the card's name and power limit
from nvidia-smi, and last ``{"ok": true, "device": {...}}``.  Without a
CUDA device the script prints no result and exits with 1.
"""
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

SEED = 0
# H100 SXM data sheet at 700 W: HBM3 bandwidth and non-tensor f32 peak
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
KERNEL_TOL = 5e-6          # one kernel against its plain version
PIPE_TOL = 5e-5            # a 3-axis composition
NORTH_N = 1024             # the c2c north star, NORTH_N^3
DEALIAS_N = 512            # the r2c 3/2-rule plan, on a (1.5 DEALIAS_N)^3 grid
# the long-axis plans: 8.6 GB planar volumes like the north star's
LONG_SHAPES = ((2048, 1024, 512), (4096, 1024, 256))
# fft_axis_pair_p held at N = 2048 on every axis position (the first is
# the lead pass of LONG_SHAPES[0], the one timed)
PAIR_SHAPES = (((2048, 1024, 512), 0), ((512, 2048, 1024), 1),
               ((512, 1024, 2048), 2))


def _emit(obj):
    print(json.dumps(obj), flush=True)


def _check(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def _smi():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60)
    _check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def _rel(a, b, chunk=64):
    """Relative L2 error of a against b and their max abs difference, in
    chunks along the first dim past a planar one, so that no full-size
    temporary is made."""
    dim = 1 if a.dim() > 1 and a.shape[0] == 2 else 0
    num = den = 0.0
    mx = 0.0
    for i in range(0, a.shape[dim], chunk):
        d = (a.narrow(dim, i, min(chunk, a.shape[dim] - i))
             - b.narrow(dim, i, min(chunk, b.shape[dim] - i))).double()
        num += float((d * d).sum())
        mx = max(mx, float(d.abs().max()))
        bb = b.narrow(dim, i, min(chunk, b.shape[dim] - i)).double()
        den += float((bb * bb).sum())
    return math.sqrt(num / den), mx


def _median_ms(fn, reps=7, warm=2):
    for _ in range(warm):
        fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


@contextlib.contextmanager
def _plain_path(bf):
    """Run the port's pipeline with every kernel wrapper replaced by its
    plain version (the plain path on the card)."""
    saved = bf.fft_axis_p, bf.rfft_axis_p, bf.irfft_axis_p
    bf.fft_axis_p = bf.fft_axis_plain
    bf.rfft_axis_p = bf.rfft_axis_plain
    bf.irfft_axis_p = bf.irfft_axis_plain
    try:
        yield
    finally:
        bf.fft_axis_p, bf.rfft_axis_p, bf.irfft_axis_p = saved


def _delta(c0, c1):
    """Launches between two snapshots of the counters, nonzero only."""
    return {k: c1[k] - c0[k] for k in c0 if c1[k] != c0[k]}


def _rand(shape, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand(shape, generator=g, device=dev) - 0.5


def _fftn_ref(x):
    """torch.fft.fftn of planar x, normalized, as planar (the oracle)."""
    F = torch.fft.fftn(torch.complex(x[0], x[1]))
    F /= float(F.numel())
    return torch.view_as_real(F).permute(-1, *range(F.dim()))


def _bound_ms(nbytes, flops):
    tb, tf = nbytes / PEAK_BYTES_S, flops / PEAK_F32_S
    return 1e3 * max(tb, tf), 'bytes' if tb >= tf else 'operations'


class Holds:
    """Largest errors of each kernel against its plain version."""

    def __init__(self, names):
        self.err = {k: 0.0 for k in names}
        self.rel = dict(self.err)

    def hold(self, name, got, ref, what):
        torch.cuda.synchronize()
        r, m = _rel(got, ref)
        self.err[name] = max(self.err[name], m)
        self.rel[name] = max(self.rel[name], r)
        _check(bool(torch.isfinite(got).all()), f"{what}: non-finite")
        _check(r <= KERNEL_TOL, f"{what}: rel L2 {r:.3e} > {KERNEL_TOL}")


def phase_build():
    from mpi4py_fft_torch.ops import _build
    t0 = time.perf_counter()
    _build.load()
    secs = time.perf_counter() - t0
    ptxas = [ln.strip() for out in _build.LOG.values()
             for ln in out.splitlines()
             if 'registers' in ln or 'spill' in ln or 'Compiling' in ln]
    _emit({'phase': 'build', 'seconds': secs, 'ptxas': ptxas})
    print(_smi(), flush=True)


def phase_holds(holds, dev):
    """Each kernel against its plain version at small shapes, every axis
    position, both signs, scales, a ragged shape, hext/trunc and short
    and long c2r inputs."""
    from mpi4py_fft_torch.ops import butterfly as bf
    g = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    n = 0
    for N in (2, 8, 96, 256, 768, 1024):
        for shape, ax in (((N, 24, 40), 0), ((6, N, 40), 1), ((50, N), 1)):
            p = rnd(2, *shape)
            for fwd, sc in ((True, None), (False, None), (True, 1.0 / N)):
                holds.hold('fft_axis_p', bf.fft_axis_p(p, ax, fwd, scale=sc),
                           bf.fft_axis_plain(p, ax, fwd, scale=sc),
                           f"fft_axis_p {shape} axis {ax} fwd={fwd}")
                n += 1
    p = rnd(2, 3, 96, 5)
    for fwd in (True, False):
        holds.hold('fft_axis_p', bf.fft_axis_p(p, 1, fwd),
                   bf.fft_axis_plain(p, 1, fwd), "fft_axis_p (3, 96, 5)")
        n += 1
    for shape, ax in (((40, 768), 1), ((768, 3, 20), 0), ((5, 64, 33), 1),
                      ((7, 2), 1), ((3, 96, 5), 1)):
        x = rnd(*shape)
        N = shape[ax]
        nh = N // 2 + 1
        for hext, trunc, sc in ((None, None, None), (nh + 5, None, 0.5),
                                (None, max(1, nh - 2), None),
                                (nh + 1, max(1, nh - 3), 2.0)):
            holds.hold('rfft_axis_p',
                       bf.rfft_axis_p(x, ax, hext=hext, trunc=trunc,
                                      scale=sc),
                       bf.rfft_axis_plain(x, ax, hext=hext, trunc=trunc,
                                          scale=sc),
                       f"rfft_axis_p {shape} axis {ax} hext={hext} "
                       f"trunc={trunc}")
            n += 1
        for hin, sc in ((nh, None), (max(1, nh - 2), None),
                        (max(1, nh - 1), 0.25), (nh + 3, None)):
            sh = list(shape)
            sh[ax] = hin
            h = rnd(2, *sh)
            holds.hold('irfft_axis_p', bf.irfft_axis_p(h, ax, N, scale=sc),
                       bf.irfft_axis_plain(h, ax, N, scale=sc),
                       f"irfft_axis_p {tuple(sh)} axis {ax} n={N}")
            n += 1
    # the pair kernels: halves sliced out of one tensor (views, strided
    # off axis 0), the whole tensor, and contiguous halves aliased
    for N in (4, 6, 96, 1024, 1536, 2048):
        for shape, ax in (((N, 24, 40), 0), ((6, N, 40), 1), ((50, N), 1)):
            p = rnd(2, *shape)
            d, h = 1 + ax, N // 2
            pa, pb = p.narrow(d, 0, h), p.narrow(d, h, h)
            for fwd, sc in ((True, None), (False, None), (True, 1.0 / N)):
                what = f"{shape} axis {ax} fwd={fwd}"
                holds.hold('fft_axis2_p',
                           torch.cat(bf.fft_axis2_p(pa, pb, ax, fwd,
                                                    scale=sc), d),
                           torch.cat(bf.fft_axis2_plain(pa, pb, ax, fwd,
                                                        scale=sc), d),
                           f"fft_axis2_p {what}")
                holds.hold('fft_axis_pair_p',
                           bf.fft_axis_pair_p(p, ax, fwd, scale=sc),
                           bf.fft_axis_pair_plain(p, ax, fwd, scale=sc),
                           f"fft_axis_pair_p {what}")
                n += 2
            ca, cb = pa.contiguous(), pb.contiguous()
            ga, gb = bf.fft_axis2_p(ca, cb, ax, alias=True)
            _check(ga is ca and gb is cb, "alias=True returned new tensors")
            holds.hold('fft_axis2_p', torch.cat([ga, gb], d),
                       torch.cat(bf.fft_axis2_plain(pa, pb, ax), d),
                       f"fft_axis2_p {shape} axis {ax} alias")
            n += 1
    _emit({'phase': 'holds', 'cases': n, 'max_rel_l2': holds.rel,
           'max_abs_err': holds.err, 'tolerance': KERNEL_TOL})


def phase_entry(dev):
    from mpi4py_fft_torch import entry
    fn, (x,) = entry()
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.rand(x.shape, generator=g, device=dev) - 0.5
    y = fn(x)
    torch.cuda.synchronize()
    _check(tuple(y.shape) == (2, 64, 64, 33), f"entry shape {y.shape}")
    _check(bool(torch.isfinite(y).all()), "entry: non-finite")
    ref = torch.fft.rfftn(x) / x.numel()
    r, _ = _rel(y, torch.stack([ref.real, ref.imag]))
    _check(r <= PIPE_TOL, f"entry vs rfftn oracle: {r:.3e}")
    _emit({'phase': 'entry', 'shape': list(y.shape), 'rel_l2_oracle': r})


def phase_north(dev, bf):
    from mpi4py_fft_torch import PlanarPFFT
    n = NORTH_N
    pfft = PlanarPFFT(None, (n,) * 3, dtype='F')
    x = _rand((2, n, n, n), dev, SEED + 2)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    a0 = bf.LAUNCHES['fft_axis_p']
    t0 = time.perf_counter()
    y = pfft.forward(x, normalize=True)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    # the forward's peak with its input, as phase_quartered counts it
    fwd_peak = torch.cuda.max_memory_allocated() / 1e9 - held \
        + x.numel() * 4 / 1e9
    a1 = bf.LAUNCHES['fft_axis_p']
    _check(a1 - a0 == 3, f"forward launched fft_axis_p {a1 - a0} times")
    _check(tuple(y.shape) == (2, n, n, n), f"forward shape {y.shape}")
    # oracle: torch.fft.fftn of the same data, normalized
    err_f, _ = _rel(y, _fftn_ref(x))
    _check(err_f <= PIPE_TOL, f"{n}^3 forward vs fftn: {err_f:.3e}")
    z = pfft.backward(y)
    torch.cuda.synchronize()
    a2 = bf.LAUNCHES['fft_axis_p']
    _check(a2 - a1 == 3, f"backward launched fft_axis_p {a2 - a1} times")
    err_rt, _ = _rel(z, x)
    _check(err_rt <= PIPE_TOL, f"{n}^3 round trip: {err_rt:.3e}")
    peak = torch.cuda.max_memory_allocated()
    _emit({'phase': 'north', 'shape': [n] * 3, 'dtype': 'F',
           'rel_l2_fwd_vs_fftn': err_f, 'rel_l2_round_trip': err_rt,
           'fft_axis_p_per_transform': 3, 'first_forward_s': t_fwd,
           'fwd_peak_gb': fwd_peak, 'peak_gb': peak / 1e9})
    return pfft, x


def phase_quartered(bf, pfft, x):
    """The north-star plan on its quartered schedule, the JAX bench's
    production path (bench.py:_bench_fft)."""
    from mpi4py_fft_torch.ops import oop3d
    _check(pfft.quartered, "the 1024^3 c2c plan is not quartered")
    n = x.shape[1]
    vol_gb = x.numel() * 4 / 1e9
    ref = pfft.forward(x)
    qs = list(oop3d.split_q(x))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    c0 = dict(bf.LAUNCHES)
    ys = pfft.forward_fn_q(qs)
    torch.cuda.synchronize()
    c1 = dict(bf.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    _check(_delta(c0, c1) == {'fft_axis_p': 4, 'fft_axis2_p': 4},
           f"quartered forward launches {_delta(c0, c1)}")
    _check(all(tuple(q.shape) == (2, n // 2, n, n // 2) for q in ys),
           "quarter shapes")
    y = oop3d.assemble_q(ys)
    err_full, mx_full = _rel(y, ref)
    del ref
    err_f, _ = _rel(y, _fftn_ref(x))
    del y
    zs = pfft.backward_fn_q(list(ys))
    torch.cuda.synchronize()
    c2 = dict(bf.LAUNCHES)
    _check(_delta(c1, c2) == {'fft_axis_p': 4, 'fft_axis2_p': 4},
           f"quartered backward launches {_delta(c1, c2)}")
    del ys
    err_rt, _ = _rel(oop3d.assemble_q(zs), x)
    del zs
    _check(max(err_full, err_f, err_rt) <= PIPE_TOL,
           f"quartered: vs unquartered {err_full:.3e}, vs fftn "
           f"{err_f:.3e}, round trip {err_rt:.3e}")
    _emit({'phase': 'quartered', 'shape': [n] * 3, 'dtype': 'F',
           'quarter': [2, n // 2, n, n // 2],
           'rel_l2_fwd_vs_unquartered': err_full,
           'max_abs_fwd_vs_unquartered': mx_full,
           'rel_l2_fwd_vs_fftn': err_f, 'rel_l2_round_trip': err_rt,
           'launches_per_transform': _delta(c0, c1),
           # the forward's peak, with the 4 input quarters handed over and
           # without what else the script held (x, the unquartered output)
           'fwd_peak_gb': peak - held + vol_gb, 'volume_gb': vol_gb})


def phase_long(dev, bf):
    """Plans with a 2048-long axis (one pair-kernel pass) and a 4096-long
    axis (the four-step around fft_axis_p)."""
    from mpi4py_fft_torch import PlanarPFFT
    out = []
    want = ({'fft_axis_p': 2, 'fft_axis_pair_p': 1}, {'fft_axis_p': 3})
    for i, (shape, launches) in enumerate(zip(LONG_SHAPES, want)):
        pfft = PlanarPFFT(None, shape, dtype='F')
        x = _rand((2,) + shape, dev, SEED + 5 + i)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        c0 = dict(bf.LAUNCHES)
        y = pfft.forward(x)
        torch.cuda.synchronize()
        c1 = dict(bf.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 1e9
        _check(_delta(c0, c1) == launches,
               f"{shape} forward launches {_delta(c0, c1)}")
        _check(tuple(y.shape) == (2,) + shape, f"{shape}: {y.shape}")
        err_f, _ = _rel(y, _fftn_ref(x))
        z = pfft.backward(y)
        del y
        torch.cuda.synchronize()
        c2 = dict(bf.LAUNCHES)
        _check(_delta(c1, c2) == launches,
               f"{shape} backward launches {_delta(c1, c2)}")
        err_rt, _ = _rel(z, x)
        _check(bool(torch.isfinite(z).all()), f"{shape}: non-finite")
        del z, x
        torch.cuda.empty_cache()
        _check(max(err_f, err_rt) <= PIPE_TOL,
               f"{shape}: vs fftn {err_f:.3e}, round trip {err_rt:.3e}")
        out.append({'shape': list(shape), 'rel_l2_fwd_vs_fftn': err_f,
                    'rel_l2_round_trip': err_rt,
                    'launches_per_transform': launches,
                    'fwd_peak_above_input_gb': peak - held})
    _emit({'phase': 'long', 'dtype': 'F', 'plans': out})


def phase_dealias(dev, bf):
    from mpi4py_fft_torch import PlanarPFFT
    from mpi4py_fft_torch.libfft import truncate_planar
    d = DEALIAS_N
    pfft = PlanarPFFT(None, (d,) * 3, dtype='f', padding=1.5)
    shape = pfft.global_shape(False)
    m = 3 * d // 2
    _check(tuple(shape) == (m,) * 3, f"padded shape {shape}")
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    x = torch.rand(shape, generator=g, device=dev) - 0.5
    c0 = dict(bf.LAUNCHES)
    y = pfft.forward(x)
    torch.cuda.synchronize()
    c1 = dict(bf.LAUNCHES)
    z = pfft.backward(y)
    torch.cuda.synchronize()
    c2 = dict(bf.LAUNCHES)
    fwd = _delta(c0, c1)
    bwd = _delta(c1, c2)
    _check(fwd == {'fft_axis_p': 2, 'rfft_axis_p': 1},
           f"forward launches {fwd}")
    _check(bwd == {'fft_axis_p': 2, 'irfft_axis_p': 1},
           f"backward launches {bwd}")
    _check(tuple(y.shape) == (2, d, d, d // 2 + 1), f"spectrum {y.shape}")
    with _plain_path(bf):
        yp = pfft.forward(x)
        zp = pfft.backward(yp)
    torch.cuda.synchronize()
    _check(bf.LAUNCHES == c2, "the plain path launched a kernel")
    err_y, _ = _rel(y, yp)
    err_z, _ = _rel(z, zp)
    del yp, zp
    # oracle: the truncations act per axis, so they commute with the other
    # axes' transforms: forward = truncations of rfftn(x) / m^3
    F = torch.fft.rfftn(x)
    F /= float(x.numel())
    ref = torch.stack([F.real, F.imag])
    del F
    ref = truncate_planar(ref, 3, d // 2 + 1, hermitian=True)
    ref = truncate_planar(ref, 2, d, hermitian=False)
    ref = truncate_planar(ref, 1, d, hermitian=False)
    err_o, _ = _rel(y, ref)
    _check(max(err_y, err_z, err_o) <= PIPE_TOL,
           f"dealias: fwd {err_y:.3e}, bwd {err_z:.3e}, oracle {err_o:.3e}")
    _check(bool(torch.isfinite(z).all()), "dealias: non-finite")
    _emit({'phase': 'dealias', 'shape': [d] * 3, 'physical': list(shape),
           'dtype': 'f', 'rel_l2_fwd_vs_plain': err_y,
           'rel_l2_bwd_vs_plain': err_z, 'rel_l2_fwd_vs_rfftn': err_o,
           'launches_fwd': fwd, 'launches_bwd': bwd})


def phase_times(dev, bf, holds, pfft, x):
    """Kernel, plain and library times at the main path's shapes."""
    out = {}
    n = x.shape[1]
    lines = n * n
    from mpi4py_fft_torch.ops import oop3d
    # A: one pass per axis position of the north-star volume
    xc = torch.complex(x[0], x[1])
    per_axis = []
    for ax in (2, 1, 0):
        k = bf.fft_axis_p(x, ax)
        pl = bf.fft_axis_plain(x, ax)
        holds.hold('fft_axis_p', k, pl, f"fft_axis_p {n}^3 axis {ax}")
        del k, pl
        t_k = _median_ms(lambda: bf.fft_axis_p(x, ax))
        t_p = _median_ms(lambda: bf.fft_axis_plain(x, ax))
        t_l = _median_ms(lambda: torch.fft.fft(xc, dim=ax))
        b, by = _bound_ms(2 * x.numel() * 4, lines * 5 * n * math.log2(n))
        per_axis.append({'axis': ax, 'ms': t_k, 'plain_ms': t_p,
                         'library_ms': t_l, 'bound_ms': b})
    del xc
    out['fft_axis_p'] = {
        'shape': f'3 passes, axes 2, 1, 0 of (2, {n}, {n}, {n}) f32',
        'ms': sum(a['ms'] for a in per_axis),
        'plain_ms': sum(a['plain_ms'] for a in per_axis),
        'library_ms': sum(a['library_ms'] for a in per_axis),
        'bound_ms': sum(a['bound_ms'] for a in per_axis),
        'bound_by': by, 'per_axis': per_axis}
    # end to end: normalized forward + backward of the north star, on the
    # full volume and on the quartered schedule (state kept quartered)
    t_pair = _median_ms(lambda: pfft.backward(pfft.forward(x)), reps=5)
    e2e_ms = t_pair / 2
    gfs = 5.0 * n ** 3 * math.log2(n ** 3) / (e2e_ms * 1e-3) / 1e9
    state = [list(oop3d.split_q(x))]

    def chain():
        state[0] = list(pfft.backward_fn_q(list(pfft.forward_fn_q(
            state[0]))))

    e2e_q_ms = _median_ms(chain, reps=5) / 2
    del state
    out['fft_axis2_p'] = _times_axis2(bf, holds, x)
    del x
    torch.cuda.empty_cache()
    out['fft_axis_pair_p'] = _times_pair(dev, bf, holds)
    long_ms = _times_long(dev)
    # B and C: the last axis of the dealiasing grid
    m = 3 * DEALIAS_N // 2
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    r = torch.rand((m, m, m), generator=g, device=dev) - 0.5
    k = bf.rfft_axis_p(r, 2)
    holds.hold('rfft_axis_p', k, bf.rfft_axis_plain(r, 2),
               f"rfft_axis_p {m}^3 last axis")
    nh = m // 2 + 1
    b, by = _bound_ms(r.numel() * 4 + 2 * m * m * nh * 4,
                      m * m * 2.5 * m * math.log2(m))
    out['rfft_axis_p'] = {
        'shape': f'({m}, {m}, {m}) f32 -> (2, {m}, {m}, {nh}), last axis',
        'ms': _median_ms(lambda: bf.rfft_axis_p(r, 2)),
        'plain_ms': _median_ms(lambda: bf.rfft_axis_plain(r, 2)),
        'library_ms': _median_ms(lambda: torch.fft.rfft(r, dim=2)),
        'bound_ms': b, 'bound_by': by}
    h = k
    hc = torch.complex(h[0], h[1])
    holds.hold('irfft_axis_p', bf.irfft_axis_p(h, 2, m),
               bf.irfft_axis_plain(h, 2, m), f"irfft_axis_p {m}^3 last axis")
    out['irfft_axis_p'] = {
        'shape': f'(2, {m}, {m}, {nh}) f32 -> ({m}, {m}, {m}), last axis',
        'ms': _median_ms(lambda: bf.irfft_axis_p(h, 2, m)),
        'plain_ms': _median_ms(lambda: bf.irfft_axis_plain(h, 2, m)),
        'library_ms': _median_ms(
            lambda: torch.fft.irfft(hc, n=m, dim=2, norm='forward')),
        'bound_ms': b, 'bound_by': by}
    # A at the dealiasing grid's mid- and lead-axis passes, both signs
    nt = DEALIAS_N // 2 + 1
    for shape, ax in (((m, m, nt), 1), ((m, DEALIAS_N, nt), 0)):
        p = torch.rand((2,) + shape, generator=g, device=dev) - 0.5
        for fwd in (True, False):
            holds.hold('fft_axis_p', bf.fft_axis_p(p, ax, fwd),
                       bf.fft_axis_plain(p, ax, fwd),
                       f"fft_axis_p {shape} axis {ax} fwd={fwd}")
        del p
    _emit({'phase': 'times', 'e2e_shape': [n] * 3, 'e2e_dtype': 'F',
           'e2e_ms_per_transform': e2e_ms,
           'e2e_gflops_5nlogn': gfs,
           'e2e_quartered_ms_per_transform': e2e_q_ms,
           'e2e_quartered_gflops_5nlogn': gfs * e2e_ms / e2e_q_ms,
           'long_ms_per_transform': long_ms, 'kernels': out})
    return out


def _times_long(dev):
    """ms per transform (a normalized forward + backward pair, halved) of
    the long-axis plans."""
    from mpi4py_fft_torch import PlanarPFFT
    out = {}
    for i, shape in enumerate(LONG_SHAPES):
        pfft = PlanarPFFT(None, shape, dtype='F')
        x = _rand((2,) + shape, dev, SEED + 5 + i)
        out[str(shape)] = _median_ms(
            lambda: pfft.backward(pfft.forward(x)), reps=5) / 2
        del x
        torch.cuda.empty_cache()
    return out


def _pass_bound(numel, N):
    """Bound of one pass over a planar f32 tensor of ``numel`` elements
    along an N-long axis: read and write it once, 5 N log2 N flops a
    line."""
    lines = numel // 2 // N
    return _bound_ms(2 * numel * 4, lines * 5 * N * math.log2(N))


def _times_axis2(bf, holds, x):
    """D at the quartered schedule's pair passes: axis 0 of (Q00, Q10) and
    axis 2 of (Q00, Q01), both signs held, and against A on the assembled
    line (the same arithmetic at N = 1024)."""
    from mpi4py_fft_torch.ops import oop3d
    qs = oop3d.split_q(x)
    q00, q01, q10 = qs[:3]
    del qs
    per_axis = []
    d_vs_a = {}
    for ax, (pa, pb) in ((0, (q00, q10)), (2, (q00, q01))):
        d = 1 + ax
        full = torch.cat([pa, pb], d)
        for fwd in (True, False):
            k = torch.cat(bf.fft_axis2_p(pa, pb, ax, fwd), d)
            holds.hold('fft_axis2_p', k,
                       torch.cat(bf.fft_axis2_plain(pa, pb, ax, fwd), d),
                       f"fft_axis2_p quarter pair axis {ax} fwd={fwd}")
            if fwd:
                _, d_vs_a[ax] = _rel(k, bf.fft_axis_p(full, ax))
            del k
        fc = torch.complex(full[0], full[1])
        del full
        b, by = _pass_bound(2 * pa.numel(), 2 * pa.shape[d])
        per_axis.append({
            'axis': ax,
            'ms': _median_ms(lambda: bf.fft_axis2_p(pa, pb, ax)),
            'plain_ms': _median_ms(lambda: bf.fft_axis2_plain(pa, pb, ax)),
            'library_ms': _median_ms(lambda: torch.fft.fft(fc, dim=ax)),
            'bound_ms': b, 'max_abs_vs_fft_axis_p': d_vs_a[ax]})
        del fc
    # a quartered transform runs two pair passes on each of axes 0 and 2
    row = {k: 2 * sum(a[k] for a in per_axis)
           for k in ('ms', 'plain_ms', 'library_ms', 'bound_ms')}
    row.update(shape=f'4 passes, 2 on each of axes 0 and 2 of '
                     f'{tuple(q00.shape)} f32 pairs',
               bound_by=by, per_axis=per_axis)
    return row


def _times_pair(dev, bf, holds):
    """G at N = 2048 on every axis position, both signs held; timed on
    the (2048, 1024, 512) plan's lead pass."""
    row = None
    for i, (shape, ax) in enumerate(PAIR_SHAPES):
        p = _rand((2,) + shape, dev, SEED + 8 + i)
        for fwd in (True, False):
            holds.hold('fft_axis_pair_p', bf.fft_axis_pair_p(p, ax, fwd),
                       bf.fft_axis_pair_plain(p, ax, fwd),
                       f"fft_axis_pair_p {shape} axis {ax} fwd={fwd}")
        if row is None:
            pc = torch.complex(p[0], p[1])
            b, by = _pass_bound(p.numel(), shape[ax])
            row = {'shape': f'(2, {shape[0]}, {shape[1]}, {shape[2]}) f32, '
                            f'axis {ax}',
                   'ms': _median_ms(lambda: bf.fft_axis_pair_p(p, ax)),
                   'plain_ms': _median_ms(
                       lambda: bf.fft_axis_pair_plain(p, ax)),
                   'library_ms': _median_ms(
                       lambda: torch.fft.fft(pc, dim=ax)),
                   'bound_ms': b, 'bound_by': by}
            del pc
        del p
        torch.cuda.empty_cache()
    return row


KERNELS = {
    'fft_axis_p': ('mpi4py_fft_torch/ops/csrc/fft_axis.cu',
                   'mpi4py_fft_tpu/ops/pallas_butterfly.py:795'),
    'rfft_axis_p': ('mpi4py_fft_torch/ops/csrc/rfft_axis.cu',
                    'mpi4py_fft_tpu/ops/pallas_butterfly.py:1818'),
    'irfft_axis_p': ('mpi4py_fft_torch/ops/csrc/rfft_axis.cu',
                     'mpi4py_fft_tpu/ops/pallas_butterfly.py:1980'),
    'fft_axis2_p': ('mpi4py_fft_torch/ops/csrc/fft_axis2.cu',
                    'mpi4py_fft_tpu/ops/pallas_butterfly.py:1358'),
    'fft_axis_pair_p': ('mpi4py_fft_torch/ops/csrc/fft_axis2.cu',
                        'mpi4py_fft_tpu/ops/pallas_butterfly.py:1476'),
}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mpi4py_fft_torch.ops import butterfly as bf
    t_start = time.perf_counter()
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    phase_build()
    holds = Holds(KERNELS)
    phase_holds(holds, dev)

    # the main path: counters at 0 just before, read just after
    bf.reset_launches()
    phase_entry(dev)
    pfft, x = phase_north(dev, bf)
    phase_quartered(bf, pfft, x)
    phase_long(dev, bf)
    phase_dealias(dev, bf)
    launches = dict(bf.LAUNCHES)
    for name, c in launches.items():
        _check(c > 0, f"{name} was not launched on the main path")

    times = phase_times(dev, bf, holds, pfft, x)
    kernels = []
    for name, (src, rep) in KERNELS.items():
        t = times[name]
        kernels.append({
            'name': name, 'route': 'cuda', 'source': src, 'replaces': rep,
            'launches': launches[name], 'max_abs_err': holds.err[name],
            'max_rel_l2': holds.rel[name], 'ms': t['ms'],
            'plain_ms': t['plain_ms'], 'bound_ms': t['bound_ms'],
            'bound_by': t['bound_by'], 'library_ms': t['library_ms'],
            'shape': t['shape']})
    _emit({'kernels': kernels})
    _emit({'phase': 'done', 'seconds': time.perf_counter() - t_start})
    print(_smi(), flush=True)
    _emit({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
