#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (``mpi4py_fft_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, run in the order 1-15, 19-22, 16-18, 23, 24; any failure raises
and the script exits non-zero:

1. build     the kernels from ``mpi4py_fft_torch/ops/csrc`` with nvcc,
             their ``ptxas`` lines, how many two-CTA clusters of the
             pair kernel's cluster instance (N = 1536, 2048) the card
             holds at once (``cudaOccupancyMaxActiveClusters``, > 0),
             and the same for H's plane-holding kernel at 256 x 256 (a
             cluster of 8 CTAs a plane) and 64 x 64 (one CTA, > 0);
2. holds     every kernel against its plain PyTorch version on the card
             (relative L2 <= 5e-6), the pair kernels at lead, mid and last
             positions for N up to 2048 (A's tile up to 1024, the cluster
             kernel at 1536 and 2048), and the fp64 builds of
             ``fft_axis_p``, ``rfft_axis_p``, ``irfft_axis_p`` and
             ``fft_axis_tp`` on float64 tensors (<= 2e-13; the float64
             r2c on whole lines is the line kernel); the fused
             dealiasing kernel ``fft_axis_tp`` at lead, mid and last
             positions, truncation and padding, even and odd Nt, with and
             without a scale; J (``fft2stage_p``) at every S = 1..8 and
             both signs; H and I (``fft_plane_p``, ``fft_plane_large_p``)
             on planes from 4 x 2 to 1024 x 1024 (H's one-CTA planes,
             ragged, and its clusters of 2, 4 and 8);
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
             pass on axis 0, the cluster kernel) and (4096, 1024, 256)
             (the four-step around
             ``fft_axis_p`` on axis 0): forward against ``torch.fft.fftn``
             and the round trip;
7. dealias   ``PlanarPFFT(None, (512,)*3, dtype='f', padding=1.5)`` (a
             768^3 grid): the kernel path against the port's plain path on
             the card and the forward against a ``torch.fft.rfftn`` oracle;
8. north64  ``PlanarPFFT(None, (1024,)*3, dtype='D')``: the normalized
             forward held against the exact spectrum of a sum of plane
             waves with random complex amplitudes, the round trip against
             the input built anew (relative L2 <= 2e-10), 3
             ``fft_axis_p_f64`` launches per transform, and the forward's
             working set;
9. dealias64 ``PlanarPFFT(None, (512,)*3, dtype='d', padding=1.5)``: as
             phase 7, at 2e-10, against a complex128 ``torch.fft.rfftn``;
10. dns64    the port's spectral DNS example
             (``mpi4py_fft_torch/examples/spectral_dns_planar.py``): the
             reference's 64^3 float64 energy anchor to 7 decimals, then 2
             RK4 steps at 512^3 float64 after a warm-up step, timed, with
             72 ``fft_axis_p_f64``, 12 ``rfft_axis_p_f64`` and 24
             ``irfft_axis_p_f64`` launches a step, the state held at 2e-10
             against the same solver on complex128 ``torch.fft``
             (oracle only), and the peak device memory;
11. pfft     the reference API's dealiased plan, the JAX package's
             milestone #3: ``PFFT(None, (512,)*3, padding=[1.5]*3,
             dtype='f')`` on planar tensors through ``forward.fn_p``/
             ``backward.fn_p``, exactly 1 ``rfft_axis_p`` + 2
             ``fft_axis_tp`` launches a forward and 2 ``fft_axis_tp`` + 1
             ``irfft_axis_p`` a backward, against the port's plain path on
             the card and a truncated ``torch.fft.rfftn`` oracle (5e-5),
             timed, with its peak device memory;
12. pfft_c2c the same plan at ``'F'`` (3 ``fft_axis_tp`` launches each way)
             against a truncated ``torch.fft.fftn``;
13. pfft64   the same plan at ``'d'`` (``fft_axis_tp_f64``, 2e-10);
14. buffer   ``newDistArray`` and the buffer call ``fft.forward(u)``/
             ``fft.backward(u_hat, u)`` on DistArrays kept on the card, 256^3
             ``'d'`` (real) and ``'D'`` (complex): the forward against
             ``torch.fft`` and the round trip at 2e-10;
15. dns_solver the reference DNS solver on ``PFFT``
             (``mpi4py_fft_torch/examples/spectral_dns_solver.py``, complex
             tensors through ``forward.fn``/``backward.fn``): the 64^3
             energy anchor unpadded, then ``padding=True`` at 512^3 ``'d'``,
             2 RK4 steps timed after a warm-up step, with 72
             ``fft_axis_tp_f64``, 12 ``rfft_axis_p_f64`` and 24
             ``irfft_axis_p_f64`` launches a step, the state held at 2e-10
             against the same solver on complex128 ``torch.fft``
             (oracle only), and the peak device memory;
16. times    each kernel at the main path's shapes (CUDA events, median of
             7 after 2 warm-ups) beside its plain version, the one PyTorch
             call that computes the same function, and its bound; and the
             end-to-end 1024^3 c2c transform, unquartered and quartered.
             B (the line kernel) is timed at the 768^3 last axis and at
             m3's truncating pass (trunc 257, scale 1/768), each held slab
             by slab on a NaN-filled output.
             D (``fft_axis2_p``) is timed by route: the band kernel at the
             quartered lead pass and at ``fft3_8``'s y pass (axis 1 of two
             eighths) and at N = 768 (the halves of a 768^3 lead axis),
             the line kernel at the quartered last pass and at N = 768
             (the halves of a 768^3 last axis), each held slab by
             slab on both signs into NaN-filled halves and timed beside
             its plain version, cuFFT, its bound and its reachable bound
             (``block_copy`` of the same halves in the boxes of its
             access pattern, timed in the same run); at both quarter
             pairs also against A on the assembled line and in place
             (``alias=True``) bit for bit against out of place.
             Every main-path shape of a kernel is also held against its
             plain version at <= 5e-6, and so are the pair kernels at the
             N = 2048 passes of every axis position; G (the cluster
             kernel) is timed at the (2048, 1024, 512) lead pass and at
             (2, 1536, 1024, 512) axis 0, held there on both signs, and
             held in place (``fft_axis2_p(..., alias=True)`` at N = 2048)
             against out of place into NaN-filled halves, bit for bit;
17. times64  the fp64 builds at the 512^3 DNS's shapes (held at 2e-13 on
             both signs), timed beside their plain versions, complex128
             ``torch.fft`` and their bounds; A64 (``fft_axis_p_f64``) by
             route, each pass held slab by slab on both signs into a
             NaN-filled output and in place (``out=``) bit for bit
             against out of place, with its reachable bound: the DNS's
             mid (single elements, post 257) and lead (vectors) passes on
             the band kernel, the three passes of a 768^3 volume (the
             last on the line kernel, the others on the band) and of the
             1024^3 volume (the last on the line kernel, the others on the
             band kernel); B64 (the line kernel) also at the truncating pass of the dealiased f64 plan (a 768^3 input,
             trunc 257, scale 1/768: held at 2e-13, timed beside its plain
             version, its bound and ``torch.fft.rfft``); ``fft_axis_p_f64``
             at the six
             passes of the 1024^3 ``'D'`` transform on the full volume,
             held at 2e-13 against its plain version slab by slab; and
             the 1024^3 ``'D'`` transform end to end;
18. times_tp ``fft_axis_tp`` and ``fft_axis_tp_f64`` at the four passes of
             the dealiased 512^3 plan (forward axes 1 and 0 with the
             truncation and the stage's scale, backward axes 0 and 1 with
             the padding), each held against ``fft_axis_tp_plain`` slab by
             slab on its full volume, timed beside the plain version, its
             bound and cuFFT's unfused c2c pass at the same shape (no one
             PyTorch call computes the fused function: ``library_ms`` is
             null).

19. any_c2c  ``PlanarPFFT(None, (640,)*3, dtype='F')``, an extent no
             Stockham kernel takes: a normalized forward and the backward
             against ``torch.fft.fftn`` and the round trip (5e-5), exactly
             one J (``fft2stage_p``, S = 5) launch each way (the other
             axes run the mixed-radix engine, 640 = 32*20), ms per
             transform and the forward's working set;
20. any_r2c  ``PFFT(None, (896,)*3, dtype='f')`` through planar
             ``forward.fn_p``/``backward.fn_p`` (B and C refuse 896):
             exactly one J launch (S = 7) each way, against
             ``torch.fft.rfftn`` and the round trip, ms each way and the
             peak memory;
21. bluestein ``PlanarPFFT(None, (509, 512, 512), dtype='F')``: axis 0 is
             Bluestein, two J launches of M = 1024 a direction, axes 1 and
             2 take A; against ``torch.fft.fftn`` and the round trip;
22. plane    the entry points H (``fft_plane_p``, (2, 1024, 256, 256), a
             cluster a plane, and (2, 16384, 64, 64), two planes a CTA)
             and I (``fft_plane_large_p``, (2, 1024, 1024, 1024)), forward
             and backward with the 1/(N1 N2) scale, against a
             ``torch.fft.fft2`` oracle and the round trip, and against
             their plain versions slab by slab (outputs in memory filled
             with NaN first), with H's CTAs a plane and active clusters;
23. times_any J at the three S of the main path: the 640^3 last-axis
             pass (S = 5), the stacked 896^3 real axis (S = 7) and
             Bluestein's padded (512, 512, 1024) axis (S = 8), each held
             slab by slab on both signs (outputs filled with NaN first);
             H and I at phase 22's shapes; each timed beside its plain
             version, its bound, the PyTorch call that computes the same
             function (``torch.fft.fft`` over the last axis;
             ``torch.fft.fft2``) and, for H and I, two chained A passes
             at the same shape.
24. probes   the port of the JAX package's TPU probes (``scripts/tpu_*.py``,
             ``mpi4py_fft_torch/probes``): first every probe kernel
             (``ops/probes.py``) against its plain version on the card,
             ``block_copy`` and ``move`` bit for bit at every blocking and
             move the scripts name (in place, out of place, two streams),
             ``bfly`` at 5e-6 in every mode, position and tile (in place
             bit for bit against out of place on the full 1024^3 volume),
             ``fma_chain`` at 5e-6 (f64 2e-13) after 256 iterations
             (every output filled with NaN first, so that a kernel that
             skips work cannot pass on memory that held the answer); then
             the launch counters of the probe kernels are set to 0, every
             probe module runs (one JSON line each: ms, GB/s read + write
             against the HBM peak, the PyTorch yardstick) and each probe
             kernel must have been launched there; last, each probe
             kernel's time beside its plain version, its bound and its
             PyTorch yardstick for the ``kernels`` line.

``python3 chip_smoke.py --times-any TREE`` runs only phases 1, 22 and 23,
B's two rows of phase 16, D's and A64's rows of phases 16 and 17, and
phases 13 and 18, on the port of the checkout at TREE (a tree from the
plane-holding H on), and prints no last line: run it for two trees in
turns on one card (parent, change, change, parent) to compare H, I, J,
B, D, A64, E and E64 and the m3 plan at 'd' between them.

Phases 3 to 15 and 19 to 22 are the main path: the launch counters are
set to 0 just before phase 3 and read after phase 22 (phases 16 to 18
run after it, as do times_any).  The probe kernels' path is phase 24's
modules, with their own counters.  Each phase prints one JSON line;
then come the ``{"kernels": [...]}`` line, the card's name and power limit
from nvidia-smi, and last ``{"ok": true, "device": {...}}``.  Without a
CUDA device the script prints no result and exits with 1.
"""
import argparse
import collections
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

import numpy as np

SEED = 0
# H100 SXM data sheet at 700 W: HBM3 bandwidth, non-tensor f32 and f64
# peaks
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_F64_S = 34e12
KERNEL_TOL = 5e-6          # one kernel against its plain version
PIPE_TOL = 5e-5            # a 3-axis composition
# float64: the JAX suite's tolerance for its f64 kernel F
# (tests/test_ds.py:58) and the reference's f64 tolerance (:18)
KERNEL_TOL64 = 2e-13
PIPE_TOL64 = 2e-10
NORTH_N = 1024             # the c2c north star, NORTH_N^3
DEALIAS_N = 512            # the r2c 3/2-rule plan, on a (1.5 DEALIAS_N)^3 grid
# the long-axis plans: 8.6 GB planar volumes like the north star's
LONG_SHAPES = ((2048, 1024, 512), (4096, 1024, 256))
# fft_axis_pair_p held at N = 2048 on every axis position (the first is
# the lead pass of LONG_SHAPES[0], the one timed)
PAIR_SHAPES = (((2048, 1024, 512), 0), ((512, 2048, 1024), 1),
               ((512, 1024, 2048), 2))
# ... and at N = 1536 on the lead axis of a volume like the first, held
# and timed the same way
PAIR_1536 = ((1536, 1024, 512), 0)
NORTH64_N = 1024           # the c2c north star at float64 ('D')
DEALIAS64_N = 512          # the r2c 'd' 3/2-rule plan
DNS_N = 512                # the spectral DNS at float64
DNS_ANCHOR_N = 64          # the reference's energy anchor
PFFT_N = 512               # the reference API's 3/2-rule plans (768^3 grid)
BUFFER_N = 256             # the buffer call on DistArrays
DNS_SOLVER_N = 512         # the reference DNS solver, dealiased, at float64
ANY_C2C_SHAPE = (640,) * 3  # a c2c extent of J (S = 5) and the engine
ANY_R2C_SHAPE = (896,) * 3  # an r2c extent B and C refuse: J (S = 7)
BLUESTEIN_SHAPE = (509, 512, 512)   # a prime lead axis (Bluestein, M = 1024)
# the plane kernels: H at its largest axes, I at the north-star volume of
# the JAX package's A/B (scripts/tpu_plane_large_test.py)
PLANE_H = (1024, 256, 256)
PLANE_I = (1024, 1024, 1024)
# H on planes one CTA holds whole (two planes a CTA), the same volume
PLANE_H_ONE_CTA = (16384, 64, 64)
PROBE_N = 1024             # the probes' floors: the north star's 1024^3
FMA_HOLD_ITERS = 256       # fma_chain against its plain loop
# the hold's constants: every step moves each value by far more than the
# tolerance (the script's a = 1.0000001, b = 1e-9 move it by about an ulp)
FMA_HOLD_A, FMA_HOLD_B = 0.9990234375, 0.25
# fma_chain's row of the kernels line: enough iterations that the launch
# is a small share of the time, few enough for the plain loop
FMA_TIME_ITERS = 1 << 14


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
    saved = bf.fft_axis_p, bf.rfft_axis_p, bf.irfft_axis_p, bf.fft_axis_tp
    bf.fft_axis_p = bf.fft_axis_plain
    bf.rfft_axis_p = bf.rfft_axis_plain
    bf.irfft_axis_p = bf.irfft_axis_plain
    bf.fft_axis_tp = bf.fft_axis_tp_plain
    try:
        yield
    finally:
        (bf.fft_axis_p, bf.rfft_axis_p, bf.irfft_axis_p,
         bf.fft_axis_tp) = saved


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


def _bound_ms(nbytes, flops, f64=False):
    tb = nbytes / PEAK_BYTES_S
    tf = flops / (PEAK_F64_S if f64 else PEAK_F32_S)
    return 1e3 * max(tb, tf), 'bytes' if tb >= tf else 'operations'


def _reach_ms(xs, ax):
    """The reachable bound of one pass along complex axis ``ax`` of the
    contiguous planar (2, A, B, C) tensors ``xs`` (one, or a pair's two
    halves), measured: the time of ``block_copy`` (the probes' copy
    kernel) of the same tensors out of place, in boxes of the pass's
    access pattern: (2, 1, B, C) planes for the last axis; for the mid
    axis (2, 8, B, 128) where 128 elements divide the row, else (2, 1, B,
    C), whole rows (the DNS's odd post, which allows no vector); for the
    lead axis 512-byte runs of every row, (2, A, 128) on the (2, A, B C)
    view.  float64 is copied as pairs of float32."""
    from mpi4py_fft_torch.ops import probes as tp
    vs = [x.view(torch.float32) for x in xs]
    _, A, B, C = vs[0].shape
    if ax == 0:
        vs = [v.view(2, A, B * C) for v in vs]
        box = (2, A, 128 if B * C % 128 == 0 else B * C)
    elif ax == 1:
        box = (2, 8, B, 128) if C % 128 == 0 else (2, 1, B, C)
    else:
        box = (2, 1, B, C)
    ys = [torch.empty_like(v) for v in vs]
    pair = {} if len(vs) == 1 else {'x2': vs[1], 'out2': ys[1]}
    ms = _median_ms(lambda: tp.block_copy(vs[0], box, out=ys[0], **pair))
    del ys
    torch.cuda.empty_cache()
    return ms


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
        tol = KERNEL_TOL64 if name.endswith('_f64') else KERNEL_TOL
        _check(bool(torch.isfinite(got).all()), f"{what}: non-finite")
        _check(r <= tol, f"{what}: rel L2 {r:.3e} > {tol}")


def phase_build():
    from mpi4py_fft_torch.ops import _build
    t0 = time.perf_counter()
    _build.load()
    secs = time.perf_counter() - t0
    ptxas = [ln.strip() for out in _build.LOG.values()
             for ln in out.splitlines()
             if 'registers' in ln or 'spill' in ln or 'Compiling' in ln]
    from mpi4py_fft_torch.ops import butterfly as bf
    clusters = {n: bf.pair_max_active_clusters(n) for n in (1536, 2048)}
    for n, c in clusters.items():
        _check(c > 0, f"pair kernel at N = {n}: no two-CTA cluster fits")
    planes = {}
    for shape in (PLANE_H, PLANE_H_ONE_CTA):
        k, c = bf.plane_max_active_clusters(*shape[-2:])
        _check(c > 0, f"plane kernel at {shape[-2:]}: no cluster of {k} "
                      f"fits")
        planes[f'{shape[-2]}x{shape[-1]}'] = {'ctas_a_plane': k,
                                              'max_active': c}
    _emit({'phase': 'build', 'seconds': secs, 'ptxas': ptxas,
           'pair_max_active_clusters': clusters,
           'plane_max_active_clusters': planes})
    print(_smi(), flush=True)


def phase_holds(holds, dev):
    """Each kernel against its plain version at small shapes, every axis
    position, both signs, scales, a ragged shape, hext/trunc and short
    and long c2r inputs."""
    from mpi4py_fft_torch.ops import butterfly as bf
    g = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype)

    n = 0
    for dtype, sfx in ((torch.float32, ''), (torch.float64, '_f64')):
        n += _holds_abc(holds, bf, lambda *s: rnd(*s, dtype=dtype), sfx)
        n += _holds_tp(holds, bf, lambda *s: rnd(*s, dtype=dtype), sfx)
    # the pair kernels: halves sliced out of one tensor (views, strided
    # off axis 0), the whole tensor, and contiguous halves aliased
    for N in (4, 6, 96, 512, 768, 1024, 1536, 2048):
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
    n += _holds_any(holds, rnd)
    _emit({'phase': 'holds', 'cases': n, 'max_rel_l2': holds.rel,
           'max_abs_err': holds.err,
           'tolerance': {'f32': KERNEL_TOL, 'f64': KERNEL_TOL64}})


def _holds_any(holds, rnd):
    """J at every S (a ragged last block, leading dims that flatten) and
    both signs; H and I on square, oblong and tiny planes (N = 2 on either
    axis, the 256 x 256 plane of H, 1024-long axes), both signs and a
    scale; returns the number of cases."""
    from mpi4py_fft_torch.ops import butterfly as bf
    from mpi4py_fft_torch.ops import fft2stage as j2
    n = 0
    for S in range(1, 9):
        for shape in ((13, 128 * S), (3, 7, 128 * S)):
            p = rnd(2, *shape)
            for sign in (-1, 1):
                holds.hold('fft2stage_p', j2.fft2stage_p(p, sign),
                           j2.fft2stage_plain(p, sign),
                           f"fft2stage_p {shape} sign {sign}")
                n += 1
    for shape in ((3, 32, 64), (5, 256, 256), (4, 8, 2), (2, 2, 1024),
                  (2, 1024, 4), (2, 1024, 1024), (2, 3, 16, 16),
                  (7, 16, 32), (3, 64, 256), (2, 256, 128)):
        p = rnd(2, *shape)
        names = ['fft_plane_large_p']
        if bf.supported_plane(shape, p.dtype):
            names.append('fft_plane_p')
        for name in names:
            fn = getattr(bf, name)
            plain = getattr(bf, name[:-2] + '_plain')
            for fwd, sc in ((True, None), (False, None), (True, 0.37)):
                holds.hold(name, fn(p, fwd, scale=sc), plain(p, fwd, sc),
                           f"{name} {shape} fwd={fwd} scale={sc}")
                n += 1
    return n


def _holds_abc(holds, bf, rnd, sfx):
    """fft_axis_p, rfft_axis_p and irfft_axis_p of one build (counter
    suffix ``sfx``) against their plain versions on ``rnd`` data; returns
    the number of cases."""
    a, b, c = ('fft_axis_p' + sfx, 'rfft_axis_p' + sfx,
               'irfft_axis_p' + sfx)
    n = 0
    for N in (2, 8, 96, 256, 512, 768, 1024):
        for shape, ax in (((N, 24, 40), 0), ((6, N, 40), 1), ((50, N), 1),
                          ((3, N, 33), 1)):
            p = rnd(2, *shape)
            for fwd, sc in ((True, None), (False, None), (True, 1.0 / N)):
                holds.hold(a, bf.fft_axis_p(p, ax, fwd, scale=sc),
                           bf.fft_axis_plain(p, ax, fwd, scale=sc),
                           f"{a} {shape} axis {ax} fwd={fwd}")
                n += 1
    p = rnd(2, 3, 96, 5)
    for fwd in (True, False):
        holds.hold(a, bf.fft_axis_p(p, 1, fwd),
                   bf.fft_axis_plain(p, 1, fwd), f"{a} (3, 96, 5)")
        n += 1
    for shape, ax in (((40, 768), 1), ((768, 3, 20), 0), ((5, 64, 33), 1),
                      ((7, 2), 1), ((3, 96, 5), 1)):
        x = rnd(*shape)
        N = shape[ax]
        nh = N // 2 + 1
        for hext, trunc, sc in ((None, None, None), (nh + 5, None, 0.5),
                                (None, max(1, nh - 2), None),
                                (nh + 1, max(1, nh - 3), 2.0)):
            holds.hold(b, bf.rfft_axis_p(x, ax, hext=hext, trunc=trunc,
                                         scale=sc),
                       bf.rfft_axis_plain(x, ax, hext=hext, trunc=trunc,
                                          scale=sc),
                       f"{b} {shape} axis {ax} hext={hext} trunc={trunc}")
            n += 1
        for hin, sc in ((nh, None), (max(1, nh - 2), None),
                        (max(1, nh - 1), 0.25), (nh + 3, None)):
            sh = list(shape)
            sh[ax] = hin
            h = rnd(2, *sh)
            holds.hold(c, bf.irfft_axis_p(h, ax, N, scale=sc),
                       bf.irfft_axis_plain(h, ax, N, scale=sc),
                       f"{c} {tuple(sh)} axis {ax} n={N}")
            n += 1
    return n


def _holds_tp(holds, bf, rnd, sfx):
    """fft_axis_tp of one build against its plain version: lead, mid and
    last positions, whole lines, the 768- and 1024-point tiles, even Nt
    (fold and split) and odd Nt, Nt = 1, both signs, with and without a
    scale; returns the number of cases."""
    name = 'fft_axis_tp' + sfx
    n = 0
    for shape, ax, nt in (((768, 6, 40), 0, 512), ((6, 768, 40), 1, 512),
                          ((50, 768), 1, 512), ((96, 24, 40), 0, 63),
                          ((6, 96, 40), 1, 64), ((40, 96), 1, 63),
                          ((6, 5, 1024), 2, 683), ((3, 8, 48), 2, 32),
                          ((12, 5, 7), 0, 1)):
        N = shape[ax]
        p = rnd(2, *shape)
        sh = list(shape)
        sh[ax] = nt
        q = rnd(2, *sh)
        for fwd in (True, False):
            for sc in (None, 1.0 / N):
                what = f"{name} {shape} axis {ax} Nt={nt} fwd={fwd} sc={sc}"
                holds.hold(name, bf.fft_axis_tp(p, ax, fwd, trunc=nt,
                                                scale=sc),
                           bf.fft_axis_tp_plain(p, ax, fwd, trunc=nt,
                                                scale=sc), f"{what} trunc")
                holds.hold(name, bf.fft_axis_tp(q, ax, fwd, pad=N,
                                                scale=sc),
                           bf.fft_axis_tp_plain(q, ax, fwd, pad=N,
                                                scale=sc), f"{what} pad")
                n += 2
    return n


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


def phase_dealias(dev, bf, dtype='f'):
    """The r2c 3/2-rule plan at float32 ('f', phase dealias) or float64
    ('d', phase dealias64)."""
    from mpi4py_fft_torch import PlanarPFFT
    from mpi4py_fft_torch.libfft import truncate_planar
    f64 = dtype == 'd'
    d = DEALIAS64_N if f64 else DEALIAS_N
    sfx, tol = ('_f64', PIPE_TOL64) if f64 else ('', PIPE_TOL)
    pfft = PlanarPFFT(None, (d,) * 3, dtype=dtype, padding=1.5)
    shape = pfft.global_shape(False)
    m = 3 * d // 2
    _check(tuple(shape) == (m,) * 3, f"padded shape {shape}")
    g = torch.Generator(device=dev).manual_seed(SEED + (13 if f64 else 3))
    x = torch.rand(shape, generator=g, device=dev,
                   dtype=torch.float64 if f64 else torch.float32) - 0.5
    c0 = dict(bf.LAUNCHES)
    y = pfft.forward(x)
    torch.cuda.synchronize()
    c1 = dict(bf.LAUNCHES)
    z = pfft.backward(y)
    torch.cuda.synchronize()
    c2 = dict(bf.LAUNCHES)
    fwd = _delta(c0, c1)
    bwd = _delta(c1, c2)
    _check(fwd == {'fft_axis_p' + sfx: 2, 'rfft_axis_p' + sfx: 1},
           f"forward launches {fwd}")
    _check(bwd == {'fft_axis_p' + sfx: 2, 'irfft_axis_p' + sfx: 1},
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
    name = 'dealias64' if f64 else 'dealias'
    _check(max(err_y, err_z, err_o) <= tol,
           f"{name}: fwd {err_y:.3e}, bwd {err_z:.3e}, oracle {err_o:.3e}")
    _check(bool(torch.isfinite(z).all()), f"{name}: non-finite")
    del x, y, z, ref
    torch.cuda.empty_cache()
    _emit({'phase': name, 'shape': [d] * 3, 'physical': list(shape),
           'dtype': dtype, 'rel_l2_fwd_vs_plain': err_y,
           'rel_l2_bwd_vs_plain': err_z, 'rel_l2_fwd_vs_rfftn': err_o,
           'launches_fwd': fwd, 'launches_bwd': bwd})


def _waves(n, seed):
    """Four plane waves ((k0, k1, k2), complex amplitude), distinct
    wavevectors in [0, n)^3, from a seed."""
    rng = np.random.default_rng(seed)
    out = {}
    while len(out) < 4:
        k = tuple(int(v) for v in rng.integers(0, n, 3))
        out[k] = complex(*rng.standard_normal(2))
    return list(out.items())


def _plane_waves(waves, n, dev):
    """Planar (2, n, n, n) float64 sum of a exp(2 pi i k.x / n) over the
    waves, built per axis with exact phases ((k x) mod n) and added 64
    rows of axis 0 at a time."""
    idx = torch.arange(n, device=dev, dtype=torch.int64)
    x = torch.zeros((2, n, n, n), dtype=torch.float64, device=dev)

    def e(k):
        ph = ((k * idx) % n).to(torch.float64) * (2 * math.pi / n)
        return torch.polar(torch.ones_like(ph), ph)

    for (k0, k1, k2), a in waves:
        e0 = a * e(k0)
        e12 = e(k1)[:, None] * e(k2)[None, :]
        for i in range(0, n, 64):
            w = e0[i:i + 64, None, None] * e12[None]
            x[0, i:i + 64] += w.real
            x[1, i:i + 64] += w.imag
            del w
    return x


def _waves_err(y, waves):
    """Relative L2 error and max abs error of a normalized planar
    spectrum y against the exact one of the waves (their amplitudes at
    their wavevectors, zero elsewhere), 64 rows of axis 0 at a time."""
    n = y.shape[1]
    num = mx = 0.0
    for i in range(0, n, 64):
        d = y[:, i:i + 64].clone()
        for (k0, k1, k2), a in waves:
            if i <= k0 < i + 64:
                d[0, k0 - i, k1, k2] -= a.real
                d[1, k0 - i, k1, k2] -= a.imag
        num += float((d * d).sum())
        mx = max(mx, float(d.abs().max()))
        del d
    return math.sqrt(num / sum(abs(a) ** 2 for _, a in waves)), mx


def phase_north64(dev, bf):
    """The c2c north star at float64: forward against the exact spectrum
    of plane waves, round trip against the input built anew (the x, y and
    oracle volumes of 17.18 GB each do not fit together)."""
    from mpi4py_fft_torch import PlanarPFFT
    n = NORTH64_N
    pfft = PlanarPFFT(None, (n,) * 3, dtype='D')
    waves = _waves(n, SEED + 20)
    x = _plane_waves(waves, n, dev)
    vol_gb = x.numel() * 8 / 1e9
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    c0 = dict(bf.LAUNCHES)
    t0 = time.perf_counter()
    y = pfft.forward(x)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    # the forward's peak with its input, as phase_north counts it
    fwd_peak = torch.cuda.max_memory_allocated() / 1e9 - held + vol_gb
    c1 = dict(bf.LAUNCHES)
    _check(_delta(c0, c1) == {'fft_axis_p_f64': 3},
           f"'D' forward launches {_delta(c0, c1)}")
    _check(tuple(y.shape) == (2, n, n, n) and y.dtype == torch.float64,
           f"'D' forward {y.shape} {y.dtype}")
    err_f, mx_f = _waves_err(y, waves)
    del x
    z = pfft.backward(y)
    torch.cuda.synchronize()
    c2 = dict(bf.LAUNCHES)
    _check(_delta(c1, c2) == {'fft_axis_p_f64': 3},
           f"'D' backward launches {_delta(c1, c2)}")
    del y
    x = _plane_waves(waves, n, dev)
    err_rt, _ = _rel(z, x)
    _check(bool(torch.isfinite(z).all()), "'D' round trip: non-finite")
    del x, z
    torch.cuda.empty_cache()
    _check(max(err_f, err_rt) <= PIPE_TOL64,
           f"{n}^3 'D': forward {err_f:.3e}, round trip {err_rt:.3e}")
    _emit({'phase': 'north64', 'shape': [n] * 3, 'dtype': 'D',
           'waves': [[list(k), [a.real, a.imag]] for k, a in waves],
           'rel_l2_fwd_vs_exact': err_f, 'max_abs_fwd_vs_exact': mx_f,
           'rel_l2_round_trip': err_rt, 'fft_axis_p_f64_per_transform': 3,
           'first_forward_s': t_fwd, 'fwd_peak_gb': fwd_peak,
           'volume_gb': vol_gb})


class _RfftnPlan:
    """Stands in for ``PlanarPFFT`` in the DNS example to build its oracle:
    the same normalized forward and unnormalized backward on complex128
    ``torch.fft.rfftn``/``irfftn``.  The port never calls it."""

    def __init__(self, comm, shape, dtype='d', device=None):
        self.shape = tuple(shape)
        self.rdtype = np.dtype('float64')
        self.device = torch.device(device)

    def global_shape(self, forward_output=False):
        if forward_output:
            return (2,) + self.shape[:-1] + (self.shape[-1] // 2 + 1,)
        return self.shape

    def forward(self, x):
        F = torch.fft.rfftn(x, norm='forward')
        return torch.stack([F.real, F.imag])

    def backward(self, p):
        return torch.fft.irfftn(torch.complex(p[0], p[1]), s=self.shape,
                                norm='forward')


def phase_dns64(dev, bf):
    """The port's spectral DNS solver in float64: the 64^3 energy anchor,
    then 512^3 steps against a complex128 torch.fft oracle."""
    from mpi4py_fft_torch.examples import spectral_dns_planar as dns
    a = DNS_ANCHOR_N
    c0 = dict(bf.LAUNCHES)
    k = dns.run(N=(a,) * 3, T=0.1, dt=0.01, dtype='d', verbose=False)
    c1 = dict(bf.LAUNCHES)
    # 3 forwards to start, 10 steps of 12 forwards and 24 backwards, 3
    # backwards for the energy
    want = {'fft_axis_p_f64': 2 * (3 + 360 + 3), 'rfft_axis_p_f64': 123,
            'irfft_axis_p_f64': 243}
    _check(_delta(c0, c1) == want, f"anchor launches {_delta(c0, c1)}")
    _check(round(k - dns.ENERGY_64, 7) == 0,
           f"{a}^3 energy {k!r}, the reference's {dns.ENERGY_64}")
    n = DNS_N
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pfft, U, step, energy = dns.make_solver(N=(n,) * 3, dtype='d')
    _check(U.device == dev and U.dtype == torch.float64,
           f"DNS state {U.dtype} on {U.device}")
    U = step(U)                                 # warm-up
    torch.cuda.synchronize()
    c2 = dict(bf.LAUNCHES)
    ms = []
    for _ in range(2):
        ta = torch.cuda.Event(enable_timing=True)
        tb = torch.cuda.Event(enable_timing=True)
        ta.record()
        U = step(U)
        tb.record()
        tb.synchronize()
        ms.append(ta.elapsed_time(tb))
    c3 = dict(bf.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    per_step = {'fft_axis_p_f64': 72, 'rfft_axis_p_f64': 12,
                'irfft_axis_p_f64': 24}
    _check(_delta(c2, c3) == {k: 2 * c for k, c in per_step.items()},
           f"DNS launches in 2 steps {_delta(c2, c3)}")
    _check(bool(torch.isfinite(U).all()), "DNS state: non-finite")
    e = energy(U)
    c4 = dict(bf.LAUNCHES)
    del step, energy, pfft
    # oracle: the same solver and steps on complex128 torch.fft
    saved = dns.PlanarPFFT
    dns.PlanarPFFT = _RfftnPlan
    try:
        _, V, ostep, oenergy = dns.make_solver(N=(n,) * 3, dtype='d',
                                               device=dev)
    finally:
        dns.PlanarPFFT = saved
    for _ in range(3):
        V = ostep(V)
    torch.cuda.synchronize()
    _check(bf.LAUNCHES == c4, "the oracle launched a kernel")
    err, mx = _rel(U, V)
    e_ref = oenergy(V)
    del U, V, ostep, oenergy
    torch.cuda.empty_cache()
    _check(err <= PIPE_TOL64, f"{n}^3 DNS vs oracle: {err:.3e}")
    # the transforms' bytes a step: 72 c2c passes over the spectrum and
    # 36 r2c/c2r passes between the real volume and the spectrum
    spec = 2 * n * n * (n // 2 + 1) * 8
    real = n ** 3 * 8
    bound, _ = _bound_ms(72 * 2 * spec + 36 * (spec + real), 0, f64=True)
    _emit({'phase': 'dns64', 'anchor_shape': [a] * 3,
           'anchor_energy': k, 'anchor_launches': _delta(c0, c1),
           'shape': [n] * 3, 'dtype': 'd', 'ms_per_step': ms,
           'transforms_bound_ms_per_step': bound,
           'launches_per_step': per_step, 'rel_l2_vs_oracle': err,
           'max_abs_vs_oracle': mx, 'energy_t0.03': e,
           'oracle_energy_t0.03': e_ref, 'peak_gb': peak})


def phase_times64(dev, bf, holds):
    """The fp64 builds at the 512^3 DNS's shapes, both signs held; A64 on
    the full 1024^3 'D' volume, held; and the 1024^3 'D' transform end to
    end."""
    n = DNS_N
    nh = n // 2 + 1
    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    out = {}
    # A: the two c2c passes of one DNS transform, on its spectrum (the
    # band kernel: single elements at the odd post of the mid pass)
    p = torch.rand((2, n, n, nh), generator=g, device=dev,
                   dtype=torch.float64) - 0.5
    per_axis = [_axis64_pass(bf, holds, p, 1, 'band, single elements'),
                _axis64_pass(bf, holds, p, 0, 'band, vectors')]
    del p
    keys = ('ms', 'plain_ms', 'library_ms', 'bound_ms', 'reach_ms')
    row = {k: sum(a[k] for a in per_axis) for k in keys}
    row.update(shape=f'2 passes, axes 1 and 0 of (2, {n}, {n}, {nh}) f64',
               bound_by=per_axis[0]['bound_by'], per_axis=per_axis)
    row['w768'] = _axis64_w768(dev, bf, holds, g)
    out['fft_axis_p_f64'] = row
    # B and C: the last axis of the DNS's real volume
    r = torch.rand((n, n, n), generator=g, device=dev,
                   dtype=torch.float64) - 0.5
    h = bf.rfft_axis_p(r, 2)
    holds.hold('rfft_axis_p_f64', h, bf.rfft_axis_plain(r, 2),
               f"rfft_axis_p_f64 {n}^3 last axis")
    b, by = _bound_ms(r.numel() * 8 + 2 * n * n * nh * 8,
                      n * n * 2.5 * n * math.log2(n), f64=True)
    out['rfft_axis_p_f64'] = {
        'shape': f'({n}, {n}, {n}) f64 -> (2, {n}, {n}, {nh}), last axis',
        'ms': _median_ms(lambda: bf.rfft_axis_p(r, 2)),
        'plain_ms': _median_ms(lambda: bf.rfft_axis_plain(r, 2), reps=3,
                               warm=1),
        'library_ms': _median_ms(lambda: torch.fft.rfft(r, dim=2)),
        'bound_ms': b, 'bound_by': by}
    del r
    out['rfft_axis_p_f64']['trunc768'] = _times_trunc(dev, bf, holds, g,
                                                     f64=True)
    hc = torch.complex(h[0], h[1])
    for sc in (None, 1.0 / n):
        holds.hold('irfft_axis_p_f64', bf.irfft_axis_p(h, 2, n, scale=sc),
                   bf.irfft_axis_plain(h, 2, n, scale=sc),
                   f"irfft_axis_p_f64 {n}^3 last axis scale={sc}")
    out['irfft_axis_p_f64'] = {
        'shape': f'(2, {n}, {n}, {nh}) f64 -> ({n}, {n}, {n}), last axis',
        'ms': _median_ms(lambda: bf.irfft_axis_p(h, 2, n)),
        'plain_ms': _median_ms(lambda: bf.irfft_axis_plain(h, 2, n),
                               reps=3, warm=1),
        'library_ms': _median_ms(
            lambda: torch.fft.irfft(hc, n=n, dim=2, norm='forward')),
        'bound_ms': b, 'bound_by': by}
    del h, hc
    torch.cuda.empty_cache()
    slabs, row['w1024'] = _holds_volume64(dev, bf, holds)
    # end to end: the normalized 'D' forward and the backward, timed apart
    # (x, y and the two volumes in flight fill 3 of the card's 80 GB)
    from mpi4py_fft_torch import PlanarPFFT
    m = NORTH64_N
    pfft = PlanarPFFT(None, (m,) * 3, dtype='D')
    x = _plane_waves(_waves(m, SEED + 20), m, dev)
    t_f = _median_ms(lambda: pfft.forward(x), reps=3, warm=1)
    y = pfft.forward(x)
    del x
    t_b = _median_ms(lambda: pfft.backward(y), reps=3, warm=1)
    del y
    torch.cuda.empty_cache()
    e2e = (t_f + t_b) / 2
    b3, _ = _pass_bound(2 * m ** 3, m, f64=True)
    _emit({'phase': 'times64', 'e2e_shape': [m] * 3, 'e2e_dtype': 'D',
           'e2e_ms_per_transform': e2e, 'e2e_fwd_ms': t_f,
           'e2e_bwd_ms': t_b, 'e2e_bound_ms': 3 * b3,
           'e2e_gflops_5nlogn': 5.0 * m ** 3 * math.log2(m ** 3)
           / (e2e * 1e-3) / 1e9, 'full_volume_slabs_held': slabs,
           'kernels': out})
    return out


def _times_trunc(dev, bf, holds, g, f64=False):
    """B (B64 with ``f64``) at the truncating pass of the dealiased plan
    (libfft's r2c stage of PFFT((512,)*3, padding=[1.5]*3) at 'f', which
    m3 runs, or 'd': a 768^3 input, trunc 257, the stage's scale 1/768),
    held at 5e-6 (2e-13) and timed beside its plain version, its bound and
    torch.fft.rfft."""
    n = DEALIAS64_N if f64 else DEALIAS_N
    m = 3 * n // 2
    nt = n // 2 + 1
    kw = dict(trunc=nt, scale=1.0 / m)
    dtype, size, sfx, tag = ((torch.float64, 8, '_f64', 'f64') if f64 else
                             (torch.float32, 4, '', 'f32'))
    r = torch.rand((m, m, m), generator=g, device=dev, dtype=dtype) - 0.5
    _nan_block((2, m, m, nt), dtype, dev)
    _slab_hold(holds, 'rfft_axis_p' + sfx, bf.rfft_axis_p(r, 2, **kw),
               lambda i, w: bf.rfft_axis_plain(r.narrow(0, i, w), 2, **kw),
               1, f"rfft_axis_p{sfx} {m}^3 last axis trunc={nt}")
    b, by = _bound_ms(r.numel() * size + 2 * m * m * nt * size,
                      m * m * 2.5 * m * math.log2(m), f64=f64)
    row = {'shape': f'({m}, {m}, {m}) {tag} -> (2, {m}, {m}, {nt}), last '
                    f'axis, trunc {nt}, scale 1/{m}',
           'ms': _median_ms(lambda: bf.rfft_axis_p(r, 2, **kw)),
           'plain_ms': _median_ms(lambda: bf.rfft_axis_plain(r, 2, **kw),
                                  reps=3, warm=1),
           'library_ms': _median_ms(lambda: torch.fft.rfft(r, dim=2)),
           'bound_ms': b, 'bound_by': by}
    del r
    torch.cuda.empty_cache()
    return row


def _times_b(dev, bf, holds):
    """B (f32) on the dealiasing grid's 768^3 last axis, held at 5e-6 on
    a NaN-filled output and timed beside its plain version, torch.fft.rfft
    and its bound, with the truncating pass of m3's forward as its
    ``trunc768`` row; returns the row and the spectrum (C's input)."""
    m = 3 * DEALIAS_N // 2
    nh = m // 2 + 1
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    r = torch.rand((m, m, m), generator=g, device=dev) - 0.5
    _nan_block((2, m, m, nh), torch.float32, dev)
    k = bf.rfft_axis_p(r, 2)
    _slab_hold(holds, 'rfft_axis_p', k, lambda i, w: bf.rfft_axis_plain(
        r.narrow(0, i, w), 2), 1, f"rfft_axis_p {m}^3 last axis")
    b, by = _bound_ms(r.numel() * 4 + 2 * m * m * nh * 4,
                      m * m * 2.5 * m * math.log2(m))
    row = {
        'shape': f'({m}, {m}, {m}) f32 -> (2, {m}, {m}, {nh}), last axis',
        'ms': _median_ms(lambda: bf.rfft_axis_p(r, 2)),
        'plain_ms': _median_ms(lambda: bf.rfft_axis_plain(r, 2)),
        'library_ms': _median_ms(lambda: torch.fft.rfft(r, dim=2)),
        'bound_ms': b, 'bound_by': by}
    del r
    torch.cuda.empty_cache()
    row['trunc768'] = _times_trunc(dev, bf, holds, g)
    return row, k


def _axis64_w768(dev, bf, holds, g):
    """A64 at the three passes of a 768^3 volume (the dealiased 'd'
    plans' length): the last axis on the line kernel, the others on the
    band kernel (a radix-3 column stage first, clusters of four CTAs)."""
    m = 3 * DEALIAS64_N // 2
    p = torch.rand((2, m, m, m), generator=g, device=dev,
                   dtype=torch.float64) - 0.5
    rows = [_axis64_pass(bf, holds, p, 2, 'lines'),
            _axis64_pass(bf, holds, p, 1, 'band, vectors'),
            _axis64_pass(bf, holds, p, 0, 'band, vectors')]
    del p
    torch.cuda.empty_cache()
    return rows


def _axis64_pass(bf, holds, p, ax, route, in_place=True):
    """A64 (fft_axis_p on float64) on p along ax: held on both signs slab
    by slab against its plain version into a NaN-filled output, in place
    (out= a copy of p, ``in_place``) bit for bit against out of place,
    then timed beside its plain version, complex128 torch.fft.fft, its
    bound and its reachable bound."""
    sd = 2 if ax == 0 else 1                   # slabs off the pass axis
    N = p.shape[1 + ax]
    tag = f"fft_axis_p_f64 {tuple(p.shape)} axis {ax} ({route})"
    for fwd in (True, False):
        k = bf.fft_axis_p(p, ax, fwd, out=_nan(p))
        _slab_hold(holds, 'fft_axis_p_f64', k, lambda i, w: (
            bf.fft_axis_plain(p.narrow(sd, i, w), ax, fwd)), sd,
            f"{tag} fwd={fwd}")
        del k
    if in_place:
        _hold_axis64_in_place(bf, p, ax, tag)
    b, by = _pass_bound(p.numel(), N, f64=True)
    row = {'axis': ax, 'route': route, 'shape': f'{tuple(p.shape)} f64, '
                                                 f'axis {ax}',
           'ms': _median_ms(lambda: bf.fft_axis_p(p, ax)),
           'plain_ms': _median_ms(lambda: bf.fft_axis_plain(p, ax), reps=3,
                                  warm=1)}
    pc = torch.complex(p[0], p[1])
    row['library_ms'] = _median_ms(lambda: torch.fft.fft(pc, dim=ax))
    del pc
    row.update(bound_ms=b, bound_by=by,
               reach_ms=_reach_ms((p,), ax))
    return row


def _hold_axis64_in_place(bf, p, ax, tag):
    """fft_axis_p on float64 in place (out= a copy of p) against out of
    place into a NaN-filled tensor, bit for bit, with a scale."""
    q = p.clone()
    _check(bf.fft_axis_p(q, ax, False, scale=0.5, out=q) is q,
           f"{tag}: out= returned a new tensor")
    _exact(q, bf.fft_axis_p(p, ax, False, scale=0.5, out=_nan(p)),
           f"{tag} in place")
    del q


def _holds_volume64(dev, bf, holds):
    """fft_axis_p_f64 on a random (2, 1024, 1024, 1024) volume at the six
    passes of a normalized 'D' forward and backward (forward axes 2, 1,
    then 0 with the 1/n^3 scale; backward axes 0, 1, 2), each output
    starting as NaN and held against fft_axis_plain slab by slab along an
    axis it does not transform (64 rows, 1.07 GB a slab); then each axis
    timed beside its plain version, complex128 torch.fft.fft, its bound
    and its reachable bound, and held in place bit for bit on a 64-row
    slab of the volume.  Returns the number of slabs held and the rows."""
    n = NORTH64_N
    g = torch.Generator(device=dev).manual_seed(SEED + 22)
    x = torch.rand((2, n, n, n), generator=g, device=dev,
                   dtype=torch.float64).sub_(0.5)
    passes = ((2, True, None), (1, True, None), (0, True, 1.0 / n ** 3),
              (0, False, None), (1, False, None), (2, False, None))
    s = min(64, n)
    for ax, fwd, sc in passes:
        _nan_block(x.shape, x.dtype, dev)
        k = bf.fft_axis_p(x, ax, fwd, scale=sc)
        d = 2 if ax == 0 else 1         # the slabs' dim in the planar view
        for i in range(0, n, s):
            holds.hold('fft_axis_p_f64', k.narrow(d, i, s),
                       bf.fft_axis_plain(x.narrow(d, i, s), ax, fwd,
                                         scale=sc),
                       f"fft_axis_p_f64 {n}^3 axis {ax} fwd={fwd} "
                       f"slab {i}")
        del k
    rows = []
    for ax, route in ((2, 'lines'), (1, 'band, vectors'),
                      (0, 'band, vectors')):
        sd = 2 if ax == 0 else 1
        _hold_axis64_in_place(bf, x.narrow(sd, 0, s).contiguous(), ax,
                              f"fft_axis_p_f64 {n}^3 slab, axis {ax}")
        b, by = _pass_bound(x.numel(), n, f64=True)
        row = {'axis': ax, 'route': route,
               'shape': f'{tuple(x.shape)} f64, axis {ax}',
               'ms': _median_ms(lambda: bf.fft_axis_p(x, ax), reps=5),
               'plain_ms': _median_ms(lambda: bf.fft_axis_plain(x, ax),
                                      reps=1, warm=1)}
        xc = torch.complex(x[0], x[1])
        row['library_ms'] = _median_ms(lambda: torch.fft.fft(xc, dim=ax),
                                       reps=5)
        del xc
        torch.cuda.empty_cache()
        row.update(bound_ms=b, bound_by=by,
                   reach_ms=_reach_ms((x,), ax))
        rows.append(row)
    del x
    torch.cuda.empty_cache()
    return len(passes) * n // s, rows


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
    nh = m // 2 + 1
    out['rfft_axis_p'], k = _times_b(dev, bf, holds)
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    b, by = _bound_ms(m ** 3 * 4 + 2 * m * m * nh * 4,
                      m * m * 2.5 * m * math.log2(m))
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


def _pass_bound(numel, N, f64=False):
    """Bound of one pass over a planar f32 (or f64) tensor of ``numel``
    elements along an N-long axis: read and write it once, 5 N log2 N
    flops a line."""
    lines = numel // 2 // N
    return _bound_ms(2 * numel * (8 if f64 else 4),
                     lines * 5 * N * math.log2(N), f64)


def _pair_pass(bf, holds, pa, pb, ax, route):
    """D (fft_axis2_p) on the halves pa, pb along ax: held on both signs
    slab by slab against its plain version into NaN-filled output halves,
    then timed beside its plain version, cuFFT's pass over the assembled
    axis, its bound and its reachable bound."""
    d = 1 + ax
    sd = 2 if ax == 0 else 1                   # slabs off the pass axis
    N = 2 * pa.shape[d]
    tag = f"fft_axis2_p {tuple(pa.shape)} pair axis {ax} ({route})"
    for fwd in (True, False):
        oa, ob = bf.fft_axis2_p(pa, pb, ax, fwd, out=(_nan(pa), _nan(pb)))
        for i in range(0, pa.shape[sd], 64):
            w = min(64, pa.shape[sd] - i)
            ra, rb = bf.fft_axis2_plain(pa.narrow(sd, i, w),
                                        pb.narrow(sd, i, w), ax, fwd)
            holds.hold('fft_axis2_p',
                       torch.cat([oa.narrow(sd, i, w),
                                  ob.narrow(sd, i, w)], d),
                       torch.cat([ra, rb], d), f"{tag} fwd={fwd} slab {i}")
            del ra, rb
        del oa, ob
    full = torch.cat([pa, pb], d)
    fc = torch.complex(full[0], full[1])
    del full
    b, by = _pass_bound(2 * pa.numel(), N)
    row = {'axis': ax, 'route': route,
           'shape': f'{tuple(pa.shape)} f32 pair, axis {ax}, N = {N}',
           'ms': _median_ms(lambda: bf.fft_axis2_p(pa, pb, ax)),
           'plain_ms': _median_ms(lambda: bf.fft_axis2_plain(pa, pb, ax),
                                  reps=3, warm=1),
           'library_ms': _median_ms(lambda: torch.fft.fft(fc, dim=ax)),
           'bound_ms': b, 'bound_by': by,
           'reach_ms': _reach_ms((pa, pb), ax)}
    del fc
    return row


def _times_axis2(bf, holds, x):
    """D at the quartered schedule's pair passes: axis 0 of (Q00, Q10)
    (the band kernel) and axis 2 of (Q00, Q01) (the line kernel), each
    also against A on the assembled line (the same arithmetic at N =
    1024) and in place (alias=True) bit for bit against out of place; at
    fft3_8's y pass (axis 1 of two eighths, the band kernel); and at
    N = 768 (the halves of a 768^3 volume's last axis on the line kernel,
    of its lead axis on the band kernel).  Each held on both signs slab by slab into NaN-filled halves
    and timed (``_pair_pass``)."""
    from mpi4py_fft_torch.ops import oop3d
    qs = oop3d.split_q(x)
    q00, q01, q10 = qs[:3]
    del qs
    qshape = tuple(q00.shape)
    per_axis = []
    for ax, (pa, pb), route in ((0, (q00, q10), 'band'),
                                (2, (q00, q01), 'lines')):
        row = _pair_pass(bf, holds, pa, pb, ax, route)
        d = 1 + ax
        k = torch.cat(bf.fft_axis2_p(pa, pb, ax), d)
        _, row['max_abs_vs_fft_axis_p'] = _rel(
            k, bf.fft_axis_p(torch.cat([pa, pb], d), ax))
        del k
        _hold_pair_in_place(pa, pb, pa.clone(), pb.clone(), ax, bf)
        per_axis.append(row)
    del q00, q01, q10, pa, pb
    # a quartered transform runs two pair passes on each of axes 0 and 2
    keys = ('ms', 'plain_ms', 'library_ms', 'bound_ms', 'reach_ms')
    row = {k: 2 * sum(a[k] for a in per_axis) for k in keys}
    row.update(shape=f'4 passes, 2 on each of axes 0 and 2 of {qshape} '
                     f'f32 pairs', bound_by=per_axis[0]['bound_by'],
               per_axis=per_axis)
    h = x.shape[1] // 2
    ea = x[:, :h, :h, :h].contiguous()
    eb = x[:, :h, h:, :h].contiguous()
    row['mid_pair'] = _pair_pass(bf, holds, ea, eb, 1, 'band')
    del ea, eb
    # N = 768: the halves of a 768^3 volume's last axis (lines) and lead
    # axis (the band, a radix-3 column stage first)
    m = 3 * DEALIAS_N // 2
    v = _rand((2, m, m, m), x.device, SEED + 6)
    for key, ax, route in (('n768', 2, 'lines'), ('n768_band', 0, 'band')):
        va = v.narrow(1 + ax, 0, m // 2).contiguous()
        vb = v.narrow(1 + ax, m // 2, m // 2).contiguous()
        row[key] = _pair_pass(bf, holds, va, vb, ax, route)
        del va, vb
        torch.cuda.empty_cache()
    del v
    torch.cuda.empty_cache()
    return row


def _pair_row(p, shape, ax, bf):
    """Time of fft_axis_pair_p on p beside its plain version, cuFFT's
    pass and its bound."""
    pc = torch.complex(p[0], p[1])
    b, by = _pass_bound(p.numel(), shape[ax])
    row = {'shape': f'(2, {shape[0]}, {shape[1]}, {shape[2]}) f32, '
                    f'axis {ax}',
           'ms': _median_ms(lambda: bf.fft_axis_pair_p(p, ax)),
           'plain_ms': _median_ms(lambda: bf.fft_axis_pair_plain(p, ax)),
           'library_ms': _median_ms(lambda: torch.fft.fft(pc, dim=ax)),
           'bound_ms': b, 'bound_by': by}
    del pc
    return row


def _hold_pair_in_place(pa, pb, qa, qb, ax, bf):
    """fft_axis2_p in place (alias=True on qa, qb, copies of the halves
    pa, pb) against out of place into NaN-filled halves, bit for bit."""
    ga, gb = bf.fft_axis2_p(qa, qb, ax, alias=True)
    _check(ga is qa and gb is qb, "alias=True returned new tensors")
    oa, ob = bf.fft_axis2_p(pa, pb, ax, out=(_nan(ga), _nan(gb)))
    what = f"fft_axis2_p {tuple(pa.shape)} axis {ax} in place"
    _exact(ga, oa, f"{what}, first half")
    _exact(gb, ob, f"{what}, second half")
    del ga, gb, oa, ob


def _times_pair(dev, bf, holds):
    """G (the cluster kernel) at N = 2048 on every axis position and at
    N = 1536 on the lead axis, both signs held; timed on the (2048, 1024,
    512) plan's lead pass and at N = 1536; held in place at the first."""
    row = None
    for i, (shape, ax) in enumerate(PAIR_SHAPES + (PAIR_1536,)):
        p = _rand((2,) + shape, dev, SEED + 8 + i)
        for fwd in (True, False):
            holds.hold('fft_axis_pair_p', bf.fft_axis_pair_p(p, ax, fwd),
                       bf.fft_axis_pair_plain(p, ax, fwd),
                       f"fft_axis_pair_p {shape} axis {ax} fwd={fwd}")
        if row is None:
            row = _pair_row(p, shape, ax, bf)
            h = p.shape[1] // 2
            q = p.clone()
            _hold_pair_in_place(p.narrow(1, 0, h), p.narrow(1, h, h),
                                q.narrow(1, 0, h), q.narrow(1, h, h), 0, bf)
            del q
        elif (shape, ax) == PAIR_1536:
            row['n1536'] = _pair_row(p, shape, ax, bf)
        del p
        torch.cuda.empty_cache()
    return row


def _planar_c(z):
    """A complex tensor as a real (..., 2) view, for _rel."""
    return torch.view_as_real(z) if z.is_complex() else z


def _truncate_all(ref, d, hermitian):
    """The forward's 3/2-rule truncations of a normalized planar spectrum
    of the (1.5 d)^3 grid, axis by axis (they commute with the other
    axes' transforms)."""
    from mpi4py_fft_torch.libfft import truncate_planar
    ref = truncate_planar(ref, 3, d // 2 + 1 if hermitian else d,
                          hermitian=hermitian)
    ref = truncate_planar(ref, 2, d, hermitian=False)
    return truncate_planar(ref, 1, d, hermitian=False)


def phase_pfft(dev, bf, dtype):
    """The reference API's dealiased plan ``PFFT(None, (d,)*3,
    padding=[1.5]*3)`` on planar tensors (phase pfft at 'f', pfft_c2c at
    'F', pfft64 at 'd')."""
    from mpi4py_fft_torch import PFFT
    f64, real = dtype in 'dD', dtype in 'fd'
    d = PFFT_N
    m = 3 * d // 2
    sfx, tol = ('_f64', PIPE_TOL64) if f64 else ('', PIPE_TOL)
    tdt = torch.float64 if f64 else torch.float32
    fft = PFFT(None, (d,) * 3, padding=[1.5] * 3, dtype=dtype)
    _check(fft.global_shape(False) == (m,) * 3,
           f"padded shape {fft.global_shape(False)}")
    g = torch.Generator(device=dev).manual_seed(SEED + 30 + ord(dtype))
    x = torch.rand((m,) * 3 if real else (2,) + (m,) * 3, generator=g,
                   device=dev, dtype=tdt) - 0.5
    tp = 'fft_axis_tp' + sfx
    want_f = {'rfft_axis_p' + sfx: 1, tp: 2} if real else {tp: 3}
    want_b = {tp: 2, 'irfft_axis_p' + sfx: 1} if real else {tp: 3}
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    c0 = dict(bf.LAUNCHES)
    y = fft.forward.fn_p(x)
    torch.cuda.synchronize()
    c1 = dict(bf.LAUNCHES)
    fwd_peak = torch.cuda.max_memory_allocated() / 1e9 - held
    torch.cuda.reset_peak_memory_stats()
    held_b = torch.cuda.memory_allocated() / 1e9
    z = fft.backward.fn_p(y)
    torch.cuda.synchronize()
    c2 = dict(bf.LAUNCHES)
    bwd_peak = torch.cuda.max_memory_allocated() / 1e9 - held_b
    _check(_delta(c0, c1) == want_f, f"'{dtype}' forward launches "
                                     f"{_delta(c0, c1)}")
    _check(_delta(c1, c2) == want_b, f"'{dtype}' backward launches "
                                     f"{_delta(c1, c2)}")
    spec = (2, d, d, d // 2 + 1) if real else (2, d, d, d)
    _check(tuple(y.shape) == spec and y.dtype == tdt,
           f"spectrum {tuple(y.shape)} {y.dtype}")
    _check(tuple(z.shape) == tuple(x.shape), f"backward {tuple(z.shape)}")
    with _plain_path(bf):
        yp = fft.forward.fn_p(x)
        zp = fft.backward.fn_p(yp)
    torch.cuda.synchronize()
    _check(bf.LAUNCHES == c2, "the plain path launched a kernel")
    err_y, _ = _rel(y, yp)
    err_z, _ = _rel(z, zp)
    del yp, zp
    if real:
        F = torch.fft.rfftn(x, norm='forward')
    else:
        F = torch.fft.fftn(torch.complex(x[0], x[1]), norm='forward')
    ref = torch.stack([F.real, F.imag])
    del F
    ref = _truncate_all(ref, d, real)
    err_o, mx_o = _rel(y, ref)
    del ref
    _check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(z).all()),
           f"'{dtype}': non-finite")
    _check(max(err_y, err_z, err_o) <= tol,
           f"'{dtype}' {d}^3 padded: fwd vs plain {err_y:.3e}, bwd vs plain "
           f"{err_z:.3e}, vs oracle {err_o:.3e}")
    del z
    t_f = _median_ms(lambda: fft.forward.fn_p(x), reps=5, warm=1)
    t_b = _median_ms(lambda: fft.backward.fn_p(y), reps=5, warm=1)
    del x, y
    torch.cuda.empty_cache()
    name = {'f': 'pfft', 'F': 'pfft_c2c', 'd': 'pfft64'}[dtype]
    _emit({'phase': name, 'shape': [d] * 3, 'physical': [m] * 3,
           'dtype': dtype, 'rel_l2_fwd_vs_plain': err_y,
           'rel_l2_bwd_vs_plain': err_z, 'rel_l2_fwd_vs_oracle': err_o,
           'max_abs_fwd_vs_oracle': mx_o, 'launches_fwd': want_f,
           'launches_bwd': want_b, 'fwd_ms': t_f, 'bwd_ms': t_b,
           'fwd_peak_above_input_gb': fwd_peak,
           'bwd_peak_above_input_gb': bwd_peak})


def phase_buffer(dev, bf):
    """``newDistArray`` and the buffer call on DistArrays kept on the card:
    a real ('d') and a complex ('D') 256^3 plan, the forward against
    torch.fft and the round trip."""
    from mpi4py_fft_torch import PFFT, DistArray, newDistArray
    n = BUFFER_N
    out = {}
    for i, dtype in enumerate(('d', 'D')):
        fft = PFFT(None, (n,) * 3, dtype=dtype)
        u = newDistArray(fft, False)
        _check(isinstance(u, DistArray) and u.v.device == dev,
               f"newDistArray on {u.v.device}")
        g = torch.Generator(device=dev).manual_seed(SEED + 40 + i)
        data = torch.rand((n,) * 3, generator=g, device=dev,
                          dtype=torch.float64) - 0.5
        if dtype == 'D':
            data = torch.complex(data, torch.rand(
                (n,) * 3, generator=g, device=dev, dtype=torch.float64))
        u[:] = data
        c0 = dict(bf.LAUNCHES)
        uh = fft.forward(u)
        torch.cuda.synchronize()
        c1 = dict(bf.LAUNCHES)
        _check(isinstance(uh, DistArray) and uh.v.device == dev
               and uh.v.is_complex(), f"forward gave {type(uh)}")
        ub = newDistArray(fft, False)
        _check(fft.backward(uh, ub) is ub, "backward did not fill ub")
        torch.cuda.synchronize()
        c2 = dict(bf.LAUNCHES)
        want_f = {'rfft_axis_p_f64': 1, 'fft_axis_p_f64': 2} \
            if dtype == 'd' else {'fft_axis_p_f64': 3}
        want_b = {'irfft_axis_p_f64': 1, 'fft_axis_p_f64': 2} \
            if dtype == 'd' else {'fft_axis_p_f64': 3}
        _check(_delta(c0, c1) == want_f and _delta(c1, c2) == want_b,
               f"'{dtype}' buffer launches {_delta(c0, c1)} "
               f"{_delta(c1, c2)}")
        ref = torch.fft.rfftn(data, norm='forward') if dtype == 'd' \
            else torch.fft.fftn(data, norm='forward')
        err_f, _ = _rel(_planar_c(uh.v), _planar_c(ref))
        del ref
        err_rt, _ = _rel(_planar_c(ub.v), _planar_c(data))
        _check(max(err_f, err_rt) <= PIPE_TOL64,
               f"'{dtype}' buffer: forward {err_f:.3e}, round trip "
               f"{err_rt:.3e}")
        out[dtype] = {'rel_l2_fwd_vs_fft': err_f, 'rel_l2_round_trip': err_rt,
                      'launches_fwd': want_f, 'launches_bwd': want_b}
        del u, uh, ub, data, fft
        torch.cuda.empty_cache()
    _emit({'phase': 'buffer', 'shape': [n] * 3, 'plans': out})


class _RfftnPFFT:
    """Stands in for ``PFFT`` in the reference DNS solver to build its
    oracle: the same normalized forward and unnormalized backward, with
    the reference's 3/2-rule truncation and padding (``libfft``'s
    ``truncate_spectral``/``pad_spectral``), on complex128
    ``torch.fft.rfftn``/``irfftn``.  The port never calls it."""

    def __init__(self, comm, shape, padding=False, dtype='d', device=None,
                 **kw):
        from types import SimpleNamespace
        self.device = torch.device(device)
        self.N = tuple(shape)
        self.P = tuple(int(1.5 * n) for n in shape) if padding else self.N
        self.forward = SimpleNamespace(fn=self._fwd)
        self.backward = SimpleNamespace(fn=self._bck)

    def _fwd(self, u):
        from mpi4py_fft_torch.libfft import truncate_spectral
        F = torch.fft.rfftn(u, norm='forward')
        if self.P != self.N:
            sh = list(F.shape)
            for ax, n in ((2, self.N[2] // 2 + 1), (1, self.N[1]),
                          (0, self.N[0])):
                sh[ax] = n
                F = truncate_spectral(F, tuple(sh), ax, ax == 2)
        return F

    def _bck(self, U):
        from mpi4py_fft_torch.libfft import pad_spectral
        if self.P != self.N:
            sh = list(U.shape)
            for ax, n in ((0, self.P[0]), (1, self.P[1]),
                          (2, self.P[2] // 2 + 1)):
                sh[ax] = n
                U = pad_spectral(U, tuple(sh), ax, ax == 2)
        return torch.fft.irfftn(U, s=self.P, norm='forward')


def phase_dns_solver(dev, bf):
    """The reference spectral DNS solver on the port's PFFT, float64: the
    64^3 energy anchor, then 512^3 dealiased steps against a complex128
    torch.fft oracle."""
    from mpi4py_fft_torch.examples import spectral_dns_solver as dns
    a = DNS_ANCHOR_N
    c0 = dict(bf.LAUNCHES)
    k = dns.run(N=(a,) * 3, T=0.1, dt=0.01, verbose=False)
    c1 = dict(bf.LAUNCHES)
    # 2 forwards to start, 10 steps of 12 forwards and 24 backwards, 3
    # backwards for the energy
    want = {'fft_axis_p_f64': 2 * (2 + 360 + 3), 'rfft_axis_p_f64': 122,
            'irfft_axis_p_f64': 243}
    _check(_delta(c0, c1) == want, f"anchor launches {_delta(c0, c1)}")
    _check(round(k - dns.ENERGY_64, 7) == 0,
           f"{a}^3 energy {k!r}, the reference's {dns.ENERGY_64}")
    n = DNS_SOLVER_N
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fft, U, step, energy = dns.make_solver(N=(n,) * 3, padding=True)
    _check(U.device == dev and U.dtype == torch.complex128,
           f"DNS state {U.dtype} on {U.device}")
    U = step(U)                                 # warm-up
    torch.cuda.synchronize()
    c2 = dict(bf.LAUNCHES)
    ms = []
    for _ in range(2):
        ta = torch.cuda.Event(enable_timing=True)
        tb = torch.cuda.Event(enable_timing=True)
        ta.record()
        U = step(U)
        tb.record()
        tb.synchronize()
        ms.append(ta.elapsed_time(tb))
    c3 = dict(bf.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    per_step = {'fft_axis_tp_f64': 72, 'rfft_axis_p_f64': 12,
                'irfft_axis_p_f64': 24}
    _check(_delta(c2, c3) == {k: 2 * c for k, c in per_step.items()},
           f"DNS launches in 2 steps {_delta(c2, c3)}")
    _check(bool(torch.isfinite(torch.view_as_real(U)).all()),
           "DNS state: non-finite")
    e = energy(U)
    c4 = dict(bf.LAUNCHES)
    # the complex boundary of fn: one planar copy of a spectral component
    # in (backward) and one out (forward), 36 of them a step
    from mpi4py_fft_torch.ops import matfft
    u0 = U[0]
    copy_in = _median_ms(lambda: matfft.planar(u0))
    p0 = matfft.planar(u0)
    copy_out = _median_ms(lambda: matfft.unplanar(p0))
    del step, energy, fft, u0, p0
    torch.cuda.empty_cache()
    # oracle: the same solver and steps on complex128 torch.fft
    saved = dns.PFFT
    dns.PFFT = _RfftnPFFT
    try:
        _, V, ostep, oenergy = dns.make_solver(N=(n,) * 3, padding=True,
                                               device=dev)
    finally:
        dns.PFFT = saved
    for _ in range(3):
        V = ostep(V)
    torch.cuda.synchronize()
    _check(bf.LAUNCHES == c4, "the oracle launched a kernel")
    err, mx = _rel(torch.view_as_real(U), torch.view_as_real(V))
    e_ref = oenergy(V)
    del U, V, ostep, oenergy
    torch.cuda.empty_cache()
    _check(err <= PIPE_TOL64, f"{n}^3 dealiased DNS vs oracle: {err:.3e}")
    # the transforms' bytes a step: 36 transforms, each an r2c/c2r pass
    # between the real 768^3 grid and its (2, 768, 768, 257) spectrum and
    # two fused c2c passes (768 -> 512 rows on axis 1, then on axis 0)
    m = 3 * n // 2
    nh = n // 2 + 1
    one = (m ** 3 * 8 + 2 * m * m * nh * 8) + \
        2 * 8 * nh * ((m + n) * m + (m + n) * n)
    bound, _ = _bound_ms(36 * one, 0, f64=True)
    _emit({'phase': 'dns_solver', 'anchor_shape': [a] * 3,
           'anchor_energy': k, 'anchor_launches': _delta(c0, c1),
           'shape': [n] * 3, 'padding': [1.5] * 3, 'dtype': 'd',
           'ms_per_step': ms, 'transforms_bound_ms_per_step': bound,
           'launches_per_step': per_step, 'rel_l2_vs_oracle': err,
           'max_abs_vs_oracle': mx, 'energy_t0.03': e,
           'oracle_energy_t0.03': e_ref, 'peak_gb': peak,
           'planar_copy_in_ms': copy_in, 'planar_copy_out_ms': copy_out,
           'planar_copies_per_step': {'in': 24, 'out': 12}})


def phase_times_tp(dev, bf, holds):
    """fft_axis_tp (f32 and f64) at the four passes of the dealiased 512^3
    plan, each held against its plain version slab by slab on the full
    volume, and timed beside it, its bound and cuFFT's unfused pass."""
    from mpi4py_fft_torch import PFFT
    d = PFFT_N
    m = 3 * d // 2
    out = {}
    for dtype, sfx in (('f', ''), ('d', '_f64')):
        f64 = dtype == 'd'
        name = 'fft_axis_tp' + sfx
        tdt = torch.float64 if f64 else torch.float32
        fft = PFFT(None, (d,) * 3, padding=[1.5] * 3, dtype=dtype)
        g = torch.Generator(device=dev).manual_seed(SEED + 50)
        x = torch.rand((m,) * 3, generator=g, device=dev, dtype=tdt) - 0.5
        y0 = fft.xfftn[0].forward_fn_p(x)          # (2, m, m, d/2 + 1)
        del x
        sc1, sc0 = float(fft.xfftn[1].M), float(fft.xfftn[2].M)
        passes = (('fwd', 1, dict(trunc=d, scale=sc1)),
                  ('fwd', 0, dict(trunc=d, scale=sc0)),
                  ('bwd', 0, dict(pad=m)), ('bwd', 1, dict(pad=m)))
        rows = []
        inp = y0
        for direction, ax, kw in passes:
            fwd = direction == 'fwd'
            k = bf.fft_axis_tp(inp, ax, fwd, **kw)
            sd = 2 if ax == 0 else 1             # slabs off the pass axis
            s = 64
            for i in range(0, inp.shape[sd], s):
                w = min(s, inp.shape[sd] - i)
                holds.hold(name, k.narrow(sd, i, w),
                           bf.fft_axis_tp_plain(inp.narrow(sd, i, w), ax,
                                                fwd, **kw),
                           f"{name} {direction} axis {ax} slab {i}")
            big = inp if inp.shape[1 + ax] == m else k
            Nin, Nout = inp.shape[1 + ax], k.shape[1 + ax]
            lines = inp.numel() // 2 // Nin
            b, by = _bound_ms((Nin + Nout) * lines * 2 * (8 if f64 else 4),
                              lines * 5 * m * math.log2(m), f64)
            bc = torch.complex(big[0], big[1])
            rows.append({
                'pass': f"{direction} axis {ax}",
                'in': list(inp.shape), 'out': list(k.shape),
                'ms': _median_ms(lambda: bf.fft_axis_tp(inp, ax, fwd, **kw)),
                'plain_ms': _median_ms(
                    lambda: bf.fft_axis_tp_plain(inp, ax, fwd, **kw),
                    reps=3, warm=1),
                'cufft_unfused_ms': _median_ms(
                    lambda: torch.fft.fft(bc, dim=ax)),
                'bound_ms': b})
            del bc, big
            inp = k
            del k
        del inp, y0, fft
        torch.cuda.empty_cache()
        row = {key: sum(r[key] for r in rows)
               for key in ('ms', 'plain_ms', 'cufft_unfused_ms', 'bound_ms')}
        row.update(shape=f"4 passes of the {d}^3 'f' plan on its {m}^3 "
                         f"grid: fwd axes 1, 0 (trunc {m} -> {d}), bwd axes "
                         f"0, 1 (pad {d} -> {m}), {tdt}".replace(
                             "'f'", f"'{dtype}'"),
                   bound_by=by, library_ms=None, per_pass=rows)
        out[name] = row
    _emit({'phase': 'times_tp', 'kernels': out})
    return out


def _slab_hold(holds, name, got, plain, dim, what, s=64):
    """Hold ``got`` against ``plain(i, w)`` (the plain version on rows
    i..i+w of ``dim``) slab by slab; returns the number of slabs."""
    n = got.shape[dim]
    for i in range(0, n, s):
        w = min(s, n - i)
        holds.hold(name, got.narrow(dim, i, w), plain(i, w),
                   f"{what} slab {i}")
    return (n + s - 1) // s


def phase_any_c2c(dev, bf):
    """A c2c plan of an extent no Stockham kernel takes: 640 = 5*128 runs
    J on the last axis and the mixed-radix engine (640 = 32*20) on the
    other two."""
    from mpi4py_fft_torch import PlanarPFFT
    shape = ANY_C2C_SHAPE
    pfft = PlanarPFFT(None, shape, dtype='F')
    x = _rand((2,) + shape, dev, SEED + 60)
    vol_gb = x.numel() * 4 / 1e9
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    c0 = dict(bf.LAUNCHES)
    y = pfft.forward(x, normalize=True)
    torch.cuda.synchronize()
    c1 = dict(bf.LAUNCHES)
    fwd_peak = torch.cuda.max_memory_allocated() / 1e9 - held + vol_gb
    z = pfft.backward(y)
    torch.cuda.synchronize()
    c2 = dict(bf.LAUNCHES)
    want = {'fft2stage_p': 1}
    _check(_delta(c0, c1) == want and _delta(c1, c2) == want,
           f"{shape} 'F' launches {_delta(c0, c1)} {_delta(c1, c2)}")
    _check(tuple(y.shape) == (2,) + shape, f"{shape} forward {y.shape}")
    err_f, _ = _rel(y, _fftn_ref(x))
    err_rt, _ = _rel(z, x)
    _check(bool(torch.isfinite(z).all()), f"{shape}: non-finite")
    _check(max(err_f, err_rt) <= PIPE_TOL,
           f"{shape} 'F': vs fftn {err_f:.3e}, round trip {err_rt:.3e}")
    del y, z
    ms = _median_ms(lambda: pfft.backward(pfft.forward(x)), reps=3,
                    warm=1) / 2
    del x
    torch.cuda.empty_cache()
    _emit({'phase': 'any_c2c', 'shape': list(shape), 'dtype': 'F',
           'rel_l2_fwd_vs_fftn': err_f, 'rel_l2_round_trip': err_rt,
           'launches_per_transform': want, 'ms_per_transform': ms,
           'fwd_peak_gb': fwd_peak, 'volume_gb': vol_gb})


def phase_any_r2c(dev, bf):
    """The reference API's r2c plan at 896 = 7*128, which B and C refuse:
    the stacked real axis runs J forward, the Hermitian-extended axis J
    backward; the other axes the engine (896 = 32*28)."""
    from mpi4py_fft_torch import PFFT
    shape = ANY_R2C_SHAPE
    fft = PFFT(None, shape, dtype='f')
    g = torch.Generator(device=dev).manual_seed(SEED + 61)
    x = torch.rand(shape, generator=g, device=dev) - 0.5
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    c0 = dict(bf.LAUNCHES)
    y = fft.forward.fn_p(x)
    torch.cuda.synchronize()
    c1 = dict(bf.LAUNCHES)
    fwd_peak = torch.cuda.max_memory_allocated() / 1e9 - held
    torch.cuda.reset_peak_memory_stats()
    held_b = torch.cuda.memory_allocated() / 1e9
    z = fft.backward.fn_p(y)
    torch.cuda.synchronize()
    c2 = dict(bf.LAUNCHES)
    bwd_peak = torch.cuda.max_memory_allocated() / 1e9 - held_b
    want = {'fft2stage_p': 1}
    _check(_delta(c0, c1) == want and _delta(c1, c2) == want,
           f"{shape} 'f' launches {_delta(c0, c1)} {_delta(c1, c2)}")
    _check(tuple(y.shape) == (2,) + shape[:2] + (shape[2] // 2 + 1,) and
           tuple(z.shape) == shape, f"{shape} 'f': {y.shape} {z.shape}")
    F = torch.fft.rfftn(x, norm='forward')
    ref = torch.stack([F.real, F.imag])
    del F
    err_f, _ = _rel(y, ref)
    del ref
    err_rt, _ = _rel(z, x)
    _check(bool(torch.isfinite(z).all()), f"{shape} 'f': non-finite")
    _check(max(err_f, err_rt) <= PIPE_TOL,
           f"{shape} 'f': vs rfftn {err_f:.3e}, round trip {err_rt:.3e}")
    del z
    t_f = _median_ms(lambda: fft.forward.fn_p(x), reps=3, warm=1)
    t_b = _median_ms(lambda: fft.backward.fn_p(y), reps=3, warm=1)
    del x, y
    torch.cuda.empty_cache()
    _emit({'phase': 'any_r2c', 'shape': list(shape), 'dtype': 'f',
           'rel_l2_fwd_vs_rfftn': err_f, 'rel_l2_round_trip': err_rt,
           'launches_fwd': want, 'launches_bwd': want, 'fwd_ms': t_f,
           'bwd_ms': t_b, 'fwd_peak_above_input_gb': fwd_peak,
           'bwd_peak_above_input_gb': bwd_peak})


def phase_bluestein(dev, bf):
    """A prime lead extent: axis 0 of (509, 512, 512) is Bluestein, two J
    launches of M = 1024 a direction; axes 1 and 2 take A."""
    from mpi4py_fft_torch import PlanarPFFT
    shape = BLUESTEIN_SHAPE
    pfft = PlanarPFFT(None, shape, dtype='F')
    x = _rand((2,) + shape, dev, SEED + 62)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    c0 = dict(bf.LAUNCHES)
    y = pfft.forward(x, normalize=True)
    torch.cuda.synchronize()
    c1 = dict(bf.LAUNCHES)
    fwd_peak = torch.cuda.max_memory_allocated() / 1e9 - held
    z = pfft.backward(y)
    torch.cuda.synchronize()
    c2 = dict(bf.LAUNCHES)
    want = {'fft2stage_p': 2, 'fft_axis_p': 2}
    _check(_delta(c0, c1) == want and _delta(c1, c2) == want,
           f"{shape} launches {_delta(c0, c1)} {_delta(c1, c2)}")
    err_f, _ = _rel(y, _fftn_ref(x))
    err_rt, _ = _rel(z, x)
    _check(bool(torch.isfinite(z).all()), f"{shape}: non-finite")
    _check(max(err_f, err_rt) <= PIPE_TOL,
           f"{shape} 'F': vs fftn {err_f:.3e}, round trip {err_rt:.3e}")
    del y, z
    ms = _median_ms(lambda: pfft.backward(pfft.forward(x)), reps=3,
                    warm=1) / 2
    del x
    torch.cuda.empty_cache()
    _emit({'phase': 'bluestein', 'shape': list(shape), 'dtype': 'F',
           'rel_l2_fwd_vs_fftn': err_f, 'rel_l2_round_trip': err_rt,
           'launches_per_transform': want, 'ms_per_transform': ms,
           'fwd_peak_above_input_gb': fwd_peak})


def phase_plane(dev, bf, holds):
    """The plane entry points, which nothing dispatches: H on PLANE_H (a
    cluster a plane) and PLANE_H_ONE_CTA (two planes a CTA) and I on
    PLANE_I, forward, then backward with the 1/(N1 N2) scale, against a
    torch.fft.fft2 oracle and the round trip (5e-5), and against their
    plain versions slab by slab (5e-6), each output in memory filled with
    NaN first."""
    out = {}
    launches = collections.Counter()
    runs = (('fft_plane_p', PLANE_H), ('fft_plane_p', PLANE_H_ONE_CTA),
            ('fft_plane_large_p', PLANE_I))
    for i, (name, shape) in enumerate(runs):
        fn = getattr(bf, name)
        plain = getattr(bf, name[:-2] + '_plain')
        x = _rand((2,) + shape, dev, SEED + 63 + i)
        sc = 1.0 / (shape[-1] * shape[-2])
        c0 = dict(bf.LAUNCHES)
        _nan(x)     # freed at once: the output's block starts as NaN
        y = fn(x, True)
        torch.cuda.synchronize()
        c1 = dict(bf.LAUNCHES)
        _nan(x)
        z = fn(y, False, scale=sc)
        torch.cuda.synchronize()
        c2 = dict(bf.LAUNCHES)
        d0, d1 = _delta(c0, c1), _delta(c1, c2)
        _check(d0 == {name: 1} and d1 == {name: 1},
               f"{name} launches {d0} {d1}")
        launches.update(d0)
        launches.update(d1)
        _check(tuple(y.shape) == (2,) + shape, f"{name}: {y.shape}")
        num = den = 0.0
        for j in range(0, shape[0], 64):
            F = torch.fft.fft2(torch.complex(x[0, j:j + 64], x[1, j:j + 64]))
            d = (y[:, j:j + 64] - torch.stack([F.real, F.imag])).double()
            num += float((d * d).sum())
            den += float((F.abs().double() ** 2).sum())
            del F, d
        err_o = math.sqrt(num / den)
        err_rt, _ = _rel(z, x)
        _check(max(err_o, err_rt) <= PIPE_TOL,
               f"{name} {shape}: vs fft2 {err_o:.3e}, round trip "
               f"{err_rt:.3e}")
        n = _slab_hold(holds, name, y, lambda j, w: plain(
            x.narrow(1, j, w), True), 1, f"{name} {shape} fwd")
        n += _slab_hold(holds, name, z, lambda j, w: plain(
            y.narrow(1, j, w), False, sc), 1, f"{name} {shape} bwd")
        del x, y, z
        torch.cuda.empty_cache()
        row = {'shape': list(shape), 'rel_l2_fwd_vs_fft2': err_o,
               'rel_l2_round_trip': err_rt, 'slabs_held': n}
        if name == 'fft_plane_p':
            k, c = bf.plane_max_active_clusters(*shape[-2:])
            row.update(ctas_a_plane=k, max_active=c)
        out[f'{name} {shape}'] = row
    _emit({'phase': 'plane', 'launches': dict(launches), 'plans': out})


def _j_flops(lines, N):
    """J's operations on ``lines`` lines of N = S*128 points: the direct
    S-point DFT (S^2 complex multiply-adds, 8 flops each, a column), the
    twiddle (6 flops a point) and S Stockham transforms of 128 points
    (5 * 128 * 7 flops each)."""
    S = N // 128
    return lines * (128 * S * S * 8 + 6 * N + S * 5 * 128 * 7)


def _j_row(j2, x, holds, slabs):
    """J on the last axis of x: held slab by slab on both signs (each
    output in memory filled with NaN first), then timed beside its plain
    version, torch.fft.fft and its bound."""
    for sign in (-1, 1):
        _nan(x)     # freed at once: the output's block starts as NaN
        k = j2.fft2stage_p(x, sign)
        slabs[0] += _slab_hold(holds, 'fft2stage_p', k, lambda i, w: (
            j2.fft2stage_plain(x.narrow(1, i, w), sign)), 1,
            f"fft2stage_p {tuple(x.shape)} sign {sign}")
        del k
    xc = torch.complex(x[0], x[1])
    n = x.shape[-1]
    b, by = _bound_ms(2 * x.numel() * 4, _j_flops(x.numel() // 2 // n, n))
    row = {'shape': f'{tuple(x.shape)} f32, last axis (S = {n // 128})',
           'ms': _median_ms(lambda: j2.fft2stage_p(x, -1)),
           'plain_ms': _median_ms(lambda: j2.fft2stage_plain(x, -1), reps=3,
                                  warm=1),
           'library_ms': _median_ms(lambda: torch.fft.fft(xc, dim=-1)),
           'bound_ms': b, 'bound_by': by}
    del xc
    return row


def _plane_row(bf, name, x):
    """A plane kernel at x's shape, timed beside two chained A passes,
    its plain version, torch.fft.fft2 and its bound."""
    fn = getattr(bf, name)
    plain = getattr(bf, name[:-2] + '_plain')
    N1, N2 = x.shape[-2], x.shape[-1]
    b, by = _bound_ms(2 * x.numel() * 4,
                      5 * (x.numel() // 2) * math.log2(N1 * N2))
    row = {'shape': f'{tuple(x.shape)} f32, last two axes',
           'ms': _median_ms(lambda: fn(x, True)),
           'two_a_passes_ms': _median_ms(
               lambda: bf.fft_axis_p(bf.fft_axis_p(x, 2), 1)),
           'plain_ms': _median_ms(lambda: plain(x, True), reps=3, warm=1)}
    xc = torch.complex(x[0], x[1])
    row['library_ms'] = _median_ms(lambda: torch.fft.fft2(xc))
    row.update(bound_ms=b, bound_by=by)
    if name == 'fft_plane_p':
        row['ctas_a_plane'], row['max_active'] = \
            bf.plane_max_active_clusters(N1, N2)
    return row


def phase_times_d_a64(dev, bf, holds):
    """D's and A64's rows of phases 16 and 17 alone (for --times-any):
    D at the quarter pairs, fft3_8's y pass and N = 768; A64 at the DNS's
    two passes and the three passes of 768^3 and 1024^3 volumes, each
    held first."""
    x = _rand((2,) + (NORTH_N,) * 3, dev, SEED + 2)
    d = _times_axis2(bf, holds, x)
    del x
    torch.cuda.empty_cache()
    n = DNS_N
    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    p = torch.rand((2, n, n, n // 2 + 1), generator=g, device=dev,
                   dtype=torch.float64) - 0.5
    a64 = [_axis64_pass(bf, holds, p, 1, 'band, single elements'),
           _axis64_pass(bf, holds, p, 0, 'band, vectors')]
    del p
    torch.cuda.empty_cache()
    w768 = _axis64_w768(dev, bf, holds, g)
    _, w1024 = _holds_volume64(dev, bf, holds)
    _emit({'phase': 'times_d_a64', 'kernels': {
        'fft_axis2_p': d, 'fft_axis_p_f64': {'dns': a64, 'w768': w768,
                                             'w1024': w1024}}})


def phase_times_any(dev, bf, holds):
    """J at the three S of the main path, held slab by slab on both signs
    and timed there: the any_c2c plan's 640^3 last axis (S = 5, the
    kernels line's row), the stacked any_r2c real axis (S = 7) and the
    Bluestein (509, 512, 512) plan's padded M = 1024 axis (S = 8); H at
    PLANE_H (its row) and PLANE_H_ONE_CTA, and I at PLANE_I, beside two
    chained A passes at the same shape (the JAX package's own A/B)."""
    from mpi4py_fft_torch.ops import fft2stage as j2
    out = {}
    slabs = [0]
    b3 = BLUESTEIN_SHAPE
    rows = {}
    for s, shape in ((5, ANY_C2C_SHAPE), (7, ANY_R2C_SHAPE),
                     (8, (b3[1], b3[2], 1024))):
        x = _rand((2,) + shape, dev, SEED + 70 + s)
        rows[s] = _j_row(j2, x, holds, slabs)
        del x
        torch.cuda.empty_cache()
    out['fft2stage_p'] = dict(rows[5], s7=rows[7], s8=rows[8],
                              slabs_held=slabs[0])
    for i, (name, shape) in enumerate((('fft_plane_p', PLANE_H),
                                       ('fft_plane_p', PLANE_H_ONE_CTA),
                                       ('fft_plane_large_p', PLANE_I))):
        x = _rand((2,) + shape, dev, SEED + 72 + i)
        row = _plane_row(bf, name, x)
        del x
        torch.cuda.empty_cache()
        if shape == PLANE_H_ONE_CTA:
            out[name]['one_cta'] = row
        else:
            out[name] = row
    _emit({'phase': 'times_any', 'kernels': out})
    return out


def _exact(got, ref, what):
    """A probe kernel that computes a copy: equal to its plain version
    bit for bit."""
    torch.cuda.synchronize()
    _check(tuple(got.shape) == tuple(ref.shape) and torch.equal(got, ref),
           f"{what}: differs from its plain version")


def _nan_block(shape, dtype, dev):
    """Leave a freed NaN-filled block of ``shape`` for the next output of
    that size to take."""
    torch.full(shape, float('nan'), dtype=dtype, device=dev)


def _nan(t):
    """An output for a kernel under hold that no correct run leaves as it
    is (a new tensor may reuse a freed block that already holds the
    answer)."""
    return torch.full_like(t, float('nan'))


def _copy_cases(n):
    """(label, tensor view shape, box, grid order, two streams) of the
    scripts' copies at n (scripts/tpu_*.py; rows 1-5, 9-10, 12-16, 18-19
    of the port's kernel table)."""
    h = n // 2
    v = (2, n, n * n // 128, 128)
    return (('plane', (2, n, n, n), (2, 1, n, n), None, False),
            ('8-plane', (2, n, n, n), (2, 8, n, n), None, False),
            ('2-plane', (2, n, n, n), (2, 2, n, n), None, False),
            ('halfplane', (2, n, n, n), (2, 1, h, n), None, False),
            ('lead', (2, n, n, n), (2, n, 8, 128), None, False),
            ('lead swapped grid', (2, n, n, n), (2, n, 8, 128), (0, 1, 3, 2),
             False),
            ('lead 8x256', (2, n, n, n), (2, n, 8, 256), None, False),
            ('lead 8x512', (2, n, n, n), (2, n, 8, min(512, n)), None,
             False),
            ('lead 16x128', (2, n, n, n), (2, n, 16, 128), None, False),
            ('mid', (2, n, n, n), (2, 8, n, 128), None, False),
            ('lead view', v, (2, n, 8, 128), None, False),
            ('lead view sub 16', v, (2, n, 16, 128), None, False),
            ('lead view sub 32', v, (2, n, 32, 128), None, False),
            ('contig', (2, n ** 3 // 256, 256), (2, 4096, 256), None, False),
            ('pair base', (2, h, n, h), (2, h, 8, 128), None, True),
            ('pair wide', (2, h, n, h), (2, h, 8, min(256, h)), None,
             True),
            ('pair tall', (2, h, n, h), (2, h, 16, 128), None, True),
            ('pair gridT', (2, h, n, h), (2, h, 8, 128), (0, 1, 3, 2), True),
            ('pair halfrow', (2, h, n, h), (2, h // 2, 8, 128), None, True),
            ('paircopy', (2, h, n * h // 128, 128), (2, h, 8, 128), None,
             True))


def _holds_probes(holds, dev, tp):
    """Every probe kernel against its plain version; returns the number
    of cases."""
    cases = 0
    for n in (PROBE_N // 4, PROBE_N):           # the scripts' 256 and 1024
        x = _rand((2,) + (n,) * 3, dev, SEED + 80)
        x2 = _rand((2,) + (n,) * 3, dev, SEED + 81)
        for label, shape, box, order, pair in _copy_cases(n):
            a = x.view(-1)[:math.prod(shape)].view(shape)
            ra = tp.block_copy_plain(a)
            what = f"block_copy {label} n={n}"
            if pair:
                b = x2.view(-1)[:math.prod(shape)].view(shape)
                ya, yb = tp.block_copy(a, box, order, out=_nan(a), x2=b,
                                       out2=_nan(b))
                _exact(ya, ra, f"{what} stream 1")
                _exact(yb, tp.block_copy_plain(b), f"{what} stream 2")
                del ya, yb
            else:
                _exact(tp.block_copy(a, box, order, out=_nan(a)), ra, what)
                # in place the copy is the identity: this shows only that
                # the launch writes nothing wrong
                tp.block_copy(a, box, order, out=a)
                _exact(a, ra, f"{what} in place")
            cases += 2
            del ra
        del x, x2
        torch.cuda.empty_cache()
    # the moves: the script's nine spellings, and B's reads at 768^3
    from mpi4py_fft_torch.probes import moves
    x = torch.arange(64 * 8 * 128, dtype=torch.float32,
                     device=dev).reshape(64, 8, 128)
    for tag, m in moves.MOVES.items():
        ref = tp.move_plain(x, *m)
        _exact(tp.move(x, *m, out=_nan(ref)), ref, f"move {tag}")
        cases += 1
    m = 3 * DEALIAS_N // 2
    x = _rand((m, m, m), dev, SEED + 82)
    for axis in (0, 2):
        for kind, shift in (('even', 0), ('odd', 0), ('reverse', 0),
                            ('roll', 1), ('roll', m - 5)):
            ref = tp.move_plain(x, axis, kind, shift)
            _exact(tp.move(x, axis, kind, shift, out=_nan(ref)), ref,
                   f"move {kind} {shift} axis {axis} of {m}^3")
            del ref
            cases += 1
    del x
    # bfly: every mode at lead, mid and last positions, reps, fewer lines a
    # tile than A's
    g = torch.Generator(device=dev).manual_seed(SEED + 83)
    for N in (16, 64, 256, 512, 768, 1024):
        for shape, ax in (((N, 24, 40), 0), ((6, N, 40), 1), ((50, N), 1)):
            p = torch.randn((2,) + shape, generator=g, device=dev)
            modes = tp.MODES if N in (16, 64, 256, 1024) else ('copy',
                                                                'full')
            for mode in modes:
                for reps in (1, 3):
                    got = tp.bfly(p, ax, mode, reps, out=_nan(p))
                    ref = tp.bfly_plain(p, ax, mode, reps)
                    what = f"bfly {mode} x{reps} {shape} axis {ax}"
                    if mode in ('copy', 'moves'):
                        _exact(got, ref, what)
                    else:
                        holds.hold('bfly', got, ref, what)
                    q = p.clone()
                    tp.bfly(q, ax, mode, reps, out=q)
                    _exact(q, got, f"{what} in place")
                    cases += 2
            lines = tp.tile_lines(N)
            holds.hold('bfly', tp.bfly(p, ax, 'full', lines=lines // 4,
                                       out=_nan(p)),
                       tp.bfly_plain(p, ax, 'full'),
                       f"bfly full {shape} axis {ax} {lines // 4} lines")
            cases += 1
    # in place against out of place on the full probe volume, lead and mid
    n = PROBE_N
    x = _rand((2,) + (n,) * 3, dev, SEED + 84)
    for ax, mode, reps in ((0, 'full', 1), (0, 'full', 2), (0, 'adds', 1),
                           (1, 'full', 1)):
        y = tp.bfly(x, ax, mode, reps, out=_nan(x))
        tp.bfly(x, ax, mode, reps, out=x)
        _exact(x, y, f"bfly {mode} x{reps} {n}^3 axis {ax} in place")
        cases += 1
        del y
    del x
    torch.cuda.empty_cache()
    # fma_chain after 256 iterations (the plain loop cannot run the timed
    # 2^18), every accumulator count, at constants each step moves
    from mpi4py_fft_torch.probes import vpu_peak
    for dtype, name in ((torch.float32, 'fma_chain'),
                        (torch.float64, 'fma_chain_f64')):
        numel = torch.cuda.get_device_properties(dev).multi_processor_count \
            * vpu_peak.THREADS_PER_SM * 8
        x = 1.0 + 0.5 * _rand((numel,), dev, SEED + 85).to(dtype)
        ref = tp.fma_chain_plain(x, FMA_HOLD_ITERS, FMA_HOLD_A, FMA_HOLD_B)
        for acc in (1, 4, 8, 16):
            holds.hold(name, tp.fma_chain(x, FMA_HOLD_ITERS, acc, FMA_HOLD_A,
                                          FMA_HOLD_B, out=_nan(x)),
                       ref, f"{name} acc={acc}")
            cases += 1
        del x, ref
    return cases


def _probe_times(dev, tp):
    """Each probe kernel at one shape of its probes: ms beside its plain
    version, its bound and its PyTorch yardstick (None where no one call
    computes the function)."""
    from mpi4py_fft_torch.probes import vpu_peak
    out = {}
    n = PROBE_N
    x = _rand((2,) + (n,) * 3, dev, SEED + 86)
    y = torch.empty_like(x)
    box = (2, 1, n, n)
    b, by = _bound_ms(2 * x.numel() * 4, 0)
    out['block_copy'] = {
        'shape': f'(2, {n}, {n}, {n}) f32 out of place in (2, 1, {n}, {n}) '
                 f'boxes (the plane copy floor)',
        'ms': _median_ms(lambda: tp.block_copy(x, box, out=y)),
        'plain_ms': _median_ms(lambda: tp.block_copy_plain(x)),
        'library_ms': _median_ms(lambda: y.copy_(x)),
        'bound_ms': b, 'bound_by': by}
    del y
    modes = {}
    xv = x.view(2, n, n * n // 128, 128)
    for mode in tp.MODES:
        modes[mode] = _median_ms(lambda: tp.bfly(xv, 0, mode, out=xv))
    xc = torch.complex(x[0], x[1])
    lib = _median_ms(lambda: torch.fft.fft(xc, dim=0))
    del xc
    b, by = _bound_ms(2 * x.numel() * 4, n * n * 5 * n * math.log2(n))
    out['bfly'] = {
        'shape': f'(2, {n}, {n}, {n}) f32, lead axis, in place, mode full '
                 f'(A\'s plan); modes_ms: each mode at the same shape',
        'ms': modes['full'],
        'plain_ms': _median_ms(lambda: tp.bfly_plain(x, 0, 'full'), reps=1,
                               warm=0),
        'library_ms': lib, 'bound_ms': b, 'bound_by': by,
        'modes_ms': modes}
    del x, xv
    torch.cuda.empty_cache()
    m = 3 * DEALIAS_N // 2
    r = _rand((m, m, m), dev, SEED + 87)
    e = tp.move(r, 2, 'even')
    b, by = _bound_ms(2 * e.numel() * 4, 0)
    out['move'] = {
        'shape': f'({m}, {m}, {m}) f32 -> ({m}, {m}, {m // 2}), the even '
                 f'points of the last axis (B\'s deinterleaved reads)',
        'ms': _median_ms(lambda: tp.move(r, 2, 'even', out=e)),
        'plain_ms': _median_ms(lambda: tp.move_plain(r, 2, 'even')),
        'library_ms': _median_ms(lambda: e.copy_(r[..., 0::2])),
        'bound_ms': b, 'bound_by': by}
    del r, e
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype, name in ((torch.float32, 'fma_chain'),
                        (torch.float64, 'fma_chain_f64')):
        numel = sms * vpu_peak.THREADS_PER_SM * 8
        x = torch.ones(numel, dtype=dtype, device=dev)
        b, by = _bound_ms(2 * numel * x.element_size(),
                          2.0 * numel * FMA_TIME_ITERS,
                          f64=dtype == torch.float64)
        out[name] = {
            'shape': f'{numel} {str(dtype)[6:]} elements, '
                     f'{FMA_TIME_ITERS} iterations, 8 accumulators a '
                     f'thread (the rate at 2^18: probes vpu_peak)',
            'ms': _median_ms(lambda: tp.fma_chain(x, FMA_TIME_ITERS, 8,
                                                  out=x)),
            'plain_ms': _median_ms(lambda: tp.fma_chain_plain(
                x, FMA_TIME_ITERS), reps=1, warm=1),
            'library_ms': None, 'bound_ms': b, 'bound_by': by}
        del x
    return out


def _fft_yardsticks(res, dev):
    """Fill in ``library_ms`` of the probe rows that name the transform
    they compute (``fft``: complex shape and axis) with torch.fft.fft's
    time on random data of that shape; the port never calls it."""
    ms = {}
    for r in res['rows']:
        if 'fft' in r:
            key = repr(r['fft'])
            if key not in ms:
                shape, dim = r['fft']
                x = torch.complex(_rand(shape, dev, SEED + 88),
                                  _rand(shape, dev, SEED + 89))
                ms[key] = _median_ms(lambda: torch.fft.fft(x, dim=dim))
                del x
            r['library_ms'] = ms[key]


def phase_probes(dev):
    """The probe kernels held against their plain versions, then every
    probe module, the probe kernels' launches counted from 0 across the
    modules, then the probe kernels' times for the kernels line."""
    from mpi4py_fft_torch import probes
    from mpi4py_fft_torch.ops import probes as tp
    t0 = time.perf_counter()
    holds = Holds(PROBE_KERNELS)
    cases = _holds_probes(holds, dev, tp)
    holds_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    tp.reset_launches()
    for name in probes.NAMES:
        res = probes.module(name).run(dev)
        torch.cuda.empty_cache()
        _fft_yardsticks(res, dev)
        _emit({'phase': 'probes', **res})
        torch.cuda.empty_cache()
    launches = dict(tp.LAUNCHES)
    _check(set(launches) == set(PROBE_KERNELS), f"counters {launches}")
    for name, c in launches.items():
        _check(c > 0, f"{name} was not launched by the probe modules")
    secs = time.perf_counter() - t0
    times = _probe_times(dev, tp)
    _emit({'phase': 'probes', 'seconds': secs, 'holds_seconds': holds_s,
           'seconds_with_kernel_times': time.perf_counter() - t0,
           'holds': cases, 'max_rel_l2': holds.rel,
           'max_abs_err': holds.err, 'launches': launches})
    return [{'name': name, 'route': 'cuda', 'source': src, 'replaces': rep,
             'launches': launches[name], 'max_abs_err': holds.err[name],
             'max_rel_l2': holds.rel[name], **times[name]}
            for name, (src, rep) in PROBE_KERNELS.items()]


_COPIES = ', '.join(f'scripts/{s}' for s in (
    'tpu_dma_probe.py:69', 'tpu_blockshape_probe.py:72',
    'tpu_blockshape_probe.py:113', 'tpu_lead_copy.py:89',
    'tpu_lead_copy.py:102', 'tpu_r3_profile.py:79', 'tpu_r3_profile.py:93',
    'tpu_plane_test.py:96', 'tpu_plane_test.py:110',
    'tpu_pair_blocking_probe.py:66', 'tpu_pair_blocking_probe.py:96',
    'tpu_oop3d_dissect.py:104', 'tpu_slope_probe.py:74',
    'tpu_slope_probe.py:88'))
_BFLY = ', '.join(f'scripts/{s}' for s in (
    'tpu_lead_copy.py:119', 'tpu_lead_copy.py:137', 'tpu_lead_copy.py:199',
    'tpu_r3_profile.py:121', 'tpu_bfly_dissect.py:77',
    'tpu_bfly_dissect.py:152', 'tpu_vpu_probe.py:57'))
PROBE_KERNELS = {
    'block_copy': ('mpi4py_fft_torch/ops/csrc/probe_copy.cu', _COPIES),
    'move': ('mpi4py_fft_torch/ops/csrc/probe_copy.cu',
             'scripts/tpu_probe_moves.py:31'),
    'bfly': ('mpi4py_fft_torch/ops/csrc/probe_bfly.cu', _BFLY),
    'fma_chain': ('mpi4py_fft_torch/ops/csrc/probe_fma.cu',
                  'scripts/tpu_vpu_peak.py:86'),
    'fma_chain_f64': ('mpi4py_fft_torch/ops/csrc/probe_fma.cu',
                      'scripts/tpu_vpu_peak.py:86'),
}
# A at N = 256, 512 and 1024 as tpu_longN_probe.py times it (probes
# long_n) is A and A64 as they are
_LONG_N = '; scripts/tpu_longN_probe.py:76'

KERNELS = {
    'fft_axis_p': ('mpi4py_fft_torch/ops/csrc/fft_axis.cu',
                   'mpi4py_fft_tpu/ops/pallas_butterfly.py:795' + _LONG_N),
    'rfft_axis_p': ('mpi4py_fft_torch/ops/csrc/rfft_axis.cu',
                    'mpi4py_fft_tpu/ops/pallas_butterfly.py:1818'),
    'irfft_axis_p': ('mpi4py_fft_torch/ops/csrc/rfft_axis.cu',
                     'mpi4py_fft_tpu/ops/pallas_butterfly.py:1980'),
    'fft_axis2_p': ('mpi4py_fft_torch/ops/csrc/fft_axis2.cu',
                    'mpi4py_fft_tpu/ops/pallas_butterfly.py:1358'),
    'fft_axis_pair_p': ('mpi4py_fft_torch/ops/csrc/fft_axis2.cu',
                        'mpi4py_fft_tpu/ops/pallas_butterfly.py:1476'),
    'fft_axis_p_f64': ('mpi4py_fft_torch/ops/csrc/fft_axis.cu',
                       'mpi4py_fft_tpu/ops/pallas_ds.py:368' + _LONG_N),
    'rfft_axis_p_f64': ('mpi4py_fft_torch/ops/csrc/rfft_axis.cu',
                        'mpi4py_fft_tpu/ops/pallas_ds.py:546'),
    'irfft_axis_p_f64': ('mpi4py_fft_torch/ops/csrc/rfft_axis.cu',
                         'mpi4py_fft_tpu/ops/pallas_ds.py:593'),
    'fft_axis_tp': ('mpi4py_fft_torch/ops/csrc/fft_axis_tp.cu',
                    'mpi4py_fft_tpu/ops/pallas_butterfly.py:938'),
    'fft_axis_tp_f64': ('mpi4py_fft_torch/ops/csrc/fft_axis_tp.cu',
                        'mpi4py_fft_tpu/ops/pallas_butterfly.py:938'),
    'fft2stage_p': ('mpi4py_fft_torch/ops/csrc/fft2stage.cu',
                    'mpi4py_fft_tpu/ops/pallas_fft.py:158'),
    'fft_plane_p': ('mpi4py_fft_torch/ops/csrc/fft_plane.cu',
                    'mpi4py_fft_tpu/ops/pallas_butterfly.py:1056'),
    'fft_plane_large_p': ('mpi4py_fft_torch/ops/csrc/fft_plane.cu',
                          'mpi4py_fft_tpu/ops/pallas_butterfly.py:1167'),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--times-any', metavar='TREE', nargs='?',
                    const=os.path.dirname(os.path.abspath(__file__)),
                    help="run only phases 1, 22 and 23, B's, D's and "
                         "A64's rows and phases 13 and 18 on the port in "
                         "TREE (default: this script's checkout), to "
                         "compare two trees on one card")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.times_any or os.path.dirname(
        os.path.abspath(__file__)))
    sys.path.insert(0, tree)
    from mpi4py_fft_torch.ops import butterfly as bf
    _check(os.path.abspath(bf.__file__).startswith(tree + os.sep),
           f"mpi4py_fft_torch imported from {bf.__file__}, not {tree}")
    t_start = time.perf_counter()
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    phase_build()
    holds = Holds(KERNELS)
    if args.times_any:
        phase_plane(dev, bf, holds)
        phase_times_any(dev, bf, holds)
        _emit({'phase': 'times_b', 'kernels': {
            'rfft_axis_p': _times_b(dev, bf, holds)[0]}})
        phase_times_d_a64(dev, bf, holds)
        phase_pfft(dev, bf, 'd')
        phase_times_tp(dev, bf, holds)
        print(_smi(), flush=True)
        return 0
    phase_holds(holds, dev)

    # the main path: counters at 0 just before, read just after
    bf.reset_launches()
    phase_entry(dev)
    pfft, x = phase_north(dev, bf)
    phase_quartered(bf, pfft, x)
    del x
    torch.cuda.empty_cache()
    phase_long(dev, bf)
    phase_dealias(dev, bf)
    phase_north64(dev, bf)
    phase_dealias(dev, bf, dtype='d')
    phase_dns64(dev, bf)
    marks = {'planar_path_s': time.perf_counter() - t_start}
    phase_pfft(dev, bf, 'f')
    phase_pfft(dev, bf, 'F')
    phase_pfft(dev, bf, 'd')
    phase_buffer(dev, bf)
    phase_dns_solver(dev, bf)
    marks['reference_api_path_s'] = time.perf_counter() - t_start
    phase_any_c2c(dev, bf)
    phase_any_r2c(dev, bf)
    phase_bluestein(dev, bf)
    phase_plane(dev, bf, holds)
    marks['any_extent_path_s'] = time.perf_counter() - t_start
    launches = dict(bf.LAUNCHES)
    _check(set(launches) == set(KERNELS), f"counters {sorted(launches)}")
    for name, c in launches.items():
        _check(c > 0, f"{name} was not launched on the main path")

    x = _rand((2,) + (NORTH_N,) * 3, dev, SEED + 2)
    times = phase_times(dev, bf, holds, pfft, x)
    del x, pfft
    torch.cuda.empty_cache()
    times.update(phase_times64(dev, bf, holds))
    marks['times_s'] = time.perf_counter() - t_start
    times.update(phase_times_tp(dev, bf, holds))
    times.update(phase_times_any(dev, bf, holds))
    marks['times_any_s'] = time.perf_counter() - t_start
    probe_rows = phase_probes(dev)
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
        for extra in ('reach_ms', 'per_axis', 'mid_pair', 'n768',
                      'n768_band', 'w768',
                      'w1024', 'cufft_unfused_ms', 'two_a_passes_ms',
                      'n1536', 'trunc768', 's7', 's8', 'one_cta',
                      'ctas_a_plane', 'max_active'):
            if extra in t:
                kernels[-1][extra] = t[extra]
    _emit({'kernels': kernels + probe_rows})
    # seconds from the start at the end of the planar phases (3-10), the
    # reference-API phases (11-15), the any-extent phases (19-22), times
    # and times64, and times_any (the probes take the rest)
    _emit({'phase': 'done', 'seconds': time.perf_counter() - t_start,
           'marks': marks})
    print(_smi(), flush=True)
    _emit({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
