#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (``mpi4py_fft_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, run in the order 1-15, 19-22, 25-27, 16-18, 23, 24; any
failure raises and the script exits non-zero:

1. build     the kernels from ``mpi4py_fft_torch/ops/csrc`` with nvcc,
             the host-staging extension ``_hoststage`` from
             ``native/hoststage.cpp`` with g++ (``utils/native.py``, its
             seconds), the kernels' ``ptxas`` lines, how many two-CTA clusters of the
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
             768^3 grid): 2 ``fft_axis_tp`` and 1 ``rfft_axis_p`` launches
             forward, 2 ``fft_axis_tp`` and 1 ``irfft_axis_p`` backward
             (the 3/2-rule boundary in the kernels' reads and writes); the
             kernel path against the port's plain path on
             the card and the forward against a ``torch.fft.rfftn`` oracle;
             the backward's c2r (C on the line kernel) held slab by slab
             against its plain version on the plan's spectrum, into a
             NaN-filled output;
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
             then a forward and a backward again with each fused pass and
             the c2r held slab by slab against its plain version on the
             plan's own data (outputs NaN-filled first), timed, with its
             peak device memory;
12. pfft_c2c the same plan at ``'F'`` (3 ``fft_axis_tp`` launches each way:
             the line kernel on the last axis, the column band kernel's
             vectors on axes 1 and 0), against a truncated
             ``torch.fft.fftn``, each fused pass held slab by slab as in
             phase 11;
13. pfft64   the same plan at ``'d'`` (``fft_axis_tp_f64``: E64's four
             passes on the column band kernel, held at 2e-13; the plan at
             2e-10);
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
             ``irfft_axis_p_f64`` launches a step and 4 of each algebra
             kernel (``ops/dns_algebra.py``), the state held at 2e-10
             against the same solver on complex128 ``torch.fft`` (the
             transforms' oracle; the algebra kernels run in both), and the
             peak device memory; then ``times_dns``: the three algebra
             kernels alone at the step's shapes ((3, 512, 512, 257)
             spectra, six 768^3 grids; the projection as the first
             stage, a middle stage and the last), each held against its
             plain version on the card (1e-15), timed (CUDA events,
             median of 7 after 2 warm-ups) beside it and beside its bound
             (its bytes at 3.35 TB/s);
16. times    each kernel at the main path's shapes (CUDA events, median of
             7 after 2 warm-ups) beside its plain version, the one PyTorch
             call that computes the same function, and its bound; and the
             end-to-end 1024^3 c2c transform, unquartered and quartered.
             A (``fft_axis_p``) is timed by route with its reachable
             bound: the three 1024^3 passes (the last on the line kernel,
             the others on the band kernel), a quarter's mid pass and the
             dealiased 'f' plan's two 768-point passes (post 257, single
             elements; the lead axis, vectors), each held slab by slab on
             both signs into a NaN-filled output and in place (``out=``)
             bit for bit against out of place.
             B (the line kernel) is timed at the 768^3 last axis and at
             m3's truncating pass (trunc 257, scale 1/768), and C (the c2r
             line kernel) on B's 768^3 spectrum back to the real volume,
             each held slab by slab on a NaN-filled output (C with and
             without the 1/n scale), C with its reachable bound; C also
             on a random spectrum of that shape, whose DC and Nyquist
             rows have imaginary parts, held on host slabs against
             ``numpy.fft.irfft`` (5e-6; ``numpy_hold``).
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
             version, its bound and ``torch.fft.rfft``); C64 (the c2r
             line kernel) on the 512^3 last axis and at the dealiased
             solvers' shape, (2, 768, 768, 257) -> 768^3 (hin 257 of 385
             rows, padded in the read), each held slab by slab at 2e-13
             with and without the 1/n scale, and on a random spectrum of
             its shape against ``numpy.fft.irfft`` of host slabs at 2e-13
             (imaginary DC and Nyquist rows read as real), and timed
             beside its plain
             version, ``torch.fft.irfft(..., norm='forward')``, its bound
             and its reachable bound; ``fft_axis_p_f64``
             at the six
             passes of the 1024^3 ``'D'`` transform on the full volume,
             held at 2e-13 against its plain version slab by slab; and
             the 1024^3 ``'D'`` transform end to end;
18. times_tp ``fft_axis_tp`` and ``fft_axis_tp_f64`` at the four passes of
             the dealiased 512^3 plan at ``'f'`` and ``'d'`` (forward axes
             1 and 0 with the truncation and the stage's scale, backward
             axes 0 and 1 with the padding), and ``fft_axis_tp`` at the six
             of the plan at ``'F'`` (forward axes 2, 1 and 0, backward 0,
             1 and 2), each held against ``fft_axis_tp_plain`` slab by
             slab on its full volume into a NaN-filled output, timed beside
             the plain version, its bound, its reachable bound (half the
             ``block_copy`` times of its input and its output in the
             pass's access pattern) and cuFFT's unfused c2c pass at the
             same shape (no one PyTorch call computes the fused function:
             ``library_ms`` is null); each pass names its route by the C
             entry's rule (the column band kernel with vectors or single
             elements on inner axes, the line kernel on float32 whole
             lines, else the tile).

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
             move the scripts name (in place, out of place, two streams;
             ``block_copy`` on its vector route at every blocking, on its
             scalar route on a misaligned view and 2-float runs;
             ``move``'s every kind along the last and lead axes of 768^3,
             a (768, 768, 772) volume and a 768^3 view 4 bytes off
             alignment, shifts 1, 4 and 763, each route checked),
             ``bfly`` at 5e-6 in every mode, position and tile (copy and
             moves bit for bit; A's line and band kernels at N = 512, 768
             and 1024, A's tile elsewhere and with ``lines=``; in place
             bit for bit against out of place on the full 1024^3 volume),
             ``fma_chain`` at 5e-6 (f64 2e-13) after 256 iterations
             (every output filled with NaN first, so that a kernel that
             skips work cannot pass on memory that held the answer), each
             case's route printed; then
             the launch counters of the probe kernels are set to 0, every
             probe module runs (one JSON line each: ms, GB/s read + write
             against the HBM peak, the PyTorch yardstick) and each probe
             kernel must have been launched there; last, each probe
             kernel's time beside its plain version, its bound and its
             PyTorch yardstick for the ``kernels`` line, with its path
             (``block_copy``'s, ``move``'s and ``bfly``'s route);
             ``move``'s kinds (even, odd, reverse, roll by 1 and 4) along
             the last and lead axes of 768^3 beside ``copy_`` of the
             strided view, ``torch.flip`` and ``torch.roll``, each with
             its route and its bound from the sectors of x it must read
             (``move_bytes``); ``bfly``'s modes on
             the 1024^3 lead and mid passes beside the same modes on A's
             tile (``lines=tile_lines(1024)``) and A's own passes;
             ``block_copy`` on every ``_reach_ms`` pattern beside
             ``copy_``.  The route of every ``block_copy`` that
             ``_reach_ms`` timed prints before the ``kernels`` line.

25. dist     the distributed layer (``mpi4py_fft_torch/parallel``), ranks
             on this card: the dry run (``mpi4py_fft_torch/dryrun.py``) at
             n = 512 on one NCCL rank, bit for bit against the same calls
             on no group (the DNS step, the uneven PFFT and the c2c round
             trips), and ``dryrun_multichip`` itself; then 4 gloo ranks on
             the card (``dryrun.launch(..., backend='gloo')``, one process
             a rank): the dry run's float64 DNS step at 512^3 on a (2, 2)
             grid, each rank's block held against the one-rank step's
             (2e-10), the uneven ``PFFT((256, 257, 256), 'd',
             a2a_chunks=2)`` round trip (1e-8) and the float64 c2c round
             trip (2e-10); then 2 gloo ranks: the m3 plan ``PFFT((512,)*3,
             padding=[1.5]*3, dtype='f')`` on a slab grid (2, 1), each
             block held against the one-rank plan's (5e-5), exactly 1 B +
             2 E launches a forward and 2 E + 1 C a backward on every
             rank; every rank reports its launches, ms per step and per
             round trip with and without each exchange timed whole (CUDA
             events around it), the exchanges' ms and its peak memory.
             Gloo moves CUDA tensors through host memory: these are not
             the times of NVLink transposes.
26. r2r      the r2r transforms (``mpi4py_fft_torch/ops/core.py``) on B
             and C and on the one-pass DCT-II/III kernels: DCT I-IV, DST
             I-IV and DHT along axis 2 (whole lines) and axis 1 (the
             column band) of a (32, 512, 512) volume, DCT-I at N = 513 and
             DST-I at N = 511 (extended to 1024 points), R2HC then HC2R,
             at float32 and float64, each held against scipy's dct/dst
             (DHT: Re - Im of numpy's fft) in float64 on the host
             (relative L2 <= 5e-5, 2e-10), every B, C, DCT-II and DCT-III
             call on the way held slab by slab against its plain version
             (outputs NaN-filled first), ms per call; the DCT-II and
             DCT-III kernels at 512^3, float32 and float64, on axes 2 and
             1, each held first, beside their bound (512^3 values read
             and written a pass), their plain versions and the glue
             around torch.fft they replace (their rows of the kernels
             line); the r2c, c2r, DCT-II and DCT-III on the r2r cell's
             inner-axis passes (512^3 axis 0, axis 1 for the DCTs),
             float64 and float32, each held first, with its route, ms,
             bound, reach (``block_copy`` of the same boxes), plain
             version and the band instance's registers and spills (the
             ``inner`` rows of the kernels line); then the
             transforms example's plan ``PFFT(None, (512,)*3, axes=((0,),
             (1, 2)), transforms={(1, 2): (dctn type 3, idctn type 3)})``
             at 'd' and 'f' and its twin with ``padding=[1.5, 1, 1]``:
             the forward held slab by slab against scipy's dctn on axes
             1 and 2 and the rfft on axis 0 in float64, the round trip,
             ms and launches each way, peak memory, ``stage_times``
             (``utils/profiling.py``) of each direction, the bound (each
             pass's bytes read and written once) and a yardstick, the
             same plan with ``torch.fft.rfft``/``irfft`` in place of B
             and C; last 2 gloo ranks on the card: the ported transforms
             example at N = 18 and 512 'd' and the darray example, each
             printing its OK line, and each rank's block of the example's
             512^3 'd' plan against the one-rank forward (2e-10), with
             its launches and ms.
27. io       snapshot IO (``mpi4py_fft_torch/io/``) and the host staging
             of ``utils/native.py``: ``pack_block``/``unpack_block`` GB/s
             on half of a 512^3 'd' host array beside numpy's slice copy
             (bits held); ``PFFT(None, (512,)*3, dtype='d')`` forward
             and backward of a seeded input (B64, A64, C64; round trip
             2e-10), the input at steps 0 and 1 with the global slice
             [:, 256, :] and the spectrum written to one HDF5 file (where
             h5py is installed), ``generate_xdmf``, and the input to
             NetCDF, each read back under another alignment bit for
             bit; then 2 gloo ranks write the same input from their
             blocks (HDF5 ``vds``, ``serial``, ``repack``; NetCDF in
             turns), their datasets byte for byte the one-rank file's
             (NetCDF: the whole file), no sidecar after ``repack``, and
             the files read back on the 2 ranks and on one; ms and GB/s
             of every write and read (device <-> host copies in, page
             cache not flushed), file sizes, the disk's free space.

``python3 chip_smoke.py --times-probes TREE`` runs only phase 1 and the
probe kernels' times of phase 24 (``bfly``'s modes on the 1024^3 lead and
mid passes, on A's band and on A's tile of ``tile_lines(1024)`` lines,
beside A's own passes and cuFFT; ``block_copy`` on every pattern that
``_reach_ms`` times, each beside ``copy_``, with its route; ``move``'s
kinds on the 768^3 last and lead axes beside their PyTorch calls; each
held first) on the port of the checkout at TREE, and prints no last line:
run it for two trees in turns on one card (parent, change, change,
parent).  A tree without ``move_route`` or ``move_bytes`` reports that
route and bound as null.

``python3 chip_smoke.py --times-c2r TREE`` runs only phase 1, B's and
C's rows of phase 16 and C64's rows of phase 17 on the port of the
checkout at TREE, each c2r's hold against numpy on a random spectrum
reported in its row and not checked (a tree whose c2r keeps the
imaginary DC and Nyquist parts runs to the end), and prints no last
line: run it for two trees in turns on one card.

``python3 chip_smoke.py --times-dns`` runs only phase 1, ``times_dns``
and phase 15, and prints no last line.

``python3 chip_smoke.py --times-r2r TREE`` runs only phase 1, the DCT-II
and DCT-III kernels' rows and the real kernels' inner-axis rows of phase
26 (null in a tree without them) and
the transforms example's 512^3 'd' plan of phase 26 on the port of the
checkout at TREE, and prints no last line: run it for two trees in turns
on one card.

``python3 chip_smoke.py --times-any TREE`` runs only phases 1, 22 and 23,
B's two rows and C's row of phase 16, A's, C64's, D's and A64's rows of
phases 16 and 17, and phases 11, 12, 13 and 18, on the port of the
checkout at TREE (a tree from the plane-holding H on), and prints no
last line: run it for two trees in turns on one card (parent, change,
change, parent) to compare H, I, J, A, B, C, C64, D, A64, E and E64 and
the m3 plan at 'f', 'F' and 'd' between them.

Phases 3 to 15, 19 to 22 and 25 to 27 are the main path: the launch
counters are set to 0 just before phase 3 and read after phase 27
(phases 16 to 18 run after it, as do times_any); the ranks of phases 25
and 26 count their own launches.  The probe kernels' path is phase 24's
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
import shutil
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
# phase dist: ranks on this card over gloo (CUDA tensors through host
# memory); the DNS step at phase 10's size, the uneven PFFT round trip at
# (256, 257, 256), the m3 plan at phase 11's
DIST_N = 512
DIST_PFFT_N = 256
DIST_M3_N = 512
DIST_TIMEOUT = 420         # seconds for each launch of ranks
# phase io: the 'd' PFFT whose input and spectrum it writes, NetCDF at
# the same size (scipy's writer moves the whole file at each write: about
# 2 s a 1 GiB record on the card), and the writes' global slice
IO_N = 512
IO_SLICE = (slice(None), IO_N // 2, slice(None))
R2R_N = 512                # the r2r kinds' length and the r2r plans' N^3
R2R_BATCH = 32             # the kinds' (R2R_BATCH, R2R_N, R2R_N) volume
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


def _reach_box(xs, ax):
    """The float32 views of the contiguous planar (2, A, B, C) tensors
    ``xs`` (one, or a pair's two halves) and the ``block_copy`` box of the
    access pattern of one pass along complex axis ``ax``: (2, 1, B, C)
    planes for the last axis; for the mid axis (2, 8, B, 128) where 128
    elements divide the row, else (2, 1, B, C), whole rows (the DNS's odd
    post, which allows no vector); for the lead axis 512-byte runs of
    every row, (2, A, 128) on the (2, A, B C) view.  float64 is copied as
    pairs of float32."""
    vs = [x.view(torch.float32) for x in xs]
    _, A, B, C = vs[0].shape
    if ax == 0:
        vs = [v.view(2, A, B * C) for v in vs]
        box = (2, A, 128 if B * C % 128 == 0 else B * C)
    elif ax == 1:
        box = (2, 8, B, 128) if C % 128 == 0 else (2, 1, B, C)
    else:
        box = (2, 1, B, C)
    return vs, box


# block_copy's route for each pattern that _reach_ms timed, by tensor
# shape and box (the kernels line prints it)
REACH_ROUTES = {}


def _copy_route(tp, x, box, **pair):
    """block_copy's route on these tensors ('vector', 'scalar'; a tree
    whose probes do not report one: 'not reported')."""
    route = getattr(tp, 'block_copy_route', None)
    return route(x, box, **pair) if route else 'not reported'


def _reach_ms(xs, ax):
    """The reachable bound of one pass along complex axis ``ax`` of the
    contiguous planar (2, A, B, C) tensors ``xs`` (one, or a pair's two
    halves), measured: the time of ``block_copy`` (the probes' copy
    kernel) of the same tensors out of place, in the boxes of the pass's
    access pattern (``_reach_box``), its route kept in ``REACH_ROUTES``."""
    from mpi4py_fft_torch.ops import probes as tp
    vs, box = _reach_box(xs, ax)
    ys = [torch.empty_like(v) for v in vs]
    pair = {} if len(vs) == 1 else {'x2': vs[1], 'out2': ys[1]}
    key = f"{tuple(vs[0].shape)} in {box}" + (' x2' if pair else '')
    REACH_ROUTES[key] = _copy_route(tp, vs[0], box, **pair)
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
    from mpi4py_fft_torch.utils import native
    t0 = time.perf_counter()
    _build.load()
    secs = time.perf_counter() - t0
    # the host-staging extension (g++, native/hoststage.cpp)
    t0 = time.perf_counter()
    _check(native.HAVE_NATIVE, "utils.native: no C++ compiler on PATH")
    hoststage = native.build().name
    native._hoststage()
    host_secs = time.perf_counter() - t0
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
           'hoststage': hoststage, 'hoststage_seconds': host_secs,
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


def phase_dealias(dev, bf, holds, dtype='f'):
    """The r2c 3/2-rule plan at float32 ('f', phase dealias) or float64
    ('d', phase dealias64); the backward's c2r held slab by slab against
    its plain version on the pipeline's spectrum."""
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
    with _held_calls(bf, holds, ('irfft_axis_p',)):
        z = pfft.backward(y)
    torch.cuda.synchronize()
    c2 = dict(bf.LAUNCHES)
    fwd = _delta(c0, c1)
    bwd = _delta(c1, c2)
    # the 3/2-rule boundary in the kernels: E's write and B's (trunc)
    # forward, E's read and C's (a truncated spectrum) backward
    _check(fwd == {'fft_axis_tp' + sfx: 2, 'rfft_axis_p' + sfx: 1},
           f"forward launches {fwd}")
    _check(bwd == {'fft_axis_tp' + sfx: 2, 'irfft_axis_p' + sfx: 1},
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
    per_axis = [_axis_pass(bf, holds, p, 1, 'band, single elements'),
                _axis_pass(bf, holds, p, 0, 'band, vectors')]
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
    out['irfft_axis_p_f64'] = _times_c64(dev, bf, holds, h, g)
    del h
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


def _c2r_reach_ms(h, y):
    """The reachable bound of a c2r pass along the last axis of the
    planar spectrum h into the real y: half the sum of ``_reach_ms`` of
    the two tensors (a copy of each moves its bytes twice; the pass reads
    h and writes y once)."""
    yv = y.view((2, y.shape[0] // 2) + tuple(y.shape[1:]))   # even lead
    return (_reach_ms((h,), 2) + _reach_ms((yv,), 2)) / 2


def _herm_pad_np(c, nh):
    """The complex half spectrum c cut or zero-padded to nh rows along its
    last axis, with the Hermitian rule of a short spectrum (an even count
    of rows has its last row's real part halved, its imaginary part 0)."""
    hin = c.shape[-1]
    if hin >= nh:
        return c[..., :nh]
    out = np.zeros(c.shape[:-1] + (nh,), dtype=c.dtype)
    out[..., :hin] = c
    if hin % 2 == 0:
        out[..., hin - 1] = 0.5 * out[..., hin - 1].real
    return out


def _c2r_vs_numpy(bf, h, n, what, check=True, s=4):
    """C (C64 on float64) along the last axis into n points on a random
    half spectrum of h's shape, whose DC row and (where present) Nyquist
    row have imaginary parts: slabs of s lines of the output (first,
    middle, last) against ``numpy.fft.irfft(...) * n`` of the same host
    slab, Hermitian-padded where short, in float64.  Fails above 5e-6
    (2e-13) unless ``check`` is false; returns the largest relative L2
    and abs error."""
    f64 = h.dtype == torch.float64
    tol = KERNEL_TOL64 if f64 else KERNEL_TOL
    g = torch.Generator(device=h.device).manual_seed(SEED + 31)
    q = torch.rand(h.shape, generator=g, device=h.device,
                   dtype=h.dtype) - 0.5
    y = bf.irfft_axis_p(q, 2, n)
    torch.cuda.synchronize()
    rel = err = 0.0
    for i in sorted({0, q.shape[1] // 2, q.shape[1] - s}):
        c = q[:, i:i + s].double().cpu().numpy()
        ref = np.fft.irfft(_herm_pad_np(c[0] + 1j * c[1], n // 2 + 1), n,
                           axis=-1) * n
        d = y[i:i + s].double().cpu().numpy() - ref
        r = float(np.linalg.norm(d) / np.linalg.norm(ref))
        rel, err = max(rel, r), max(err, float(np.abs(d).max()))
        _check(bool(np.isfinite(d).all()), f"{what}: non-finite")
        if check:
            _check(r <= tol, f"{what} on a random spectrum, lines {i}.."
                             f"{i + s - 1}, against numpy.fft.irfft: rel "
                             f"L2 {r:.3e} > {tol}")
    del q, y
    torch.cuda.empty_cache()
    return {'rel_l2': rel, 'max_abs_err': err, 'tolerance': tol}


def _c2r_row(bf, holds, h, n, what, check_numpy=True):
    """C (irfft_axis_p; C64 on float64) along the last axis of the
    spectrum h into n points, on the c2r line kernel: held at 5e-6 (2e-13)
    slab by slab on both scales (None, 1/n) into a NaN-filled output, and
    on a random spectrum of h's shape against numpy (``_c2r_vs_numpy``,
    its errors in ``numpy_hold``), then timed beside its plain version,
    torch.fft.irfft, its bound and its reachable bound."""
    f64 = h.dtype == torch.float64
    name = 'irfft_axis_p' + ('_f64' if f64 else '')
    size = h.element_size()
    pre = h.shape[1] * h.shape[2]
    for sc in (None, 1.0 / n):
        _nan_block((h.shape[1], h.shape[2], n), h.dtype, h.device)
        _slab_hold(holds, name, bf.irfft_axis_p(h, 2, n, scale=sc),
                   lambda i, w: bf.irfft_axis_plain(h.narrow(1, i, w), 2, n,
                                                    scale=sc),
                   0, f"{name} {what} scale={sc}")
    numpy_hold = _c2r_vs_numpy(bf, h, n, f"{name} {what}", check_numpy)
    b, by = _bound_ms(h.numel() * size + pre * n * size,
                      pre * 2.5 * n * math.log2(n), f64=f64)
    hc = torch.complex(h[0], h[1])
    row = {'kernel': 'irfft_lines_kernel (the c2r line kernel)',
           'shape': f"{tuple(h.shape)} {'f64' if f64 else 'f32'} -> "
                    f"({h.shape[1]}, {h.shape[2]}, {n}), last axis",
           'ms': _median_ms(lambda: bf.irfft_axis_p(h, 2, n)),
           'plain_ms': _median_ms(lambda: bf.irfft_axis_plain(h, 2, n),
                                  reps=3, warm=1),
           'library_ms': _median_ms(
               lambda: torch.fft.irfft(hc, n=n, dim=2, norm='forward')),
           'bound_ms': b, 'bound_by': by, 'numpy_hold': numpy_hold}
    del hc
    y = bf.irfft_axis_p(h, 2, n)
    row['reach_ms'] = _c2r_reach_ms(h, y)
    del y
    torch.cuda.empty_cache()
    return row


def _times_c64(dev, bf, holds, h, g, check_numpy=True):
    """C64 on the 512^3 DNS's last axis (the spectrum h of its real
    volume; the row) and at the dealiased solvers' shape (``pad768``: a
    random (2, 768, 768, 257) spectrum, hin 257 < 385 rows, into 768
    points, Hermitian zero-padded in the read)."""
    n = 2 * (h.shape[-1] - 1)
    row = _c2r_row(bf, holds, h, n, f"{n}^3 last axis", check_numpy)
    m = 3 * DEALIAS64_N // 2
    nt = DEALIAS64_N // 2 + 1
    p = torch.rand((2, m, m, nt), generator=g, device=dev,
                   dtype=torch.float64) - 0.5
    row['pad768'] = _c2r_row(bf, holds, p, m,
                             f"(2, {m}, {m}, {nt}) -> {m}^3 last axis",
                             check_numpy)
    del p
    torch.cuda.empty_cache()
    return row


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


def _times_b_c(dev, bf, holds, check_numpy=True):
    """B's row (``_times_b``) and C's: the c2r line kernel on B's 768^3
    spectrum back to the real volume (``_c2r_row``)."""
    b, k = _times_b(dev, bf, holds)
    m = 3 * DEALIAS_N // 2
    c = _c2r_row(bf, holds, k, m, f"{m}^3 last axis", check_numpy)
    del k
    torch.cuda.empty_cache()
    return b, c


def _axis64_w768(dev, bf, holds, g):
    """A64 at the three passes of a 768^3 volume (the dealiased 'd'
    plans' length): the last axis on the line kernel, the others on the
    band kernel (a radix-3 column stage first, clusters of four CTAs)."""
    m = 3 * DEALIAS64_N // 2
    p = torch.rand((2, m, m, m), generator=g, device=dev,
                   dtype=torch.float64) - 0.5
    rows = [_axis_pass(bf, holds, p, 2, 'lines'),
            _axis_pass(bf, holds, p, 1, 'band, vectors'),
            _axis_pass(bf, holds, p, 0, 'band, vectors')]
    del p
    torch.cuda.empty_cache()
    return rows


def _axis_pass(bf, holds, p, ax, route, in_place=True):
    """A (fft_axis_p; A64 on float64) on p along ax: held on both signs
    slab by slab against its plain version into a NaN-filled output, in
    place (out= a copy of p, ``in_place``) bit for bit against out of
    place, then timed beside its plain version, torch.fft.fft, its bound
    and its reachable bound."""
    f64 = p.dtype == torch.float64
    name = 'fft_axis_p_f64' if f64 else 'fft_axis_p'
    sd = 2 if ax == 0 else 1                   # slabs off the pass axis
    N = p.shape[1 + ax]
    tag = f"{name} {tuple(p.shape)} axis {ax} ({route})"
    for fwd in (True, False):
        k = bf.fft_axis_p(p, ax, fwd, out=_nan(p))
        _slab_hold(holds, name, k, lambda i, w: (
            bf.fft_axis_plain(p.narrow(sd, i, w), ax, fwd)), sd,
            f"{tag} fwd={fwd}")
        del k
    if in_place:
        _hold_axis_in_place(bf, p, ax, tag)
    b, by = _pass_bound(p.numel(), N, f64=f64)
    row = {'axis': ax, 'route': route,
           'shape': f"{tuple(p.shape)} {'f64' if f64 else 'f32'}, "
                    f"axis {ax}",
           'ms': _median_ms(lambda: bf.fft_axis_p(p, ax)),
           'plain_ms': _median_ms(lambda: bf.fft_axis_plain(p, ax), reps=3,
                                  warm=1)}
    pc = torch.complex(p[0], p[1])
    row['library_ms'] = _median_ms(lambda: torch.fft.fft(pc, dim=ax))
    del pc
    torch.cuda.empty_cache()
    row.update(bound_ms=b, bound_by=by,
               reach_ms=_reach_ms((p,), ax))
    return row


def _hold_axis_in_place(bf, p, ax, tag):
    """fft_axis_p in place (out= a copy of p) against out of place into a
    NaN-filled tensor, bit for bit, with a scale."""
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
        _hold_axis_in_place(bf, x.narrow(sd, 0, s).contiguous(), ax,
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


def _times_a(dev, bf, holds, x):
    """A at the main path's shapes (``_axis_pass``: held on both signs
    slab by slab, in place, timed with its reachable bound): the three
    passes of the north-star volume x (the row: the last axis on the
    line kernel, the others on the band kernel), the mid pass of one of
    the quartered schedule's quarters (``quarter_mid``), and the two
    768-point passes of the dealiased 'f' plan (``f768``: the mid axis at
    post 257, single elements, and the lead axis, vectors)."""
    from mpi4py_fft_torch.ops import oop3d
    n = x.shape[1]
    per_axis = [_axis_pass(bf, holds, x, 2, 'lines'),
                _axis_pass(bf, holds, x, 1, 'band, vectors'),
                _axis_pass(bf, holds, x, 0, 'band, vectors')]
    keys = ('ms', 'plain_ms', 'library_ms', 'bound_ms', 'reach_ms')
    row = {k: sum(a[k] for a in per_axis) for k in keys}
    row.update(shape=f'3 passes, axes 2, 1, 0 of (2, {n}, {n}, {n}) f32',
               bound_by=per_axis[0]['bound_by'], per_axis=per_axis)
    q = oop3d.split_q(x)[0]
    row['quarter_mid'] = _axis_pass(bf, holds, q, 1, 'band, vectors')
    del q
    torch.cuda.empty_cache()
    m = 3 * DEALIAS_N // 2
    nt = DEALIAS_N // 2 + 1
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    row['f768'] = []
    for shape, ax, route in (((m, m, nt), 1, 'band, single elements'),
                             ((m, DEALIAS_N, nt), 0, 'band, vectors')):
        p = torch.rand((2,) + shape, generator=g, device=dev) - 0.5
        row['f768'].append(_axis_pass(bf, holds, p, ax, route))
        del p
        torch.cuda.empty_cache()
    return row


def phase_times(dev, bf, holds, pfft, x):
    """Kernel, plain and library times at the main path's shapes."""
    out = {}
    n = x.shape[1]
    from mpi4py_fft_torch.ops import oop3d
    out['fft_axis_p'] = _times_a(dev, bf, holds, x)
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
    out['rfft_axis_p'], out['irfft_axis_p'] = _times_b_c(dev, bf, holds)
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


def phase_pfft(dev, bf, holds, dtype):
    """The reference API's dealiased plan ``PFFT(None, (d,)*3,
    padding=[1.5]*3)`` on planar tensors (phase pfft at 'f', pfft_c2c at
    'F', pfft64 at 'd'), its fused passes and c2r held slab by slab on
    the plan's own data."""
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
    # E's passes and C held slab by slab on the plan's own data, a forward
    # and a backward again (the kernels' outputs NaN-filled first)
    with _held_calls(bf, holds, ('fft_axis_tp', 'irfft_axis_p')):
        fft.backward.fn_p(fft.forward.fn_p(x))
    torch.cuda.synchronize()
    c2h = dict(bf.LAUNCHES)
    _check(_delta(c2, c2h) == {k: want_f.get(k, 0) + want_b.get(k, 0)
                               for k in set(want_f) | set(want_b)},
           f"'{dtype}' held launches {_delta(c2, c2h)}")
    c2 = c2h
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
    # backwards for the energy; each algebra kernel 4 times a step
    want = {'fft_axis_p_f64': 2 * (2 + 360 + 3), 'rfft_axis_p_f64': 122,
            'irfft_axis_p_f64': 243, **{k: 40 for k in DNS_KERNELS}}
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
                'irfft_axis_p_f64': 24, **{k: 4 for k in DNS_KERNELS}}
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
    _check(_delta(c4, bf.LAUNCHES) == {k: 12 for k in DNS_KERNELS},
           "the oracle launched a transform kernel")
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


DNS_ALGEBRA_TOL = 1e-15    # an algebra kernel against its plain version
# the DNS solver's algebra kernels (ops/dns_algebra.py), 4 launches each a
# step of the reference solver
DNS_KERNELS = ('dns_curl_f64', 'dns_cross_f64', 'dns_project_rk_f64')


def _dns_row(bf, holds, name, run, plain, got, want, nbytes, shape,
             reps_plain=3):
    """One algebra kernel's row: ``got`` (its output) held against
    ``want`` (the plain version's), then ``run`` and ``plain`` timed.
    The plain version is the solver's former eager torch ops, so the row
    has no ``library_ms`` of its own."""
    torch.cuda.synchronize()
    got = [g for g in got if g is not None]
    want = [w for w in want if w is not None]
    real = [(torch.view_as_real(g) if g.is_complex() else g,
             torch.view_as_real(w) if w.is_complex() else w)
            for g, w in zip(got, want)]
    for g, w in real:
        holds.hold(name, g, w, f"{name} {tuple(g.shape)}")
    rel = max(_rel(g, w)[0] for g, w in real)
    exact = all(torch.equal(g, w) for g, w in zip(got, want))
    _check(rel <= DNS_ALGEBRA_TOL, f"{name}: rel L2 {rel:.3e} against its "
                                   f"plain version")
    del got, want, real
    c0 = bf.LAUNCHES[name]
    ms = _median_ms(run)
    _check(bf.LAUNCHES[name] - c0 == 9, f"{name}: launches while timed")
    plain_ms = _median_ms(plain, reps=reps_plain, warm=1)
    bound, by = _bound_ms(nbytes, 0, f64=True)
    return {'shape': list(shape), 'ms': ms, 'plain_ms': plain_ms,
            'library_ms': None, 'bound_ms': bound, 'bound_by': by,
            'gb': nbytes / 1e9, 'hbm_pct': 100.0 * bound / ms,
            'max_rel_l2': rel, 'exact': exact}


def phase_times_dns(dev, bf, holds):
    """The solver's three algebra kernels alone at the rk4 cell's shapes
    (``DNS_SOLVER_N``^3 dealiased: (3, n, n, n/2+1) spectra, six (3n/2)^3
    grids), each held against its plain version on the card, then timed
    beside it and beside its bound (its bytes at 3.35 TB/s).  Returns the
    three kernels' rows."""
    from mpi4py_fft_torch.ops import dns_algebra as da
    n = DNS_SOLVER_N
    S = (n, n, n // 2 + 1)
    g = torch.Generator(device=dev).manual_seed(SEED + 25)

    def spec(shape):
        return torch.complex(
            torch.randn(shape, generator=g, device=dev, dtype=torch.float64),
            torch.randn(shape, generator=g, device=dev, dtype=torch.float64))
    k = [np.fft.fftfreq(n, 1. / n), np.fft.fftfreq(n, 1. / n),
         np.fft.rfftfreq(n, 1. / n)]
    Lp = 2 * np.pi / np.array([2 * np.pi, 4 * np.pi, 4 * np.pi])
    K = [torch.tensor(k[i] * Lp[i], device=dev).reshape(
        [S[i] if d == i else 1 for d in range(3)]) for i in range(3)]
    kbytes = sum(Ki.numel() * 8 for Ki in K)
    one = 3 * math.prod(S) * 16                 # a (3,) + S state
    nu, adt, bdt = 0.000625, 0.01 / 3, 0.005
    rows = {}
    U = spec((3,) + S)
    rows['dns_curl_f64'] = _dns_row(
        bf, holds, 'dns_curl_f64', lambda: da.curl(U, K),
        lambda: da.curl_plain(U, K), [da.curl(U, K)],
        [da.curl_plain(U, K)], 2 * one + kbytes, U.shape)
    N = [spec(S) for _ in range(3)]
    U0, U1 = spec((3,) + S), spec((3,) + S)
    name = 'dns_project_rk_f64'
    # the first stage: U, U0 and U1 the caller's state, new buffers
    rows[name] = _dns_row(
        bf, holds, name, lambda: da.project_rk(N, U, U, U, K, nu, adt, bdt),
        lambda: da.project_rk_plain(N, U, U, U, K, nu, adt, bdt),
        da.project_rk(N, U, U, U, K, nu, adt, bdt),
        da.project_rk_plain(N, U, U, U, K, nu, adt, bdt),
        4 * one + kbytes, U.shape)              # N and U read, two written
    # a middle stage and the last, in place on the stage's own buffers
    for key, b in (('middle', bdt), ('last', None)):
        Uc, U1c = U.clone(), U1.clone()
        got = da.project_rk(N, Uc, U0, U1c, K, nu, adt, b, inplace=True)
        want = da.project_rk_plain(N, U.clone(), U0, U1.clone(), K, nu,
                                   adt, b, inplace=True)
        reads = 4 if b is not None else 3
        rows[name][key] = _dns_row(
            bf, holds, name,
            lambda: da.project_rk(N, Uc, U0, U1c, K, nu, adt, b,
                                  inplace=True),
            lambda: da.project_rk_plain(N, U, U0, U1, K, nu, adt, b),
            got, want, (reads + (2 if b is not None else 1)) * one + kbytes,
            U.shape)
        del got, want, Uc, U1c
    del U, U0, U1, N
    torch.cuda.empty_cache()
    m = 3 * n // 2
    u = [torch.randn((m,) * 3, generator=g, device=dev, dtype=torch.float64)
         for _ in range(3)]
    w = [torch.randn((m,) * 3, generator=g, device=dev, dtype=torch.float64)
         for _ in range(3)]
    want = da.cross_plain(u, [t.clone() for t in w])
    got = da.cross(u, w)
    rows['dns_cross_f64'] = _dns_row(
        bf, holds, 'dns_cross_f64', lambda: da.cross(u, w),
        lambda: da.cross_plain(u, w), got, want, 9 * m ** 3 * 8,
        (3,) + u[0].shape)
    del u, w, got, want
    torch.cuda.empty_cache()
    _emit({'phase': 'times_dns', 'spectrum': list(S), 'grid': [m] * 3,
           'kernels': rows})
    return rows


def _tp_route(inp, ax, kw):
    """The kernel fft_axis_tp.cu's C entry picks for the pass of ``inp``
    along ``ax`` with ``kw`` (trunc or pad) into a new tensor: at N = 768
    the band kernel on inner axes (vectors where post is a multiple of a
    16-byte vector and the input is aligned) unless a truncation to an
    even Nt folds across CTAs (4 does not divide N - Nt), the line kernel
    on float32 whole lines where Nt/2 and N - Nt are multiples of 4 and
    the input is aligned; else the tile."""
    pad = kw.get('pad') is not None
    N = kw['pad'] if pad else inp.shape[1 + ax]
    nt = inp.shape[1 + ax] if pad else kw['trunc']
    post = math.prod(inp.shape[2 + ax:])
    vec = 16 // inp.element_size()
    aligned = inp.data_ptr() % 16 == 0
    if N != 768:
        return 'tile'
    if post > 1:
        if not pad and nt % 2 == 0 and (N - nt) % 4:
            return 'tile'
        return 'band, ' + ('vectors' if post % vec == 0 and aligned else
                           'single elements')
    if (inp.dtype == torch.float32 and (nt // 2) % 4 == 0 and
            (N - nt) % 4 == 0 and aligned):
        return 'lines'
    return 'tile'


_TP_KERNELS = {'band': 'fft_axis_tp_band_kernel (the column band kernel, '
                       'clusters of 4 CTAs)',
               'lines': 'fft_axis_tp_lines_kernel (a warp a line)',
               'tile': 'fft_axis_tp_kernel (the tile)'}


def _tp_passes(bf, holds, name, inp, passes):
    """Each pass (direction, axis, kw) of a dealiased plan in turn, from
    ``inp``: held slab by slab on its full volume into a NaN-filled
    output, timed beside the plain version, cuFFT's unfused c2c pass on
    the pass's larger side, its bound and its reachable bound; returns
    the rows and their sums."""
    f64 = inp.dtype == torch.float64
    rows = []
    for direction, ax, kw in passes:
        fwd = direction == 'fwd'
        route = _tp_route(inp, ax, kw)
        k = _tp_held(bf, bf.fft_axis_tp, holds, inp, ax, fwd, kw,
                     f"{name} {direction} axis {ax}")
        Nin, Nout = inp.shape[1 + ax], k.shape[1 + ax]
        big = inp if Nin > Nout else k
        N = max(Nin, Nout)
        lines = inp.numel() // 2 // Nin
        b, by = _bound_ms((Nin + Nout) * lines * 2 * (8 if f64 else 4),
                          lines * 5 * N * math.log2(N), f64)
        bc = torch.complex(big[0], big[1])
        rows.append({
            'pass': f"{direction} axis {ax}", 'route': route,
            'in': list(inp.shape), 'out': list(k.shape),
            'ms': _median_ms(lambda: bf.fft_axis_tp(inp, ax, fwd, **kw)),
            'plain_ms': _median_ms(
                lambda: bf.fft_axis_tp_plain(inp, ax, fwd, **kw),
                reps=3, warm=1),
            'cufft_unfused_ms': _median_ms(
                lambda: torch.fft.fft(bc, dim=ax)),
            'bound_ms': b, 'bound_by': by})
        del bc, big
        # half the copies of the input and the output in the pass's
        # access pattern (the pass reads the one and writes the other)
        rows[-1]['reach_ms'] = (_reach_ms((inp,), ax) +
                                _reach_ms((k,), ax)) / 2
        inp = k
        del k
    del inp
    torch.cuda.empty_cache()
    row = {key: sum(r[key] for r in rows)
           for key in ('ms', 'plain_ms', 'cufft_unfused_ms', 'bound_ms',
                       'reach_ms')}
    row.update(bound_by=rows[0]['bound_by'], library_ms=None, per_pass=rows,
               kernel=', '.join(_TP_KERNELS[k] for k in _TP_KERNELS
                                if any(r['route'].startswith(k)
                                       for r in rows)))
    return row


def phase_times_tp(dev, bf, holds):
    """fft_axis_tp (f32 and f64) at the four passes of the dealiased 512^3
    plan at 'f' and 'd', and the f32 kernel at the six of the plan at
    'F', each held against its plain version slab by slab on the full
    volume, and timed beside it, its bound and cuFFT's unfused pass."""
    from mpi4py_fft_torch import PFFT
    d = PFFT_N
    m = 3 * d // 2
    out = {}
    for dtype in 'fdF':
        f64, real = dtype == 'd', dtype in 'fd'
        name = 'fft_axis_tp' + ('_f64' if f64 else '')
        tdt = torch.float64 if f64 else torch.float32
        fft = PFFT(None, (d,) * 3, padding=[1.5] * 3, dtype=dtype)
        g = torch.Generator(device=dev).manual_seed(SEED + 50)
        x = torch.rand((m,) * 3 if real else (2,) + (m,) * 3, generator=g,
                       device=dev, dtype=tdt) - 0.5
        # the forward's stages after the first (r2c) one, or every stage
        first = fft.xfftn[0].forward_fn_p(x) if real else x
        del x
        stages = fft.xfftn[1:] if real else fft.xfftn
        fwd = [('fwd', s.axes[-1], dict(trunc=d, scale=float(s.M)))
               for s in stages]
        bwd = [('bwd', s.axes[-1], dict(pad=m)) for s in stages[::-1]]
        row = _tp_passes(bf, holds, name, first, fwd + bwd)
        del first, fft
        torch.cuda.empty_cache()
        if dtype == 'F':
            row['shape'] = (f"6 passes of the {d}^3 'F' plan on its {m}^3 "
                            f"grid: fwd axes 2, 1, 0 (trunc {m} -> {d}), "
                            f"bwd axes 0, 1, 2 (pad {d} -> {m}), {tdt}")
            out['fft_axis_tp']['c2c_F'] = row
        else:
            row['shape'] = (f"4 passes of the {d}^3 '{dtype}' plan on its "
                            f"{m}^3 grid: fwd axes 1, 0 (trunc {m} -> {d}), "
                            f"bwd axes 0, 1 (pad {d} -> {m}), {tdt}")
            out[name] = row
    _emit({'phase': 'times_tp', 'kernels': out})
    return out


def _tp_held(bf, tp, holds, inp, ax, fwd, kw, what):
    """tp(inp, ax, fwd, **kw) (``fft_axis_tp``) into a NaN-filled output,
    held against its plain version slab by slab along a planar dim off
    the pass axis; returns the output."""
    name = 'fft_axis_tp' + ('_f64' if inp.dtype == torch.float64 else '')
    sd = 2 if ax == 0 else 1
    shape = list(inp.shape)
    shape[1 + ax] = kw['pad'] if kw.get('pad') is not None else kw['trunc']
    _nan_block(shape, inp.dtype, inp.device)
    k = tp(inp, ax, fwd, **kw)
    _slab_hold(holds, name, k, lambda i, w: bf.fft_axis_tp_plain(
        inp.narrow(sd, i, w), ax, fwd, **kw), sd, what)
    return k


@contextlib.contextmanager
def _held_calls(bf, holds, names):
    """Within the block, every call of the wrappers ``names``
    (``rfft_axis_p``, ``irfft_axis_p``, ``fft_axis_tp``, ``dct2_axis_p``,
    ``dct3_axis_p``) lands in a
    NaN-filled block and is held slab by slab against its plain version
    on the data the pipeline gives it (5e-6, 2e-13 on float64)."""
    saved = {n: getattr(bf, n) for n in names}

    def r2c(x, axis, hext=None, scale=None, trunc=None):
        axis %= x.dim()
        shape = list(x.shape)
        shape[axis] = bf._r2c_out_rows(shape[axis], hext, trunc)[1]
        _nan_block([2] + shape, x.dtype, x.device)
        kw = dict(hext=hext, scale=scale, trunc=trunc)
        y = saved['rfft_axis_p'](x, axis, **kw)
        d = 1 if axis == 0 else 0              # slabs off the pass axis
        name = 'rfft_axis_p' + ('_f64' if x.dtype == torch.float64 else '')
        _slab_hold(holds, name, y, lambda i, w: bf.rfft_axis_plain(
            x.narrow(d, i, w), axis, **kw), d + 1,
            f"{name} {tuple(x.shape)} axis {axis} in the pipeline")
        return y

    def c2r(p, axis, n, scale=None):
        axis %= p.dim() - 1
        shape = list(p.shape[1:])
        shape[axis] = n
        _nan_block(shape, p.dtype, p.device)
        y = saved['irfft_axis_p'](p, axis, n, scale=scale)
        d = 1 if axis == 0 else 0              # slabs off the pass axis
        name = 'irfft_axis_p' + ('_f64' if p.dtype == torch.float64 else '')
        _slab_hold(holds, name, y, lambda i, w: bf.irfft_axis_plain(
            p.narrow(1 + d, i, w), axis, n, scale=scale), d,
            f"{name} {tuple(p.shape)} axis {axis} in the pipeline")
        return y

    def tp(p, axis, forward=True, trunc=None, pad=None, scale=None):
        axis %= p.dim() - 1
        return _tp_held(bf, saved['fft_axis_tp'], holds, p, axis, forward,
                        dict(trunc=trunc, pad=pad, scale=scale),
                        f"fft_axis_tp {tuple(p.shape)} axis {axis} in the "
                        f"pipeline")

    def dct(what):
        def held(x, axis):
            plain = getattr(bf, what[:4] + '_axis_plain')
            axis %= x.dim()
            _nan_block(tuple(x.shape), x.dtype, x.device)
            y = saved[what](x, axis)
            d = 1 if axis == 0 else 0          # slabs off the pass axis
            name = what + ('_f64' if x.dtype == torch.float64 else '')
            _slab_hold(holds, name, y, lambda i, w: plain(
                x.narrow(d, i, w), axis), d,
                f"{name} {tuple(x.shape)} axis {axis} in the pipeline")
            return y
        return held

    wrapped = {'rfft_axis_p': r2c, 'irfft_axis_p': c2r, 'fft_axis_tp': tp,
               'dct2_axis_p': dct('dct2_axis_p'),
               'dct3_axis_p': dct('dct3_axis_p')}
    for n in names:
        setattr(bf, n, wrapped[n])
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(bf, n, f)


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


# -- phase dist: the distributed layer, ranks on this card ----------------

def _event_ms(fn):
    """ms of one call of fn between two CUDA events."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


@contextlib.contextmanager
def _timed_exchanges(acc):
    """Run each pencil exchange whole (started and waited on at once)
    between two CUDA events, its packing and unpacking copies included,
    and append its ms to ``acc``."""
    from mpi4py_fft_torch.parallel import pencil, planar
    real = pencil.exchange

    def timed(x, *args):
        out = []
        acc.append(_event_ms(lambda: out.append(real(x, *args).wait())))
        return pencil._Done(out[0])
    pencil.exchange = planar.exchange = timed
    try:
        yield
    finally:
        pencil.exchange = planar.exchange = real


def _timed_with_exchanges(fn):
    """(ms of fn, ms of fn with every exchange timed whole, the exchanges'
    ms in that run)."""
    ms = _event_ms(fn)
    acc = []
    with _timed_exchanges(acc):
        ms_t = _event_ms(fn)
    return ms, ms_t, acc


def _block_ref(path, sl, dev):
    """The block ``sl`` of the reference array saved at ``path``."""
    a = np.load(path, mmap_mode='r')
    return torch.from_numpy(np.ascontiguousarray(a[sl])).to(dev)


def dist_dns_rank(comm, n, n_pfft, ref):
    """One rank of phase dist's 4 gloo ranks (started by
    ``mpi4py_fft_torch.dryrun.launch``): the dry run's DNS step at n^3
    float64 through the per-shard ``PlanarPFFT``, its block held against
    the one-rank step's (``ref``), a step timed with and without timed
    exchanges; the uneven ``PFFT((n_pfft, n_pfft + 1, n_pfft), 'd',
    a2a_chunks=2)`` round trip and the float64 c2c round trip, timed the
    same way; the launches of the DNS step and the peak memory."""
    from mpi4py_fft_torch import dryrun
    from mpi4py_fft_torch.ops import butterfly as bf
    dev = comm.device
    rng, u0, _ = dryrun._inputs(n, SEED)
    torch.cuda.reset_peak_memory_stats(dev)
    bf.reset_launches()
    pfft, U_hat, out, step = dryrun.dns_step(comm, n, u0)
    torch.cuda.synchronize()
    launches = dict(bf.LAUNCHES)
    del u0
    refb = _block_ref(ref, (slice(None),) + pfft.local_slice(True), dev)
    err, mx = _rel(out, refb)
    finite = bool(torch.isfinite(out).all())
    del refb, out
    ms_step, ms_step_t, ex_step = _timed_with_exchanges(lambda: step(U_hat))
    del U_hat, step
    x = dryrun._inputs(n_pfft, SEED)[2]
    fft, xl, y = dryrun.pfft_round_trip(comm, n_pfft, x)
    err_rt = float((y - xl).abs().max()) if xl.numel() else 0.0
    del y
    ms_rt, ms_rt_t, ex_rt = _timed_with_exchanges(
        lambda: fft.backward.fn_p(fft.forward.fn_p(xl, True), False))
    pds, xz, yz = dryrun.c2c_round_trip(comm, rng)
    err_c2c = float((yz - xz).abs().max()) if xz.numel() else 0.0
    torch.cuda.synchronize()
    return {'rank': comm.Get_rank(), 'backend': comm.backend,
            'device': str(dev), 'grid': list(pfft.subcomm.sizes),
            'block': list(pfft.local_shape(True)), 'rel_l2_vs_one_rank': err,
            'max_abs_vs_one_rank': mx, 'finite': finite,
            'launches': launches, 'ms_per_step': ms_step,
            'ms_per_step_exchanges_timed': ms_step_t,
            'exchange_ms_per_step': sum(ex_step),
            'exchanges_per_step': len(ex_step),
            'pfft_shape': [n_pfft, n_pfft + 1, n_pfft],
            'pfft_executor': fft.executor,
            'pfft_round_trip_max_abs': err_rt,
            'ms_per_round_trip': ms_rt,
            'ms_per_round_trip_exchanges_timed': ms_rt_t,
            'exchange_ms_per_round_trip': sum(ex_rt),
            'c2c_round_trip_max_abs': err_c2c,
            'peak_gb': torch.cuda.max_memory_allocated(dev) / 1e9}


def dist_m3_rank(comm, d, ref_y, ref_z):
    """One rank of phase dist's 2 gloo ranks: the m3 plan
    ``PFFT(comm, (d,)*3, padding=[1.5]*3, dtype='f')`` on a slab grid
    (2, 1) through ``forward.fn_p``/``backward.fn_p`` on this rank's block
    of phase 11's input, held against the one-rank plan's results (the
    files ``ref_y``, ``ref_z``), timed with and without timed exchanges."""
    from mpi4py_fft_torch import PFFT
    from mpi4py_fft_torch.ops import butterfly as bf
    dev = comm.device
    m = 3 * d // 2
    fft = PFFT(comm, (d,) * 3, padding=[1.5] * 3, dtype='f', grid=(2, 1))
    g = torch.Generator(device=dev).manual_seed(SEED + 30 + ord('f'))
    x = torch.rand((m,) * 3, generator=g, device=dev,
                   dtype=torch.float32) - 0.5
    xl = x[fft.local_slice(False)].contiguous()
    del x
    torch.cuda.reset_peak_memory_stats(dev)
    bf.reset_launches()
    y = fft.forward.fn_p(xl)
    torch.cuda.synchronize()
    c1 = dict(bf.LAUNCHES)
    z = fft.backward.fn_p(y)
    torch.cuda.synchronize()
    c2 = dict(bf.LAUNCHES)
    err_y, _ = _rel(y, _block_ref(ref_y, (slice(None),) +
                                  fft.local_slice(True), dev))
    err_z, _ = _rel(z, _block_ref(ref_z, fft.local_slice(False), dev))
    finite = bool(torch.isfinite(y).all()) and bool(torch.isfinite(z).all())
    del z
    ms_f, ms_f_t, ex_f = _timed_with_exchanges(lambda: fft.forward.fn_p(xl))
    ms_b, ms_b_t, ex_b = _timed_with_exchanges(lambda: fft.backward.fn_p(y))
    return {'rank': comm.Get_rank(), 'backend': comm.backend,
            'device': str(dev), 'block_in': list(fft.local_shape(False)),
            'block_out': list(fft.local_shape(True)),
            'executor': fft.executor, 'rel_l2_fwd_vs_one_rank': err_y,
            'rel_l2_bwd_vs_one_rank': err_z, 'finite': finite,
            'launches_fwd': _delta({k: 0 for k in c1}, c1),
            'launches_bwd': _delta(c1, c2), 'fwd_ms': ms_f, 'bwd_ms': ms_b,
            'fwd_ms_exchanges_timed': ms_f_t, 'exchange_ms_fwd': sum(ex_f),
            'bwd_ms_exchanges_timed': ms_b_t, 'exchange_ms_bwd': sum(ex_b),
            'peak_gb': torch.cuda.max_memory_allocated(dev) / 1e9}


def phase_dist(dev, bf):
    """The distributed layer: the dry run on one NCCL rank bit for bit
    against the same calls on no group, then 4 gloo ranks on this card
    (the DNS step at DIST_N^3 float64 held block by block against the
    one-rank step, the uneven PFFT and c2c round trips) and 2 gloo ranks
    (the m3 'f' plan held against the one-rank plan)."""
    from mpi4py_fft_torch import PFFT, dryrun
    from mpi4py_fft_torch.parallel import multihost
    from mpi4py_fft_torch.parallel.comm import COMM_WORLD
    t0 = time.perf_counter()
    n = DIST_N
    refdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          'build', 'dist_ref')
    os.makedirs(refdir, exist_ok=True)
    try:
        # one rank, no group, then one NCCL rank: bit for bit
        rng, u0, x = dryrun._inputs(n, SEED)
        _, _, out0, _ = dryrun.dns_step(None, n, u0)
        _, _, y0 = dryrun.pfft_round_trip(None, n, x)
        _, _, yz0 = dryrun.c2c_round_trip(None, rng)
        multihost.initialize(f'tcp://localhost:{dryrun._free_port()}',
                             world_size=1, rank=0, device=dev)
        try:
            _check(COMM_WORLD.distributed and COMM_WORLD.backend == 'nccl',
                   f"one-rank group on {COMM_WORLD.backend}")
            rng, u0, x = dryrun._inputs(n, SEED)
            _, _, out1, _ = dryrun.dns_step(COMM_WORLD, n, u0)
            _, _, y1 = dryrun.pfft_round_trip(COMM_WORLD, n, x)
            _, _, yz1 = dryrun.c2c_round_trip(COMM_WORLD, rng)
            del u0, x
            same = [bool(torch.equal(a, b)) for a, b in
                    ((out0, out1), (y0, y1), (yz0, yz1))]
            _check(all(same), f"one NCCL rank against no group: {same}")
            del out1, y1, yz1
            one = dryrun.dryrun_multichip(COMM_WORLD, n=n, seed=SEED)
        finally:
            multihost.finalize()
        ref = os.path.join(refdir, 'dns_out.npy')
        np.save(ref, out0.cpu().numpy())
        del out0, y0, yz0
        torch.cuda.empty_cache()
        four = dryrun.launch(4, 'chip_smoke:dist_dns_rank',
                             {'n': n, 'n_pfft': DIST_PFFT_N, 'ref': ref},
                             device='cuda', backend='gloo',
                             timeout=DIST_TIMEOUT)
        os.remove(ref)
        want = {'fft_axis_p_f64', 'rfft_axis_p_f64', 'irfft_axis_p_f64'}
        for r in four:
            _check(r['finite'] and r['rel_l2_vs_one_rank'] <= PIPE_TOL64,
                   f"4 ranks, rank {r['rank']}: DNS step block "
                   f"{r['rel_l2_vs_one_rank']:.3e} against one rank")
            _check(r['pfft_executor'] == 'shard_map'
                   and r['pfft_round_trip_max_abs'] <= 1e-8
                   and r['c2c_round_trip_max_abs'] <= 2e-10,
                   f"4 ranks, rank {r['rank']}: round trips {r}")
            _check(all(r['launches'].get(k, 0) > 0 for k in want),
                   f"4 ranks, rank {r['rank']}: launches {r['launches']}")
        # the m3 'f' plan: one rank, then 2 gloo ranks on a slab grid
        d = DIST_M3_N
        m = 3 * d // 2
        fft = PFFT(None, (d,) * 3, padding=[1.5] * 3, dtype='f')
        g = torch.Generator(device=dev).manual_seed(SEED + 30 + ord('f'))
        xm = torch.rand((m,) * 3, generator=g, device=dev,
                        dtype=torch.float32) - 0.5
        ym = fft.forward.fn_p(xm)
        del xm
        ref_y = os.path.join(refdir, 'm3_y.npy')
        ref_z = os.path.join(refdir, 'm3_z.npy')
        np.save(ref_z, fft.backward.fn_p(ym).cpu().numpy())
        np.save(ref_y, ym.cpu().numpy())
        del ym, fft
        torch.cuda.empty_cache()
        two = dryrun.launch(2, 'chip_smoke:dist_m3_rank',
                            {'d': d, 'ref_y': ref_y, 'ref_z': ref_z},
                            device='cuda', backend='gloo',
                            timeout=DIST_TIMEOUT)
        for r in two:
            _check(r['finite'] and r['executor'] == 'shard_map'
                   and max(r['rel_l2_fwd_vs_one_rank'],
                           r['rel_l2_bwd_vs_one_rank']) <= PIPE_TOL,
                   f"2 ranks, rank {r['rank']}: m3 blocks {r}")
            _check(r['launches_fwd'] == {'rfft_axis_p': 1, 'fft_axis_tp': 2}
                   and r['launches_bwd'] == {'fft_axis_tp': 2,
                                             'irfft_axis_p': 1},
                   f"2 ranks, rank {r['rank']}: launches {r}")
    finally:
        shutil.rmtree(refdir, ignore_errors=True)
    _emit({'phase': 'dist', 'seconds': time.perf_counter() - t0,
           'card': _smi(), 'one_nccl_rank': {
               'n': n, 'bit_for_bit_vs_no_group': True, 'dryrun': one},
           'gloo_4_ranks_dns': four, 'gloo_2_ranks_m3': two,
           'exchanges': 'gloo on CUDA tensors, through host memory, all '
                        'ranks on one card: not an NVLink transpose'})


# -- phase r2r: DCT/DST I-IV, DHT and R2HC/HC2R on B and C ------------------

def _r2r_names():
    from mpi4py_fft_torch.ops import kinds as K
    return {K.FFTW_REDFT00: ('dct', 1), K.FFTW_REDFT10: ('dct', 2),
            K.FFTW_REDFT01: ('dct', 3), K.FFTW_REDFT11: ('dct', 4),
            K.FFTW_RODFT00: ('dst', 1), K.FFTW_RODFT10: ('dst', 2),
            K.FFTW_RODFT01: ('dst', 3), K.FFTW_RODFT11: ('dst', 4),
            K.FFTW_DHT: ('dht', 0)}


def _r2r_ref(x, kind, axis):
    """The float64 host reference of one r2r kind along ``axis`` of the
    numpy array x: scipy's dct/dst (unnormalized, FFTW's), DHT as Re - Im
    of numpy's fft."""
    import scipy.fft
    name, t = _r2r_names()[kind]
    if name == 'dht':
        F = np.fft.fft(x, axis=axis)
        return F.real - F.imag
    return getattr(scipy.fft, name)(x, type=t, axis=axis, workers=-1)


def _r2hc_ref(x, axis):
    """FFTW's halfcomplex layout of numpy's rfft: r0..r_{N/2}, then
    i_{(N+1)//2-1}..i_1."""
    N = x.shape[axis]
    F = np.fft.rfft(x, axis=axis)
    im = np.take(F.imag, np.arange((N + 1) // 2 - 1, 0, -1), axis=axis)
    return np.concatenate([F.real, im], axis=axis)


def _hc2r_ref(h, axis):
    """FFTW's unnormalized HC2R of the halfcomplex host array h: N times
    numpy's irfft of the spectrum it holds (Im 0 at DC and Nyquist)."""
    N = h.shape[axis]
    nh = N // 2 + 1
    re = np.take(h, np.arange(nh), axis=axis)
    im = np.zeros_like(re)
    k = np.arange(1, (N + 1) // 2)
    idx = [slice(None)] * h.ndim
    idx[axis] = k
    im[tuple(idx)] = np.take(h, N - k, axis=axis)
    return np.fft.irfft(re + 1j * im, n=N, axis=axis) * N


def _held_rel(got, ref, tol, what):
    """Relative L2 of ``got`` (on the card) against the float64 host
    array ``ref``; fails above ``tol``."""
    torch.cuda.synchronize()
    _check(bool(torch.isfinite(got).all()), f"{what}: non-finite")
    err, _ = _rel(got.double(), torch.from_numpy(ref).to(got.device))
    _check(err <= tol, f"{what}: rel L2 {err:.3e} > {tol}")
    return err


def _r2r_kinds(dev, bf, holds):
    """Every kind along axis 2 (whole lines: the line kernels) and axis
    1 (the column band) of a (R2R_BATCH, R2R_N, R2R_N) volume at float32 and
    float64, DCT-I at R2R_N + 1 and DST-I at R2R_N - 1 (extended to
    2 R2R_N points) and R2HC then HC2R on the last axis, each held against
    its float64 host reference; every B, C, DCT-II and DCT-III call on the
    way held slab by slab against its plain version.  Returns ms per call
    and launches."""
    from mpi4py_fft_torch.ops import core, kinds as K
    n, b = R2R_N, R2R_BATCH
    g = torch.Generator(device=dev).manual_seed(SEED + 80)
    rows, c0 = [], dict(bf.LAUNCHES)

    def run(x32, kind, axis, ref, label):
        for x, tol in ((x32, PIPE_TOL), (x32.double(), PIPE_TOL64)):
            f = lambda: core.r2r(x, (axis,), (kind,))         # noqa: E731
            with _held_calls(bf, holds, ('rfft_axis_p', 'irfft_axis_p',
                                         'dct2_axis_p', 'dct3_axis_p')):
                c = dict(bf.LAUNCHES)
                y = f()
                torch.cuda.synchronize()
                launches = _delta(c, dict(bf.LAUNCHES))
            err = _held_rel(y, ref, tol, f"{label} {x.dtype}")
            del y
            rows.append({'kind': label, 'shape': list(x.shape),
                         'axis': axis, 'dtype': str(x.dtype)[6:],
                         'rel_l2': err, 'launches': launches,
                         'ms': _median_ms(f, reps=5, warm=1)})
    x32 = torch.rand((b, n, n), generator=g, device=dev) - 0.5
    xh = x32.double().cpu().numpy()
    for kind, (name, t) in _r2r_names().items():
        for axis in (2, 1):
            run(x32, kind, axis, _r2r_ref(xh, kind, axis),
                f"{name}{t or ''}")
    run(x32, K.FFTW_R2HC, 2, _r2hc_ref(xh, 2), 'r2hc')
    hc32 = core.r2r(x32, (2,), (K.FFTW_R2HC,))
    run(hc32, K.FFTW_HC2R, 2, _hc2r_ref(hc32.double().cpu().numpy(), 2),
        'hc2r')
    del x32, hc32, xh
    for kind, m in ((K.FFTW_REDFT00, n + 1), (K.FFTW_RODFT00, n - 1)):
        x32 = torch.rand((b, n, m), generator=g, device=dev) - 0.5
        xh = x32.double().cpu().numpy()
        name, t = _r2r_names()[kind]
        run(x32, kind, 2, _r2r_ref(xh, kind, 2), f"{name}{t} N={m}")
        del x32, xh
    torch.cuda.empty_cache()
    launches = _delta(c0, dict(bf.LAUNCHES))
    for k in ('rfft_axis_p', 'irfft_axis_p', 'rfft_axis_p_f64',
              'irfft_axis_p_f64', 'dct2_axis_p', 'dct3_axis_p',
              'dct2_axis_p_f64', 'dct3_axis_p_f64'):
        _check(launches.get(k, 0) > 0, f"r2r kinds: {k} not launched")
    return rows, launches


def _times_dct(dev, bf, holds):
    """The rows of dct2_axis_p and dct3_axis_p, float32 and float64: a
    (R2R_N,)*3 volume along axis 2 (the line kernels) and axis 1 (the
    column band), each pass held slab by slab against its plain version
    first,
    beside its bound (every value read and written once), its plain
    version and the glue around torch.fft that it replaces (the r2r
    plans' yardstick, ``_lib_r2c_c2r``), and the r2c (DCT-II) or c2r
    (DCT-III) it folds into at the same shape (``packed_ms``: B's or C's
    pass, which moves the same bytes); a row's ms is the two passes', as
    the transforms example's DCT stage runs them.  None for a tree
    without the kernels."""
    if not hasattr(bf, 'dct2_axis_p'):
        return None
    from mpi4py_fft_torch.ops import core
    r2c, c2r = _lib_r2c_c2r()
    lib = {'dct2': lambda x, a: core._dct2_glue(x, a, r2c),
           'dct3': lambda x, a: core._dct3_glue(x, a, c2r)}
    n = R2R_N
    g = torch.Generator(device=dev).manual_seed(SEED + 85)
    out = {}
    for dtype, sfx in ((torch.float32, ''), (torch.float64, '_f64')):
        x = torch.rand((n,) * 3, generator=g, device=dev, dtype=dtype) - 0.5
        nbytes = 2 * x.numel() * x.element_size()
        flops = n * n * 2.5 * n * math.log2(n)
        bound, by = _bound_ms(nbytes, flops, dtype == torch.float64)
        for kind in ('dct2', 'dct3'):
            name = kind + '_axis_p' + sfx
            fn = getattr(bf, kind + '_axis_p')
            plain = getattr(bf, kind + '_axis_plain')
            per = {}
            for axis in (2, 1):
                _nan_block(tuple(x.shape), dtype, dev)
                got = fn(x, axis)
                _slab_hold(holds, name, got, lambda i, w: plain(
                    x.narrow(0, i, w), axis), 0,
                    f"{name} {tuple(x.shape)} axis {axis}")
                del got
                if kind == 'dct2':
                    packed = lambda: bf.rfft_axis_p(x, axis)  # noqa: E731
                else:
                    h = bf.rfft_axis_p(x, axis)
                    packed = lambda: bf.irfft_axis_p(h, axis, n)  # noqa
                per[str(axis)] = {
                    'ms': _median_ms(lambda: fn(x, axis)),
                    'packed_ms': _median_ms(packed),
                    'plain_ms': _median_ms(lambda: plain(x, axis), reps=1,
                                           warm=0),
                    'library_ms': _median_ms(lambda: lib[kind](x, axis),
                                             reps=3, warm=1),
                    'bound_ms': bound}
                h = packed = None
                torch.cuda.empty_cache()
            out[name] = {
                'shape': list(x.shape), 'axes': [2, 1],
                'ms': sum(r['ms'] for r in per.values()),
                'plain_ms': sum(r['plain_ms'] for r in per.values()),
                'library_ms': sum(r['library_ms'] for r in per.values()),
                'bound_ms': 2 * bound, 'bound_by': by, 'per_axis': per}
        del x
        torch.cuda.empty_cache()
    return out


def _ptxas_of(kernel, dtype):
    """Registers and spill bytes of rfft_axis.cu's instance ``kernel``<T,
    1> (T as ``dtype``) as ptxas printed them at the build, or None."""
    import re
    from mpi4py_fft_torch.ops import _build
    tag = f"{len(kernel)}{kernel}I{'d' if dtype == torch.float64 else 'f'}"
    out, cur = {}, ''
    for ln in _build.LOG.get('rfft_axis', '').splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = m.group(1)
        elif tag + 'Li1E' in cur:
            m = re.search(r'Used (\d+) registers', ln)
            if m:
                out['registers'] = int(m.group(1))
            m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill '
                          r'loads', ln)
            if m:
                out['spill_stores'] = int(m.group(1))
                out['spill_loads'] = int(m.group(2))
    return out or None


def _times_real_inner(dev, bf, holds):
    """The rows of the r2c, c2r, DCT-II and DCT-III on the inner-axis
    passes of the r2r cell's plan, float64 and float32: (R2R_N,)*3 along
    axis 0 (the r2c, and the c2r on its spectrum) and axis 1 (the DCTs),
    each pass held slab by slab against its plain version first, with its
    route (``real_route``), ms, bound (every value read and written
    once), reach (``block_copy`` of the same boxes: the real volume seen
    as a planar (2, n/2, n, n) one along the pass's axis), the plain
    version's ms, and the registers and spills of the band instance.
    None for a tree without the band (no ``real_route``)."""
    if not hasattr(bf, 'real_route'):
        return None
    n = R2R_N
    g = torch.Generator(device=dev).manual_seed(SEED + 86)
    flops = n * n * 2.5 * n * math.log2(n)
    out = {}
    for dtype, sfx in ((torch.float64, '_f64'), (torch.float32, '')):
        x = torch.rand((n,) * 3, generator=g, device=dev, dtype=dtype) - 0.5
        h = bf.rfft_axis_p(x, 0)
        reach = {ax: _reach_ms([x.view(2, n // 2, n, n)], ax)
                 for ax in (0, 1)}
        passes = (
            ('rfft_axis_p', 0, lambda: bf.rfft_axis_p(x, 0),
             lambda i, w: bf.rfft_axis_plain(x.narrow(2, i, w), 0), 3,
             h.shape, x.numel() + h.numel()),
            ('irfft_axis_p', 0, lambda: bf.irfft_axis_p(h, 0, n),
             lambda i, w: bf.irfft_axis_plain(h.narrow(3, i, w), 0, n), 2,
             x.shape, x.numel() + h.numel()),
            ('dct2_axis_p', 1, lambda: bf.dct2_axis_p(x, 1),
             lambda i, w: bf.dct2_axis_plain(x.narrow(0, i, w), 1), 0,
             x.shape, 2 * x.numel()),
            ('dct3_axis_p', 1, lambda: bf.dct3_axis_p(x, 1),
             lambda i, w: bf.dct3_axis_plain(x.narrow(0, i, w), 1), 0,
             x.shape, 2 * x.numel()))
        for kind, ax, run, plain, dim, oshape, numel in passes:
            name = kind + sfx
            _nan_block(tuple(oshape), dtype, dev)
            got = run()
            _slab_hold(holds, name, got, plain, dim,
                       f"{name} {tuple(x.shape)} axis {ax}")
            del got
            bound, by = _bound_ms(numel * x.element_size(), flops,
                                  dtype == torch.float64)
            out[name] = {
                'shape': [n] * 3, 'axis': ax,
                'route': bf.real_route((n,) * 3, ax, n, dtype),
                'ms': _median_ms(run), 'bound_ms': bound, 'bound_by': by,
                'reach_ms': reach[ax],
                'plain_ms': _median_ms(lambda: plain(0, n), reps=1,
                                       warm=0),
                'ptxas': _ptxas_of(kind.replace('_axis_p', '_band_kernel'),
                                   dtype)}
            torch.cuda.empty_cache()
        del x, h
        torch.cuda.empty_cache()
    return out


def _lib_r2c_c2r():
    """``rfft_axis_p``/``irfft_axis_p`` as torch.fft (cuFFT) calls, with
    their ``trunc``, ``scale`` and Hermitian pad: the r2r plans'
    yardstick, the same glue around the library's FFT (here only)."""
    from mpi4py_fft_torch.libfft import truncate_planar

    def r2c(x, axis, hext=None, scale=None, trunc=None):
        F = torch.fft.rfft(x, dim=axis)
        p = torch.stack([F.real, F.imag])
        del F
        if trunc is not None:
            p = truncate_planar(p, 1 + axis, int(trunc), hermitian=True)
        return p if scale is None else p * scale

    def c2r(p, axis, n, scale=None):
        y = torch.fft.irfft(torch.complex(p[0], p[1]), n=n, dim=axis,
                            norm='forward')
        return y if scale is None else y * scale
    return r2c, c2r


@contextlib.contextmanager
def _lib_path(bf):
    """Run the port's pipeline with B and C replaced by torch.fft calls
    (``_lib_r2c_c2r``), and the DCT-II and DCT-III kernels by the glue
    around them."""
    from mpi4py_fft_torch.ops import core
    names = [n for n in ('rfft_axis_p', 'irfft_axis_p', 'dct2_axis_p',
                         'dct3_axis_p') if hasattr(bf, n)]
    saved = {n: getattr(bf, n) for n in names}
    r2c, c2r = _lib_r2c_c2r()
    lib = {'rfft_axis_p': r2c, 'irfft_axis_p': c2r,
           'dct2_axis_p': lambda x, a: core._dct2_glue(x, a, r2c),
           'dct3_axis_p': lambda x, a: core._dct3_glue(x, a, c2r)}
    for n in names:
        setattr(bf, n, lib[n])
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(bf, n, f)


def _r2r_input(dev, shape):
    """The r2r plans' input: float32 values from a seed, on the card."""
    g = torch.Generator(device=dev).manual_seed(SEED + 90 + shape[0])
    return torch.rand(shape, generator=g, device=dev) - 0.5


def _r2r_plan_ref(A, plan, nrows):
    """Per slab of 64 rows of axis 1: the plan's forward in float64 on the
    host from ``A``, scipy's dctn(type=3) of the input on axes 1 and 2:
    the rfft on axis 0 cut to ``nrows`` rows, times the plan's
    normalization."""
    import scipy.fft
    M = float(np.prod([o.M for o in plan.xfftn]))
    for j in range(0, A.shape[1], 64):
        F = scipy.fft.rfft(A[:, j:j + 64], axis=0, workers=-1)[:nrows] * M
        yield j, np.stack([F.real, F.imag])


def _r2r_plan(dev, bf, dtype, padded, x32, A, save=None):
    """The transforms example's plan on one rank, explicit axes:
    ``PFFT(None, (R2R_N,)*3, axes=((0,), (1, 2)), transforms={(1, 2):
    (dctn type 3, idctn type 3)})`` (``padding=[1.5, 1, 1]`` for its
    twin) through ``forward.fn_p``/``backward.fn_p`` on ``x32`` (at
    float64 for 'd'): the forward held slab by slab against the float64
    host reference (from ``A``, the input's dctn on the host), the round
    trip (the twin: forward(backward(y)) against y); ms, launches, peak
    memory, ``stage_times`` each way, the bound and the torch.fft
    yardstick.  ``save``: a file for the forward's result."""
    import functools
    from mpi4py_fft_torch import PFFT, fftw
    from mpi4py_fft_torch.utils import profiling
    n = R2R_N
    tol = PIPE_TOL64 if dtype == 'd' else PIPE_TOL
    dct = (functools.partial(fftw.dctn, type=3),
           functools.partial(fftw.idctn, type=3))
    kw = dict(padding=[1.5, 1.0, 1.0]) if padded else {}
    fft = PFFT(None, (n,) * 3, axes=((0,), (1, 2)), dtype=dtype,
               transforms={(1, 2): dct}, **kw)
    m = fft.global_shape(False)[0]
    nh = fft.global_shape(True)[0]
    x = x32.double() if dtype == 'd' else x32
    it = x.element_size()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    c0 = dict(bf.LAUNCHES)
    y = fft.forward.fn_p(x)
    torch.cuda.synchronize()
    c1 = dict(bf.LAUNCHES)
    fwd_peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    held_b = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    z = fft.backward.fn_p(y)
    torch.cuda.synchronize()
    c2 = dict(bf.LAUNCHES)
    bwd_peak = (torch.cuda.max_memory_allocated() - held_b) / 1e9
    what = f"r2r plan '{dtype}'{' padded' if padded else ''}"
    _check(tuple(y.shape) == (2, nh, n, n) and tuple(z.shape) == (m, n, n),
           f"{what}: shapes {tuple(y.shape)}, {tuple(z.shape)}")
    num = den = 0.0
    for j, r in _r2r_plan_ref(A, fft, nh):
        d = (y.narrow(2, j, r.shape[2]).double()
             - torch.from_numpy(r).to(dev))
        num += float((d * d).sum())
        den += float(np.sum(r * r))
    err_y = math.sqrt(num / den)
    if padded:
        err_z, _ = _rel(fft.forward.fn_p(z), y)
    else:
        err_z, _ = _rel(z, x)
    _check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(z).all())
           and max(err_y, err_z) <= tol,
           f"{what}: forward {err_y:.3e}, round trip {err_z:.3e} > {tol}")
    del z
    if save:
        np.save(save, y.cpu().numpy())
    t_f = _median_ms(lambda: fft.forward.fn_p(x), reps=5, warm=1)
    t_b = _median_ms(lambda: fft.backward.fn_p(y), reps=5, warm=1)
    stages = {}
    for d, tr, inp in (('fwd', fft.forward, x), ('bwd', fft.backward, y)):
        st = profiling.stage_times(tr, inp, reps=5)
        stages[d] = {k: v * 1e3 for k, v in st.items()
                     if not k.startswith('_')}
        del st
    c3 = dict(bf.LAUNCHES)
    with _lib_path(bf):
        yl = fft.forward.fn_p(x)
        err_l, _ = _rel(yl, y)
        del yl
        lib_f = _median_ms(lambda: fft.forward.fn_p(x), reps=5, warm=1)
        lib_b = _median_ms(lambda: fft.backward.fn_p(y), reps=5, warm=1)
    _check(dict(bf.LAUNCHES) == c3 and err_l <= tol,
           f"{what}: the torch.fft yardstick launched a kernel or differs "
           f"({err_l:.3e})")
    # each pass reads and writes its tensor once: the two DCT passes on
    # the (m, n, n) real volume, the r2c on axis 0 into (2, nh, n, n)
    nbytes = 2 * 2 * m * n * n * it + m * n * n * it + 2 * nh * n * n * it
    flops = 2 * m * n * 2.5 * n * math.log2(n) + n * n * 2.5 * m * \
        math.log2(m)
    bound, by = _bound_ms(nbytes, flops, dtype == 'd')
    del y
    torch.cuda.empty_cache()
    return {'dtype': dtype, 'padding': kw.get('padding'),
            'shape': [n] * 3, 'physical': [m, n, n],
            'rel_l2_fwd_vs_host': err_y, 'rel_l2_round_trip': err_z,
            'launches_fwd': _delta(c0, c1), 'launches_bwd': _delta(c1, c2),
            'fwd_ms': t_f, 'bwd_ms': t_b, 'bound_ms_each_way': bound,
            'bound_by': by, 'fwd_peak_above_input_gb': fwd_peak,
            'bwd_peak_above_input_gb': bwd_peak, 'stage_times_ms': stages,
            'torch_fft_yardstick': {'fwd_ms': lib_f, 'bwd_ms': lib_b,
                                    'rel_l2_vs_kernels': err_l}}


def r2r_example_rank(comm, n, ref):
    """One rank of phase r2r's 2 gloo ranks (started by
    ``mpi4py_fft_torch.dryrun.launch``): the ported transforms example at
    its own N = 18 and at ``n`` 'd', and the darray example, each with
    what it printed; then the example's collapsed slab plan ``fft`` at
    ``n`` 'd' on this rank's block of the one-rank plan's input, held
    against the one-rank forward (the file ``ref``), its round trip,
    launches and ms (with every exchange timed whole, and without)."""
    import io
    from mpi4py_fft_torch.examples import darray, transforms
    from mpi4py_fft_torch.ops import butterfly as bf
    dev = comm.device
    out = {'rank': comm.Get_rank(), 'backend': comm.backend,
           'device': str(dev)}
    for key, run in (('transforms_18', lambda: transforms.run(comm)),
                     (f'transforms_{n}',
                      lambda: transforms.run(comm, N=n, dtype='d')),
                     ('darray', lambda: darray.run(comm))):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = run()
        out[key] = {'message': res['message'], 'printed': buf.getvalue(),
                    'seconds': time.perf_counter() - t0}
    fft = transforms.plans(comm, n, 'd')[0]
    xl = _r2r_input(dev, (n,) * 3).double()[fft.local_slice(False)]
    xl = xl.contiguous()
    torch.cuda.empty_cache()
    bf.reset_launches()
    y = fft.forward.fn_p(xl)
    torch.cuda.synchronize()
    c1 = dict(bf.LAUNCHES)
    z = fft.backward.fn_p(y)
    torch.cuda.synchronize()
    c2 = dict(bf.LAUNCHES)
    refb = _block_ref(ref, (slice(None),) + fft.local_slice(True), dev)
    err_y, mx_y = _rel(y, refb)
    del refb
    err_z, _ = _rel(z, xl)
    finite = bool(torch.isfinite(y).all()) and bool(torch.isfinite(z).all())
    del z
    ms_f, ms_f_t, ex_f = _timed_with_exchanges(lambda: fft.forward.fn_p(xl))
    ms_b, ms_b_t, ex_b = _timed_with_exchanges(lambda: fft.backward.fn_p(y))
    out.update({
        'axes': [list(a) for a in fft.axes], 'executor': fft.executor,
        'block_in': [int(v) for v in fft.local_shape(False)],
        'block_out': [int(v) for v in fft.local_shape(True)],
        'rel_l2_fwd_vs_one_rank': err_y, 'max_abs_fwd_vs_one_rank': mx_y,
        'rel_l2_round_trip': err_z, 'finite': finite,
        'launches_fwd': _delta({k: 0 for k in c1}, c1),
        'launches_bwd': _delta(c1, c2), 'fwd_ms': ms_f, 'bwd_ms': ms_b,
        'fwd_ms_exchanges_timed': ms_f_t, 'exchange_ms_fwd': sum(ex_f),
        'bwd_ms_exchanges_timed': ms_b_t, 'exchange_ms_bwd': sum(ex_b),
        'peak_gb': torch.cuda.max_memory_allocated(dev) / 1e9})
    return out


def phase_r2r(dev, bf, holds):
    """r2r on the card: every kind on the kernels (``_r2r_kinds``), the
    DCT-II and DCT-III kernels' rows (``_times_dct``), the real kernels'
    inner-axis rows (``_times_real_inner``), the transforms example's
    plans on one rank at R2R_N^3 'd' and 'f', plain and padded
    (``_r2r_plan``), then the ported transforms and darray examples on 2
    gloo ranks, each rank's block of the example's plan against the
    one-rank forward.  Returns the DCT kernels' rows and the inner-axis
    rows."""
    import scipy.fft
    from mpi4py_fft_torch import dryrun
    t0 = time.perf_counter()
    kinds, kind_launches = _r2r_kinds(dev, bf, holds)
    dct = _times_dct(dev, bf, holds)
    inner = _times_real_inner(dev, bf, holds)
    n = R2R_N
    refdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          'build', 'r2r_ref')
    os.makedirs(refdir, exist_ok=True)
    plans = []
    try:
        ref = os.path.join(refdir, 'fwd_d.npy')
        for padded in (False, True):
            x32 = _r2r_input(dev, (3 * n // 2 if padded else n, n, n))
            A = scipy.fft.dctn(x32.double().cpu().numpy(), type=3,
                               axes=(1, 2), workers=-1)
            for dtype in ('d', 'f'):
                plans.append(_r2r_plan(
                    dev, bf, dtype, padded, x32, A,
                    save=ref if dtype == 'd' and not padded else None))
            del x32, A
            torch.cuda.empty_cache()
        two = dryrun.launch(2, 'chip_smoke:r2r_example_rank',
                            {'n': n, 'ref': ref}, device='cuda',
                            backend='gloo', timeout=DIST_TIMEOUT)
    finally:
        shutil.rmtree(refdir, ignore_errors=True)
    for r in two:
        for key in ('transforms_18', f'transforms_{n}', 'darray'):
            msg = r[key]['message']
            _check(msg.endswith('demo OK') and r[key]['printed'] ==
                   (msg + '\n' if r['rank'] == 0 else ''),
                   f"2 ranks, rank {r['rank']}: {key} {r[key]}")
        _check(r['finite'] and r['executor'] == 'shard_map'
               and r['axes'] == [[0], [1, 2]]
               and max(r['rel_l2_fwd_vs_one_rank'],
                       r['rel_l2_round_trip']) <= PIPE_TOL64,
               f"2 ranks, rank {r['rank']}: the example's plan {r}")
        _check(r['launches_fwd'].get('rfft_axis_p_f64', 0) > 0
               and r['launches_bwd'].get('irfft_axis_p_f64', 0) > 0,
               f"2 ranks, rank {r['rank']}: launches {r}")
    _emit({'phase': 'r2r', 'seconds': time.perf_counter() - t0,
           'card': _smi(), 'kinds': kinds, 'kinds_launches': kind_launches,
           'dct_kernels': dct, 'real_inner': inner, 'plans': plans,
           'gloo_2_ranks_examples': two,
           'exchanges': 'gloo on CUDA tensors, through host memory, both '
                        'ranks on one card'})
    return dct, inner


def phase_times_r2r(dev, bf, holds):
    """The DCT kernels' rows and the transforms example's R2R_N^3 'd'
    plan alone (for --times-r2r)."""
    import scipy.fft
    dct = _times_dct(dev, bf, holds)
    inner = _times_real_inner(dev, bf, holds)
    x32 = _r2r_input(dev, (R2R_N,) * 3)
    A = scipy.fft.dctn(x32.double().cpu().numpy(), type=3, axes=(1, 2),
                       workers=-1)
    plan = _r2r_plan(dev, bf, 'd', False, x32, A)
    _emit({'phase': 'times_r2r', 'card': _smi(), 'dct_kernels': dct,
           'real_inner': inner, 'plan': plan})


# -- phase io: snapshot IO and the host-staging engine ---------------------

def _io_input(dev, n):
    """Phase io's real n^3 float64 field, made from the seed on the card
    (every rank makes the same one and takes its block)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 27)
    return torch.rand((n,) * 3, generator=g, device=dev,
                      dtype=torch.float64)


def _io_rate(fn, nbytes):
    """ms of fn on the host clock, the card synchronised before and after
    (so a write's device -> host copy and a read's host -> device copy
    count), and GB/s of ``nbytes``, the bytes of the arrays it writes or
    reads."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    return {'ms': 1e3 * s, 'gb_s': nbytes / s / 1e9, 'bytes': nbytes}


def _other(alignment):
    """An alignment other than ``alignment`` for a read back."""
    return 0 if alignment != 0 else 1


def _io_nbytes(u):
    return math.prod(u.global_shape) * u.dtype.itemsize


def _io_writes(f, u):
    """Phase io's writes of ``u`` to the snapshot file ``f``: step 0 with
    the global slice IO_SLICE, then step 1."""
    nb = _io_nbytes(u)
    return {'write_step0_with_slice': _io_rate(
                lambda: f.write(0, {'u': [u, (u, IO_SLICE)]}),
                nb + nb // u.global_shape[1]),
            'write_step1': _io_rate(lambda: f.write(1, {'u': [u]}), nb)}


def _io_read(path, u, alignment, name='u', step=1, ref=None):
    """Read ``name`` at ``step`` into a DistArray like ``u`` under
    ``alignment``; ms and GB/s, and the read block held bit for bit
    against ``ref`` (u's block by default)."""
    from mpi4py_fft_torch import DistArray
    v = DistArray(u.global_shape, dtype=u.dtype, alignment=alignment,
                  device=u.device)
    out = _io_rate(lambda: v.read(path, name, step=step), _io_nbytes(u))
    want = u.v if ref is None else ref[v.local_slice()]
    _check(torch.equal(v.v, want),
           f"{os.path.basename(path)}: {name} at step {step} read back "
           f"under alignment {alignment} differs")
    return out


def _io_files(path):
    """A snapshot file and its sidecars, with their sizes in bytes."""
    import glob
    return {os.path.basename(p): os.path.getsize(p)
            for p in [path] + sorted(glob.glob(path + '.p*.h5'))}


def _io_remove(path):
    for name in _io_files(path):
        os.remove(os.path.join(os.path.dirname(path), name))


def _same_bytes(a, b, chunk=1 << 26):
    with open(a, 'rb') as fa, open(b, 'rb') as fb:
        while True:
            x, y = fa.read(chunk), fb.read(chunk)
            if x != y:
                return False
            if not x:
                return True


def _io_dsets_equal(a, b):
    """The datasets of phase io's writes in two HDF5 files, byte for
    byte."""
    import h5py
    names = ('u/3D/0', 'u/3D/1',
             f'u/2D/slice_{IO_SLICE[1]}_slice/0')
    with h5py.File(a, 'r') as fa, h5py.File(b, 'r') as fb:
        return all(fa[k].shape == fb[k].shape and fa[k].dtype == fb[k].dtype
                   and fa[k][()].tobytes() == fb[k][()].tobytes()
                   for k in names)


def _io_native(n):
    """``pack_block`` and ``unpack_block`` of half of an n^3 float64 host
    array (rank 0's block of 2 on axis 1: runs of n doubles), each beside
    the numpy slice copy, median of 3 on the host clock: GB/s of the
    block's bytes; the packed and unpacked bits held against numpy's."""
    from mpi4py_fft_torch.utils import native
    full = native.aligned_native((n,) * 3, dtype='d')
    full.reshape(-1)[:] = np.arange(full.size, dtype='d')
    starts, sizes = (0, n // 4, 0), (n, n // 2, n)
    sl = tuple(slice(s, s + c) for s, c in zip(starts, sizes))
    packed = native.aligned_native(sizes, dtype='d')
    ref = np.empty(sizes)
    back = np.zeros_like(full)

    def gb_s(fn):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return packed.nbytes / statistics.median(ts) / 1e9
    out = {'block': list(sizes), 'bytes': packed.nbytes,
           'pack_gb_s': gb_s(lambda: native.pack_block(full, starts, sizes,
                                                       out=packed)),
           'numpy_pack_gb_s': gb_s(lambda: np.copyto(ref, full[sl]))}
    _check(packed.tobytes() == ref.tobytes(),
           "pack_block against the numpy slice copy")
    out['unpack_gb_s'] = gb_s(
        lambda: native.unpack_block(back, starts, sizes, packed))
    _check(back[sl].tobytes() == ref.tobytes() and not back[:, :n // 4].any(),
           "unpack_block against the numpy slice copy")
    out['numpy_unpack_gb_s'] = gb_s(lambda: back.__setitem__(sl, ref))
    return out


def _io_h5_one(d, u, u_hat, other):
    """One rank: u at steps 0 and 1 with the slice, and u_hat, to one
    HDF5 file, ``generate_xdmf``, then both read back under another
    alignment."""
    from mpi4py_fft_torch import HDF5File, generate_xdmf
    path = os.path.join(d, 'one.h5')
    f = HDF5File(path, mode='w')
    out = _io_writes(f, u)
    out['write_u_hat'] = _io_rate(lambda: f.write(0, {'u_hat': [u_hat]}),
                                  _io_nbytes(u_hat))
    t0 = time.perf_counter()
    generate_xdmf(path)
    out['xdmf_ms'] = 1e3 * (time.perf_counter() - t0)
    _check(os.path.exists(os.path.join(d, 'one.xdmf')) and os.path.exists(
        os.path.join(d, f'one_slice_{IO_SLICE[1]}_slice.xdmf')),
        "generate_xdmf wrote no XDMF file")
    out['read_step1'] = _io_read(path, u, other)
    out['read_u_hat'] = _io_read(path, u_hat, _other(u_hat.alignment),
                                 name='u_hat', step=0)
    out['files'] = _io_files(path)
    return out, path


def _io_nc_one(d, u, other):
    """One rank: u at steps 0 and 1 with the slice to NetCDF, then read
    back under another alignment."""
    from mpi4py_fft_torch import NCFile
    path = os.path.join(d, 'one.nc')
    out = _io_writes(NCFile(path, mode='w'), u)
    out['read_step1'] = _io_read(path, u, other)
    out['files'] = _io_files(path)
    return out, path


def io_rank(comm, n, out, alignment, other, h5):
    """One rank of phase io's 2 gloo ranks (started by
    ``mpi4py_fft_torch.dryrun.launch``): this rank's block of the
    one-rank phase's field written as there, to HDF5 in ``vds``,
    ``serial`` and ``repack`` modes (where ``h5``) and to NetCDF in
    turns, then each file read back under the other alignment; ms and
    GB/s of each call on this rank (a collective write's time, turns and
    barriers included), the blocks held bit for bit."""
    import scipy.io  # noqa: F401  (imported before the timed writes)
    from mpi4py_fft_torch import DistArray, HDF5File, NCFile
    dev = comm.device
    x = _io_input(dev, n)
    u = DistArray((n,) * 3, dtype='d', alignment=alignment, device=dev)
    u.v.copy_(x[u.local_slice()])
    res = {'rank': comm.Get_rank(), 'backend': comm.backend,
           'device': str(dev),
           'block': [[s.start, s.stop] for s in u.local_slice()]}
    files = {}
    modes = (('vds', 'vds', False), ('serial', 'serial', False),
             ('repack', 'vds', True)) if h5 else ()
    try:
        for name, mode, repack in modes:
            os.environ['MPI4PY_FFT_TORCH_H5_MODE'] = mode
            files[name] = os.path.join(out, f'two_{name}.h5')
            res[name] = _io_writes(
                HDF5File(files[name], mode='w', repack=repack), u)
    finally:
        os.environ.pop('MPI4PY_FFT_TORCH_H5_MODE', None)
    files['netcdf'] = os.path.join(out, 'two.nc')
    res['netcdf'] = _io_writes(NCFile(files['netcdf'], mode='w'), u)
    for name, path in files.items():
        res[name]['read_step1'] = _io_read(path, u, other, ref=x)
    res['files'] = files
    return res


def phase_io(dev, bf):
    """Snapshot IO on the card (``mpi4py_fft_torch/io/``) and the host
    staging of ``utils/native.py``: pack/unpack rates; one rank writing a
    512^3 'd' PFFT's input and spectrum and reading them back; 2 gloo
    ranks writing the input in every mode, their files held against the
    one-rank files and read back on 2 ranks and on one."""
    import tempfile
    from mpi4py_fft_torch import PFFT, dryrun, newDistArray
    from mpi4py_fft_torch.utils import native
    t0 = time.perf_counter()
    _check(native.HAVE_NATIVE, "utils.native: no host-staging extension")
    n = IO_N
    rates = _io_native(n)
    try:
        import h5py  # noqa: F401
        h5 = True
    except ImportError:
        h5 = False
    fft = PFFT(None, (n,) * 3, dtype='d')
    u = newDistArray(fft, False)
    u.v.copy_(_io_input(dev, n))
    c0 = dict(bf.LAUNCHES)
    u_hat = fft.forward(u)
    back = fft.backward(u_hat)
    torch.cuda.synchronize()
    launches = _delta(c0, dict(bf.LAUNCHES))
    rt, _ = _rel(back.v, u.v)
    del back
    _check(rt <= PIPE_TOL64 and bool(torch.isfinite(u_hat.v).all()),
           f"PFFT {n}^3 'd' round trip {rt:.3e}")
    _check(all(launches.get(k, 0) > 0 for k in (
        'rfft_axis_p_f64', 'fft_axis_p_f64', 'irfft_axis_p_f64')),
        f"PFFT {n}^3 'd': launches {launches}")
    other = _other(u.alignment)
    d = tempfile.mkdtemp()
    try:
        free_gb = shutil.disk_usage(d).free / 1e9
        one = {}
        if h5:
            one['hdf5'], one_h5 = _io_h5_one(d, u, u_hat, other)
        else:
            one['hdf5'] = 'not run: h5py is not installed here'
        del u_hat
        one['netcdf'], one_nc = _io_nc_one(d, u, other)
        torch.cuda.empty_cache()
        two = dryrun.launch(2, 'chip_smoke:io_rank',
                            {'n': n, 'out': d, 'alignment': u.alignment,
                             'other': other, 'h5': h5},
                            device='cuda', backend='gloo',
                            timeout=DIST_TIMEOUT)
        files = two[0]['files']
        _check(all(r['files'] == files for r in two), "ranks' files differ")
        same = {'netcdf': _same_bytes(files['netcdf'], one_nc)}
        for name in ('vds', 'serial', 'repack') if h5 else ():
            same[name] = _io_dsets_equal(files[name], one_h5)
        if h5:
            _check(list(_io_files(files['repack'])) == ['two_repack.h5'],
                   "a sidecar survived the repack write")
        _check(all(same.values()), f"2 ranks against one rank: {same}")
        reads = {name: _io_read(path, u, other)
                 for name, path in files.items()}
        sizes = {name: _io_files(path) for name, path in files.items()}
        for path in list(files.values()) + ([one_h5] if h5 else []) + \
                [one_nc]:
            _io_remove(path)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    del u, fft
    torch.cuda.empty_cache()
    _emit({'phase': 'io', 'seconds': time.perf_counter() - t0,
           'card': _smi(), 'have_native': native.HAVE_NATIVE,
           'native': rates, 'shape': [n] * 3, 'dtype': 'd',
           'netcdf_n': n, 'launches': launches, 'round_trip_rel_l2': rt,
           'disk_free_gb_before': free_gb, 'one_rank': one,
           'gloo_2_ranks': two, 'same_as_one_rank': same,
           'read_on_one_rank': reads, 'two_rank_files': sizes,
           'rates': 'GB/s of the arrays each call writes or reads, the '
                    'device <-> host copy included; the page cache is not '
                    'flushed, so a read may come from memory'})


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
    a64 = [_axis_pass(bf, holds, p, 1, 'band, single elements'),
           _axis_pass(bf, holds, p, 0, 'band, vectors')]
    del p
    torch.cuda.empty_cache()
    w768 = _axis64_w768(dev, bf, holds, g)
    _, w1024 = _holds_volume64(dev, bf, holds)
    _emit({'phase': 'times_d_a64', 'kernels': {
        'fft_axis2_p': d, 'fft_axis_p_f64': {'dns': a64, 'w768': w768,
                                             'w1024': w1024}}})


def _times_c64_dns(dev, bf, holds, check_numpy=True):
    """C64's rows (``_times_c64``) on the spectrum of a random 512^3
    float64 volume (the DNS's last axis) and at the dealiased solvers'
    spectrum."""
    n = DNS_N
    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    r = torch.rand((n, n, n), generator=g, device=dev,
                   dtype=torch.float64) - 0.5
    h = bf.rfft_axis_p(r, 2)
    del r
    c64 = _times_c64(dev, bf, holds, h, g, check_numpy)
    del h
    torch.cuda.empty_cache()
    return c64


def phase_times_a_c64(dev, bf, holds):
    """A's and C64's rows of phases 16 and 17 alone (for --times-any):
    A at the north-star volume's three passes, a quarter's mid pass and
    the dealiased 'f' plan's 768-point passes; C64 at the 512^3 DNS's
    last axis and at the dealiased solvers' (2, 768, 768, 257) spectrum,
    each held first."""
    x = _rand((2,) + (NORTH_N,) * 3, dev, SEED + 2)
    a = _times_a(dev, bf, holds, x)
    del x
    torch.cuda.empty_cache()
    c64 = _times_c64_dns(dev, bf, holds)
    _emit({'phase': 'times_a_c64', 'kernels': {'fft_axis_p': a,
                                               'irfft_axis_p_f64': c64}})


def phase_times_c2r(dev, bf, holds):
    """C's and C64's rows alone (for --times-c2r): B's 768^3 row and C on
    its spectrum, then C64's two rows, each held against its plain
    version first; the holds against numpy on random spectra are reported
    in each row's ``numpy_hold`` and not checked, so that a tree whose c2r
    keeps the imaginary DC and Nyquist parts runs to the end."""
    b, c = _times_b_c(dev, bf, holds, check_numpy=False)
    c64 = _times_c64_dns(dev, bf, holds, check_numpy=False)
    _emit({'phase': 'times_c2r', 'kernels': {'rfft_axis_p': b,
                                             'irfft_axis_p': c,
                                             'irfft_axis_p_f64': c64}})


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


def _move_route_want(x, axis, kind, shift):
    """The route ``move`` should take on ``x`` into a new tensor at the
    shapes ``_holds_probes`` gives it (lines short enough to stage)."""
    axis = axis % x.dim()
    N, Q = x.shape[axis], math.prod(x.shape[axis + 1:])
    if x.data_ptr() % 16:
        return 'scalar'
    if Q > 1:
        return 'rows' if Q % 4 == 0 else 'scalar'
    return 'lines' if kind in ('even', 'odd') else 'lines_shared'


def _holds_moves(dev, tp, routes):
    """``move`` bit for bit against ``move_plain``: the script's nine
    spellings, then every kind on each route at B's reads, each route
    checked against ``_move_route_want`` and kept in ``routes``; returns
    the number of cases."""
    cases = 0
    from mpi4py_fft_torch.probes import moves
    x = torch.arange(64 * 8 * 128, dtype=torch.float32,
                     device=dev).reshape(64, 8, 128)
    for tag, m in moves.MOVES.items():
        ref = tp.move_plain(x, *m)
        _exact(tp.move(x, *m, out=_nan(ref)), ref, f"move {tag}")
        cases += 1
    # every kind on each route: the last axis of m^3 (lines, in registers
    # for even and odd, staged for reverse and roll), of a 772-point last axis
    # (N % 8 == 4) and the lead axis (rows); a view 4 bytes off alignment
    # (scalar)
    m = 3 * DEALIAS_N // 2
    base = _rand((m * m * (m + 4) + 1,), dev, SEED + 82)
    for label, x in ((f'{m}^3', base[:m ** 3].view(m, m, m)),
                     (f'({m}, {m}, {m + 4})',
                      base[:m * m * (m + 4)].view(m, m, m + 4)),
                     (f'{m}^3 off alignment',
                      base[1:m ** 3 + 1].view(m, m, m))):
        for axis in (0, 2):
            for kind, shift in (('even', 0), ('odd', 0), ('reverse', 0),
                                ('roll', 1), ('roll', 4), ('roll', m - 5)):
                ref = tp.move_plain(x, axis, kind, shift)
                y = _nan(ref)
                what = f"move {kind} {shift} axis {axis} of {label}"
                route = tp.move_route(x, axis, kind, shift, out=y)
                want = _move_route_want(x, axis, kind, shift)
                routes[what] = route
                _check(route == want, f"{what}: route {route}, not {want}")
                _exact(tp.move(x, axis, kind, shift, out=y), ref, what)
                del ref, y
                cases += 1
    del x, base
    return cases


def _holds_probes(holds, dev, tp, routes):
    """Every probe kernel against its plain version, each case's route
    (``block_copy``'s vectors on every blocking, its scalar route on a
    misaligned view and 2-float runs; ``move``'s by ``_move_route_want``;
    ``bfly``'s by A's rule) checked and
    kept in ``routes``; returns the number of cases."""
    cases = 0
    for n in (PROBE_N // 4, PROBE_N):           # the scripts' 256 and 1024
        x = _rand((2,) + (n,) * 3, dev, SEED + 80)
        x2 = _rand((2,) + (n,) * 3, dev, SEED + 81)
        for label, shape, box, order, pair in _copy_cases(n):
            a = x.view(-1)[:math.prod(shape)].view(shape)
            ra = tp.block_copy_plain(a)
            what = f"block_copy {label} n={n}"
            b = x2.view(-1)[:math.prod(shape)].view(shape) if pair else None
            route = tp.block_copy_route(a, box, order, x2=b)
            routes[f"{label} n={n}"] = route
            _check(route == 'vector', f"{what}: route {route}, not vector")
            if pair:
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
    # the scalar route: a view 4 bytes off alignment, and 2-float runs
    x = _rand((2 * 64 * 256 * 256 + 1,), dev, SEED + 80)
    for label, v, box in (
            ('misaligned planes', x[1:].view(2, 64, 256, 256),
             (2, 1, 256, 256)),
            ('2-float runs', x[:-1].view(2, 64, 256 * 128, 2),
             (2, 64, 1, 2))):
        route = tp.block_copy_route(v, box)
        routes[label] = route
        _check(route == 'scalar', f"block_copy {label}: route {route}")
        _exact(tp.block_copy(v, box, out=_nan(v)), v, f"block_copy {label}")
        cases += 1
    del x
    cases += _holds_moves(dev, tp, routes)
    # bfly: every mode at lead, mid and last positions, reps, fewer lines a
    # tile than A's; at 512, 768 and 1024 on A's line and band kernels
    # (the band with vectors and, at post 9, single elements)
    g = torch.Generator(device=dev).manual_seed(SEED + 83)
    for N in (16, 64, 256, 512, 768, 1024):
        for shape, ax in (((N, 24, 40), 0), ((6, N, 40), 1), ((50, N), 1),
                          ((5, N, 9), 1)):
            p = torch.randn((2,) + shape, generator=g, device=dev)
            route = tp.bfly_route(p, ax)
            routes[f"bfly {shape} axis {ax}"] = route
            _check(route == ('tile' if N < 512 else 'lines' if ax == len(
                shape) - 1 else 'band'), f"bfly {shape}: route {route}")
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
    # in place against out of place on the full probe volume: lead and mid
    # (the band), last (the line kernel)
    n = PROBE_N
    x = _rand((2,) + (n,) * 3, dev, SEED + 84)
    for ax, mode, reps in ((0, 'full', 1), (0, 'full', 2), (0, 'adds', 1),
                           (0, 'moves', 1), (0, 'copy', 1), (1, 'full', 1),
                           (2, 'full', 1), (2, 'adds', 2)):
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


def _reach_patterns(dev):
    """(label, tensors, axis) of every access pattern ``_reach_ms`` times
    in this script, at the main path's shapes: A's three 1024^3 passes,
    the 'f' plan's 768-point mid (post 257, whole rows) and lead passes,
    D's quartered lead pair, A64's 512^3 DNS mid (post 257 doubles) and
    lead passes."""
    n = PROBE_N
    q = _rand((2, n // 2, n, n // 2), dev, SEED + 91)
    d = _rand((2, DNS_N, DNS_N, DNS_N // 2 + 1), dev, SEED + 92).double()
    m = 3 * DEALIAS_N // 2
    big = _rand((2, n, n, n), dev, SEED + 90)
    return ((f'lead (2, A, 128), {n}^3', (big,), 0),
            (f'mid (2, 8, B, 128), {n}^3', (big,), 1),
            (f'last (2, 1, B, C), {n}^3', (big,), 2),
            (f'mid, odd post (2, 1, B, C), (2, {m}, {m}, 257)',
             (_rand((2, m, m, 257), dev, SEED + 93),), 1),
            (f'lead (2, A, 128), (2, {m}, {2 * m // 3}, 257)',
             (_rand((2, m, 2 * m // 3, 257), dev, SEED + 94),), 0),
            (f'lead pair (2, A, 128) x2, (2, {n // 2}, {n}, {n // 2}) '
             f'halves', (q, q.clone()), 0),
            (f'mid, odd post, f64 (2, {DNS_N}, {DNS_N}, '
             f'{DNS_N // 2 + 1})', (d,), 1),
            (f'lead, f64 (2, {DNS_N}, {DNS_N}, {DNS_N // 2 + 1})', (d,), 0))


def _reach_times(dev, tp):
    """``block_copy`` on every pattern of ``_reach_patterns`` beside
    ``copy_`` of the same tensors, each copy held bit for bit first: its
    route, ms, copy_ ms and their ratio."""
    out = []
    for label, xs, ax in _reach_patterns(dev):
        vs, box = _reach_box(xs, ax)
        ys = [_nan(v) for v in vs]
        pair = {} if len(vs) == 1 else {'x2': vs[1], 'out2': ys[1]}
        tp.block_copy(vs[0], box, out=ys[0], **pair)
        for v, y in zip(vs, ys):
            _exact(y, v, f"block_copy {label}")
        ms = _median_ms(lambda: tp.block_copy(vs[0], box, out=ys[0],
                                              **pair))
        copy_ms = _median_ms(lambda: [y.copy_(v) for v, y in zip(vs, ys)])
        out.append({'pattern': label, 'shape': list(vs[0].shape),
                    'box': list(box), 'streams': len(vs),
                    'path': _copy_route(tp, vs[0], box, **pair), 'ms': ms,
                    'copy_ms': copy_ms, 'ratio': ms / copy_ms})
        del xs, vs, ys, pair
        torch.cuda.empty_cache()
    return out


def _bfly_modes(tp, x, x0, ax, lines=None):
    """ms of each bfly mode along ``ax`` in place on ``x`` (reset from
    ``x0`` before each), each held first out of place on a slab against
    bfly_plain."""
    ms = {}
    for mode in tp.MODES:
        y = tp.bfly(x0, ax, mode, lines=lines, out=_nan(x0))
        sl = (slice(None),) * (ax + 2) + (slice(0, 4),)
        ref = tp.bfly_plain(x0[sl].contiguous(), ax, mode)
        if mode in ('copy', 'moves'):
            _exact(y[sl], ref, f"bfly {mode} axis {ax} lines={lines}")
        else:
            r, _ = _rel(y[sl], ref)
            _check(r <= KERNEL_TOL, f"bfly {mode} axis {ax} lines={lines}: "
                                    f"rel L2 {r:.3e}")
        del y, ref
        x.copy_(x0)
        ms[mode] = _median_ms(lambda: tp.bfly(x, ax, mode, lines=lines,
                                              out=x))
    return ms


def _move_times(dev, tp):
    """``move`` on every kind (roll by 1 and by 4) along the last and
    the lead axis of a (1.5 DEALIAS_N)^3 float32 volume, out of place, each
    held first: ms beside its plain version, its PyTorch call (``copy_``
    of the strided view, ``torch.flip``, ``torch.roll``), its route and
    its bound from ``move_bytes`` (null where the tree lacks
    ``move_route`` or ``move_bytes``).  The first row (even on the last
    axis, B's deinterleaved reads) is the kernels line's."""
    m = 3 * DEALIAS_N // 2
    r = _rand((m, m, m), dev, SEED + 87)
    route = getattr(tp, 'move_route', None)
    nbytes = getattr(tp, 'move_bytes', None)
    rows = []
    for axis in (2, 0):
        for kind, shift in (('even', 0), ('odd', 0), ('reverse', 0),
                            ('roll', 1), ('roll', 4)):
            y = tp.move(r, axis, kind, shift)
            what = f"move {kind} {shift} axis {axis} of {m}^3"
            _exact(y, tp.move_plain(r, axis, kind, shift), what)
            if kind in ('even', 'odd'):
                sl = [slice(None)] * 3
                sl[axis] = slice(kind == 'odd', None, 2)
                view = r[tuple(sl)]
                lib, lib_name = (lambda: y.copy_(view)), \
                    'copy_ of the strided view'
            elif kind == 'reverse':
                lib, lib_name = (lambda: torch.flip(r, (axis,))), \
                    'torch.flip'
            else:
                lib, lib_name = (lambda: torch.roll(r, shift, axis)), \
                    'torch.roll'
            b = nbytes(r, axis, kind) if nbytes else None
            bound, by = _bound_ms(b, 0) if b else (None, None)
            rows.append({
                'axis': axis, 'kind': kind, 'shift': shift,
                'route': route(r, axis, kind, shift, out=y) if route
                else None,
                'ms': _median_ms(lambda: tp.move(r, axis, kind, shift,
                                                 out=y), reps=11),
                'plain_ms': _median_ms(
                    lambda: tp.move_plain(r, axis, kind, shift), reps=11),
                'library_ms': _median_ms(lib, reps=11), 'library': lib_name,
                'bytes': b, 'bound_ms': bound, 'bound_by': by})
            del y, lib
            torch.cuda.empty_cache()
    del r
    first = rows[0]
    return {'shape': f'({m}, {m}, {m}) f32 -> ({m}, {m}, {m // 2}), the '
                     f'even points of the last axis (B\'s deinterleaved '
                     f'reads); rows: every kind along the last (2) and lead '
                     f'(0) axes',
            'path': first['route'], 'ms': first['ms'],
            'plain_ms': first['plain_ms'],
            'library_ms': first['library_ms'],
            'bound_ms': first['bound_ms'], 'bound_by': first['bound_by'],
            'rows': rows}


def _probe_times(dev, tp):
    """Each probe kernel at one shape of its probes: ms beside its plain
    version, its bound and its PyTorch yardstick (None where no one call
    computes the function), and its path (block_copy's, move's and bfly's
    route); move's kinds on the last and lead axes (``_move_times``);
    bfly's modes on the 1024^3 lead and mid passes (A's band) beside the
    same modes on A's tile of ``tile_lines(1024)`` lines and A's own
    passes, and block_copy on every ``_reach_ms`` pattern beside
    ``copy_``."""
    from mpi4py_fft_torch.ops import butterfly as bf
    from mpi4py_fft_torch.probes import vpu_peak
    out = {}
    n = PROBE_N
    x = _rand((2,) + (n,) * 3, dev, SEED + 86)
    y = torch.empty_like(x)
    box = (2, 1, n, n)
    b, by = _bound_ms(2 * x.numel() * 4, 0)
    out['block_copy'] = {
        'shape': f'(2, {n}, {n}, {n}) f32 out of place in (2, 1, {n}, {n}) '
                 f'boxes (the plane copy floor); reach_patterns: every '
                 f'_reach_ms pattern beside copy_',
        'path': _copy_route(tp, x, box, out=y),
        'ms': _median_ms(lambda: tp.block_copy(x, box, out=y)),
        'plain_ms': _median_ms(lambda: tp.block_copy_plain(x)),
        'library_ms': _median_ms(lambda: y.copy_(x)),
        'bound_ms': b, 'bound_by': by}
    del y
    torch.cuda.empty_cache()
    # bfly in place: the lead and mid passes, x reset from x0 before each
    x0 = x
    x = x0.clone()
    route = getattr(tp, 'bfly_route', lambda *a, **k: 'not reported')
    modes = _bfly_modes(tp, x, x0, 0)
    mid = _bfly_modes(tp, x, x0, 1)
    tile = _bfly_modes(tp, x, x0, 0, tp.tile_lines(n))
    a_ms = {}
    for ax in (0, 1):
        x.copy_(x0)
        a_ms[ax] = _median_ms(lambda: bf.fft_axis_p(x, ax, out=x))
    xc = torch.complex(x0[0], x0[1])
    lib = _median_ms(lambda: torch.fft.fft(xc, dim=0))
    lib_mid = _median_ms(lambda: torch.fft.fft(xc, dim=1))
    del xc
    b, by = _bound_ms(2 * x.numel() * 4, n * n * 5 * n * math.log2(n))
    out['bfly'] = {
        'shape': f'(2, {n}, {n}, {n}) f32, lead axis, in place, mode full '
                 f'(A\'s transform); modes_ms: each mode at the same shape, '
                 f'mid_modes_ms on the mid axis, tile_modes_ms on A\'s tile '
                 f'of {tp.tile_lines(n)} lines (lines=); a_ms: A '
                 f'(fft_axis_p) on the same passes',
        'path': route(x, 0), 'mid_path': route(x, 1),
        'ms': modes['full'],
        'plain_ms': _median_ms(lambda: tp.bfly_plain(x0, 0, 'full'), reps=1,
                               warm=0),
        'library_ms': lib, 'mid_library_ms': lib_mid, 'bound_ms': b,
        'bound_by': by, 'modes_ms': modes, 'mid_modes_ms': mid,
        'tile_modes_ms': tile, 'a_ms': {'lead': a_ms[0], 'mid': a_ms[1]}}
    del x, x0
    torch.cuda.empty_cache()
    out['block_copy']['reach_patterns'] = _reach_times(dev, tp)
    out['move'] = _move_times(dev, tp)
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
            'path': 'one element a thread, 8 chains',
            'ms': _median_ms(lambda: tp.fma_chain(x, FMA_TIME_ITERS, 8,
                                                  out=x)),
            'plain_ms': _median_ms(lambda: tp.fma_chain_plain(
                x, FMA_TIME_ITERS), reps=1, warm=1),
            'library_ms': None, 'bound_ms': b, 'bound_by': by}
        del x
    return out


def phase_times_probes(dev):
    """For --times-probes: the probe kernels' rows of ``_probe_times`` on
    the port of the tree given (bfly's modes and A beside them, block_copy
    on every _reach_ms pattern, each held first)."""
    from mpi4py_fft_torch.ops import probes as tp
    t0 = time.perf_counter()
    times = _probe_times(dev, tp)
    _emit({'phase': 'times_probes', 'seconds': time.perf_counter() - t0,
           'kernels': times})


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
    routes = {}
    cases = _holds_probes(holds, dev, tp, routes)
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
           'max_abs_err': holds.err, 'launches': launches,
           'routes': routes})
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

# the DCT-II/III kernels replace no TPU kernel: the JAX package's glue
_DCT_GLUE = ('none: jnp glue of mpi4py_fft_tpu/ops/core.py:248-290 around '
             'the r2c and c2r, which XLA fuses')
# nor do the DNS solver's algebra kernels: the JAX solver's jnp algebra,
# which XLA fuses inside the jitted step
_DNS_ALGEBRA = ('none: jnp algebra of '
                'examples/spectral_dns_solver.py')
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
    'dct2_axis_p': ('mpi4py_fft_torch/ops/csrc/rfft_axis.cu', _DCT_GLUE),
    'dct3_axis_p': ('mpi4py_fft_torch/ops/csrc/rfft_axis.cu', _DCT_GLUE),
    'dct2_axis_p_f64': ('mpi4py_fft_torch/ops/csrc/rfft_axis.cu',
                        _DCT_GLUE),
    'dct3_axis_p_f64': ('mpi4py_fft_torch/ops/csrc/rfft_axis.cu',
                        _DCT_GLUE),
    'dns_curl_f64': ('mpi4py_fft_torch/ops/csrc/dns_algebra.cu',
                     _DNS_ALGEBRA + ':76-78'),
    'dns_cross_f64': ('mpi4py_fft_torch/ops/csrc/dns_algebra.cu',
                      _DNS_ALGEBRA + ':79-81'),
    'dns_project_rk_f64': ('mpi4py_fft_torch/ops/csrc/dns_algebra.cu',
                           _DNS_ALGEBRA + ':82-84, :93-96'),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--times-any', metavar='TREE', nargs='?',
                    const=os.path.dirname(os.path.abspath(__file__)),
                    help="run only phases 1, 22 and 23, A's, B's, C's, "
                         "C64's, D's and A64's rows and phases 11, 12, 13 "
                         "and 18 on the port in TREE (default: this "
                         "script's checkout), to compare two trees on one "
                         "card")
    ap.add_argument('--times-probes', metavar='TREE', nargs='?',
                    const=os.path.dirname(os.path.abspath(__file__)),
                    help="run only phase 1 and the probe kernels' times "
                         "(bfly's modes beside A, block_copy on every "
                         "reach pattern beside copy_, move's kinds beside "
                         "their PyTorch calls) on the port in TREE, to "
                         "compare two trees on one card")
    ap.add_argument('--times-dns', action='store_true',
                    help="run only phase 1, the algebra kernels' times "
                         "and the reference DNS solver (phase 15)")
    ap.add_argument('--times-r2r', metavar='TREE', nargs='?',
                    const=os.path.dirname(os.path.abspath(__file__)),
                    help="run only phase 1, the DCT kernels' rows and the "
                         "transforms example's 'd' plan on the port in "
                         "TREE, to compare two trees on one card")
    ap.add_argument('--times-c2r', metavar='TREE', nargs='?',
                    const=os.path.dirname(os.path.abspath(__file__)),
                    help="run only phase 1, B's and C's rows and C64's "
                         "rows (the holds against numpy reported, not "
                         "checked) on the port in TREE, to compare two "
                         "trees on one card")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.times_any or args.times_probes or
                           args.times_c2r or args.times_r2r or
                           os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, tree)
    from mpi4py_fft_torch.ops import butterfly as bf
    _check(os.path.abspath(bf.__file__).startswith(tree + os.sep),
           f"mpi4py_fft_torch imported from {bf.__file__}, not {tree}")
    t_start = time.perf_counter()
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    phase_build()
    holds = Holds(KERNELS)
    if args.times_probes:
        phase_times_probes(dev)
        print(_smi(), flush=True)
        return 0
    if args.times_c2r:
        phase_times_c2r(dev, bf, holds)
        print(_smi(), flush=True)
        return 0
    if args.times_dns:
        phase_times_dns(dev, bf, holds)
        phase_dns_solver(dev, bf)
        print(_smi(), flush=True)
        return 0
    if args.times_r2r:
        phase_times_r2r(dev, bf, holds)
        print(_smi(), flush=True)
        return 0
    if args.times_any:
        phase_plane(dev, bf, holds)
        phase_times_any(dev, bf, holds)
        b, c = _times_b_c(dev, bf, holds)
        _emit({'phase': 'times_b_c', 'kernels': {'rfft_axis_p': b,
                                                 'irfft_axis_p': c}})
        del b, c
        phase_times_a_c64(dev, bf, holds)
        phase_times_d_a64(dev, bf, holds)
        phase_pfft(dev, bf, holds, 'f')
        phase_pfft(dev, bf, holds, 'F')
        phase_pfft(dev, bf, holds, 'd')
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
    phase_dealias(dev, bf, holds)
    phase_north64(dev, bf)
    phase_dealias(dev, bf, holds, dtype='d')
    phase_dns64(dev, bf)
    marks = {'planar_path_s': time.perf_counter() - t_start}
    phase_pfft(dev, bf, holds, 'f')
    phase_pfft(dev, bf, holds, 'F')
    phase_pfft(dev, bf, holds, 'd')
    phase_buffer(dev, bf)
    phase_dns_solver(dev, bf)
    dns_rows = phase_times_dns(dev, bf, holds)
    marks['reference_api_path_s'] = time.perf_counter() - t_start
    phase_any_c2c(dev, bf)
    phase_any_r2c(dev, bf)
    phase_bluestein(dev, bf)
    phase_plane(dev, bf, holds)
    marks['any_extent_path_s'] = time.perf_counter() - t_start
    phase_dist(dev, bf)
    marks['dist_s'] = time.perf_counter() - t_start
    dct_rows, inner_rows = phase_r2r(dev, bf, holds)
    marks['r2r_s'] = time.perf_counter() - t_start
    phase_io(dev, bf)
    marks['io_s'] = time.perf_counter() - t_start
    launches = dict(bf.LAUNCHES)
    _check(set(launches) == set(KERNELS), f"counters {sorted(launches)}")
    for name, c in launches.items():
        _check(c > 0, f"{name} was not launched on the main path")

    x = _rand((2,) + (NORTH_N,) * 3, dev, SEED + 2)
    times = phase_times(dev, bf, holds, pfft, x)
    del x, pfft
    torch.cuda.empty_cache()
    times.update(phase_times64(dev, bf, holds))
    times.update(dct_rows)
    for name, row in inner_rows.items():
        times[name]['inner'] = row
    times.update(dns_rows)
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
        for extra in ('kernel', 'reach_ms', 'per_axis', 'mid_pair', 'n768',
                      'n768_band', 'w768', 'w1024', 'quarter_mid', 'f768',
                      'pad768', 'numpy_hold', 'cufft_unfused_ms',
                      'per_pass', 'c2c_F',
                      'two_a_passes_ms',
                      'n1536', 'trunc768', 's7', 's8', 'one_cta',
                      'ctas_a_plane', 'max_active', 'middle', 'last',
                      'inner'):
            if extra in t:
                kernels[-1][extra] = t[extra]
    _emit({'phase': 'reach_routes', 'routes': REACH_ROUTES})
    _emit({'kernels': kernels + probe_rows})
    # seconds from the start at the end of the planar phases (3-10), the
    # reference-API phases (11-15), the any-extent phases (19-22), dist,
    # r2r, io, times and times64, and times_any (the probes take the rest)
    _emit({'phase': 'done', 'seconds': time.perf_counter() - t_start,
           'marks': marks})
    print(_smi(), flush=True)
    _emit({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
