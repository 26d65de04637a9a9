"""The port's probe kernels (mpi4py_fft_torch/ops/probes.py) against the
JAX package's TPU probes (scripts/tpu_*.py) on the CPU, and their CUDA
sources in the g++ thread emulation.

The scripts define their kernels inside ``main()``, so each is restated
here as the script writes it and run as a ``pl.pallas_call`` in interpret
mode: the copies with the scripts' ``_bspec`` blockings at n = 32 (lanes
of 8 where the script has 128), the nine moves of tpu_probe_moves.py on
its (64, 8, 128) arange, body_concat/body_adds/``_butterfly`` of
tpu_bfly_dissect.py at N = 64 and 256, ``_kern_lead``/``_kern_mid``/
``_kern_last``/``_kern_last2`` as tpu_longN_probe.py calls them at
N = 512, and the FMA body of tpu_vpu_peak.py.  On CPU tensors the port's
wrappers run their plain versions.  Then the .cu sources, compiled by g++
against tests/cuda_emu (every block's threads real, meeting at each
barrier), are driven through the same wrappers.  Tolerances: copies and
moves bit for bit; the butterfly 5e-6 relative L2 (the JAX kernel
tolerance, tests/test_butterfly.py:44), 2e-13 for A's fp64 build; the FMA
chain 5e-6 (the plain version rounds the multiply and the add apart).
"""
import ctypes
import functools
import math
import shutil
import subprocess
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
import torch

from mpi4py_fft_tpu.ops import pallas_butterfly as pb
from mpi4py_fft_torch.ops import _build
from mpi4py_fft_torch.ops import butterfly as bf
from mpi4py_fft_torch.ops import probes as tp

from test_torch_kernel_emu import CSRC, EMU, _emu_source

TOL = 5e-6
TOL64 = 2e-13
VMEM = pltpu.VMEM


def _rel(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _rand(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _k_copy(x_ref, o_ref):
    o_ref[...] = x_ref[...]


def _k_copy2(xa_ref, xb_ref, oa_ref, ob_ref):
    oa_ref[...] = xa_ref[...]
    ob_ref[...] = xb_ref[...]


# ---------------------------------------------------------------------------
# the copies: (tensor shape, block, index map, grid, the port's grid order,
# in place, two streams), the scripts' blockings at n = 32, lanes of 8
# ---------------------------------------------------------------------------

n, L, h = 32, 8, 16
COPIES = {
    # tpu_dma_probe.py:69, tpu_slope_probe.py:88, tpu_blockshape_probe.py
    'plane': ((2, n, n, n), (2, 1, n, n), lambda i: (0, i, 0, 0), (n,),
              None, False, False),
    'plane in place': ((2, n, n, n), (2, 1, n, n), lambda i: (0, i, 0, 0),
                       (n,), None, True, False),
    'lead': ((2, n, n, n), (2, n, 8, L), lambda i, j: (0, 0, i, j),
             (n // 8, n // L), None, False, False),
    'lead in place': ((2, n, n, n), (2, n, 8, L), lambda i, j: (0, 0, i, j),
                      (n // 8, n // L), None, True, False),
    '8-plane in place': ((2, n, n, n), (2, 8, n, n),
                         lambda i: (0, i, 0, 0), (n // 8,), None, True,
                         False),
    'lead swapped grid': ((2, n, n, n), (2, n, 8, L),
                          lambda j, i: (0, 0, i, j), (n // L, n // 8),
                          (0, 1, 3, 2), True, False),
    # tpu_blockshape_probe.py:72 and :113
    'lead wide': ((2, n, n, n), (2, n, 8, 2 * L), lambda i, j: (0, 0, i, j),
                  (n // 8, n // (2 * L)), None, True, False),
    'lead wider': ((2, n, n, n), (2, n, 8, 4 * L),
                   lambda i, j: (0, 0, i, j), (n // 8, n // (4 * L)), None,
                   True, False),
    'lead tall': ((2, n, n, n), (2, n, 16, L), lambda i, j: (0, 0, i, j),
                  (n // 16, n // L), None, True, False),
    '2-plane': ((2, n, n, n), (2, 2, n, n), lambda i: (0, i, 0, 0),
                (n // 2,), None, True, False),
    'halfplane': ((2, n, n, n), (2, 1, n // 2, n),
                  lambda i, j: (0, i, j, 0), (n, 2), None, True, False),
    # tpu_lead_copy.py:89 and :102, tpu_r3_profile.py:79 and :93,
    # tpu_plane_test.py:96 and :110
    'lead 1-D grid': ((2, n, n * n // L, L), (2, n, 8, L),
                      lambda i: (0, 0, i, 0), (n * n // (8 * L),), None,
                      False, False),
    'mid': ((2, n, n, n), (2, 8, n, L), lambda i, j: (0, i, 0, j),
            (n // 8, n // L), None, False, False),
    'lead sub 16': ((2, n, n * n // L, L), (2, n, 16, L),
                    lambda i: (0, 0, i, 0), (n * n // (16 * L),), None,
                    False, False),
    'lead sub 32': ((2, n, n * n // L, L), (2, n, 32, L),
                    lambda i: (0, 0, i, 0), (n * n // (32 * L),), None,
                    False, False),
    'contig': ((2, n ** 3 // (4 * L), 4 * L), (2, 64, 4 * L),
               lambda i: (0, i, 0), (n ** 3 // (4 * L) // 64,), None, False,
               False),
    # tpu_pair_blocking_probe.py:66 on the (2, h, n, h) quarters, and :96
    'pair base': ((2, h, n, h), (2, h, 8, L), lambda i, j: (0, 0, i, j),
                  (n // 8, h // L), None, False, True),
    'pair wide': ((2, h, n, h), (2, h, 8, 2 * L), lambda i, j: (0, 0, i, j),
                  (n // 8, h // (2 * L)), None, False, True),
    'pair tall': ((2, h, n, h), (2, h, 16, L), lambda i, j: (0, 0, i, j),
                  (n // 16, h // L), None, False, True),
    'pair gridT': ((2, h, n, h), (2, h, 8, L), lambda j, i: (0, 0, i, j),
                   (h // L, n // 8), (0, 1, 3, 2), False, True),
    'pair halfrow': ((2, h, n, h), (2, h // 2, 8, L),
                     lambda k, i, j: (0, k, i, j), (2, n // 8, h // L),
                     None, False, True),
    'single': ((2, h, n, h), (2, h, 8, L), lambda i, j: (0, 0, i, j),
               (n // 8, h // L), None, False, False),
    # tpu_oop3d_dissect.py:104 on the (2, h, n*h/128, 128) pair view
    'paircopy': ((2, h, n * h // L, L), (2, h, 8, L),
                 lambda i: (0, 0, i, 0), (n * h // L // 8,), None, False,
                 True),
}


def _pallas_copy(case, xs):
    shape, block, imap, grid, _, alias, pair = case
    spec = pb._bspec(block, imap, memory_space=VMEM)
    sds = jax.ShapeDtypeStruct(shape, jnp.float32)
    if pair:
        return pl.pallas_call(
            _k_copy2, out_shape=(sds, sds), grid=grid,
            in_specs=[spec, spec], out_specs=(spec, spec),
            interpret=True)(*(jnp.asarray(x) for x in xs))
    y = pl.pallas_call(
        _k_copy, out_shape=sds, grid=grid, in_specs=[spec],
        out_specs=spec, input_output_aliases={0: 0} if alias else {},
        interpret=True)(jnp.asarray(xs[0]))
    return (y,)


def _nan(t):
    """An output no correct run leaves as it is."""
    return torch.full_like(t, float('nan'))


def _port_copy(case, xs):
    """The port's block_copy of case on numpy inputs xs, into NaN-filled
    outputs (in place into a tensor of the input where the case is)."""
    _, block, _, _, order, alias, pair = case
    ts = [torch.from_numpy(x.copy()) for x in xs]
    if pair:
        return tp.block_copy(ts[0], block, order, out=_nan(ts[0]), x2=ts[1],
                             out2=_nan(ts[1]))
    out = tp.block_copy(ts[0], block, order,
                        out=ts[0] if alias else _nan(ts[0]))
    assert (out is ts[0]) == alias
    return (out,)


@pytest.mark.parametrize('name', list(COPIES))
def test_block_copy_vs_pallas(name):
    case = COPIES[name]
    xs = [_rand(case[0], 30 + i) for i in range(2 if case[6] else 1)]
    ref = _pallas_copy(case, xs)
    got = _port_copy(case, xs)
    for g, r, x in zip(got, ref, xs):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_array_equal(g.numpy(), x)


# ---------------------------------------------------------------------------
# the moves of tpu_probe_moves.py:31 on its (64, 8, 128) arange
# ---------------------------------------------------------------------------

MN, MS, ML = 64, 8, 128
# the script's body -> the port's (axis, kind, shift)
MOVE_CASES = {
    'lead strided x[0::2]': (lambda x: x[0::2], (0, 'even', 0)),
    'lead strided x[1::2]': (lambda x: x[1::2], (0, 'odd', 0)),
    'lead flip jnp.flip(x,0)': (lambda x: jnp.flip(x, axis=0),
                                (0, 'reverse', 0)),
    'lead neg-step x[::-1]': (lambda x: x[::-1], (0, 'reverse', 0)),
    'pltpu.roll lead': (lambda x: pltpu.roll(x, shift=1, axis=0),
                        (0, 'roll', 1)),
    'concat pages reversal': (
        lambda x: jnp.concatenate([x[i:i + 1]
                                   for i in range(MN - 1, -1, -1)], axis=0),
        (0, 'reverse', 0)),
    'concat pages deinterleave': (
        lambda x: jnp.concatenate([x[2 * i:2 * i + 1]
                                   for i in range(MN // 2)], axis=0),
        (0, 'even', 0)),
    'reshape pair-split (N/2,2,S,L) take even': (
        lambda x: x.reshape(MN // 2, 2, MS, ML)[:, 0], (0, 'even', 0)),
    'sublane flip jnp.flip(x,1)': (lambda x: jnp.flip(x, axis=1),
                                   (1, 'reverse', 0)),
}


def _arange():
    return np.arange(MN * MS * ML, dtype=np.float32).reshape(MN, MS, ML)


def _pallas_move(body):
    def kern(x_ref, o_ref):
        o_ref[...] = body(x_ref[...])
    x = _arange()
    out = jax.eval_shape(body, jnp.zeros((MN, MS, ML), jnp.float32))
    return np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(out.shape, np.float32),
        in_specs=[pl.BlockSpec(memory_space=VMEM)],
        out_specs=pl.BlockSpec(memory_space=VMEM), interpret=True)(x))


@pytest.mark.parametrize('name', list(MOVE_CASES))
def test_moves_vs_pallas(name):
    body, (axis, kind, shift) = MOVE_CASES[name]
    got = tp.move(torch.from_numpy(_arange()), axis, kind, shift)
    np.testing.assert_array_equal(got.numpy(), _pallas_move(body))


# ---------------------------------------------------------------------------
# tpu_bfly_dissect.py: body_copy, body_concat, body_adds, body_full on the
# lead blocks (2, N, 8, 128), restated as the script writes them
# ---------------------------------------------------------------------------

def _body_copy(N, xr, xi, tw):
    return xr, xi


def _body_concat(N, xr, xi, tw):
    xr = xr[:, None]
    xi = xi[:, None]
    Ln = N
    while Ln > 1:
        Lq = Ln // 4
        xr = jnp.concatenate([xr[:Lq], xr[Lq:2 * Lq],
                              xr[2 * Lq:3 * Lq], xr[3 * Lq:]], axis=1)
        xi = jnp.concatenate([xi[:Lq], xi[Lq:2 * Lq],
                              xi[2 * Lq:3 * Lq], xi[3 * Lq:]], axis=1)
        Ln = Lq
    return xr[0], xi[0]


def _body_adds(N, xr, xi, tw):
    xr = xr[:, None]
    xi = xi[:, None]
    Ln = N
    while Ln > 1:
        Lq = Ln // 4
        q0r, q1r = xr[:Lq], xr[Lq:2 * Lq]
        q2r, q3r = xr[2 * Lq:3 * Lq], xr[3 * Lq:]
        q0i, q1i = xi[:Lq], xi[Lq:2 * Lq]
        q2i, q3i = xi[2 * Lq:3 * Lq], xi[3 * Lq:]
        t0r, t0i = q0r + q2r, q0i + q2i
        t1r, t1i = q1r + q3r, q1i + q3i
        t2r, t2i = q0r - q2r, q0i - q2i
        t3r, t3i = q1r - q3r, q1i - q3i
        u3r, u3i = t3i, -t3r
        xr = jnp.concatenate([t0r + t1r, t2r + u3r,
                              t0r - t1r, t2r - u3r], axis=1)
        xi = jnp.concatenate([t0i + t1i, t2i + u3i,
                              t0i - t1i, t2i - u3i], axis=1)
        Ln = Lq
    return xr[0], xi[0]


def _body_full(N, xr, xi, tw):
    return pb._butterfly(xr, xi, tw, N, -1)


BODIES = {'copy': _body_copy, 'moves': _body_concat, 'adds': _body_adds,
          'full': _body_full}


def _pallas_bfly(body, N, x, reps=1):
    """A lead-axis pallas_call of the script's shape: blocks (2, N, 8, 128)
    in place, the twiddles broadcast to (2, T, 8, 128) (with_tw)."""
    tws = jnp.asarray(pb._tw_pack(N, -1, 'float32'))
    tw = jnp.broadcast_to(tws[:, :, None, None], (2, tws.shape[1], 8, 128))

    def kern(x_ref, tw_ref, o_ref):
        r, i = x_ref[0], x_ref[1]
        for _ in range(reps):
            r, i = body(N, r, i, tw_ref)
        o_ref[0] = r
        o_ref[1] = i

    spec = pb._bspec((2, N, 8, 128), lambda i, j: (0, 0, i, j),
                     memory_space=VMEM)
    return np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        grid=(x.shape[2] // 8, x.shape[3] // 128),
        in_specs=[spec, pb._bspec(tw.shape, lambda *g: (0, 0, 0, 0),
                                  memory_space=VMEM)],
        out_specs=spec, input_output_aliases={0: 0},
        interpret=True)(jnp.asarray(x), tw))


@pytest.mark.parametrize('N', [64, 256])
@pytest.mark.parametrize('mode', list(BODIES))
def test_bfly_modes_vs_pallas(mode, N):
    x = _rand((2, N, 16, 128), 31)
    ref = _pallas_bfly(BODIES[mode], N, x)
    got = tp.bfly(torch.from_numpy(x), 0, mode).numpy()
    if mode in ('copy', 'moves'):
        np.testing.assert_array_equal(got, ref)
    else:
        assert _rel(got, ref) <= TOL


def test_bfly_reps_vs_pallas():
    """tpu_vpu_probe.py:57: the butterfly applied reps times a block."""
    x = _rand((2, 64, 8, 128), 32)
    ref = _pallas_bfly(_body_full, 64, x, 3)
    got = tp.bfly(torch.from_numpy(x), 0, 'full', reps=3).numpy()
    assert _rel(got, ref) <= TOL


# ---------------------------------------------------------------------------
# tpu_longN_probe.py:76: the JAX package's own kernels at N = 512
# ---------------------------------------------------------------------------

def _pallas_kern(kern, N, x, block, grid, imap, alias):
    tws = jnp.asarray(pb._tw_pack(N, -1, 'float32'))
    tw = jnp.broadcast_to(tws[:, :, None, None], (2, tws.shape[1], 8, 128))
    return np.asarray(pl.pallas_call(
        functools.partial(kern, N=N, sign=-1, scale=None),
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype), grid=grid,
        in_specs=[pb._bspec(block, imap, memory_space=VMEM),
                  pb._bspec(tw.shape, lambda *g: (0, 0, 0, 0),
                            memory_space=VMEM)],
        out_specs=pb._bspec(block, imap, memory_space=VMEM),
        input_output_aliases={0: 0} if alias else {},
        interpret=True)(jnp.asarray(x), tw))


LN = 512
LONG_CASES = {
    # kernel, data shape, block, grid, index map, port axis (complex)
    'lead': (pb._kern_lead, (2, LN, 8, 128), (2, LN, 8, 128), (1,),
             lambda i: (0, 0, i, 0), 0),
    'mid': (pb._kern_mid, (2, 8, LN, 128), (2, 8, LN, 128), (1, 1),
            lambda i, j: (0, i, 0, j), 1),
    'last': (pb._kern_last, (2, 1024, LN), (2, 1024, LN), (1,),
             lambda i: (0, i, 0), 1),
    'last2': (pb._kern_last2, (2, 8, 128, LN), (2, 8, 128, LN), (1, 1),
              lambda i, j: (0, i, 0, j), 2),
}


@pytest.mark.parametrize('name,alias', [('lead', True), ('mid', False),
                                        ('last', False), ('last2', True)])
def test_long_n_kernels_vs_pallas(name, alias):
    """A at the lead, mid and last positions, in place (the output is the
    input) and out of place, against the JAX kernel of that position."""
    kern, shape, block, grid, imap, axis = LONG_CASES[name]
    x = _rand(shape, 33)
    ref = _pallas_kern(kern, LN, x, block, grid, imap, alias)
    t = torch.from_numpy(x.copy())
    got = bf.fft_axis_p(t, axis, out=t if alias else None)
    assert (got is t) == alias
    assert _rel(got.numpy(), ref) <= TOL


# ---------------------------------------------------------------------------
# tpu_vpu_peak.py:86: acc <- acc * a + b, iters * inner times
# ---------------------------------------------------------------------------

def _pallas_fma(x, iters, muls, inner, a, b):
    def kern(x_ref, o_ref):
        a_ = jnp.float32(a)
        b_ = jnp.float32(b)

        def body(i, accs):
            accs = list(accs)
            for _ in range(inner):
                for j in range(muls):
                    accs[j] = accs[j] * a_ + b_
            return tuple(accs)
        accs = jax.lax.fori_loop(
            0, iters, body, tuple(x_ref[0, j] for j in range(muls)))
        for j in range(muls):
            o_ref[0, j] = accs[j]

    g, _, rows, _ = x.shape
    spec = pl.BlockSpec((1, muls, rows, 128), lambda i: (i, 0, 0, 0),
                        memory_space=VMEM)
    return np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype), grid=(g,),
        in_specs=[spec], out_specs=spec, interpret=True)(jnp.asarray(x)))


# constants whose every step moves each value by far more than TOL (the
# script's a = 1.0000001, b = 1e-9 move it by about an ulp)
FMA_A, FMA_B = 0.9990234375, 0.25


@pytest.mark.parametrize('iters,inner', [(3, 4), (5, 3)])
def test_fma_chain_vs_pallas(iters, inner):
    """The script's kernel body against fma_chain_plain; one step more or
    less would move the result by about 5%."""
    x = 1.0 + 0.5 * _rand((2, 4, 8, 128), 34)
    ref = _pallas_fma(x, iters, 4, inner, FMA_A, FMA_B)
    got = tp.fma_chain(torch.from_numpy(x), iters * inner, a=FMA_A,
                       b=FMA_B).numpy()
    assert _rel(got, ref) <= TOL
    short = tp.fma_chain(torch.from_numpy(x), iters * inner - 1, a=FMA_A,
                         b=FMA_B).numpy()
    assert _rel(short, ref) > 1000 * TOL


# ---------------------------------------------------------------------------
# the .cu sources in the g++ emulation, through the port's wrappers
# ---------------------------------------------------------------------------

EMU_LIBS = ('probe_copy', 'probe_bfly', 'probe_fma', 'fft_axis')


@pytest.fixture(scope='module')
def emu_probes(tmp_path_factory):
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ to compile the kernel emulation')
    d = tmp_path_factory.mktemp('probe_emu')
    procs = {}
    for lib in EMU_LIBS:
        src = d / f'{lib}.cpp'
        src.write_text(_emu_source(CSRC / f'{lib}.cu'))
        cmd = [gxx, '-std=c++20', '-O1', '-ffp-contract=off', '-shared',
               '-fPIC', '-pthread', '-I', str(EMU), '-I', str(CSRC),
               '-o', str(d / f'{lib}.so'), str(src)]
        procs[lib] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    k = types.SimpleNamespace(libs={})
    for lib, p in procs.items():
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, out
        so = ctypes.CDLL(str(d / f'{lib}.so'))
        k.libs[lib] = so
        for name, argtypes in _build._ENTRIES[lib].items():
            fn = getattr(so, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            setattr(k, name[len('mff_'):], fn)
    return k


@pytest.fixture
def kernel_path(emu_probes, monkeypatch):
    """The wrappers launch the emulated kernels on CPU tensors."""
    def launcher(counts):
        def launch(what, fn, t, *args, nbytes, route=None):
            rc = fn(*args, ctypes.c_void_p(0))
            if rc != 0:
                raise RuntimeError(f"{what}: emulated launch failed: {rc}")
            counts[what] += 1
        return launch

    monkeypatch.setattr(_build, 'load', lambda: emu_probes)
    monkeypatch.setattr(tp, '_launch', launcher(tp.LAUNCHES))
    monkeypatch.setattr(bf, '_launch', launcher(bf.LAUNCHES))
    monkeypatch.setattr(tp, '_plain_ok', lambda t, what, *a: False)
    monkeypatch.setattr(bf, '_plain_ok', lambda t, what, **kw: False)
    tp.reset_launches()
    bf.reset_launches()
    yield
    tp.reset_launches()
    bf.reset_launches()


@pytest.mark.parametrize('name', list(COPIES))
def test_block_copy_kernel(kernel_path, name):
    """Every blocking, both grid orders, in place, out of place and two
    streams: bit for bit; a misaligned tensor takes the scalar path."""
    case = COPIES[name]
    alias = case[5]
    xs = [_rand(case[0], 35 + i) for i in range(2 if case[6] else 1)]
    got = _port_copy(case, xs)
    if alias:
        # in place the copy is the identity, so the same boxes also go out
        # of place into NaN, where a box left out shows
        got += _port_copy(case[:5] + (False,) + case[6:], xs)
        xs = xs * 2
    for g, x in zip(got, xs):
        np.testing.assert_array_equal(g.numpy(), x)
    assert tp.LAUNCHES['block_copy'] == (2 if alias else 1)


def _emu_counter(emu, lib, name):
    fn = getattr(emu.libs[lib], name)
    fn.restype = ctypes.c_longlong
    return fn()


@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('name', list(COPIES))
def test_block_copy_route_orders(kernel_path, name, reverse):
    """The vector route on every blocking (each 16-byte aligned, its runs
    multiples of 4 floats), in the case's grid order and in its reverse,
    in place and out of place (two streams where the case has them), bit
    for bit."""
    shape, block, _, _, order, _, pair = COPIES[name]
    order = tuple(range(len(shape))) if order is None else order
    if reverse:
        order = order[::-1]
    xs = [torch.from_numpy(_rand(shape, 43 + i))
          for i in range(2 if pair else 1)]
    two = {'x2': xs[1]} if pair else {}
    assert tp.block_copy_route(xs[0], block, order, **two) == 'vector'
    if pair:
        got = tp.block_copy(xs[0], block, order, out=_nan(xs[0]), x2=xs[1],
                            out2=_nan(xs[1]))
        qs = [x.clone() for x in xs]
        tp.block_copy(qs[0], block, order, out=qs[0], x2=qs[1], out2=qs[1])
    else:
        got = (tp.block_copy(xs[0], block, order, out=_nan(xs[0])),)
        qs = [xs[0].clone()]
        assert tp.block_copy(qs[0], block, order, out=qs[0]) is qs[0]
    for g, q, x in zip(got, qs, xs):
        assert torch.equal(g, x) and torch.equal(q, x)
    assert tp.LAUNCHES['block_copy'] == 2


# (tensor shape, box, grid order, route): box extents above 256, a 5-D
# box, _reach_ms's patterns (chip_smoke.py) at n = 16 and the 257-column
# runs of the dealiased plans, and runs of 2 and 6 floats (the scalar
# route)
COPY_PLANS = {
    'box above 256, run cut': ((512, 520), (512, 260), None, 'vector'),
    'rows above 256': ((1024, 128), (512, 64), None, 'vector'),
    'long run into rows': ((2, 4, 2048), (2, 1, 2048), None, 'vector'),
    '5-D box': ((2, 4, 6, 8, 600), (1, 2, 3, 4, 300), (4, 3, 2, 1, 0),
                'vector'),
    'reach last axis (2, 1, B, C)': ((2, 16, 16, 16), (2, 1, 16, 16), None,
                                     'vector'),
    'reach mid axis (2, 8, B, 128)': ((2, 16, 16, 256), (2, 8, 16, 128),
                                      None, 'vector'),
    'reach mid axis, f64 odd post (2, 1, B, C)': ((2, 2, 512, 514),
                                                  (2, 1, 512, 514), None,
                                                  'vector'),
    'reach mid axis, odd post (2, 1, B, 257)': ((2, 4, 768, 257),
                                                (2, 1, 768, 257), None,
                                                'vector'),
    'reach lead axis (2, A, 128)': ((2, 16, 256), (2, 16, 128), None,
                                    'vector'),
    '2-float run': ((2, 6, 10, 2), (2, 6, 1, 2), None, 'scalar'),
    'run of 6 floats': ((2, 6, 10, 6), (2, 6, 1, 6), None, 'scalar'),
}


@pytest.mark.parametrize('name', list(COPY_PLANS))
def test_block_copy_route_plan(kernel_path, name):
    """The route the C entry takes (16-byte vectors where every base is
    16-byte aligned and a box row is a multiple of 4 floats, else single
    floats), and the copy bit for bit on that route."""
    shape, box, order, route = COPY_PLANS[name]
    x = torch.from_numpy(_rand(shape, 44))
    assert tp.block_copy_route(x, box, order) == route
    y = tp.block_copy(x, box, order, out=_nan(x))
    assert torch.equal(y, x) and tp.LAUNCHES['block_copy'] == 1


def test_block_copy_kernel_scalar_and_refusals(kernel_path, emu_probes):
    base = torch.from_numpy(_rand((2 * 6 * 10 * 3 + 1,), 36))
    x = base[1:].view(2, 6, 10, 3)            # 4-byte aligned only, run 6
    assert tp.block_copy_route(x, (1, 2, 10, 3), (0, 2, 1, 3)) == 'scalar'
    y = tp.block_copy(x, (1, 2, 10, 3), (0, 2, 1, 3))
    assert torch.equal(y, x) and tp.LAUNCHES['block_copy'] == 1
    # the same boxes 16-byte aligned take vectors, misaligned by 4 floats
    # too
    a = torch.from_numpy(_rand((2 * 6 * 10 * 4 + 4,), 36))
    for v in (a[:-4].view(2, 6, 10, 4), a[4:].view(2, 6, 10, 4)):
        assert tp.block_copy_route(v, (1, 2, 10, 4)) == 'vector'
        assert torch.equal(tp.block_copy(v, (1, 2, 10, 4)), v)
    assert tp.block_copy_route(a[1:-3].view(2, 6, 10, 4),
                               (1, 2, 10, 4)) == 'scalar'
    with pytest.raises(ValueError, match='tile'):
        tp.block_copy(x, (2, 4, 10, 3))
    with pytest.raises(ValueError, match='permutation'):
        tp.block_copy(x, (1, 2, 10, 3), (0, 1, 1, 3))
    # the C entry refuses a box that does not divide the tensor
    dims = (ctypes.c_longlong * 2)(4, 6)
    box = (ctypes.c_longlong * 2)(3, 6)
    order = (ctypes.c_int * 2)(0, 1)
    rc = emu_probes.block_copy_f32(bf._ptr(y), bf._ptr(y), None, None, dims,
                                   box, order, 2, ctypes.c_void_p(0))
    assert rc != 0


@pytest.mark.parametrize('name', list(MOVE_CASES))
def test_move_kernel(kernel_path, name):
    _, (axis, kind, shift) = MOVE_CASES[name]
    x = torch.from_numpy(_arange())
    ref = tp.move_plain(x, axis, kind, shift)
    assert torch.equal(tp.move(x, axis, kind, shift, out=_nan(ref)), ref)
    assert tp.LAUNCHES['move'] == 1


def test_move_kernel_shapes(kernel_path):
    """Odd inner extents (the scalar path), the last axis (B's reads),
    every kind and rolls past N, against the plain version."""
    x = torch.from_numpy(_rand((3, 10, 5), 37))
    for axis in (0, 1, 2):
        for kind, shift in (('even', 0), ('odd', 0), ('reverse', 0),
                            ('roll', 3), ('roll', -7)):
            if kind in ('even', 'odd') and x.shape[axis] % 2:
                continue
            ref = tp.move_plain(x, axis, kind, shift % x.shape[axis])
            got = tp.move(x, axis, kind, shift, out=_nan(ref))
            assert torch.equal(got, ref), (axis, kind, shift)
            assert torch.equal(tp.move_plain(x, axis, kind, shift), ref)
    assert tp.LAUNCHES['move'] == 11


# move's routes: (shape, axis, kind, shift, floats off 16-byte alignment
# of x and of out, route).  The last axis (Q = 1): in registers for even
# and odd at N % 8 == 0 and 4 and 2 (a tail of single floats); staged in
# shared memory for reverse and roll (N % 4 == 0, N odd, N % 4 == 2, shifts
# 0, 1, 4, N - 1, negative);
# rows of a multiple of 4 floats as vectors (whole rows an item, and rows
# of more than one item); single floats off alignment, at Q % 4 != 0 and
# on lines too long to stage.  P = 1 and Q = 1 among them.
MOVE_ROUTE_CASES = {
    'lines even N%8=0': ((6, 16), 1, 'even', 0, 0, 0, 'lines'),
    'lines odd N%8=0': ((6, 16), 1, 'odd', 0, 0, 0, 'lines'),
    'lines even N%8=4, P odd': ((5, 12), 1, 'even', 0, 0, 0, 'lines'),
    'lines odd N%8=4, P odd': ((5, 12), 1, 'odd', 0, 0, 0, 'lines'),
    'lines even N%8=4, 772 points': ((3, 772), 1, 'even', 0, 0, 0,
                                     'lines'),
    'lines odd N=6, float tail': ((3, 6), 1, 'odd', 0, 0, 0, 'lines'),
    'lines even P=1': ((1, 1, 40), -1, 'even', 0, 0, 0, 'lines'),
    'shared reverse N%4=0': ((5, 16), 1, 'reverse', 0, 0, 0,
                             'lines_shared'),
    'shared reverse 1-D': ((2048,), 0, 'reverse', 0, 0, 0, 'lines_shared'),
    'shared roll 0': ((5, 16), 1, 'roll', 0, 0, 0, 'lines_shared'),
    'shared roll 4': ((5, 16), 1, 'roll', 4, 0, 0, 'lines_shared'),
    'shared roll -4': ((3, 2, 16), 2, 'roll', -4, 0, 0, 'lines_shared'),
    'shared roll 1': ((5, 16), 1, 'roll', 1, 0, 0, 'lines_shared'),
    'shared roll N-1': ((5, 16), 1, 'roll', 15, 0, 0, 'lines_shared'),
    'shared roll -3': ((5, 16), 1, 'roll', -3, 0, 0, 'lines_shared'),
    'shared roll 1, 772 points': ((6, 772), 1, 'roll', 1, 0, 0,
                                  'lines_shared'),
    'shared reverse N odd': ((5, 9), 1, 'reverse', 0, 0, 0, 'lines_shared'),
    'shared reverse N%4=2': ((7, 10), 1, 'reverse', 0, 0, 0,
                             'lines_shared'),
    'shared roll 0, N odd': ((5, 9), 1, 'roll', 0, 0, 0, 'lines_shared'),
    'shared roll 1, N odd': ((5, 9), 1, 'roll', 1, 0, 0, 'lines_shared'),
    'shared roll 4, N odd': ((5, 9), 1, 'roll', 4, 0, 0, 'lines_shared'),
    'shared roll N-1, N odd': ((5, 9), 1, 'roll', 8, 0, 0, 'lines_shared'),
    'shared roll -2, N odd': ((5, 9), 1, 'roll', -2, 0, 0, 'lines_shared'),
    'shared roll 3, P=1, groups': ((1, 2, 3, 4, 2000), 4, 'roll', 3, 0, 0,
                                   'lines_shared'),
    'rows even': ((4, 6, 8), 1, 'even', 0, 0, 0, 'rows'),
    'rows odd': ((4, 6, 8), 1, 'odd', 0, 0, 0, 'rows'),
    'rows reverse': ((4, 6, 8), 1, 'reverse', 0, 0, 0, 'rows'),
    'rows roll 1': ((4, 6, 8), 1, 'roll', 1, 0, 0, 'rows'),
    'rows roll -1, P=1': ((7, 4, 12), 0, 'roll', -1, 0, 0, 'rows'),
    'rows roll 4, Q=4': ((3, 10, 4), 1, 'roll', 4, 0, 0, 'rows'),
    'rows even, long rows': ((2, 4, 4100), 1, 'even', 0, 0, 0, 'rows'),
    'rows reverse, long rows': ((3, 4100), 0, 'reverse', 0, 0, 0, 'rows'),
    'rows roll 5, long rows': ((2, 6, 2056), 1, 'roll', 5, 0, 0, 'rows'),
    'scalar x off alignment, lines even': ((6, 16), 1, 'even', 0, 1, 0,
                                           'scalar'),
    'scalar out off alignment, shared roll 4': ((5, 16), 1, 'roll', 4, 0,
                                                1, 'scalar'),
    'scalar x off alignment, rows odd': ((4, 6, 8), 1, 'odd', 0, 1, 0,
                                         'scalar'),
    'scalar x off alignment, shared roll 1': ((5, 9), 1, 'roll', 1, 1, 0,
                                              'scalar'),
    'scalar Q=3': ((4, 6, 3), 1, 'reverse', 0, 0, 0, 'scalar'),
    'scalar Q=6 roll -7': ((2, 10, 6), 1, 'roll', -7, 0, 0, 'scalar'),
    'scalar lines too long to stage': ((12292,), 0, 'roll', 1, 0, 0,
                                       'scalar'),
    'scalar reverse too long to stage': ((12292,), 0, 'reverse', 0, 0, 0,
                                         'scalar'),
}


def _off(shape, off, seed):
    """A random tensor of ``shape`` that starts ``off`` floats into its
    buffer (16-byte aligned at off = 0)."""
    base = torch.from_numpy(_rand((math.prod(shape) + off,), seed))
    return base[off:].view(shape)


@pytest.mark.parametrize('name', list(MOVE_ROUTE_CASES))
def test_move_kernel_routes(kernel_path, name):
    """Each kind on each of move's routes: the route the C entry reports,
    and the result bit for bit move_plain's, into a NaN-filled out."""
    shape, axis, kind, shift, xoff, yoff, route = MOVE_ROUTE_CASES[name]
    x = _off(shape, xoff, 45)
    ref = tp.move_plain(x, axis, kind, shift)
    out = _off(tuple(ref.shape), yoff, 46).fill_(float('nan'))
    assert tp.move_route(x, axis, kind, shift, out=out) == route
    if not xoff and not yoff:
        assert tp.move_route(x, axis, kind, shift) == route
    assert tp.move(x, axis, kind, shift, out=out) is out
    assert torch.equal(out, ref)
    assert tp.LAUNCHES['move'] == 1


def test_move_refuses_overlap(kernel_path, emu_probes):
    """An out whose bytes overlap x raises, on the kernel path as on the
    CPU's plain path, and the C entry refuses it; a view of the same
    buffer that does not overlap is taken."""
    buf = torch.from_numpy(_rand((3 * 64,), 47))
    x = buf[:128].view(8, 16)
    for out, kind in ((x, 'reverse'), (buf[64:192].view(8, 16), 'roll'),
                      (buf[120:184].view(8, 8), 'even')):
        with pytest.raises(ValueError, match='overlaps'):
            tp.move(x, 1, kind, 1, out=out)
        with pytest.raises(ValueError, match='overlaps'):
            tp.move_route(x, 1, kind, 1, out=out)
        N, kn = 16, tp.MOVES.index(kind)
        assert emu_probes.move_route_f32(bf._ptr(x), bf._ptr(out), 8, N, 1,
                                         kn, 1) == -1
        assert emu_probes.move_f32(bf._ptr(x), bf._ptr(out), 8, N, 1, kn, 1,
                                   ctypes.c_void_p(0)) != 0
    apart = buf[128:192].view(8, 8)
    assert tp.move_route(x, 1, 'odd', out=apart) == 'lines'
    assert torch.equal(tp.move(x, 1, 'odd', out=apart),
                       tp.move_plain(x, 1, 'odd'))
    assert tp.LAUNCHES['move'] == 1


def test_move_refuses_overlap_on_cpu():
    """The plain path refuses the same overlap (move runs in place
    nowhere), so the CPU and the card agree: out is x, out shares bytes
    with x, and, the check comparing address spans, two views that
    interleave without sharing a byte."""
    x = torch.arange(48, dtype=torch.float32).view(3, 16)
    with pytest.raises(ValueError, match='overlaps'):
        tp.move(x, 1, 'reverse', out=x)
    with pytest.raises(ValueError, match='overlaps'):
        tp.move(x[:, :8], 1, 'roll', 3, out=x[:, 4:12])
    with pytest.raises(ValueError, match='overlaps'):
        tp.move(x[:, :8], 1, 'roll', 3, out=x[:, 8:])
    y = torch.empty(3, 16)
    assert torch.equal(tp.move(x, 1, 'reverse', out=y), x.flip(1))


def _sectors_brute(x, axis, kind):
    """move_bytes by enumeration: y's bytes plus 32 for each distinct
    32-byte sector holding a gathered element of x."""
    axis = axis % x.dim()
    Q = math.prod(x.shape[axis + 1:])
    i = np.arange(x.numel())
    keep = (i // Q) % 2 == (kind == 'odd') if kind in ('even', 'odd') else \
        np.ones_like(i, dtype=bool)
    sectors = np.unique((x.data_ptr() + 4 * i[keep]) // 32)
    return 4 * int(keep.sum()) + 32 * sectors.size


@pytest.mark.parametrize('Q', [1, 2, 3, 4, 5, 6, 7, 8, 12, 20])
def test_move_bytes(Q):
    """move_bytes against the sectors counted one by one, every kind, at
    every offset of x into a 32-byte sector; then the three rules: x + y
    on the last axis, 2 y for rows of whole sectors, 2 x for reverse."""
    for off in range(8):
        for shape, axis in (((3, 10, Q), 1), ((10, Q), 0), ((2, 2, 10), 2)):
            x = _off(shape, off, 48)
            for kind in tp.MOVES:
                want = _sectors_brute(x, axis, kind) if kind in (
                    'even', 'odd') else 2 * 4 * x.numel()
                assert tp.move_bytes(x, axis, kind) == want, (shape, off,
                                                              kind)
    x = torch.empty((6, 10, 16))
    if x.data_ptr() % 32 == 0:
        assert tp.move_bytes(x, 2, 'even') == 4 * x.numel() * 3 // 2
        assert tp.move_bytes(x, 1, 'odd') == 4 * x.numel()
        assert tp.move_bytes(x, 0, 'reverse') == 8 * x.numel()


# (complex shape, axis, modes): lead, mid and last positions, whole lines
BFLY_SHAPES = [((64, 3, 8), 0), ((2, 16, 40), 1), ((6, 256), 1),
               ((3, 5, 64), 2), ((16, 9), 0)]


@pytest.mark.parametrize('shape,axis', BFLY_SHAPES)
def test_bfly_kernel(kernel_path, shape, axis):
    """Every mode against its plain version (copy and moves bit for bit),
    reps 1 and 2, and in place equal to out of place bit for bit."""
    p = torch.from_numpy(_rand((2,) + shape, 38))
    for mode in tp.MODES:
        for reps in (1, 2):
            got = tp.bfly(p, axis, mode, reps, out=_nan(p))
            ref = tp.bfly_plain(p, axis, mode, reps)
            if mode in ('copy', 'moves'):
                assert torch.equal(got, ref), (mode, reps)
            else:
                assert _rel(got, ref) <= TOL, (mode, reps)
            q = p.clone()
            assert tp.bfly(q, axis, mode, reps, out=q) is q
            assert torch.equal(q, got)
    assert tp.LAUNCHES['bfly'] == 16


def test_bfly_kernel_lengths_and_tiles(kernel_path, emu_probes):
    """full at 2^a and 3*2^a lengths and either sign; fewer lines a tile
    than A's; modes that need N = 4^k refuse other lengths."""
    for shape, axis in (((8, 3, 5), 0), ((4, 96), 1), ((2, 3, 512), 2)):
        p = torch.from_numpy(_rand((2,) + shape, 39))
        for fwd in (True, False):
            got = tp.bfly(p, axis, 'full', forward=fwd, out=_nan(p))
            assert _rel(got, bf.fft_axis_plain(p, axis, fwd)) <= TOL
    p = torch.from_numpy(_rand((2, 64, 40), 40))
    for lines in (1, 2, 8):
        got = tp.bfly(p, 0, 'full', lines=lines, out=_nan(p))
        assert _rel(got, bf.fft_axis_plain(p, 0)) <= TOL
        assert torch.equal(tp.bfly(p, 0, 'moves', lines=lines, out=_nan(p)),
                           tp.bfly_plain(p, 0, 'moves'))
    with pytest.raises(ValueError, match='4\\^k'):
        tp.bfly(torch.zeros((2, 32, 4)), 0, 'adds')
    with pytest.raises(ValueError, match='tile'):
        tp.bfly(p, 0, 'full', lines=3)
    # the C entry refuses a tile wider than A's
    tw = bf._tw_tensor(64, -1, False, torch.float32, p.device)
    plan, nst = bf._plan_args(64)
    y = torch.empty_like(p)
    rc = emu_probes.bfly_f32(bf._ptr(p), bf._ptr(y), bf._ptr(tw),
                             tw.shape[1], 1, 64, 40, -1, plan, nst, 3, 1, 8,
                             ctypes.c_void_p(0))
    assert rc != 0


# A's routes at N = 512, 768, 1024: (complex shape, axis, route) at the
# lead, mid and last positions (post 24 and 12: vectors; post 5: single
# elements)
BFLY_ROUTES = {
    (1024, 'lead'): ((1024, 3, 8), 0, 'band'),
    (1024, 'mid'): ((2, 1024, 12), 1, 'band'),
    (1024, 'last'): ((3, 1024), 1, 'lines'),
    (512, 'lead'): ((512, 2, 4), 0, 'band'),
    (512, 'mid'): ((3, 512, 5), 1, 'band'),
    (512, 'last'): ((2, 512), 1, 'lines'),
    (768, 'lead'): ((768, 6), 0, 'band'),
    (768, 'mid'): ((2, 768, 8), 1, 'band'),
    (768, 'last'): ((2, 768), 1, 'lines'),
}


@pytest.mark.parametrize('key', list(BFLY_ROUTES), ids=str)
def test_bfly_kernel_routes(kernel_path, emu_probes, key):
    """bfly on A's line and band kernels (lines.cuh line_body and
    axis_band under the mode): every mode at N = 1024, copy and full at
    512 and 768, reps 1 (forward) and 2 (backward), against bfly_plain
    (copy and moves bit for bit, adds and full 5e-6), in place equal to
    out of place bit for bit; the band runs on clusters, the lines on
    warps."""
    shape, axis, route = BFLY_ROUTES[key]
    N = key[0]
    p = torch.from_numpy(_rand((2,) + shape, 45))
    assert tp.bfly_route(p, axis) == route
    modes = tp.MODES if N == 1024 else ('copy', 'full')
    lib = 'probe_bfly'
    c0 = _emu_counter(emu_probes, lib, 'emu_cluster_launches')
    for mode in modes:
        for reps, fwd in ((1, True), (2, False)):
            w0 = _emu_counter(emu_probes, lib, 'emu_syncwarps')
            got = tp.bfly(p, axis, mode, reps, out=_nan(p), forward=fwd)
            ref = tp.bfly_plain(p, axis, mode, reps, forward=fwd)
            what = (mode, reps)
            if mode in ('copy', 'moves'):
                assert torch.equal(got, ref), what
            else:
                assert _rel(got, ref) <= TOL, what
            q = p.clone()
            assert tp.bfly(q, axis, mode, reps, out=q, forward=fwd) is q
            assert torch.equal(q, got), what
            # the line kernel's stages meet at __syncwarp; copy has none
            warps = _emu_counter(emu_probes, lib, 'emu_syncwarps') - w0
            assert (warps > 0) == (route == 'lines' and mode != 'copy')
    clusters = _emu_counter(emu_probes, lib, 'emu_cluster_launches') - c0
    assert clusters == (4 * len(modes) if route == 'band' else 0)
    assert tp.LAUNCHES['bfly'] == 4 * len(modes)


@pytest.mark.parametrize('dtype,tol', [(np.float32, TOL),
                                       (np.float64, TOL64)])
def test_fma_chain_kernel(kernel_path, dtype, tol):
    """Element counts that leave the last block partly empty, every
    accumulator count, and in place."""
    name = 'fma_chain' + ('_f64' if dtype == np.float64 else '')
    for numel, acc in ((1000, 1), (3000, 4), (5000, 8), (600, 16)):
        x = torch.from_numpy(1.0 + 0.5 * _rand((numel,), 41, dtype))
        y = tp.fma_chain(x, 40, acc, a=FMA_A, b=FMA_B, out=_nan(x))
        assert _rel(y, tp.fma_chain_plain(x, 40, FMA_A, FMA_B)) <= tol
        got = tp.fma_chain(x, 40, acc)
        assert _rel(got, tp.fma_chain_plain(x, 40)) <= tol
        assert tp.fma_chain(x, 40, acc, out=x) is x
        assert torch.equal(x, got)
    assert tp.LAUNCHES[name] == 12


@pytest.mark.parametrize('dtype,tol', [(np.float32, TOL),
                                       (np.float64, TOL64)])
def test_fft_axis_out_kernel(kernel_path, dtype, tol):
    """A's own C entry in place and out of place at lead, mid and last
    positions: equal bit for bit, and held against its plain version."""
    name = 'fft_axis_p' + ('_f64' if dtype == np.float64 else '')
    for shape, axis in (((64, 3, 8), 0), ((2, 96, 6), 1), ((5, 128), 1)):
        p = torch.from_numpy(_rand((2,) + shape, 42, dtype))
        oop = bf.fft_axis_p(p, axis, out=torch.full_like(p, float('nan')))
        assert _rel(oop, bf.fft_axis_plain(p, axis)) <= tol
        q = p.clone()
        assert bf.fft_axis_p(q, axis, out=q) is q
        assert torch.equal(q, oop)
    assert bf.LAUNCHES[name] == 6


# ---------------------------------------------------------------------------
# the probe modules' Python on CPU tensors (plain versions); the card's
# timing replaced by one call each, so no time is taken here
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('name', ['dma', 'blockshape', 'lead_copy',
                                  'r3_profile', 'plane_copy',
                                  'pair_blocking', 'oop3d_dissect', 'moves',
                                  'slope', 'bfly_dissect', 'vpu_probe',
                                  'vpu_peak', 'long_n'])
def test_probe_module_runs_plain(name, monkeypatch):
    from mpi4py_fft_torch import probes
    from mpi4py_fft_torch.probes import _common
    assert probes.NAMES[probes.NAMES.index(name)] == name
    mod = probes.module(name)

    def once(step, k=1, reps=5, warm=2):
        for _ in range(k):
            step()
        return 1.0 + k
    monkeypatch.setattr(_common, 'chain_ms', once)
    for m in (mod, _common):
        for attr, value in (('card', lambda device=None: torch.device('cpu')),
                            ('chain_ms', once), ('sm_count', lambda dev: 1)):
            if hasattr(m, attr):
                monkeypatch.setattr(m, attr, value)
    if name == 'long_n':
        monkeypatch.setattr(mod, 'PLANE', 1 << 14)
    out = mod.run(n=8 if name == 'vpu_peak' else 16)
    assert out['probe'] == name and out['script'] == probes.SCRIPTS[name]
    assert out['device'] == 'cpu' and out['rows']
    for r in out['rows']:
        assert r['ms'] > 0 and 'library_ms' in r, r
    if name == 'moves':
        assert all(out['legal'].values()) and len(out['legal']) == 9
    if name == 'long_n':
        assert out['in_place_held'] == 6
    assert not any(tp.LAUNCHES.values())
    with pytest.raises(ValueError, match='no probe'):
        probes.module('nope')


def test_probes_need_a_card(monkeypatch):
    """Without a card the probes raise; they never time the CPU."""
    from mpi4py_fft_torch.probes import _common, dma
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA card'):
        dma.run()
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    with pytest.raises(RuntimeError, match='CUDA card'):
        _common.card('cpu')


def test_wrappers_refuse():
    """Shapes and types the kernels do not take raise before any launch."""
    x = torch.zeros((2, 8, 8))
    with pytest.raises(ValueError, match='even axis'):
        tp.move(torch.zeros((3, 5)), 1, 'odd')
    with pytest.raises(ValueError, match='one of'):
        tp.move(x, 0, 'shuffle')
    with pytest.raises(ValueError, match='mode'):
        tp.bfly(x, 0, 'half')
    with pytest.raises(ValueError, match='acc'):
        tp.fma_chain(x, 3, acc=3)
    with pytest.raises(ValueError, match='out'):
        tp.block_copy(x, (2, 4, 4), out=torch.zeros((2, 8, 4)))
    with pytest.raises(ValueError, match='do not match'):
        tp.block_copy(x, (2, 4, 4), x2=torch.zeros((2, 8, 4)))
    with pytest.raises(ValueError, match='engine'):
        bf.fft_axis_p(torch.zeros((2, 10, 3)), 0)
    assert tp.tile_lines(1024) == 8 and tp.tile_lines(256) == 32
    assert tp.tile_lines(768) == 8 and tp.tile_lines(2) == 1024
