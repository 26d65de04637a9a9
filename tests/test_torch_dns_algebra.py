"""The DNS solver's algebra kernels (mpi4py_fft_torch/ops/dns_algebra.py,
ops/csrc/dns_algebra.cu) on the CPU.

* The plain versions, which the wrappers run on CPU tensors, are the
  solver's eager expressions: each is held bit for bit against the
  expression it replaced, and the solver's step against the eager step
  (the same transforms, the algebra in eager ops), on padded and unpadded
  grids with odd and even spectral rows.
* Each wrapper refuses a wrong dtype, a non-contiguous tensor and
  mismatched shapes, and the first stage writes nothing of its inputs.
* The .cu source, compiled by g++ against tests/cuda_emu/cuda_runtime.h
  (the emulation of tests/test_torch_kernel_emu.py), runs through the
  wrappers: its index decode (i0, i1, i2) -> K read back from the curl,
  and each kernel against its plain version, bit for bit (both round each
  product, sum and quotient on its own, in the same order; g++ contracts
  no multiply-add under -ffp-contract=off).

On the card, tests/test_torch_cuda.py holds the kernels built by nvcc
against the plain versions.
"""
import ctypes
import pathlib
import re
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from mpi4py_fft_torch import PFFT
from mpi4py_fft_torch.examples import spectral_dns_solver as dns
from mpi4py_fft_torch.ops import _build
from mpi4py_fft_torch.ops import butterfly as bf
from mpi4py_fft_torch.ops import dns_algebra as da

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / 'mpi4py_fft_torch' / 'ops' / 'csrc'
EMU = pathlib.Path(__file__).resolve().parent / 'cuda_emu'
C128 = torch.complex128

# spectral shapes (n0, n1, n2h): the r2c half of 8^3 and 12^3 (odd rows),
# of 6^3 and 10^3 (even rows), a ragged one
SPECTRA = [(8, 8, 5), (6, 6, 4), (12, 12, 7), (10, 10, 6), (5, 7, 3)]
# physical grids: unpadded, 3/2-padded, an odd point count
GRIDS = [(8, 8, 8), (12, 12, 12), (9, 9, 9), (5, 7, 9)]


def _K(S, L=(2 * np.pi, 4 * np.pi, 4 * np.pi), n_last=None):
    """The solver's wavenumber tensors for a spectrum S (make_solver's
    construction; the last axis an r2c axis of n_last points)."""
    n_last = 2 * (S[2] - 1) if n_last is None else n_last
    k = [np.fft.fftfreq(n, 1. / n).astype(int) for n in S[:2]]
    k.append(np.fft.rfftfreq(n_last, 1. / n_last).astype(int))
    Lp = 2 * np.pi / np.asarray(L)
    return [torch.from_numpy((k[i] * Lp[i]).astype(float).reshape(
        [len(k[i]) if d == i else 1 for d in range(3)])) for i in range(3)]


def _c(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.complex(torch.randn(shape, generator=g, dtype=torch.float64),
                         torch.randn(shape, generator=g, dtype=torch.float64))


def _r(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float64)


def _inputs(S, seed=3):
    U = _c((3,) + S, seed)
    U0 = _c((3,) + S, seed + 1)
    U1 = _c((3,) + S, seed + 2)
    N = [_c(S, seed + 3 + j) for j in range(3)]
    return N, U, U0, U1


def _eager_rhs(N, U, K, nu):
    """The solver's projection and viscous term as the eager ops ran
    them: K^2 and K/K^2 held in full, the three forwards stacked."""
    K2 = K[0] * K[0] + K[1] * K[1] + K[2] * K[2]
    K2s = torch.where(K2 == 0, 1, K2)
    K_over_K2 = torch.stack([Ki / K2s for Ki in K])
    rhs = torch.stack(list(N))
    P_hat = torch.sum(rhs * K_over_K2, 0)
    rhs -= torch.stack([P_hat * Ki for Ki in K])
    rhs -= nu * K2 * U
    return rhs


# ---------------------------------------------------------------------------
# the plain versions are the eager expressions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('S', SPECTRA)
def test_curl_plain_is_the_eager_curl(S):
    K = _K(S)
    U = _c((3,) + S, 5)
    W = da.curl(U, K)
    eager = [1j * (K[1] * U[2] - K[2] * U[1]),
             1j * (K[2] * U[0] - K[0] * U[2]),
             1j * (K[0] * U[1] - K[1] * U[0])]
    assert W.shape == U.shape and W.dtype == C128
    for j in range(3):
        assert torch.equal(W[j], eager[j])


@pytest.mark.parametrize('shape', GRIDS)
def test_cross_plain_is_the_eager_cross(shape):
    u = [_r(shape, 10 + j) for j in range(3)]
    w = [_r(shape, 20 + j) for j in range(3)]
    eager = [u[1] * w[2] - u[2] * w[1],
             u[2] * w[0] - u[0] * w[2],
             u[0] * w[1] - u[1] * w[0]]
    ptrs = [t.data_ptr() for t in w]
    got = da.cross(u, w)
    assert [t.data_ptr() for t in got] == ptrs       # in place over w
    for j in range(3):
        assert torch.equal(got[j], eager[j])


@pytest.mark.parametrize('S', SPECTRA)
@pytest.mark.parametrize('stage', [0, 1, 3])
def test_project_rk_plain_is_the_eager_stage(S, stage):
    """Stage 0 on the caller's state (U = U0 = U1, new buffers), a middle
    stage in place, the last stage (no U_next) in place."""
    K = _K(S)
    nu, adt, bdt = 0.000625, 0.01 / 3, 0.005
    N, U, U0, U1 = _inputs(S)
    if stage == 0:
        U0 = U1 = U
    last = stage == 3
    dU = _eager_rhs(N, U, K, nu)
    want_next = None if last else U0 + bdt * dU
    want_1 = U1 + adt * dU
    before = U.clone(), U0.clone(), U1.clone()
    got_next, got_1 = da.project_rk(N, U, U0, U1, K, nu, adt,
                                    None if last else bdt,
                                    inplace=stage > 0)
    assert torch.equal(got_1, want_1)
    if last:
        assert got_next is None
    else:
        assert torch.equal(got_next, want_next)
    if stage == 0:
        assert all(torch.equal(a, b) for a, b in zip((U, U0, U1), before))
    else:
        assert got_1 is U1 and (last or got_next is U)
        assert torch.equal(U0, before[1])


def _eager_step(N, L, nu, dt, padding):
    """The solver's step as the eager ops ran it, on plans built as
    make_solver builds them."""
    fft = PFFT(None, list(N), collapse=False, dtype='d', device='cpu')
    fft_pad = (PFFT(None, list(N), padding=[1.5, 1.5, 1.5], dtype='d',
                    device='cpu') if padding else fft)
    K = _K(tuple(fft.shape(True)), L, N[-1])
    fwd, bck = fft_pad.forward.fn, fft_pad.backward.fn
    a = [1. / 6., 1. / 3., 1. / 3., 1. / 6.]
    b = [0.5, 0.5, 1.]

    def compute_rhs(U_hat):
        u = [bck(U_hat[j]) for j in range(3)]
        w = [bck(1j * (K[1] * U_hat[2] - K[2] * U_hat[1])),
             bck(1j * (K[2] * U_hat[0] - K[0] * U_hat[2])),
             bck(1j * (K[0] * U_hat[1] - K[1] * U_hat[0]))]
        rhs = [fwd(u[1] * w[2] - u[2] * w[1]),
               fwd(u[2] * w[0] - u[0] * w[2]),
               fwd(u[0] * w[1] - u[1] * w[0])]
        return _eager_rhs(rhs, U_hat, K, nu)

    def step(U_hat):
        U_hat0 = U_hat1 = U_hat
        for rk in range(4):
            dU = compute_rhs(U_hat)
            if rk < 3:
                U_hat = U_hat0 + b[rk] * dt * dU
            U_hat1 = U_hat1 + a[rk] * dt * dU
        return U_hat1
    return step


@pytest.mark.parametrize('n,padding', [(8, True), (6, False), (10, True)])
def test_solver_step_is_the_eager_step(n, padding):
    """Two steps of the solver from a seeded state (and its Taylor-Green
    one) give the eager step's states bit for bit, and leave the state
    they were given as it was."""
    N = (n,) * 3
    L = (2 * np.pi, 4 * np.pi, 4 * np.pi)
    fft, U_tg, step, _ = dns.make_solver(N=N, L=L, padding=padding,
                                         device='cpu')
    eager = _eager_step(N, L, 0.000625, 0.01, padding)
    S = tuple(fft.shape(True))
    for U in (U_tg, 0.1 * _c((3,) + S, 7)):
        V = W = U
        kept = U.clone()
        for _ in range(2):
            V, W = step(V), eager(W)
            assert torch.equal(V, W)
        assert torch.equal(U, kept)


# ---------------------------------------------------------------------------
# what the wrappers refuse
# ---------------------------------------------------------------------------

S0 = (6, 6, 4)


def _refusals():
    K = _K(S0)
    N, U, U0, U1 = _inputs(S0)
    u = [_r((6, 6, 6), j) for j in range(3)]
    w = [_r((6, 6, 6), 3 + j) for j in range(3)]
    Kt = [Ki.clone() for Ki in K]
    Kt[2] = Kt[2].float()
    return {
        'curl_dtype': (TypeError, lambda: da.curl(U.to(torch.complex64), K)),
        'curl_K_dtype': (TypeError, lambda: da.curl(U, Kt)),
        'curl_noncontiguous': (ValueError, lambda: da.curl(
            U.transpose(1, 2), K)),
        'curl_shape': (ValueError, lambda: da.curl(U[:2], K)),
        'curl_K_shape': (ValueError, lambda: da.curl(U, [K[0], K[2], K[1]])),
        'cross_dtype': (TypeError, lambda: da.cross(
            [t.float() for t in u], [t.float() for t in w])),
        'cross_noncontiguous': (ValueError, lambda: da.cross(
            u, [w[0].transpose(0, 2), w[1], w[2]])),
        'cross_shape': (ValueError, lambda: da.cross(u, [w[0][:5], w[1],
                                                         w[2]])),
        'cross_aliased': (ValueError, lambda: da.cross(u, [w[0], w[1],
                                                           u[0]])),
        'project_dtype': (TypeError, lambda: da.project_rk(
            [n.to(torch.complex64) for n in N], U, U0, U1, K, 0.1, 0.2,
            0.3)),
        'project_noncontiguous': (ValueError, lambda: da.project_rk(
            N, U, U0.transpose(2, 3).contiguous().transpose(2, 3), U1, K,
            0.1, 0.2, 0.3)),
        'project_shape': (ValueError, lambda: da.project_rk(
            [N[0], N[1], N[2][:, :, :3]], U, U0, U1, K, 0.1, 0.2, 0.3)),
        'project_state_shape': (ValueError, lambda: da.project_rk(
            N, U, U0[:, :5], U1, K, 0.1, 0.2, 0.3)),
        'project_in_place_on_one_buffer': (ValueError, lambda: da.project_rk(
            N, U, U0, U, K, 0.1, 0.2, 0.3, inplace=True)),
    }


@pytest.mark.parametrize('case', list(_refusals()))
def test_a_wrapper_refuses(case):
    exc, call = _refusals()[case]
    with pytest.raises(exc):
        call()


# ---------------------------------------------------------------------------
# the .cu source in the g++ emulation
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def emu_lib(tmp_path_factory):
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++ to compile the kernel emulation')
    d = tmp_path_factory.mktemp('dns_emu')
    src = (CSRC / 'dns_algebra.cu').read_text()
    src = re.sub(r'(\w+)<<<(.*?)>>>\(',
                 lambda m: f'emu_launch({m.group(1)}, {m.group(2)}, ', src,
                 flags=re.S)
    (d / 'dns_algebra.cpp').write_text(src)
    out = subprocess.run(
        [gxx, '-std=c++20', '-O1', '-ffp-contract=off', '-shared', '-fPIC',
         '-pthread', '-I', str(EMU), '-o', str(d / 'dns_algebra.so'),
         str(d / 'dns_algebra.cpp')],
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    lib = ctypes.CDLL(str(d / 'dns_algebra.so'))
    fns = {}
    for name, argtypes in _build._ENTRIES['dns_algebra'].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name[len('mff_'):]] = fn
    return types.SimpleNamespace(error_string=str, **fns)


@pytest.fixture
def emulated(emu_lib, monkeypatch):
    """The wrappers launch the emulated kernels on CPU tensors."""
    def launch(what, fn, t, *args, nbytes, route=None):
        rc = fn(*args, ctypes.c_void_p(0))
        if rc != 0:
            raise RuntimeError(f"{what}: emulated launch failed: {rc}")
        bf.LAUNCHES[what] += 1

    monkeypatch.setattr(_build, '_kernels', emu_lib)
    monkeypatch.setattr(bf, '_launch', launch)
    monkeypatch.setattr(da, '_kernel', lambda t: True)
    bf.reset_launches()
    yield
    bf.reset_launches()


def _plain(monkeypatch, fn, *args, **kw):
    """The plain version through the same wrapper."""
    with monkeypatch.context() as m:
        m.setattr(da, '_kernel', lambda t: False)
        return fn(*args, **kw)


@pytest.mark.parametrize('S', [(5, 7, 3), (4, 6, 9)])
def test_emulated_decode_reads_each_wavenumber(S, emulated):
    """With U = (0, 0, 1) the curl is (i K1, -i K0, 0); with U = (0, 1,
    0) it is (-i K2, 0, i K0): the K read at each element (i0, i1, i2),
    on shapes with n0, n1 and n2h all different."""
    K = [torch.arange(1, n + 1, dtype=torch.float64).reshape(
        [n if d == i else 1 for d in range(3)]) * 10 ** (2 * i)
        for i, n in enumerate(S)]
    full = [Ki.expand(S) for Ki in K]
    zero = torch.zeros(S, dtype=torch.float64)
    for hot, want in ((2, (full[1], -full[0], zero)),
                      (1, (-full[2], zero, full[0]))):
        U = torch.zeros((3,) + S, dtype=C128)
        U[hot] = 1
        W = da.curl(U, K)
        for j in range(3):
            assert torch.equal(W[j].imag, want[j])
            assert not W[j].real.any()
    assert bf.LAUNCHES['dns_curl_f64'] == 2


@pytest.mark.parametrize('S', SPECTRA)
def test_emulated_curl_vs_plain(S, emulated, monkeypatch):
    K = _K(S)
    U = _c((3,) + S, 11)
    got = da.curl(U, K)
    assert bf.LAUNCHES['dns_curl_f64'] == 1
    assert torch.equal(got, _plain(monkeypatch, da.curl, U, K))


@pytest.mark.parametrize('shape,offset', [((12, 12, 12), 0), ((5, 7, 9), 0),
                                          ((8, 8, 8), 1), ((5, 7, 9), 1)])
def test_emulated_cross_vs_plain(shape, offset, emulated, monkeypatch):
    """16-byte vectors (an odd count: the last point alone), and single
    points where the grids start off a 16-byte boundary."""
    n = int(np.prod(shape))

    def grid(seed):
        return _r((n + offset,), seed)[offset:].view(shape)
    u = [grid(30 + j) for j in range(3)]
    w = [grid(40 + j) for j in range(3)]
    assert all((t.data_ptr() % 16 == 0) == (offset == 0) for t in u + w)
    want = _plain(monkeypatch, da.cross, u, [t.clone() for t in w])
    got = da.cross(u, w)
    assert bf.LAUNCHES['dns_cross_f64'] == 1
    for j in range(3):
        assert torch.equal(got[j], want[j])


@pytest.mark.parametrize('S', SPECTRA)
@pytest.mark.parametrize('stage', [0, 1, 3])
def test_emulated_project_rk_vs_plain(S, stage, emulated, monkeypatch):
    """The three stage kinds of the solver's step; the first stage writes
    none of its inputs, later stages write in place."""
    K = _K(S)
    nu, adt, bdt = 0.000625, 0.01 / 6, 0.01
    N, U, U0, U1 = _inputs(S, 50)
    if stage == 0:
        U0 = U1 = U
    last = stage == 3
    args = (N, U, U0, U1, K, nu, adt, None if last else bdt)
    cl = [t.clone() for t in (U, U0, U1)]
    want_next, want_1 = _plain(monkeypatch, da.project_rk, N, *cl[:3],
                               *args[4:], inplace=stage > 0)
    before = [t.clone() for t in (U, U0, U1)]
    got_next, got_1 = da.project_rk(*args, inplace=stage > 0)
    assert bf.LAUNCHES['dns_project_rk_f64'] == 1
    assert torch.equal(got_1, want_1)
    assert (got_next is None) == last
    if not last:
        assert torch.equal(got_next, want_next)
    if stage == 0:
        assert all(torch.equal(a, b) for a, b in zip((U, U0, U1), before))
        assert got_1.data_ptr() != U.data_ptr()
        assert got_next.data_ptr() != U.data_ptr()
    else:
        assert got_1 is U1 and (last or got_next is U)
        assert torch.equal(U0, before[1])


def test_emulated_kernels_in_the_solver_step(emulated):
    """The solver's step with the emulated kernels (the transforms on
    their plain versions) is the plain step, bit for bit: 12 launches of
    the algebra a step."""
    fft, U, step, _ = dns.make_solver(N=(8, 8, 8), padding=True,
                                      device='cpu')
    got = step(U)
    assert bf.LAUNCHES == {k: 4 if k.startswith('dns_') else 0
                           for k in bf.LAUNCHES}
    with pytest.MonkeyPatch.context() as m:
        m.setattr(da, '_kernel', lambda t: False)
        want = step(U)
    assert torch.equal(got, want)
