"""The port's kernel modules (mpi4py_fft_torch/ops/butterfly.py) against
the JAX package on the CPU.

On CPU tensors the port's wrappers run their plain PyTorch versions; the
JAX side runs its Pallas kernels in interpret mode, called directly as
tests/test_butterfly.py does.  Both get the same numpy inputs, made from a
seed.  Tolerances: the stage-plan and twiddle tables bit for bit, the
kernels to relative L2 5e-6 (the JAX kernel tolerance,
tests/test_butterfly.py:44).  The CUDA kernels themselves are held against
these plain versions on the card by chip_smoke.py.
"""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from mpi4py_fft_tpu.ops import matfft as jmatfft
from mpi4py_fft_tpu.ops import pallas_butterfly as pb
from mpi4py_fft_torch.ops import butterfly as tb
from mpi4py_fft_torch.ops import matfft as tmatfft
from mpi4py_fft_torch.ops import _build

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 5e-6
# every length of fft_axis_p, and the long ones of the pair kernel, whose
# plans are (16, 16, 2, 3) and (16, 16, 8)
LENGTHS = [n for n in range(2, 1025) if pb._supported_len(n)] + [1536, 2048]


def _rel(got, ref):
    got = np.asarray(got)
    ref = np.asarray(ref)
    wide = np.complex128 if np.iscomplexobj(got) or np.iscomplexobj(ref) \
        else np.float64
    got, ref = got.astype(wide), ref.astype(wide)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _both(a):
    """The same numpy array for both packages."""
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize('N', LENGTHS)
def test_tables_bit_for_bit(N):
    assert tb._supported_len(N)
    assert tb._stage_plan(N) == pb._stage_plan(N)
    assert tb._tw_len(N) == pb._tw_len(N)
    for sign in (-1, 1):
        for dt in ('float32', 'float64'):
            np.testing.assert_array_equal(tb._tw_pack(N, sign, dt),
                                          pb._tw_pack(N, sign, dt))
            if N // 2 >= 2:
                np.testing.assert_array_equal(
                    tb._tw_pack_packed(N, sign, dt),
                    pb._tw_pack_packed(N, sign, dt))


@pytest.mark.parametrize('sign', [-1, 1])
def test_four_step_twiddle_bit_for_bit(sign):
    for dt in ('float32', 'float64'):
        np.testing.assert_array_equal(tmatfft._twiddle(4, 1024, sign, dt),
                                      jmatfft._twiddle(4, 1024, sign, dt))


def test_supported_lengths_match():
    for n in range(1, 2049):
        assert tb._supported_len(n) == pb._supported_len(n), n


# shapes inside the JAX TPU gates: last, lead, mid, and a radix-3 length
A_CASES = [((1024, 64), 1), ((64, 8, 128), 0), ((16, 64, 128), 1),
           ((1024, 96), 1)]


@pytest.mark.parametrize('shape,axis', A_CASES)
@pytest.mark.parametrize('forward,scale', [(True, None), (False, None),
                                           (True, 0.125)])
def test_fft_axis_vs_pallas(shape, axis, forward, scale):
    assert pb.supported_axis(shape, axis, np.float32)
    x = np.random.default_rng(1).standard_normal((2,) + shape) \
        .astype(np.float32)
    xj, xt = _both(x)
    ref = pb.fft_axis_p(xj, axis, forward, interpret=True, scale=scale)
    got = tb.fft_axis_p(xt, axis, forward, scale=scale)
    assert got.shape == xt.shape and got.dtype == torch.float32
    assert _rel(got, ref) < TOL


@pytest.mark.parametrize('shape,axis,kw', [
    ((1024, 64), 1, dict(hext=40, trunc=20, scale=0.5)),
    ((16, 64, 128), 1, dict()),
])
def test_rfft_axis_vs_pallas(shape, axis, kw):
    assert pb.supported_r2c(shape, axis, np.float32)
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    xj, xt = _both(x)
    ref = pb.rfft_axis_p(xj, axis, interpret=True, **kw)
    got = tb.rfft_axis_p(xt, axis, **kw)
    assert tuple(got.shape) == tuple(ref.shape)
    assert _rel(got, ref) < TOL


def _real_ends(h, axis, n):
    """A planar half spectrum (2, ...) with the imaginary parts of its DC
    row and (even n) Nyquist row along ``axis`` zeroed, where present:
    its projection onto the spectra of real lines, on which every c2r
    convention agrees."""
    h = h.copy()
    for k in (0, n // 2) if n % 2 == 0 else (0,):
        if k < h.shape[1 + axis]:
            idx = [1] + [slice(None)] * (h.ndim - 1)
            idx[1 + axis] = k
            h[tuple(idx)] = 0
    return h


@pytest.mark.parametrize('shape,axis,n,scale', [
    ((1024, 20), 1, 64, 0.25),       # short: Hermitian zero-padding
    ((16, 40, 128), 1, 64, None),    # long: rows past n//2+1 ignored
])
def test_irfft_axis_vs_pallas(shape, axis, n, scale):
    """The port's C on a random half spectrum against the JAX kernel C on
    its projection (``_real_ends``): the port reads the DC and Nyquist
    rows as real, as numpy and the JAX package's CPU path do, and the
    JAX kernel is exact on a projected spectrum."""
    assert pb.supported_c2r(shape, axis, n, np.float32)
    h = np.random.default_rng(3).standard_normal((2,) + shape) \
        .astype(np.float32)
    hj = jnp.asarray(_real_ends(h, axis, n))
    ht = torch.from_numpy(h)
    ref = pb.irfft_axis_p(hj, axis, n, scale=scale, interpret=True)
    got = tb.irfft_axis_p(ht, axis, n, scale=scale)
    assert tuple(got.shape) == tuple(ref.shape)
    assert _rel(got, ref) < TOL


# shapes the JAX gates refuse (ragged pre/post, tiny and long lengths):
# the plain versions against numpy in float64
RAGGED = [((3, 96, 5), 1), ((5, 6, 7), 1), ((2,), 0), ((7, 768), 1),
          ((1024, 3), 0), ((3, 4, 2), 2)]


def _hermitian(h, axis, n):
    """Make a half spectrum consistent: real DC and (even n) Nyquist."""
    h = h.copy()
    idx = [slice(None)] * h.ndim
    idx[axis] = 0
    h[tuple(idx)] = h[tuple(idx)].real
    if h.shape[axis] > n // 2:
        idx[axis] = n // 2
        h[tuple(idx)] = h[tuple(idx)].real
    return h


@pytest.mark.parametrize('shape,axis', RAGGED)
def test_ragged_vs_numpy(shape, axis):
    assert not pb.supported_axis(shape, axis, np.float32)
    rng = np.random.default_rng(4)
    N = shape[axis]
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    p = torch.from_numpy(np.stack([z.real, z.imag]).astype(np.float32))
    for fwd in (True, False):
        y = tb.fft_axis_p(p, axis, fwd).numpy()
        ref = np.fft.fft(z, axis=axis) if fwd \
            else np.fft.ifft(z, axis=axis) * N
        assert _rel(y[0] + 1j * y[1], ref) < TOL
    x = rng.standard_normal(shape)
    y = tb.rfft_axis_p(torch.from_numpy(x.astype(np.float32)), axis).numpy()
    assert _rel(y[0] + 1j * y[1], np.fft.rfft(x, axis=axis)) < TOL
    sh = list(shape)
    sh[axis] = N // 2 + 1
    h = _hermitian(rng.standard_normal(sh) + 1j * rng.standard_normal(sh),
                   axis, N)
    hp = torch.from_numpy(np.stack([h.real, h.imag]).astype(np.float32))
    y = tb.irfft_axis_p(hp, axis, N).numpy()
    assert _rel(y, np.fft.irfft(h, n=N, axis=axis) * N) < TOL


def test_f64_plain_vs_numpy():
    """The plain versions in float64 reach float64 accuracy."""
    rng = np.random.default_rng(5)
    shape, axis = (6, 768, 3), 1
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    y = tb.fft_axis_p(torch.from_numpy(np.stack([z.real, z.imag])),
                      axis).numpy()
    assert _rel(y[0] + 1j * y[1], np.fft.fft(z, axis=axis)) < 1e-12
    x = rng.standard_normal(shape)
    y = tb.rfft_axis_p(torch.from_numpy(x), axis).numpy()
    assert _rel(y[0] + 1j * y[1], np.fft.rfft(x, axis=axis)) < 1e-12


def test_length_gates_raise():
    p = torch.zeros((2, 4, 10, 3))
    assert not tb.supported_axis(p.shape[1:], 1)
    assert tb.supported_axis((3, 96, 5), 1)          # no tile gate
    assert tb.supported_c2r((4, 2, 3), 1, 768)
    assert not tb.supported_c2r((4, 2, 3), 1, 2048)
    # the kernels refuse other lengths, which the engine (matfft) takes
    with pytest.raises(ValueError, match='engine'):
        tb.fft_axis_p(p, 1)
    with pytest.raises(ValueError, match='engine'):
        tb.fft_axis_p(torch.zeros((2, 2048)), 0)
    with pytest.raises(ValueError, match='engine'):
        tb.rfft_axis_p(torch.zeros((4, 10)), 1)
    with pytest.raises(ValueError, match='engine'):
        tb.irfft_axis_p(torch.zeros((2, 4, 6)), 1, 10)


def test_wrapper_checks_raise():
    with pytest.raises(ValueError):                  # not planar
        tb.fft_axis_p(torch.zeros((3, 8)), 0)
    with pytest.raises(ValueError):                  # hext below the rows
        tb.rfft_axis_p(torch.zeros((4, 16)), 1, hext=5)
    with pytest.raises(TypeError):
        tb.fft_axis_p(torch.zeros((2, 8), dtype=torch.int32), 0)
    # a device that is neither the CPU nor CUDA: no plain version, no kernel
    with pytest.raises(ValueError, match='meta'):
        tb.fft_axis_p(torch.zeros((2, 8), device='meta'), 0)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, 'find_nvcc', lambda: None)
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'torch_kernels')
    monkeypatch.setattr(_build, '_kernels', None)
    with pytest.raises(RuntimeError, match='nvcc'):
        _build.load()


def test_launch_counters_untouched_on_cpu():
    tb.reset_launches()
    tb.fft_axis_p(torch.zeros((2, 4, 8)), 1)
    tb.rfft_axis_p(torch.zeros((4, 8)), 1)
    tb.irfft_axis_p(torch.zeros((2, 4, 5)), 1, 8)
    tb.fft_axis2_p(torch.zeros((2, 4, 8)), torch.zeros((2, 4, 8)), 0)
    tb.fft_axis_pair_p(torch.zeros((2, 2048, 2)), 0)
    f64 = torch.float64
    tb.fft_axis_p(torch.zeros((2, 4, 8), dtype=f64), 1)
    tb.rfft_axis_p(torch.zeros((4, 8), dtype=f64), 1)
    tb.irfft_axis_p(torch.zeros((2, 4, 5), dtype=f64), 1, 8)
    tb.fft_axis_tp(torch.zeros((2, 4, 12)), 1, trunc=8)
    tb.fft_axis_tp(torch.zeros((2, 4, 8), dtype=f64), 1, pad=12)
    from mpi4py_fft_torch.ops import fft2stage
    fft2stage.fft2stage_p(torch.zeros((2, 3, 640)), -1)
    tb.fft_plane_p(torch.zeros((2, 3, 8, 16)))
    tb.fft_plane_large_p(torch.zeros((2, 3, 8, 16)))
    tb.dct2_axis_p(torch.zeros((4, 8)), 1)
    tb.dct3_axis_p(torch.zeros((8, 4), dtype=f64), 0)
    from mpi4py_fft_torch.ops import dns_algebra as da
    U = torch.zeros((3, 4, 2, 3), dtype=torch.complex128)
    K = [torch.zeros(s, dtype=f64) for s in ((4, 1, 1), (1, 2, 1), (1, 1, 3))]
    da.curl(U, K)
    da.cross([torch.zeros((2, 3), dtype=f64) for _ in range(3)],
             [torch.zeros((2, 3), dtype=f64) for _ in range(3)])
    da.project_rk(list(U), U, U, U, K, 0.1, 0.2, 0.3)
    assert tb.LAUNCHES == {'fft_axis_p': 0, 'rfft_axis_p': 0,
                           'irfft_axis_p': 0, 'fft_axis2_p': 0,
                           'fft_axis_pair_p': 0, 'fft_axis_p_f64': 0,
                           'rfft_axis_p_f64': 0, 'irfft_axis_p_f64': 0,
                           'fft_axis_tp': 0, 'fft_axis_tp_f64': 0,
                           'fft2stage_p': 0, 'fft_plane_p': 0,
                           'fft_plane_large_p': 0, 'dct2_axis_p': 0,
                           'dct3_axis_p': 0, 'dct2_axis_p_f64': 0,
                           'dct3_axis_p_f64': 0, 'dns_curl_f64': 0,
                           'dns_cross_f64': 0, 'dns_project_rk_f64': 0}


def test_import_isolation():
    """Importing the port loads neither JAX nor the JAX package."""
    code = ("import sys, mpi4py_fft_torch; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'mpi4py_fft_tpu'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True,
                   timeout=120)


def _port_sources():
    return sorted((ROOT / 'mpi4py_fft_torch').rglob('*.py')) + \
        [ROOT / 'chip_smoke.py']


@pytest.mark.parametrize('path', _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_torch_fft(path):
    """No import of JAX or the JAX package anywhere in the port or
    chip_smoke.py; torch.fft only as the oracle in chip_smoke.py."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or '']
            if node.module == 'torch':
                names += ['torch.' + a.name for a in node.names]
        for n in names:
            assert n != 'jax' and not n.startswith('jax.'), (path, n)
            assert not n.startswith('mpi4py_fft_tpu'), (path, n)
            if path.name != 'chip_smoke.py':
                assert not n.startswith('torch.fft'), (path, n)
        if path.name != 'chip_smoke.py' and isinstance(node, ast.Attribute):
            assert not (node.attr == 'fft' and isinstance(node.value, ast.Name)
                        and node.value.id == 'torch'), path
