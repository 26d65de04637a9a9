"""Tests of the port that need a CUDA card (marked ``cuda``; they skip
where there is none).  They import nothing of JAX, so that they run on a
machine with the card alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX's CPU mesh.)
"""
import numpy as np
import pytest
import torch

from mpi4py_fft_torch.examples import spectral_dns_solver as dns
from mpi4py_fft_torch.ops import butterfly as tb


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels launch or raise there')
    return torch.device('cuda', torch.cuda.current_device())


def _rel(got, ref):
    got = got.double().cpu().numpy()
    ref = ref.double().cpu().numpy()
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


@pytest.mark.cuda
def test_tp_wrapper_on_cuda(card):
    """No fallback on the card: fft_axis_tp launches, counted, and agrees
    with its plain version (5e-6, f32; 2e-13, f64), or raises for a
    tensor the kernel does not take."""
    p = torch.zeros((2, 4, 48), device=card)
    with pytest.raises(TypeError, match='float32 and float64'):
        tb.fft_axis_tp(p.half(), 1, trunc=32)
    with pytest.raises(ValueError, match='contiguous'):
        tb.fft_axis_tp(torch.zeros((2, 48, 4), device=card).transpose(1, 2),
                       1, trunc=32)
    with pytest.raises(ValueError, match='engine'):
        tb.fft_axis_tp(torch.zeros((2, 4, 2048), device=card), 1,
                       trunc=1365)
    for dtype, tol in ((torch.float32, 5e-6), (torch.float64, 2e-13)):
        name = 'fft_axis_tp' + ('_f64' if dtype == torch.float64 else '')
        x = torch.randn((2, 8, 48, 5), device=card, dtype=dtype)
        c0 = tb.LAUNCHES[name]
        got = tb.fft_axis_tp(x, 1, trunc=31, scale=0.5)
        assert tb.LAUNCHES[name] == c0 + 1
        assert _rel(got, tb.fft_axis_tp_plain(x, 1, trunc=31,
                                              scale=0.5)) <= tol
        q = torch.randn((2, 8, 32, 5), device=card, dtype=dtype)
        got = tb.fft_axis_tp(q, 1, False, pad=48)
        assert tb.LAUNCHES[name] == c0 + 2
        assert _rel(got, tb.fft_axis_tp_plain(q, 1, False, pad=48)) <= tol


@pytest.mark.cuda
def test_dns_solver_energy_anchor(card):
    """The reference's Taylor-Green energy at 64^3, T = 0.1 (10 steps),
    unpadded, on the port's kernels (the reference DNS solver on PFFT)."""
    c0 = dict(tb.LAUNCHES)
    k = dns.run(N=(64, 64, 64), T=0.1, dt=0.01, verbose=False)
    assert round(k - dns.ENERGY_64, 7) == 0, k
    assert tb.LAUNCHES['fft_axis_p_f64'] > c0['fft_axis_p_f64']


@pytest.mark.cuda
def test_serial_fft_padded_stage_on_cuda(card):
    """The serial FFT's complex stage functions and buffer call on the
    card: a padded c2c stage is one E launch each way, and agrees with the
    same plan on the CPU (2e-13, f64)."""
    from mpi4py_fft_torch import libfft
    shape, pad = (4, 48, 6), [1.5] * 3
    g = libfft.FFT(shape, (1,), 'D', pad, device=card)
    h = libfft.FFT(shape, (1,), 'D', pad, device='cpu')
    rng = np.random.default_rng(7)
    u = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    c0 = tb.LAUNCHES['fft_axis_tp_f64']
    y = g.forward_fn(torch.from_numpy(u).to(card))
    z = g.backward_fn(y)
    back = g.backward(g.forward(u)).copy()
    assert tb.LAUNCHES['fft_axis_tp_f64'] == c0 + 4
    ref = h.forward_fn(torch.from_numpy(u))
    assert _rel(torch.view_as_real(y), torch.view_as_real(ref)) <= 2e-13
    ref = h.backward_fn(ref)
    assert _rel(torch.view_as_real(z), torch.view_as_real(ref)) <= 2e-13
    want = h.backward(h.forward(u))
    assert np.linalg.norm(back - want) <= 2e-13 * np.linalg.norm(want)


@pytest.mark.cuda
def test_any_extent_kernels_on_cuda(card):
    """J on the card at every S and both signs, H and I at both signs with
    a scale: launched, counted, and within 5e-6 of their plain versions;
    the engine runs a 640-long last axis through one J launch, and a CUDA
    tensor of a J length that is float64 takes the engine, not J."""
    from mpi4py_fft_torch.ops import fft2stage, matfft
    g = torch.Generator(device=card).manual_seed(3)
    for S in range(1, 9):
        p = torch.randn((2, 13, 128 * S), generator=g, device=card)
        for sign in (-1, 1):
            c0 = tb.LAUNCHES['fft2stage_p']
            got = fft2stage.fft2stage_p(p, sign)
            assert tb.LAUNCHES['fft2stage_p'] == c0 + 1
            assert _rel(got, fft2stage.fft2stage_plain(p, sign)) <= 5e-6
    with pytest.raises(TypeError, match='float32'):
        fft2stage.fft2stage_p(torch.zeros((2, 3, 640), device=card,
                                          dtype=torch.float64), -1)
    for shape in ((3, 256, 256), (2, 1024, 1024), (4, 8, 2)):
        p = torch.randn((2,) + shape, generator=g, device=card)
        names = ['fft_plane_large_p'] + \
            (['fft_plane_p'] if tb.supported_plane(shape, p.dtype) else [])
        for name in names:
            fn = getattr(tb, name)
            plain = getattr(tb, name[:-2] + '_plain')
            for fwd, sc in ((True, None), (False, 0.25)):
                c0 = tb.LAUNCHES[name]
                got = fn(p, fwd, scale=sc)
                assert tb.LAUNCHES[name] == c0 + 1
                assert _rel(got, plain(p, fwd, sc)) <= 5e-6
    p = torch.randn((2, 6, 640), generator=g, device=card)
    c0 = dict(tb.LAUNCHES)
    got = matfft.fft1d_p(p, 1)
    assert {k: v - c0[k] for k, v in tb.LAUNCHES.items() if v != c0[k]} \
        == {'fft2stage_p': 1}
    ref = torch.fft.fft(torch.complex(p[0], p[1]).cpu().to(torch.complex128),
                        dim=1)
    assert _rel(got, torch.stack([ref.real, ref.imag])) <= 5e-6
    c0 = dict(tb.LAUNCHES)
    got = matfft.fft1d_p(p.double(), 1)
    assert tb.LAUNCHES == c0
    assert _rel(got, torch.stack([ref.real, ref.imag])) <= 2e-13


@pytest.mark.cuda
def test_engine_products_full_f32_on_cuda(card, monkeypatch):
    """With TF32 switched on for the process, the engine's cuBLAS products
    (a 640-long lead axis: 32 x 20 mixed radix) stay within 5e-6 of a
    float64 reference; TF32 would miss it by orders of magnitude."""
    from mpi4py_fft_torch.ops import matfft
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', True)
    g = torch.Generator(device=card).manual_seed(4)
    p = torch.randn((2, 640, 96), generator=g, device=card)
    got = matfft.fft1d_p(p, 0)
    ref = torch.fft.fft(torch.complex(p[0], p[1]).to(torch.complex128), dim=0)
    assert _rel(got, torch.stack([ref.real, ref.imag])) <= 5e-6
    assert torch.backends.cuda.matmul.allow_tf32 is True
