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
from mpi4py_fft_torch.ops import dns_algebra as da


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
def test_c2r_lines_f32_on_cuda(card):
    """C on a float32 768-point last axis (the c2r line kernel): full and
    3/2-rule spectra, with and without a scale, into NaN-filled outputs,
    within 5e-6 of the plain version, one launch each."""
    g = torch.Generator(device=card).manual_seed(6)
    for hin, sc in ((385, None), (257, 1.0 / 768)):
        h = torch.randn((2, 40, 6, hin), generator=g, device=card)
        torch.full((40, 6, 768), float('nan'), device=card)
        c0 = tb.LAUNCHES['irfft_axis_p']
        got = tb.irfft_axis_p(h, 2, 768, scale=sc)
        assert tb.LAUNCHES['irfft_axis_p'] == c0 + 1
        assert bool(torch.isfinite(got).all())
        assert _rel(got, tb.irfft_axis_plain(h, 2, 768, scale=sc)) <= 5e-6


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_c2r_random_spectrum_vs_numpy_on_cuda(card, dtype):
    """C and C64 on random half spectra, whose DC and Nyquist rows have
    imaginary parts, at n = 4, 12, 768 and 1024: the line kernel (the
    last axis) and the tile (an inner axis), exact, long and short
    spectra, against numpy.fft.irfft(...) * n (5e-6, f32; 2e-13, f64)."""
    tol = 5e-6 if dtype == torch.float32 else 2e-13
    g = torch.Generator(device=card).manual_seed(8)
    for n in (4, 12, 768, 1024):
        nh = n // 2 + 1
        for hin in (nh, nh + 2, nh - 1, nh - 2):
            for post in (1, 3):
                h = torch.randn((2, 5, hin, post), generator=g,
                                device=card, dtype=dtype)
                got = tb.irfft_axis_p(h, 1, n)
                c = h.double().cpu().numpy()
                c = c[0] + 1j * c[1]
                if hin < nh:
                    z = np.zeros((5, nh, post), dtype=c.dtype)
                    z[:, :hin] = c
                    if hin % 2 == 0:
                        z[:, hin - 1] = 0.5 * z[:, hin - 1].real
                    c = z
                ref = np.fft.irfft(c[:, :nh], n, axis=1) * n
                assert _rel(got, torch.from_numpy(ref)) <= tol, \
                    (n, hin, post)


@pytest.mark.cuda
def test_tp64_band_on_cuda(card):
    """E64 at N = 768 on a (2, 768, 4, 6) volume's lead axis (the column
    band kernel): truncation to 512 and 511 rows and padding back, with
    and without a scale, within 2e-13 of the plain version."""
    g = torch.Generator(device=card).manual_seed(7)
    p = torch.randn((2, 768, 4, 6), generator=g, device=card,
                    dtype=torch.float64)
    for nt in (512, 511):
        q = torch.randn((2, nt, 4, 6), generator=g, device=card,
                        dtype=torch.float64)
        for sc in (None, 1.0 / 768):
            c0 = tb.LAUNCHES['fft_axis_tp_f64']
            got = tb.fft_axis_tp(p, 0, trunc=nt, scale=sc)
            assert _rel(got, tb.fft_axis_tp_plain(p, 0, trunc=nt,
                                                  scale=sc)) <= 2e-13
            got = tb.fft_axis_tp(q, 0, False, pad=768, scale=sc)
            assert _rel(got, tb.fft_axis_tp_plain(q, 0, False, pad=768,
                                                  scale=sc)) <= 2e-13
            assert tb.LAUNCHES['fft_axis_tp_f64'] == c0 + 2


@pytest.mark.cuda
def test_tp32_lines_band_on_cuda(card):
    """E (float32) at the m3 plans' shapes on the card: the column band
    kernel at the 'f' plan's axis-1 pass (single elements, post 257) and
    axis-0 pass (vectors), the line kernel at the 'F' plan's last axis;
    each truncating to 512 rows and padding back, with and without a
    scale, one launch a call, within 5e-6 of the plain version on the
    first and last slabs of 16 rows off the pass axis."""
    g = torch.Generator(device=card).manual_seed(8)
    for shape, ax in (((2, 768, 768, 257), 1), ((2, 768, 512, 257), 0),
                      ((2, 768, 768, 768), 2)):
        p = torch.rand(shape, generator=g, device=card) - 0.5
        sd = 2 if ax == 0 else 1
        for sc in (None, 1.0 / 768):
            c0 = tb.LAUNCHES['fft_axis_tp']
            k = tb.fft_axis_tp(p, ax, trunc=512, scale=sc)
            y = tb.fft_axis_tp(k, ax, False, pad=768, scale=sc)
            assert tb.LAUNCHES['fft_axis_tp'] == c0 + 2
            for i in (0, p.shape[sd] - 16):
                assert _rel(k.narrow(sd, i, 16), tb.fft_axis_tp_plain(
                    p.narrow(sd, i, 16), ax, trunc=512, scale=sc)) <= 5e-6
                assert _rel(y.narrow(sd, i, 16), tb.fft_axis_tp_plain(
                    k.narrow(sd, i, 16), ax, False, pad=768,
                    scale=sc)) <= 5e-6
            del k, y
        del p


DNS_KERNELS = ('dns_curl_f64', 'dns_cross_f64', 'dns_project_rk_f64')


@pytest.mark.cuda
def test_dns_solver_energy_anchor(card):
    """The reference's Taylor-Green energy at 64^3, T = 0.1 (10 steps),
    unpadded, on the port's kernels (the reference DNS solver on PFFT)."""
    c0 = dict(tb.LAUNCHES)
    k = dns.run(N=(64, 64, 64), T=0.1, dt=0.01, verbose=False)
    assert round(k - dns.ENERGY_64, 7) == 0, k
    assert tb.LAUNCHES['fft_axis_p_f64'] > c0['fft_axis_p_f64']
    # 10 steps of 4 stages, each one launch of each algebra kernel
    assert all(tb.LAUNCHES[n] - c0[n] == 40 for n in DNS_KERNELS)


def _rel_t(got, ref):
    """Relative L2 of two tensors on the card, complex as (re, im)."""
    if got.is_complex():
        got, ref = torch.view_as_real(got), torch.view_as_real(ref)
    return float(torch.linalg.vector_norm(got - ref)
                 / torch.linalg.vector_norm(ref))


@pytest.mark.cuda
def test_dns_algebra_kernels_on_cuda(card):
    """The solver's three algebra kernels against their plain versions on
    the card, at relative 1e-15: the curl and the projection's three
    stage kinds (the first on the caller's state into new buffers, a
    middle one and the last in place) on a (3, 128, 128, 65) spectrum,
    the cross product on 192^3 grids (16-byte vectors) and on grids off
    a 16-byte boundary with an odd point count (single points)."""
    g = torch.Generator(device=card).manual_seed(25)

    def c(shape):
        return torch.complex(
            torch.randn(shape, generator=g, device=card, dtype=torch.float64),
            torch.randn(shape, generator=g, device=card, dtype=torch.float64))
    S = (128, 128, 65)
    k = [np.fft.fftfreq(128, 1. / 128)] * 2 + [np.fft.rfftfreq(128, 1. / 128)]
    K = [torch.tensor(k[i] * (1.0 if i == 0 else 0.5), device=card).reshape(
        [S[i] if d == i else 1 for d in range(3)]) for i in range(3)]
    c0 = dict(tb.LAUNCHES)
    U, U0, U1 = c((3,) + S), c((3,) + S), c((3,) + S)
    N = [c(S) for _ in range(3)]
    assert _rel_t(da.curl(U, K), da.curl_plain(U, K)) <= 1e-15
    kept = U.clone()
    got = da.project_rk(N, U, U, U, K, 6.25e-4, 0.01 / 6, 0.005)
    want = da.project_rk_plain(N, U, U, U, K, 6.25e-4, 0.01 / 6, 0.005)
    assert torch.equal(U, kept)
    assert all(_rel_t(a, b) <= 1e-15 for a, b in zip(got, want))
    for b in (0.005, None):
        Uc, U1c = U.clone(), U1.clone()
        got = da.project_rk(N, Uc, U0, U1c, K, 6.25e-4, 0.01 / 3, b,
                            inplace=True)
        want = da.project_rk_plain(N, U, U0, U1, K, 6.25e-4, 0.01 / 3, b)
        assert got[1] is U1c and (b is None or got[0] is Uc)
        assert (got[0] is None) == (want[0] is None) == (b is None)
        assert all(_rel_t(x, y) <= 1e-15 for x, y in zip(got, want)
                   if x is not None)
    for shape, off in (((192,) * 3, 0), ((63, 65, 67), 1)):
        n = int(np.prod(shape))
        grids = [torch.randn(n + off, generator=g, device=card,
                             dtype=torch.float64)[off:].view(shape)
                 for _ in range(6)]
        u, w = grids[:3], grids[3:]
        want = da.cross_plain(u, [t.clone() for t in w])
        got = da.cross(u, w)
        assert all(_rel_t(x, y) <= 1e-15 for x, y in zip(got, want))
    torch.cuda.synchronize()
    assert {n: tb.LAUNCHES[n] - c0[n] for n in DNS_KERNELS} == {
        'dns_curl_f64': 1, 'dns_cross_f64': 2, 'dns_project_rk_f64': 3}


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


@pytest.mark.cuda
def test_probe_kernels_on_cuda(card):
    """The probe kernels on the card: launched and counted; block_copy and
    move bit for bit (in place, two streams, both grid orders; block_copy
    on its vector route and, on a misaligned view and a 2-float run, its
    scalar route), bfly within 5e-6 of its plain version (copy and moves
    bit for bit, in place equal to out of place) on A's tile and on A's
    line and band routes at N = 1024 (every mode) and 512, 768 (copy,
    full), fma_chain within 5e-6 (f64 2e-13); a tensor the kernels do not
    take raises, with no fallback."""
    from mpi4py_fft_torch.ops import probes as tp

    def nan(t):         # an output no correct launch leaves as it is
        return torch.full_like(t, float('nan'))
    g = torch.Generator(device=card).manual_seed(5)
    x = torch.randn((2, 64, 64, 64), generator=g, device=card)
    for box, order in (((2, 1, 64, 64), None), ((2, 64, 8, 32), None),
                       ((2, 64, 8, 32), (0, 1, 3, 2)),
                       ((1, 2, 4, 64, 64), (4, 3, 2, 1, 0))):
        if len(box) == 5:
            x = x.view(2, 16, 4, 64, 64)
        assert tp.block_copy_route(x, box, order) == 'vector'
        c0 = tp.LAUNCHES['block_copy']
        assert torch.equal(tp.block_copy(x, box, order, out=nan(x)), x)
        ya, yb = tp.block_copy(x, box, order, out=nan(x), x2=2 * x,
                               out2=nan(x))
        assert torch.equal(ya, x) and torch.equal(yb, 2 * x)
        z = x.clone()
        assert tp.block_copy(z, box, order, out=z) is z
        assert torch.equal(z, x)
        assert tp.LAUNCHES['block_copy'] == c0 + 3
    x = x.view(2, 64, 64, 64)
    base = torch.randn(2 * 6 * 10 * 4 + 1, generator=g, device=card)
    for v, box in ((base[1:].view(2, 6, 10, 4), (1, 2, 10, 4)),
                   (base[:2 * 6 * 10 * 2].view(2, 6, 10, 2), (2, 6, 1, 2))):
        assert tp.block_copy_route(v, box) == 'scalar'
        assert torch.equal(tp.block_copy(v, box), v)
    r = torch.randn((24, 10, 96), generator=g, device=card)
    for axis in (0, 1, 2):
        for kind, shift in (('even', 0), ('odd', 0), ('reverse', 0),
                            ('roll', 7)):
            ref = tp.move_plain(r, axis, kind, shift)
            assert torch.equal(tp.move(r, axis, kind, shift, out=nan(ref)),
                               ref)
    for shape, ax in (((64, 8, 40), 0), ((6, 64, 40), 1), ((50, 256), 1),
                      ((1024, 8, 40), 0), ((6, 1024, 36), 1),
                      ((50, 1024), 1), ((512, 4, 10), 0), ((3, 768, 10), 1),
                      ((20, 768), 1), ((7, 512), 1)):
        q = torch.randn((2,) + shape, generator=g, device=card)
        N = shape[ax]
        assert tp.bfly_route(q, ax) == ('tile' if N < 512 else
                                        'lines' if ax == len(shape) - 1
                                        else 'band')
        for mode in tp.MODES if N in (64, 256, 1024) else ('copy', 'full'):
            got = tp.bfly(q, ax, mode, 2, out=nan(q))
            ref = tp.bfly_plain(q, ax, mode, 2)
            if mode in ('copy', 'moves'):
                assert torch.equal(got, ref)
            else:
                assert _rel(got, ref) <= 5e-6
            w = q.clone()
            assert torch.equal(tp.bfly(w, ax, mode, 2, out=w), got)
    for dtype, tol in ((torch.float32, 5e-6), (torch.float64, 2e-13)):
        v = 1.0 + 0.5 * torch.rand(5000, generator=g, device=card,
                                   dtype=dtype)
        # constants each step moves by far more than tol
        for acc in (1, 4, 8, 16):
            assert _rel(tp.fma_chain(v, 64, acc, 0.9990234375, 0.25),
                        tp.fma_chain_plain(v, 64, 0.9990234375, 0.25)) <= tol
    with pytest.raises(TypeError, match='float32'):
        tp.block_copy(x.half(), (2, 1, 64, 64))
    with pytest.raises(ValueError, match='contiguous'):
        tp.move(x.transpose(2, 3), 1, 'even')


@pytest.mark.cuda
def test_move_routes_on_cuda(card):
    """move on each of its routes on the card, every kind, bit for bit
    against move_plain into NaN-filled outputs: lines in registers (even
    and odd at N % 8 == 0 and 4), lines staged in shared memory (reverse
    and roll by 1, 4 and -3, on N % 4 == 0, 2 and odd), rows of
    16-byte vectors (short and long rows), single floats (a view 4 bytes
    off alignment, rows of 6 floats); an out that overlaps x raises."""
    from mpi4py_fft_torch.ops import probes as tp
    g = torch.Generator(device=card).manual_seed(6)
    cases = (((40, 96), 1, 'lines'), ((30, 772), 1, 'lines'),
             ((50, 99), 1, 'lines_shared'), ((6, 4, 4100), 1, 'rows'),
             ((96, 3, 24), 0, 'rows'), ((5, 10, 6), 1, 'scalar'))
    for shape, axis, want in cases:
        x = torch.randn(shape, generator=g, device=card)
        for kind, shift in (('even', 0), ('odd', 0), ('reverse', 0),
                            ('roll', 1), ('roll', 4), ('roll', -3)):
            if kind in ('even', 'odd') and shape[axis] % 2:
                continue
            ref = tp.move_plain(x, axis, kind, shift)
            y = torch.full_like(ref, float('nan'))
            route = tp.move_route(x, axis, kind, shift, out=y)
            if want == 'lines' and kind in ('reverse', 'roll'):
                assert route == 'lines_shared'
            else:
                assert route == want, (shape, kind, shift)
            c0 = tp.LAUNCHES['move']
            assert torch.equal(tp.move(x, axis, kind, shift, out=y), ref)
            assert tp.LAUNCHES['move'] == c0 + 1
    base = torch.randn(24 * 64 + 1, generator=g, device=card)
    v = base[1:].view(24, 64)
    for axis, kind in ((1, 'even'), (0, 'reverse'), (1, 'roll')):
        assert tp.move_route(v, axis, kind, 4) == 'scalar'
        assert torch.equal(tp.move(v, axis, kind, 4),
                           tp.move_plain(v, axis, kind, 4))
    x = base[:24 * 64].view(24, 64)
    with pytest.raises(ValueError, match='overlaps'):
        tp.move(x, 1, 'reverse', out=x)
    with pytest.raises(ValueError, match='overlaps'):
        tp.move(x, 0, 'even', out=base[8 * 64:20 * 64].view(12, 64))


@pytest.mark.cuda
def test_r2r_on_cuda(card):
    """Every r2r kind on CUDA tensors along a whole-line and an inner axis:
    B and the one-pass DCT-II/III kernels launch (counted) and the result
    is the CPU plain path's (2e-5 f32 and 1e-12 f64 of max abs over
    max(1, largest value)); a PFFT with ``transforms=`` runs on the card
    by default, C in its backward."""
    import functools
    from mpi4py_fft_torch import PFFT, fftw
    from mpi4py_fft_torch.ops import core, kinds as K
    for dtype, tol in ((torch.float32, 2e-5), (torch.float64, 1e-12)):
        x = torch.randn((4, 64, 64), dtype=dtype)
        sfx = '_f64' if dtype == torch.float64 else ''
        c0 = dict(tb.LAUNCHES)
        for kind in K.R2R_KINDS:
            for axis in (1, 2):
                got = core.r2r(x.to(card), (axis,), (kind,)).cpu()
                ref = core.r2r(x, (axis,), (kind,))
                err = float((got - ref).abs().max()) / \
                    max(1.0, float(ref.abs().max()))
                assert err < tol, (kind, axis, dtype, err)
        for name in ('rfft_axis_p', 'dct2_axis_p', 'dct3_axis_p'):
            assert tb.LAUNCHES[name + sfx] > c0[name + sfx], name + sfx
    dct = (functools.partial(fftw.dctn, type=3),
           functools.partial(fftw.idctn, type=3))
    fft = PFFT(None, (16, 16, 16), axes=((0,), (1, 2)), dtype='d',
               transforms={(1, 2): dct})
    assert fft.device.type == 'cuda'
    u = torch.rand((16, 16, 16), dtype=torch.float64, device=card)
    c0 = dict(tb.LAUNCHES)
    assert _rel(fft.backward.fn_p(fft.forward.fn_p(u)), u) <= 2e-10
    assert {k: v - c0[k] for k, v in tb.LAUNCHES.items() if v != c0[k]} == \
        {'rfft_axis_p_f64': 1, 'irfft_axis_p_f64': 1, 'dct2_axis_p_f64': 2,
         'dct3_axis_p_f64': 2}


@pytest.mark.cuda
@pytest.mark.parametrize('shape,dtype,tol', [
    ((512, 512, 512), torch.float64, 2e-13),
    ((32, 768, 768), torch.float32, 5e-6)])
def test_dct_kernels_on_cuda(card, shape, dtype, tol):
    """dct2_axis_p and dct3_axis_p at the r2r cell's 512^3 float64 and at
    768 float32, on axis 1 (the column band) and axis 2 (the line
    kernels), into
    NaN-filled memory: one launch a call, within the kernel tolerance of
    the plain version (the glue around B's and C's plain versions)."""
    g = torch.Generator(device=card).manual_seed(23)
    x = torch.rand(shape, generator=g, device=card, dtype=dtype) - 0.5
    sfx = '_f64' if dtype == torch.float64 else ''
    for fn, plain, name in ((tb.dct2_axis_p, tb.dct2_axis_plain, 'dct2'),
                            (tb.dct3_axis_p, tb.dct3_axis_plain, 'dct3')):
        for axis in (1, 2):
            torch.full(shape, float('nan'), device=card, dtype=dtype)
            c0 = tb.LAUNCHES[name + '_axis_p' + sfx]
            got = fn(x, axis)
            assert tb.LAUNCHES[name + '_axis_p' + sfx] == c0 + 1
            assert bool(torch.isfinite(got).all())
            assert _rel(got, plain(x, axis)) <= tol, (name, axis)
            del got
            torch.cuda.empty_cache()


@pytest.mark.cuda
def test_real_band_on_cuda(card):
    """The column band of B64, C64 and the float64 DCT-II/III at the r2r
    cell's passes: (512, 512, 512) axis 0 r2c and c2r (the c2r on the
    r2c's spectrum), axis 1 DCT-II and DCT-III, into NaN-filled memory:
    one launch a call, whose span names the route 'band' (real_route),
    within 2e-13 of the plain version, computed slab by slab."""
    from mpi4py_fft_torch.utils import profiling
    g = torch.Generator(device=card).manual_seed(31)
    x = torch.rand((512, 512, 512), generator=g, device=card,
                   dtype=torch.float64) - 0.5
    h = tb.rfft_axis_p(x, 0)
    passes = (('rfft_axis_p_f64', lambda: tb.rfft_axis_p(x, 0),
               lambda s: tb.rfft_axis_plain(x[..., s], 0), 3),
              ('irfft_axis_p_f64', lambda: tb.irfft_axis_p(h, 0, 512),
               lambda s: tb.irfft_axis_plain(h[..., s], 0, 512), 2),
              ('dct2_axis_p_f64', lambda: tb.dct2_axis_p(x, 1),
               lambda s: tb.dct2_axis_plain(x[s], 1), 0),
              ('dct3_axis_p_f64', lambda: tb.dct3_axis_p(x, 1),
               lambda s: tb.dct3_axis_plain(x[s], 1), 0))
    with profiling.annotate('off'):
        pass
    for name, run, plain, dim in passes:
        assert tb.real_route(tuple(x.shape), 1 if dim == 0 else 0, 512,
                             x.dtype) == 'band'
        torch.full((2, 257, 512, 512), float('nan'), device=card,
                   dtype=torch.float64)
        c0 = tb.LAUNCHES[name]
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]):
            got = run()
        assert tb.LAUNCHES[name] == c0 + 1
        assert set(profiling.routes()['kernel.' + name]) == {'band'}
        assert bool(torch.isfinite(got).all())
        for i in range(0, 512, 128):
            s = slice(i, i + 128)
            ref = plain(s)
            assert _rel(got[(slice(None),) * dim + (s,)], ref) <= 2e-13, \
                (name, i)
        del got, ref
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_io_cuda_distarray(card, tmp_path):
    """A CUDA DistArray (a PFFT's input, and its spectrum in HDF5) written
    and read back: NetCDF, and HDF5 where h5py is installed; each block
    staged through the native host buffers (g++ is on the card's
    machine), the read-back blocks on the card bit for bit."""
    from mpi4py_fft_torch import DistArray, PFFT, newDistArray
    from mpi4py_fft_torch.utils import native
    assert native.HAVE_NATIVE
    fft = PFFT(None, (16, 18, 20), dtype='d')
    u = newDistArray(fft, False)
    u.v.copy_(torch.rand(u.shape, dtype=torch.float64, device=card))
    u_hat = fft.forward(u)
    names = ['u.nc']
    try:
        import h5py  # noqa: F401
        names.append('u.h5')
    except ImportError:
        pass
    for name in names:
        path = str(tmp_path / name)
        u.write(path, 'u', 0)
        u.write(path, 'u', 1, global_slice=[slice(None), 4, slice(None)])
        v = DistArray(u.global_shape, dtype='d', alignment=0)
        v.read(path, 'u', 0)
        assert v.device.type == 'cuda' and torch.equal(v.v, u.v)
        if name.endswith('.h5'):
            u_hat.write(path, 'u_hat', 0)
            vh = DistArray(u_hat.global_shape, dtype='D', alignment=2)
            vh.read(path, 'u_hat', 0)
            assert torch.equal(vh.v, u_hat.v)


@pytest.mark.cuda
def test_kernel_spans_on_cuda(card):
    """On the card a kernel's span is timed between two CUDA events around
    its launch, which it counts with the bytes the kernel cannot avoid
    moving; the span around it counts no launch of its own."""
    from mpi4py_fft_torch.utils import profiling
    x = torch.randn((2, 64, 768), device=card, dtype=torch.float64)
    tb.fft_axis_p(x, 1)
    with profiling.annotate('off'):
        pass
    c0 = tb.LAUNCHES['fft_axis_p_f64']
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        with profiling.annotate('outer'):
            y = tb.fft_axis_p(x, 1)
            y.mul_(2.0)
    t = profiling.session()
    k = t['kernel.fft_axis_p_f64']
    assert k['calls'] == k['launches'] == 1
    assert tb.LAUNCHES['fft_axis_p_f64'] == c0 + 1
    assert k['bytes'] == 2 * x.numel() * 8
    assert 0 < k['device_s'] < t['outer']['device_s']
    assert t['outer']['launches'] == 0
    assert t['outer']['self_s'] == pytest.approx(
        t['outer']['device_s'] - k['device_s'])
