"""The port's reference API on one device (mpi4py_fft_torch: ``PFFT``,
``Transform``, ``newDistArray``/``DistArray``) against the JAX package's,
on the CPU.

The JAX ``PFFT(None, ...)`` runs on the 8-device CPU mesh of
tests/conftest.py (its shard_map executor); its padded plans run with
``MPI4PY_FFT_TPU_FUSED_TP=force``, so its stage functions dispatch the
fused kernel E (interpret mode) wherever its gate takes a shard.  The
port runs with ``device='cpu'``, so every kernel wrapper uses its plain
version.  Both get the same numpy inputs, made from a seed, and global
arrays are compared: spectra, not only round trips.  Tolerances, relative
L2: f32 5e-5 (the port's pipeline tolerance; the JAX suite's own is atol
0.1 for f, tests/test_mpifft.py:18), f64 2e-10 (the reference's parallel
d tolerance).
"""
import numpy as np
import pytest

import torch

import mpi4py_fft_tpu as jpkg
import mpi4py_fft_torch as tpkg
from mpi4py_fft_torch import PFFT, DistArray, newDistArray
from mpi4py_fft_torch.ops import butterfly as tb
from mpi4py_fft_torch.parallel.comm import DeviceComm

TOL = {'f': 5e-5, 'd': 2e-10}


def _rel(got, ref):
    got = np.asarray(got)
    ref = np.asarray(ref)
    return np.linalg.norm(got.astype(np.complex128) -
                          ref.astype(np.complex128)) / np.linalg.norm(ref)


def _rand(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape)
    if np.dtype(dtype).kind == 'c':
        a = a + 1j * rng.standard_normal(shape)
    return a.astype(dtype)


# the JAX plans, shared by the tests that hold the same plan: each new
# plan compiles its own shard_map programs on the CPU mesh
_JPLANS = {}


def _plans(monkeypatch, shape, dtype, **kw):
    if kw.get('padding'):
        monkeypatch.setenv('MPI4PY_FFT_TPU_FUSED_TP', 'force')
    key = (tuple(shape), dtype, repr(sorted(kw.items())))
    if key not in _JPLANS:
        _JPLANS[key] = jpkg.PFFT(None, shape, dtype=dtype, **kw)
    jfft = _JPLANS[key]
    tfft = PFFT(None, shape, dtype=dtype, device='cpu', **kw)
    assert tfft.global_shape(False) == tuple(jfft.global_shape(False))
    assert tfft.global_shape(True) == tuple(jfft.global_shape(True))
    assert tfft.dtype(False) == jfft.dtype(False)
    assert tfft.dtype(True) == jfft.dtype(True)
    return jfft, tfft


def _hold(jfft, tfft, dtype, seed):
    """Forward (normalized and not) and backward of both plans on the same
    input; the backward on the JAX forward's spectrum (the spectrum of a
    field, consistent for a c2r)."""
    tol = TOL[dtype.lower()]
    u = _rand(jfft.global_shape(False), dtype, seed)
    ref = np.array(jfft.forward(u))
    got = tfft.forward.fn(torch.from_numpy(u))
    assert tuple(got.shape) == ref.shape and got.is_complex()
    assert _rel(got.numpy(), ref) <= tol
    raw = tfft.forward(u, normalize=False)
    assert isinstance(raw, DistArray)
    # the unnormalized forward against the JAX spectrum over the JAX
    # stages' normalization (normalize=False itself is held against JAX
    # in test_pfft_planar_and_normalize_keywords)
    m = np.prod([o.M for o in jfft.xfftn])
    assert _rel(raw.v.numpy(), ref / m) <= tol
    back = tfft.backward.fn(torch.from_numpy(ref))
    assert _rel(back.numpy(), np.asarray(jfft.backward(ref))) <= tol
    return u, ref


# (shape, dtype, padding): 16^3 and a box, c2c and r2c, f and d; the
# padded (16, 11, 16) plan keeps an odd extent on a c2c and a real axis
CASES = [((16, 16, 16), 'f', False), ((16, 16, 16), 'd', False),
         ((16, 16, 16), 'F', False), ((16, 16, 16), 'D', False),
         ((16, 24, 16), 'F', False), ((16, 24, 16), 'd', False),
         ((16, 16, 16), 'f', True), ((16, 16, 16), 'd', True),
         ((16, 16, 16), 'F', True), ((16, 16, 16), 'D', True),
         ((16, 11, 16), 'f', True), ((16, 11, 16), 'D', True)]


@pytest.mark.parametrize('shape,dtype,padding', CASES)
def test_pfft_vs_jax(monkeypatch, shape, dtype, padding):
    kw = dict(padding=[1.5] * 3) if padding else {}
    jfft, tfft = _plans(monkeypatch, shape, dtype, **kw)
    _hold(jfft, tfft, dtype, seed=1)


@pytest.mark.parametrize('dtype', ['F', 'd'])
@pytest.mark.parametrize('axes', [(2, 0, 1), ((1,), (0, 2))])
def test_pfft_axes_orders_vs_jax(monkeypatch, dtype, axes):
    """Other transform orders: the last group is transformed first (for
    r2c the real axis), a nested group is one stage."""
    jfft, tfft = _plans(monkeypatch, (16, 24, 16), dtype, axes=axes)
    _hold(jfft, tfft, dtype, seed=2)


@pytest.mark.parametrize('dtype', ['F', 'd'])
def test_pfft_collapse_vs_jax(monkeypatch, dtype):
    """collapse=True folds every stage of a one-device plan into one."""
    jfft, tfft = _plans(monkeypatch, (16, 16, 16), dtype, collapse=True)
    assert tfft.axes == ((0, 1, 2),)
    assert len(tfft.xfftn) == 1 and tfft.transfer == []
    _hold(jfft, tfft, dtype, seed=3)


@pytest.mark.parametrize('dtype', ['f', 'D'])
def test_pfft_planar_and_normalize_keywords(monkeypatch, dtype):
    """planar=True on both sides, a planar input taken as such, and
    normalize= on the buffer call and on fn/fn_p."""
    jfft, tfft = _plans(monkeypatch, (16, 16, 16), dtype,
                        padding=[1.5] * 3)
    tol = TOL[dtype.lower()]
    u = _rand(jfft.global_shape(False), dtype, 4)
    ref = np.asarray(jfft.forward(u, normalize=False))
    up = np.stack([u.real, u.imag]) if dtype == 'D' else u
    y = tfft.forward(up, planar=True, normalize=False)
    assert isinstance(y, torch.Tensor) and tuple(y.shape) == \
        (2,) + ref.shape
    assert _rel(y[0].numpy() + 1j * y[1].numpy(), ref) <= tol
    y2 = tfft.forward.fn_p(torch.from_numpy(up), normalize=False)
    assert torch.equal(y, y2)
    out = np.zeros(ref.shape, ref.dtype)       # a complex buffer
    assert tfft.forward(up, out, planar=True, normalize=False) is out
    assert _rel(out, ref) <= tol
    href = np.array(jfft.forward(u))
    hp = torch.stack([torch.from_numpy(href.real.copy()),
                      torch.from_numpy(href.imag.copy())])
    z = tfft.backward(hp)                      # planar shape: planar path
    zref = np.asarray(jfft.backward(href))
    if dtype == 'D':
        z = z[0] + 1j * z[1]
    assert _rel(z.numpy(), zref) <= tol
    zn = tfft.backward.fn(torch.from_numpy(href), normalize=True)
    zref = np.asarray(jfft.backward(href, normalize=True))
    assert _rel(zn.numpy(), zref) <= tol
    with pytest.raises(ValueError, match='planar path expects'):
        tfft.forward(torch.zeros((2, 4, 4, 4)), planar=True)


@pytest.mark.parametrize('dtype', ['d', 'F'])
def test_distarray_round_trip(monkeypatch, dtype):
    """newDistArray for both sides of a plan, the buffer call on
    DistArrays, NumPy arrays and tensors, and the DistArray surface,
    against the JAX package's."""
    jfft, tfft = _plans(monkeypatch, (16, 24, 16), dtype)
    ju = jpkg.newDistArray(jfft, False)
    tu = newDistArray(tfft, False)
    assert isinstance(tu, DistArray) and tu.v.device.type == 'cpu'
    assert tu.shape == ju.shape and tu.dtype == ju.dtype
    assert tu.alignment == ju.alignment and tu.rank == ju.rank == 0
    assert tu.global_shape == ju.global_shape
    assert tu.substart == (0, 0, 0) and tu.commsizes == [1, 1, 1]
    assert tu.pencil.subshape == tu.shape
    assert tu.local_slice() == tuple(slice(0, n) for n in tu.shape)
    u = _rand(tu.shape, dtype, 5)
    tu[:] = u
    ju[:] = u
    assert np.array_equal(np.asarray(tu), u)
    uh = tfft.forward(tu)
    assert isinstance(uh, DistArray) and uh is tfft.forward.output_array
    juh = jfft.forward(ju)
    assert uh.shape == juh.shape and uh.alignment == juh.alignment
    assert _rel(np.asarray(uh), np.asarray(juh)) <= TOL[dtype.lower()]
    ub = newDistArray(tfft, False)
    assert tfft.backward(uh, ub) is ub
    assert _rel(ub.get((slice(None),) * 3), u) <= TOL[dtype.lower()]
    # a NumPy array and a tensor as output buffers
    arr = np.zeros(uh.shape, uh.dtype)
    assert tfft.forward(u, arr) is arr
    assert _rel(arr, np.asarray(juh)) <= TOL[dtype.lower()]
    ten = torch.zeros(uh.shape, dtype=uh.v.dtype)
    assert tfft.forward(torch.from_numpy(u), ten) is ten
    assert torch.allclose(ten, uh.v)
    # rank 1: a vector of spectra, components as views
    V = newDistArray(tfft, True, rank=1)
    JV = jpkg.newDistArray(jfft, True, rank=1)
    assert V.shape == JV.shape and V.rank == 1 and V[0].rank == 0
    V[0] = uh
    assert torch.equal(V.v[0], uh.v)
    assert V.subcomm[0].Get_size() == 1 and len(V.subcomm) == 4
    # arithmetic, astype, fill, copy, __getitem__
    w = 2 * tu - tu / 2 + 1
    assert isinstance(w, DistArray)
    assert np.allclose(np.asarray(w), 1.5 * u + 1)
    assert np.allclose(np.asarray(tu * tu), u * u)
    assert np.allclose(np.asarray(-tu), -u)
    c = tu.copy()
    c.fill(3)
    assert (np.asarray(c) == 3).all() and np.array_equal(np.asarray(tu), u)
    assert tu.astype(np.float32 if dtype == 'd' else np.complex128).dtype \
        == (np.float32 if dtype == 'd' else np.complex128)
    assert np.array_equal(tu[2:5, 1], u[2:5, 1])
    assert newDistArray(tfft, False, view=True).shape == torch.Size(tu.shape)
    d = DistArray((8, 6), val=2, dtype='d', device='cpu')
    assert d.alignment == 1 and (np.asarray(d) == 2).all()
    d2 = DistArray((8, 6), buffer=np.ones((8, 6)), alignment=0,
                   device='cpu')
    assert d2.alignment == 0 and np.asarray(d2).sum() == 48


def test_pfft_from_darray():
    """A plan built from a DistArray takes its shape, dtype, device and
    decomposition, and transforms its aligned axis first."""
    u = DistArray((16, 24, 16), val=1, dtype='D', alignment=1, device='cpu')
    fft = PFFT(darray=u)
    assert fft.global_shape(False) == (16, 24, 16)
    assert fft.dtype(False) == np.dtype('D') and fft.device.type == 'cpu'
    assert fft.axes[-1] == (1,)
    uh = fft.forward.fn(u.v)
    assert abs(complex(uh[0, 0, 0]) - 1) < 1e-12
    assert float(uh.abs().sum()) == pytest.approx(1, abs=1e-9)


def test_pfft_pencils_and_transfers():
    fft = PFFT(None, (16, 24, 16), dtype='d', device='cpu')
    assert [tuple(g) for g in fft.axes] == [(0,), (1,), (2,)]
    assert fft.pencil[0].axis == 2 and fft.pencil[1].axis == 0
    assert len(fft.transfer) == 2
    assert fft.local_shape(False) == (16, 24, 16)
    assert fft.local_shape(True) == (16, 24, 9) == fft.shape(True)
    assert fft.local_slice(True) == (slice(0, 16), slice(0, 24),
                                     slice(0, 9))
    assert fft.dimensions == 3
    t = fft.transfer[0]
    x = torch.ones((2, 16, 24, 9))
    assert t.forward_fn(x, rank=1) is x and t.backward_fn(x) is x
    a, b = np.ones((16, 24, 9)), np.zeros((16, 24, 9))
    assert t.forward(a, b) is b and (b == 1).all()
    p = tpkg.Pencil(tpkg.Subcomm(None, [0, 0, 1]), (16, 24, 9), axis=2)
    assert p.subshape == (16, 24, 9) and p.substart == (0, 0, 0)
    q = p.pencil(0)
    assert q.axis == 0 and isinstance(p.transfer(q, 'D'), tpkg.Transfer)
    fft.destroy()


def test_pfft_not_ported_yet_raise(tmp_path):
    # several devices in one process are refused: the port runs one
    # device per rank (tests/test_torch_dist*.py run several ranks)
    with pytest.raises(ValueError, match='one device per rank'):
        DeviceComm(['cpu', 'cpu'])
    with pytest.raises(ValueError, match='one device per rank'):
        PFFT(['cpu', 'cpu'], (8, 8, 8), device='cpu')
    with pytest.raises(ValueError, match='needs 2 devices'):
        PFFT(None, (8, 8, 8), grid=(2,), device='cpu')
    with pytest.raises(ValueError, match='one device per rank'):
        tpkg.Subcomm(['cpu', 'cpu'], [0, 0])
    # transforms= plans its r2r stage (held against JAX in
    # tests/test_torch_r2r.py)
    dct = tpkg.fftw.dctn
    fft = PFFT(None, (8, 8, 8), transforms={(2,): (dct, dct)}, device='cpu')
    assert fft.xfftn[0].fwd.kind == (tpkg.fftw.FFTW_REDFT10,)
    # write/read round trip (held against the JAX package's files in
    # tests/test_torch_io.py)
    u = DistArray((8, 8, 8), val=0, device='cpu')
    u[...] = np.arange(512.).reshape(8, 8, 8)
    for name in ('u.h5', 'u.nc'):
        u.write(str(tmp_path / name))
        v = DistArray((8, 8, 8), alignment=0, device='cpu')
        v.read(str(tmp_path / name))
        assert torch.equal(v.v, u.v)
    with pytest.raises(ValueError, match='input shape'):
        PFFT(None, (8, 8, 8), device='cpu').forward(np.zeros((8, 8, 4)))
    # an axis of 18 (and its padded 27) is no kernel length: the
    # mixed-radix engine takes it (held against JAX in
    # tests/test_torch_engine.py)
    for kw in ({}, {'padding': [1.5] * 3}):
        fft = PFFT(None, (16, 18, 16), dtype='D', device='cpu', **kw)
        y = fft.forward.fn(torch.ones(fft.global_shape(False),
                                      dtype=torch.complex128))
        assert float(y[0, 0, 0].real) == pytest.approx(1.0)


def test_pfft_host_backend_vs_port(monkeypatch):
    """backend='numpy' runs the same plan on host arrays, a cross-check of
    the device backend."""
    fft = PFFT(None, (16, 16, 16), dtype='d', padding=[1.5] * 3,
               device='cpu')
    hfft = PFFT(None, (16, 16, 16), dtype='d', padding=[1.5] * 3,
                backend='numpy', device='cpu')
    u = _rand(fft.global_shape(False), 'd', 6)
    a = fft.forward.fn(torch.from_numpy(u))
    b = hfft.forward.fn(u)
    assert _rel(a.numpy(), b) <= 1e-12
    assert _rel(np.asarray(hfft.forward(u)), b) <= 1e-12
    with pytest.raises(ValueError, match='planar=True'):
        hfft.forward(u, planar=True)


def test_padded_plan_launches_no_kernel_on_cpu():
    """On the CPU the plan runs the plain versions: no launch counted."""
    tb.reset_launches()
    fft = PFFT(None, (16, 16, 16), dtype='F', padding=[1.5] * 3,
               device='cpu')
    fft.backward.fn(fft.forward.fn(torch.ones((24, 24, 24),
                                              dtype=torch.complex64)))
    assert not any(tb.LAUNCHES.values())


def test_pfft_default_device_is_cuda():
    """No CUDA and no device='cpu': raise, never carry on on the CPU."""
    if torch.cuda.is_available():
        assert PFFT(None, (8, 8, 8)).device.type == 'cuda'
        assert newDistArray(PFFT(None, (8, 8, 8)), False).v.is_cuda
        return
    for make in (lambda: PFFT(None, (8, 8, 8)),
                 lambda: DistArray((8, 8, 8)),
                 lambda: tpkg.fftw.fftn(np.zeros((4, 8), 'D'))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


# the JAX package on one device of the CPU mesh: every axis group of
# size 1, as the port's
def _jax_one():
    import jax
    from mpi4py_fft_tpu.parallel.pencil import DeviceComm as JComm
    return JComm(jax.devices()[:1])


def test_redistribute_one_device_vs_jax():
    """On one device redistribute relabels the pencil and returns the
    array itself; with out= alone it copies into out, which keeps its
    alignment; with an axis and out= it relabels and returns the array
    (JAX distarray.py:431-447)."""
    from mpi4py_fft_tpu.parallel.pencil import Subcomm as JSubcomm
    sc = JSubcomm(_jax_one(), [0, 0, 0])
    X = np.random.default_rng(21).random((8, 6, 4))
    ja = jpkg.DistArray((8, 6, 4), subcomm=sc, alignment=0, dtype='d')
    ta = DistArray((8, 6, 4), alignment=0, dtype='d', device='cpu')
    ja[:] = X
    ta[:] = X
    jb, tb_ = ja.redistribute(2), ta.redistribute(2)
    assert tb_ is ta and jb is ja
    assert tb_.alignment == jb.alignment == 2
    assert tb_.shape == tuple(jb.shape) == (8, 6, 4)
    assert tb_.pencil.axis == 2 and tb_.commsizes == jb.commsizes
    np.testing.assert_array_equal(np.asarray(tb_), np.asarray(jb))
    assert ta.redistribute(2) is ta
    jo = jpkg.DistArray((8, 6, 4), subcomm=sc, alignment=1, dtype='d')
    to = DistArray((8, 6, 4), alignment=1, dtype='d', device='cpu')
    jc, tc = ja.redistribute(out=jo), ta.redistribute(out=to)
    assert tc is to and jc is jo and tc.alignment == jc.alignment == 1
    np.testing.assert_array_equal(np.asarray(tc), np.asarray(jc))
    np.testing.assert_array_equal(np.asarray(tc), X)
    jd, td = ja.redistribute(1, out=jo), ta.redistribute(1, out=to)
    assert td is ta and jd is ja and td.alignment == jd.alignment == 1
    # tensor-rank arrays keep their leading axes undistributed
    tv = DistArray((3, 8, 6, 4), rank=1, alignment=2, device='cpu')
    assert tv.redistribute(0).alignment == 0 and tv.commsizes == [1] * 4
    with pytest.raises(ValueError, match='alignment'):
        ta.redistribute(2, out=to)
    with pytest.raises(ValueError, match='same global shape'):
        ta.redistribute(out=DistArray((8, 6, 5), device='cpu'))


def test_get_pencil_and_transfer_vs_jax():
    from mpi4py_fft_tpu.parallel.pencil import Subcomm as JSubcomm
    ja = jpkg.DistArray((8, 6, 4), subcomm=JSubcomm(_jax_one(), [0, 0, 0]),
                        alignment=0, dtype='d')
    ta = DistArray((8, 6, 4), alignment=0, dtype='d', device='cpu')
    for ax in (1, 2):
        jp, jt = ja.get_pencil_and_transfer(ax)
        tp, tt = ta.get_pencil_and_transfer(ax)
        assert isinstance(tp, tpkg.Pencil) and isinstance(tt, tpkg.Transfer)
        assert tp.axis == jp.axis == ax
        assert tp.subshape == tuple(jp.subshape)
        assert (tt.axisA, tt.axisB) == (jt.axisA, jt.axisB) == (0, ax)
        assert tt.subshapeB == tuple(jt.subshapeB)
        assert tt.dtype == np.dtype('d')
        tt.destroy()


@pytest.mark.parametrize('executor', ['shard_map', 'auto', 'gspmd'])
def test_executor_on_one_device_vs_jax(executor):
    """Every executor takes the one-device chain and reports 'gspmd', as
    the JAX PFFT falls back on a one-device mesh (mpifft.py:669-673); the
    round trip holds at 2e-10 and the spectrum against JAX."""
    jfft = jpkg.PFFT(_jax_one(), (8, 9, 10), dtype='d', executor=executor)
    tfft = PFFT(None, (8, 9, 10), dtype='d', executor=executor,
                device='cpu')
    assert tfft.executor == jfft.executor == 'gspmd'
    u = _rand((8, 9, 10), 'd', 22)
    uh = tfft.forward.fn(torch.from_numpy(u))
    assert _rel(uh.numpy(), np.array(jfft.forward(u))) <= TOL['d']
    back = tfft.backward.fn(uh).numpy()
    assert _rel(back, u) <= TOL['d']
    with pytest.raises(ValueError, match='unknown executor'):
        PFFT(None, (8, 9, 10), executor='mpi', device='cpu')


def test_function_alias_vs_jax():
    """The deprecated Function: a FutureWarning, then newDistArray, with
    tensor= asking for rank 1 (JAX distarray.py:536)."""
    jfft = jpkg.PFFT(_jax_one(), (8, 9, 10), dtype='d')
    tfft = PFFT(None, (8, 9, 10), dtype='d', device='cpu')
    with pytest.warns(FutureWarning, match='newDistArray'):
        jv = jpkg.Function(jfft, False, tensor=3)
    with pytest.warns(FutureWarning, match='newDistArray'):
        tv = tpkg.Function(tfft, False, tensor=3)
    assert isinstance(tv, DistArray) and tv.rank == jv.rank == 1
    assert tv.shape == tuple(jv.shape) == (3, 8, 9, 10)
    with pytest.warns(FutureWarning):
        tu = tpkg.Function(tfft, True, val=2)
    assert tu.rank == 0 and tu.shape == tfft.global_shape(True)
    assert float(tu.v[0, 0, 0].real) == 2.0
    assert 'Function' in tpkg.__all__
