"""The port's host-staging engine (``mpi4py_fft_torch/utils/native.py``).

The cases of tests/test_native.py:21-71 run against the port's own build
of the ``_hoststage`` extension (``native/hoststage.cpp``, compiled with
g++ at first use into ``build/torch_host/``): ``pack_block`` and
``unpack_block`` bit for bit in f, d, i8 and c16 on four shapes, the
bounds errors, ``aligned_native`` at 64, 128 and 256 bytes and
``aligned`` riding it.  The port's native result is held bit for bit
against the JAX package's numpy path (``mpi4py_fft_tpu.utils.native``
with ``HAVE_NATIVE`` off) on the same inputs, and the port's own numpy
path (``HAVE_NATIVE`` off) against both.
"""
import numpy as np
import pytest

from mpi4py_fft_tpu.utils import native as jnative

from mpi4py_fft_torch.utils import aligned, get_alignment
from mpi4py_fft_torch.utils import native

CASES = [((5, 7, 9), (1, 2, 3), (3, 4, 5)),
         ((8, 8), (0, 0), (8, 8)),
         ((13,), (5,), (7,)),
         ((4, 6, 2, 3), (1, 0, 1, 0), (2, 6, 1, 3))]


def _full(shape, dtype, rng):
    if np.dtype(dtype).kind == 'c':
        return (rng.random(shape) + 1j * rng.random(shape)).astype(dtype)
    return (rng.random(shape) * 100).astype(dtype)


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


def test_have_native():
    """g++ is on PATH here, so the extension is built and used."""
    assert native.HAVE_NATIVE
    path = native.build()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert native._hoststage().__name__ == '_hoststage'


@pytest.mark.parametrize('dtype', ['f', 'd', 'i8', 'c16'])
@pytest.mark.parametrize('shape,starts,subsizes', CASES)
def test_pack_unpack_bit_exact(dtype, shape, starts, subsizes):
    rng = np.random.default_rng(0)
    full = _full(shape, dtype, rng)
    sl = tuple(slice(s, s + n) for s, n in zip(starts, subsizes))
    got = native.pack_block(full, starts, subsizes)
    ref = full[sl]
    assert got.dtype == ref.dtype
    assert np.array_equal(_bits(got), _bits(ref))
    # unpack scatters back bit-exactly
    dst = np.zeros_like(full)
    native.unpack_block(dst, starts, subsizes, got)
    ref2 = np.zeros_like(full)
    ref2[sl] = ref
    assert np.array_equal(_bits(dst), _bits(ref2))


def test_pack_block_bounds():
    full = np.zeros((4, 5))
    with pytest.raises(ValueError):
        native.pack_block(full, (2, 0), (3, 5))     # 2+3 > 4
    with pytest.raises(ValueError):
        native.pack_block(full, (-1, 0), (1, 5))
    with pytest.raises(ValueError):
        native.unpack_block(full, (0, 4), (4, 2), np.zeros((4, 2)))
    with pytest.raises(ValueError):
        native.unpack_block(full.T, (0, 0), (1, 1), np.zeros((1, 1)))


def test_aligned_native_alignment():
    for align in (64, 128, 256):
        a = native.aligned_native((7, 11), dtype='d', alignment=align)
        assert a.__array_interface__['data'][0] % align == 0
        a[...] = 3.0
        assert np.all(a == 3.0)
    # the public aligned() rides the native allocator when built
    b = aligned((5, 6), n=32, dtype='f', fill=2)
    assert get_alignment(b) == 32
    assert np.all(b == 2)


def test_aligned_rides_native(monkeypatch):
    """``aligned`` takes its storage from ``aligned_native`` where the
    extension is built, and the offset trick where it is not."""
    calls = []
    real = native.aligned_native

    def spy(*a, **kw):
        calls.append(kw.get('alignment'))
        return real(*a, **kw)
    monkeypatch.setattr(native, 'aligned_native', spy)
    a = aligned((3, 4), n=64, dtype='d', fill=1)
    assert calls == [64] and get_alignment(a) == 32 and np.all(a == 1)
    monkeypatch.setattr(native, 'HAVE_NATIVE', False)
    b = aligned((3, 4), n=16, dtype='d', fill=1)
    assert calls == [64] and get_alignment(b) >= 16 and np.all(b == 1)


@pytest.mark.parametrize('dtype', ['f', 'd', 'i8', 'c16'])
@pytest.mark.parametrize('shape,starts,subsizes', CASES)
def test_native_vs_jax_numpy_path(monkeypatch, dtype, shape, starts,
                                  subsizes):
    """The port's native pack/unpack, its numpy path and the JAX
    package's numpy path give the same bits on the same inputs."""
    rng = np.random.default_rng(1)
    full = _full(shape, dtype, rng)
    packed = _full(subsizes, dtype, rng)

    def run(mod):
        p = mod.pack_block(full, starts, subsizes)
        u = mod.unpack_block(np.zeros_like(full), starts, subsizes, packed)
        return p, u

    nat = run(native)
    monkeypatch.setattr(jnative, 'HAVE_NATIVE', False)
    jref = run(jnative)
    monkeypatch.setattr(native, 'HAVE_NATIVE', False)
    own = run(native)
    for a, b, c in zip(nat, jref, own):
        assert np.array_equal(_bits(a), _bits(b))
        assert np.array_equal(_bits(c), _bits(b))


def test_numpy_path_aligned_native(monkeypatch):
    """Without the extension ``aligned_native`` falls back to ``aligned``
    (alignment capped at 32 bytes, as the JAX package's)."""
    monkeypatch.setattr(native, 'HAVE_NATIVE', False)
    a = native.aligned_native((9, 5), dtype='c16', alignment=256)
    assert a.shape == (9, 5) and a.dtype == np.complex128
    assert get_alignment(a) == 32


def test_build_failure_raises(monkeypatch, tmp_path):
    """A compiler that is present but fails raises with its output; no
    silent numpy fallback."""
    bad = tmp_path / 'bad.cpp'
    bad.write_text('this is not C++\n')
    monkeypatch.setattr(native, 'SOURCE', bad)
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path / 'out')
    with pytest.raises(RuntimeError, match='failed on bad.cpp'):
        native.build()
    monkeypatch.setattr(native, 'CXX', 'no-such-compiler-on-path')
    with pytest.raises(RuntimeError, match='none is on PATH'):
        native.build()
