"""Host buffer and layout helpers.

Port of ``mpi4py_fft_tpu/utils/__init__.py:15-109`` (``get_alignment``,
``aligned``, ``aligned_like``, ``compute_dims``): host numpy helpers with
the reference's byte-alignment semantics (reference:
mpi4py_fft/fftw/utilities.pyx:39-104).  ``aligned`` rides the
``posix_memalign`` storage of ``utils/native.py`` where its extension is
built (``native.HAVE_NATIVE``), as the JAX package's does, and the
over-allocate-and-offset trick otherwise.  Either way the buffers are
uninitialised, so their pages stay virtual until something writes
them.

``resolve_device`` and ``torch_dtype`` are the port's own: the device an
entry point runs on, CUDA unless the caller asks for the CPU, and the
torch dtype of a numpy one.
"""
import numpy as np
import torch

__all__ = ['aligned', 'aligned_like', 'get_alignment', 'compute_dims',
           'resolve_device', 'torch_dtype']

_TORCH_DTYPE = {np.dtype('float32'): torch.float32,
                np.dtype('float64'): torch.float64,
                np.dtype('complex64'): torch.complex64,
                np.dtype('complex128'): torch.complex128}


def torch_dtype(dtype):
    """The torch dtype of numpy ``dtype`` (a precision tier: f32/f64,
    real or complex)."""
    return _TORCH_DTYPE[np.dtype(dtype)]


def resolve_device(device, what):
    """The torch device ``what`` runs on: CUDA unless ``device`` says
    otherwise; no silent CPU."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what} runs on CUDA by default and no CUDA device is "
                f"available; pass device='cpu' to run the plain versions")
        if device.index is None:
            device = torch.device('cuda', torch.cuda.current_device())
    elif device.type != 'cpu':
        raise ValueError(f"unsupported device {device}")
    return device


def get_alignment(array):
    """Return byte alignment of ``array`` (highest considered is 32)."""
    addr = array.__array_interface__['data'][0]
    for i in range(5, -1, -1):
        n = 1 << i
        if addr % n == 0:
            break
    return n


def aligned(shape, n=32, dtype=np.dtype('d'), fill=None):
    """Return a host array with ``n``-byte alignment."""
    dtype = np.dtype(dtype)
    from . import native
    if native.HAVE_NATIVE:
        # posix_memalign-backed storage (native/hoststage.cpp): exact
        # alignment without the over-allocate-and-offset trick
        b = native.aligned_native(shape, dtype=dtype, alignment=max(n, 8))
    else:
        M = int(np.prod(shape)) * dtype.itemsize
        a = np.empty(M + n, dtype=np.uint8)
        offset = a.ctypes.data % n
        offset = 0 if offset == 0 else (n - offset)
        b = np.frombuffer(a[offset:(offset + M)].data,
                          dtype=dtype).reshape(shape)
    if fill is not None:
        assert isinstance(fill, int)
        b[...] = fill
    return b


def aligned_like(z, fill=None):
    """Return aligned host array with shape/dtype of ``z``."""
    n = get_alignment(z) if isinstance(z, np.ndarray) else 32
    return aligned(z.shape, n=n, dtype=z.dtype, fill=fill)


def compute_dims(nnodes, dims):
    """Balanced factorization of ``nnodes`` over the wildcard entries of dims.

    Equivalent of ``MPI.Compute_dims`` as used by the reference Subcomm
    (reference: mpi4py_fft/pencil.py:79).  Entries > 0 are fixed; entries <= 0
    are wildcards filled with a balanced factorization, larger factors first.
    """
    dims = list(dims)
    fixed = 1
    free = []
    for i, d in enumerate(dims):
        if d > 0:
            fixed *= d
        else:
            free.append(i)
    if not free:
        # a fully specified grid may use a subset of the devices
        if fixed > nnodes:
            raise ValueError(
                f"grid {dims} needs {fixed} devices, only {nnodes} available")
        return dims
    if fixed <= 0 or nnodes % fixed != 0:
        raise ValueError(
            f"cannot factor {nnodes} devices over fixed dims {dims}")
    rem = nnodes // fixed
    # balanced factorization of rem into len(free) factors, decreasing:
    # strip the largest prime factor onto the smallest bin, repeatedly
    factors = [1] * len(free)
    primes = []
    m = rem
    p = 2
    while p * p <= m:
        while m % p == 0:
            primes.append(p)
            m //= p
        p += 1
    if m > 1:
        primes.append(m)
    for p in sorted(primes, reverse=True):
        j = int(np.argmin(factors))
        factors[j] *= p
    factors.sort(reverse=True)
    for i, f in zip(free, factors):
        dims[i] = f
    return dims
