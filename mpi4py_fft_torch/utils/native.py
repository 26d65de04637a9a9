"""Aligned host buffers and the bit-exact block pack/unpack engine.

Port of ``mpi4py_fft_tpu/utils/native.py`` (``aligned_native`` :23,
``pack_block`` :58, ``unpack_block`` :77): the Python surface of the
``_hoststage`` C++ extension (``native/hoststage.cpp``), the host-side
counterpart of the reference's MPI subarray datatypes (reference:
pencil.py:12-29).  The IO writers stage a block's device tensor into an
``aligned_native`` buffer and cut a global slice's part out of it with
``pack_block``.

The port builds its own copy of the extension from
``native/hoststage.cpp`` at first use: ``g++ -O3 -std=c++17 -shared
-fPIC`` against this Python's headers, into ``build/torch_host/`` at the
root of the checkout (covered by the ``build/`` entry of
``.gitignore``), the file named after a hash of the source, the flags and
the Python; under a file lock, so that the processes of several ranks
starting together build it once.  It is loaded under the module name
``_hoststage``, which ``PyInit__hoststage`` fixes.

``HAVE_NATIVE`` is false, and the numpy path runs, in one case only:
no ``g++`` on ``PATH``.  A compiler that is present but fails to build
the extension raises with its output.
"""
import fcntl
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path

import numpy as np

__all__ = ['HAVE_NATIVE', 'aligned_native', 'pack_block', 'unpack_block',
           'build']

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / 'native' / 'hoststage.cpp'
BUILD_DIR = _ROOT / 'build' / 'torch_host'
CXX = 'g++'
CXX_FLAGS = ['-O3', '-std=c++17', '-shared', '-fPIC']

#: the extension is built and used: a C++ compiler is on PATH
HAVE_NATIVE = shutil.which(CXX) is not None

_lock = threading.Lock()
_ext = None
_owners = {}


def _include():
    return sysconfig.get_paths()['include']


def _path():
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(' '.join(CXX_FLAGS + [_include()]).encode())
    h.update(str(sysconfig.get_config_var('EXT_SUFFIX')).encode())
    return BUILD_DIR / f'_hoststage-{h.hexdigest()[:12]}.so'


def build():
    """Compile the extension if it is not built yet; return its path.
    Raises RuntimeError without a compiler or on a failed build."""
    path = _path()
    if path.exists():
        return path
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"the host-staging extension needs {CXX}; none "
                           f"is on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # one process builds at a time; the lock goes with the process
    with open(BUILD_DIR / 'build.lock', 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            tmp = path.with_suffix(f'.{os.getpid()}.tmp')
            cmd = [cxx, *CXX_FLAGS, '-I', _include(), '-o', str(tmp),
                   str(SOURCE)]
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{CXX} failed on {SOURCE.name} (exit "
                    f"{proc.returncode}):\n{proc.stdout}")
            os.replace(tmp, path)
    return path


def _hoststage():
    """The loaded extension, built at the first call of the process."""
    global _ext
    with _lock:
        if _ext is None:
            spec = importlib.util.spec_from_file_location('_hoststage',
                                                          build())
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _ext = mod
        return _ext


def aligned_native(shape, dtype=np.float64, alignment=128):
    """Aligned host ndarray backed by ``posix_memalign`` storage (the
    numpy over-allocation trick of ``utils.aligned`` without the
    extension)."""
    dtype = np.dtype(dtype)
    nbytes = int(np.prod(shape)) * dtype.itemsize
    if not HAVE_NATIVE:
        from . import aligned
        return aligned(shape, n=min(alignment, 32), dtype=dtype)
    mv, owner = _hoststage().aligned_empty(nbytes, alignment)
    arr = np.frombuffer(mv, dtype=dtype).reshape(shape)
    _owners[id(arr)] = owner  # keep storage alive as long as arr may live
    return arr


def _check_bounds(shape, starts, subsizes):
    if not len(shape) == len(starts) == len(subsizes):
        raise ValueError(f"block of {len(starts)} starts and "
                         f"{len(subsizes)} sizes in {len(shape)} axes")
    for i, (n, s, c) in enumerate(zip(shape, starts, subsizes)):
        if s < 0 or c < 0 or s + c > n:
            raise ValueError(
                f"block [{s}:{s + c}] out of range for axis {i} (extent {n})")


def _writable_contig(a):
    """C-contiguous, writable view/copy (the extension's buffer parsing
    requires read-write byte buffers even for sources)."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return a


def pack_block(full, starts, subsizes, out=None):
    """Pack the block ``full[starts:starts+subsizes]`` into a contiguous
    buffer, bit-exactly (pure memcpy of runs)."""
    full = _writable_contig(full)
    subsizes = tuple(int(s) for s in subsizes)
    starts = tuple(int(s) for s in starts)
    _check_bounds(full.shape, starts, subsizes)
    if out is None:
        out = np.empty(subsizes, dtype=full.dtype)
    if not HAVE_NATIVE:
        sl = tuple(slice(s, s + n) for s, n in zip(starts, subsizes))
        out[...] = full[sl]
        return out
    _hoststage().pack_blocks(
        full.view(np.uint8).reshape(-1), out.view(np.uint8).reshape(-1),
        full.itemsize, full.shape, full.strides, starts, subsizes)
    return out


def unpack_block(full, starts, subsizes, packed):
    """Inverse of :func:`pack_block`: scatter a contiguous block back."""
    if not full.flags['C_CONTIGUOUS']:
        raise ValueError("unpack_block: the full array must be "
                         "C-contiguous")
    subsizes = tuple(int(s) for s in subsizes)
    starts = tuple(int(s) for s in starts)
    _check_bounds(full.shape, starts, subsizes)
    packed = _writable_contig(packed)
    if not HAVE_NATIVE:
        sl = tuple(slice(s, s + n) for s, n in zip(starts, subsizes))
        full[sl] = packed.reshape(subsizes)
        return full
    _hoststage().unpack_blocks(
        full.view(np.uint8).reshape(-1), packed.view(np.uint8).reshape(-1),
        full.itemsize, full.shape, full.strides, starts, subsizes)
    return full
