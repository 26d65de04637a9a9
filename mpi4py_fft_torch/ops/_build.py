"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, and loaded with ``ctypes``:
no PyTorch headers, so a build takes seconds.  The libraries go to
``build/torch_kernels/`` at the root of the checkout, which the ``build/``
entry of ``.gitignore`` covers.  A library's file name carries a hash of
the sources, so an edited kernel is rebuilt; the files are built once per
process, at first use, all at the same time.

Every pointer and the stream are passed as ``ctypes.c_void_p``, and the
scale as the entry's own float type (``c_float`` for ``_f32``,
``c_double`` for ``_f64``: a double passed as a float would be rounded
silently); each C entry returns ``cudaGetLastError()`` after its launch,
and the wrappers in ``butterfly.py``, ``fft2stage.py`` and ``probes.py``
raise when it is not 0.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'torch_kernels'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-O3',
              '-std=c++17', '-shared', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v']

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F, _D = ctypes.c_float, ctypes.c_double
_IA = ctypes.POINTER(ctypes.c_int)
_LLA = ctypes.POINTER(ctypes.c_longlong)

# library -> {C entry: argtypes}; every entry returns an int (cudaError_t)
_ENTRIES = {
    'fft_axis': {
        # x, y, tw, tw_len, pre, n, post, sign, plan, nstages, scale, stream
        'mff_fft_axis_f32': [_P, _P, _P, _LL, _LL, _I, _LL, _I, _IA, _I,
                             _F, _P],
        'mff_fft_axis_f64': [_P, _P, _P, _LL, _LL, _I, _LL, _I, _IA, _I,
                             _D, _P],
    },
    'rfft_axis': {
        # x, y, tw, tw_len, pre, n, post, hext, nrows, fold, packed,
        # plan, nstages, scale, stream
        'mff_rfft_axis_f32': [_P, _P, _P, _LL, _LL, _I, _LL, _I, _I, _I,
                              _I, _IA, _I, _F, _P],
        'mff_rfft_axis_f64': [_P, _P, _P, _LL, _LL, _I, _LL, _I, _I, _I,
                              _I, _IA, _I, _D, _P],
        # x, y, tw, tw_len, pre, hin, n, post, packed, plan, nstages,
        # scale, stream
        'mff_irfft_axis_f32': [_P, _P, _P, _LL, _LL, _I, _I, _LL, _I, _IA,
                               _I, _F, _P],
        'mff_irfft_axis_f64': [_P, _P, _P, _LL, _LL, _I, _I, _LL, _I, _IA,
                               _I, _D, _P],
    },
    'fft_axis_tp': {
        # x, y, tw, tw_len, pre, n, nt, pad, post, sign, plan, nstages,
        # scale, stream
        'mff_fft_axis_tp_f32': [_P, _P, _P, _LL, _LL, _I, _I, _I, _LL, _I,
                                _IA, _I, _F, _P],
        'mff_fft_axis_tp_f64': [_P, _P, _P, _LL, _LL, _I, _I, _I, _LL, _I,
                                _IA, _I, _D, _P],
    },
    'fft_axis2': {
        # xa, xb, ya, yb, strides, tw, tw_len, pre, n, post, sign, plan,
        # nstages, scale, stream
        'mff_fft_axis2_f32': [_P, _P, _P, _P, _LLA, _P, _LL, _LL, _I, _LL,
                              _I, _IA, _I, _F, _P],
        # n, count
        'mff_fft_axis2_clusters_f32': [_I, _IA],
    },
    'fft2stage': {
        # x, y, tab, row, B, S, sign, stream
        'mff_fft2stage_f32': [_P, _P, _P, _LL, _LL, _I, _I, _P],
    },
    'fft_plane': {
        # x, y, tw2, tw1, P, n1, n2, sign, scale, stream
        'mff_fft_plane_f32': [_P, _P, _P, _P, _LL, _I, _I, _I, _F, _P],
        # n1, n2, k, count
        'mff_fft_plane_clusters_f32': [_I, _I, _IA, _IA],
        # x, y, tw2, tw2_len, tw1, tw1_len, P, n1, n2, sign, plan2, nst2,
        # plan1, nst1, scale, counters, stream
        'mff_fft_plane_queue_f32': [_P, _P, _P, _LL, _P, _LL, _LL, _I, _I,
                                    _I, _IA, _I, _IA, _I, _F, _P, _P],
    },
    # the probes of ops/probes.py
    'probe_copy': {
        # x0, y0, x1, y1, dims, box, order, nd, stream
        'mff_block_copy_f32': [_P, _P, _P, _P, _LLA, _LLA, _IA, _I, _P],
        # x, y, P, N, Q, kind, shift, stream
        'mff_move_f32': [_P, _P, _LL, _LL, _LL, _I, _LL, _P],
    },
    'probe_bfly': {
        # x, y, tw, tw_len, pre, n, post, sign, plan, nstages, mode, reps,
        # lc, stream
        'mff_bfly_f32': [_P, _P, _P, _LL, _LL, _I, _LL, _I, _IA, _I, _I, _I,
                         _I, _P],
    },
    'probe_fma': {
        # x, y, n, iters, acc, a, b, stream
        'mff_fma_chain_f32': [_P, _P, _LL, _LL, _I, _F, _F, _P],
        'mff_fma_chain_f64': [_P, _P, _LL, _LL, _I, _D, _D, _P],
    },
}

_lock = threading.Lock()
_kernels = None
# nvcc's output of the last build (register and shared-memory use)
LOG = {}


class Kernels:
    """The loaded C entries, one attribute each, without their prefix."""

    def __init__(self, libs):
        self._libs = libs
        for lib, entries in _ENTRIES.items():
            for name, argtypes in entries.items():
                fn = getattr(libs[lib], name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                setattr(self, name[len('mff_'):], fn)
        es = libs['fft_axis'].mff_error_string
        es.argtypes = [ctypes.c_int]
        es.restype = ctypes.c_char_p
        self._error_string = es

    def error_string(self, rc):
        return self._error_string(int(rc)).decode()


def find_nvcc():
    """Path of ``nvcc``: $CUDA_HOME/bin, then PATH, then the toolkit's
    default prefix; None if there is none."""
    cands = []
    if os.environ.get('CUDA_HOME'):
        cands.append(Path(os.environ['CUDA_HOME']) / 'bin' / 'nvcc')
    w = shutil.which('nvcc')
    if w:
        cands.append(Path(w))
    cands.append(Path('/usr/local/cuda/bin/nvcc'))
    for c in cands:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    return None


def _digest(name):
    h = hashlib.sha1()
    for f in sorted(_CSRC.glob('*.cuh')) + [_CSRC / f'{name}.cu']:
        h.update(f.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def build():
    """Compile every library that is not built yet, all at once; return
    {name: path}.  Raises RuntimeError without nvcc or on a failed
    build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: BUILD_DIR / f'{n}-{_digest(n)}.so' for n in _ENTRIES}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "the CUDA kernels need nvcc (set CUDA_HOME or put nvcc on "
            "PATH); none was found")
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(_CSRC / f'{n}.cu')]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        LOG[n] = out
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("nvcc failed on " + "\n".join(failed))
    return paths


def load():
    """The loaded kernels, built at the first call of the process."""
    global _kernels
    with _lock:
        if _kernels is None:
            paths = build()
            _kernels = Kernels({n: ctypes.CDLL(str(p))
                                for n, p in paths.items()})
        return _kernels


def unload():
    """Drop the loaded kernels: the next ``load()`` loads the libraries
    anew from ``BUILD_DIR``, building those that are not there."""
    global _kernels
    with _lock:
        _kernels = None


def error_string(rc):
    """CUDA's name for an error code the C entries returned."""
    return _kernels.error_string(rc) if _kernels is not None else str(rc)
