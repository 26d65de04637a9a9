"""Planned-transform objects and the "wisdom" surface.

Port of ``mpi4py_fft_tpu/ops/plan.py``: the plan object ``FFT`` (:56), the
precision registry ``fftlib``/``get_fftw_lib`` (:172-193),
``get_planned_FFT`` (:196) and the wisdom calls (:212-263), after the
reference's plan/execute wrapper (mpi4py_fft/fftw/fftw_xfftn.pyx:109-296)
and planner factory (mpi4py_fft/fftw/factory.py:52-182).

A plan binds host input/output buffers to a transform kind over a set of
axes.  Its device-side computation, ``fn``/``fn_p``, runs the port's
kernels through ``matfft`` on whatever device the tensor lies (on a CPU
tensor, their plain versions); calling the plan runs it on the buffers,
on the plan's ``device``.  Planning compiles nothing: the kernels are
built once per process (``_build.py``), and the built libraries are the
port's wisdom.  ``export_wisdom`` points the build directory at a
directory of the caller's (and copies what is built already),
``import_wisdom`` loads the kernels from such a directory, and
``forget_wisdom``/``cleanup`` drop the loaded kernels.

Precision tiers: float32 ('F') and float64 ('D'); the reference's 'G'
(long double) is absent, as in the JAX package.  r2r kinds (DCT/DST/DHT)
raise NotImplementedError until ROADMAP Queue 1 item 6.
"""
import shutil
from pathlib import Path

import numpy as np
import torch

from . import _build, butterfly, fft2stage, matfft
from .kinds import C2C_FORWARD, C2C_BACKWARD, R2C, C2R, R2R_KINDS
from ..utils import resolve_device

__all__ = ['FFT', 'get_planned_FFT', 'fftlib', 'get_fftw_lib',
           'export_wisdom', 'import_wisdom', 'forget_wisdom',
           'set_timelimit', 'cleanup']


def _no_r2r(what):
    return NotImplementedError(
        f"{what}: the r2r transforms (DCT/DST I-IV, DHT) arrive with ROADMAP "
        f"Queue 1 item 6")


def _host(a):
    """A host numpy view of a tensor or array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def pipeline_form(x, planar, device):
    """The pipeline form of ``x``: planar (2,) + shape if ``planar`` (a
    real tensor is taken as complex), else ``x`` itself.  An array that is
    not a tensor is moved to ``device`` first."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x), device=device)
    if not planar:
        return x
    if not x.is_complex():
        x = x.to(torch.complex128 if x.dtype == torch.float64
                 else torch.complex64)
    return matfft.planar(x)


class FFT(object):
    """A planned transform bound to host input/output buffers.

    Calling the object runs the planned transform from ``input_array``
    into ``output_array`` on the plan's ``device`` (CUDA unless the
    caller asks for the CPU); an ``input_array`` argument is first copied
    into the planned buffer, and the result into any ``output_array``
    given.  ``normalize`` multiplies by the plan's normalization constant
    (default False, as in FFTW).  :meth:`fn` and :meth:`fn_p` are the
    device-side computation that the parallel layer chains.  ``threads``
    is accepted for API parity and unused."""

    def __init__(self, input_array, output_array, axes=(-1,),
                 kind=C2C_FORWARD, threads=1, flags=(0,), normalization=1.0,
                 device=None):
        ndim = input_array.ndim
        axes = tuple(a + ndim if a < 0 else a for a in
                     ((axes,) if isinstance(axes, (int, np.integer))
                      else tuple(axes)))
        if isinstance(kind, (list, tuple, np.ndarray)):
            kind = [int(k) for k in kind]
            if kind[0] in (C2C_FORWARD, C2C_BACKWARD, R2C, C2R) and \
                    len(set(kind)) == 1:
                kind = kind[0]
            else:
                assert all(k in R2R_KINDS for k in kind), kind
                raise _no_r2r('FFT')
        else:
            kind = int(kind)
        if kind not in (C2C_FORWARD, C2C_BACKWARD, R2C, C2R):
            raise ValueError(f"unknown transform kind {kind}")
        self.axes = axes
        self.kind = kind
        self.flags = tuple(flags) if np.ndim(flags) else (int(flags),)
        self.input_array = input_array
        self.output_array = output_array
        self.M = float(normalization)
        self._last_size = int(output_array.shape[axes[-1]]) \
            if kind == C2R else 0
        self.device = resolve_device(device, 'FFT')

    # -- planar (pipeline-form) surface -----------------------------------
    # a logically complex array is a real (2,) + shape tensor; a real
    # array is itself
    @property
    def input_planar(self):
        """True if the pipeline form of this plan's input is planar."""
        return np.dtype(self.input_array.dtype).kind == 'c'

    @property
    def output_planar(self):
        """True if the pipeline form of this plan's output is planar."""
        return np.dtype(self.output_array.dtype).kind == 'c'

    def fn_p(self, p, normalize=False):
        """This plan applied to the pipeline form ``p`` of its input;
        returns the pipeline form of its output."""
        if self.kind in (C2C_FORWARD, C2C_BACKWARD):
            y = matfft.fftn_p(p, self.axes,
                              forward=(self.kind == C2C_FORWARD))
        elif self.kind == R2C:
            y = matfft.rfftn_p(p, self.axes)
        else:
            y = matfft.irfftn_p(p, self.axes, self._last_size)
        if normalize:
            y = y * self.M
        return y

    def fn(self, x, normalize=False):
        """This plan applied to a tensor: complex tensors go planar at the
        boundary and come back complex (one copy each way).  An array
        that is not a tensor is moved to the plan's device."""
        y = self.fn_p(pipeline_form(x, self.input_planar, self.device),
                      normalize)
        return matfft.unplanar(y) if self.output_planar else y

    # -- FFTW-style buffer execute ----------------------------------------
    def __call__(self, input_array=None, output_array=None, normalize=False,
                 implicit=True, **kw):
        if input_array is not None:
            self.input_array[...] = _host(input_array)
        x = torch.from_numpy(np.ascontiguousarray(self.input_array))
        y = self.fn(x.to(self.device), normalize=normalize)
        self.output_array[...] = _host(y)
        if output_array is not None:
            output_array[...] = self.output_array
            return output_array
        return self.output_array

    def get_normalization(self):
        """The plan's normalization constant."""
        return self.M

    def print_plan(self):
        """Print the passes this plan runs."""
        names = {C2C_FORWARD: 'c2c forward', C2C_BACKWARD: 'c2c backward',
                 R2C: 'r2c', C2R: 'c2r'}
        print(f"{names[self.kind]} of {self.input_array.shape} "
              f"{self.input_array.dtype} over axes {self.axes} on "
              f"{self.device}")


class _FFTLib(dict):
    """Precision-tier registry (reference: fftw/factory.py:44-48): keys
    'F' (float32) and 'D' (float64); 'G' (long double) is absent."""


fftlib = _FFTLib()
fftlib['F'] = FFT
fftlib['D'] = FFT


def get_fftw_lib(dtype):
    """Return the transform implementation for a precision, or None
    (reference: fftw/factory.py:7-42)."""
    char = np.dtype(dtype).char.upper() if not isinstance(dtype, str) \
        else dtype.upper()
    if char in ('G',):
        return None
    return fftlib.get(char[:1] if char not in 'FD' else char)


def get_planned_FFT(input_array, output_array, axes=(-1,), kind=C2C_FORWARD,
                    threads=1, flags=(0,), normalization=1.0, device=None):
    """Return a planned :class:`FFT` instance
    (reference: fftw/factory.py:52-107)."""
    dtype = np.dtype(input_array.dtype).char
    assert dtype.upper() in fftlib, \
        f"unsupported precision {dtype!r}; the tiers are f32/f64"
    cls = fftlib[dtype.upper()]
    return cls(input_array, output_array, axes, kind, threads, flags,
               normalization, device=device)


# ---------------------------------------------------------------------------
# wisdom == the built kernel libraries
# ---------------------------------------------------------------------------

def _wisdom_dir(filename):
    base = str(filename)
    if base.endswith('.wisdom'):
        base = base[:-len('.wisdom')]
    return Path(base + '.kernels')


def export_wisdom(filename):
    """Keep the built kernels under ``filename``: the libraries built so
    far are copied there, and every kernel built from now on is built
    there (reference: fftw/factory.py:109-134)."""
    d = _wisdom_dir(filename)
    d.mkdir(parents=True, exist_ok=True)
    if _build.BUILD_DIR.is_dir():
        for f in _build.BUILD_DIR.glob('*.so'):
            shutil.copy2(f, d / f.name)
    _build.BUILD_DIR = d
    _build.unload()


def import_wisdom(filename):
    """Load the kernels from a directory written by :func:`export_wisdom`
    (reference: fftw/factory.py:136-163); a library whose sources changed
    since is built anew there."""
    d = _wisdom_dir(filename)
    if not d.is_dir():
        raise AssertionError(f"Not able to import wisdom {filename}")
    _build.BUILD_DIR = d
    _build.unload()


def forget_wisdom():
    """Drop the loaded kernels and the cached twiddle tables
    (reference: fftw/factory.py:165-167)."""
    _build.unload()
    butterfly._tw_tensor.cache_clear()
    butterfly._tw_tensor_pair.cache_clear()
    butterfly._tw_tensor_axis.cache_clear()
    butterfly._tw_tensor_powers.cache_clear()
    matfft._const.cache_clear()
    fft2stage._table_tensor.cache_clear()


def set_timelimit(limit):
    """A no-op kept for API parity (reference: fftw/factory.py:169-178):
    building the kernels has no time budget."""


def cleanup():
    """Release the loaded kernels (reference: fftw/factory.py:180-182)."""
    forget_wisdom()
