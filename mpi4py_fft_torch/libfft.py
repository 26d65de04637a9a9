"""Serial transform with pluggable backends and 3/2-rule dealiasing.

Port of ``mpi4py_fft_tpu/libfft.py`` (reference: mpi4py_fft/libfft.py):

* ``truncate_spectral``/``pad_spectral`` (:35-107) on complex tensors (and
  numpy arrays, for the host backends), and ``truncate_planar``/
  ``pad_planar`` (:116-166) on planar (2,) + S tensors, the engine's
  (``ops/matfft.py``) under their names here: the reference's 3/2 rule,
  with the Nyquist mode folded on truncation and split on padding for
  even extents;
* the backend planners: the device planner (``_plan_jax`` :173, here
  ``_plan_device``) under the JAX package's names ``'jax'``, ``'fftw'``,
  ``'pyfftw'`` and ``'pallas'``, which plans the port's kernels; the host
  planners ``'numpy'``/``'mkl_fft'`` and ``'scipy'`` (:225-260), kept as
  cross-checks.  The JAX host planner ``'torch'`` (host ``torch.fft``)
  raises NotImplementedError (ROADMAP Queue 1 item 8): ``torch.fft`` is a
  test oracle only;
* ``FFTBase``/``FFT`` (:321-565): the buffer-style ``forward``/
  ``backward``, the stage functions ``forward_fn``/``backward_fn`` on
  complex tensors and ``forward_fn_p``/``backward_fn_p`` on planar ones.
  A single-axis padded stage is one engine call (``ops/matfft.py``
  ``fft1d_p``/``rfftn_p``/``irfftn_p`` with ``trunc``/``pad``), which
  runs the fused kernels where the JAX package does (:462-538), with the
  stage's normalization folded in.  The JAX package's TPU-only gate
  ``fused_tp_enabled`` is not ported: on CUDA the kernels run, on the CPU
  the same dispatch reaches their plain versions.

A device-backend ``FFT`` runs on ``device``: CUDA unless the caller asks
for the CPU.  Its buffers are host arrays of ``utils.aligned`` (virtual
pages until the buffer API writes them), so building a plan allocates no
device memory.
"""
import numpy as np

from . import ops as fftw
from .ops import matfft
from .ops.matfft import truncate_planar, pad_planar
from .ops.plan import _host, pipeline_form

__all__ = ['FFT', 'FFTBase', 'truncate_spectral', 'pad_spectral',
           'truncate_planar', 'pad_planar']


def _take_slice(ndim, axis, sl):
    s = [slice(None)] * ndim
    s[axis] = sl
    return tuple(s)


def _zeros(like, shape):
    if isinstance(like, np.ndarray):
        return np.zeros(shape, dtype=like.dtype)
    return like.new_zeros(shape)


# ---------------------------------------------------------------------------
# 3/2-rule truncation / zero-padding of complex arrays
# ---------------------------------------------------------------------------

def truncate_spectral(padded, trunc_shape, axis, real_transform):
    """Spectral truncation along ``axis`` (forward direction of
    dealiasing) of a complex tensor or numpy array.

    Reference semantics: libfft.py:263-284 (_truncation_forward).
    """
    N = trunc_shape[axis]
    ndim = len(trunc_shape)
    if real_transform:
        trunc = padded[_take_slice(ndim, axis, slice(0, N))]
        trunc = trunc.copy() if isinstance(trunc, np.ndarray) \
            else trunc.clone()
        if N % 2 == 0:
            sl = _take_slice(ndim, axis, slice(N - 1, N))
            trunc[sl] = 2.0 * trunc[sl].real
        return trunc
    head = padded[_take_slice(ndim, axis, slice(0, N // 2 + 1))]
    tail = padded[_take_slice(ndim, axis, slice(padded.shape[axis] - N // 2,
                                                padded.shape[axis]))]
    trunc = _zeros(padded, tuple(trunc_shape))
    trunc[_take_slice(ndim, axis, slice(0, N // 2 + 1))] = head
    trunc[_take_slice(ndim, axis, slice(N - N // 2, N))] += tail
    return trunc


def pad_spectral(trunc, padded_shape, axis, real_transform):
    """Spectral zero-padding along ``axis`` (backward direction of
    dealiasing) of a complex tensor or numpy array, with the symmetric
    Fourier interpolator for even N.

    Reference semantics: libfft.py:286-311 (_padding_backward).
    """
    N = trunc.shape[axis]
    Np = padded_shape[axis]
    ndim = len(padded_shape)
    padded = _zeros(trunc, tuple(padded_shape))
    if real_transform:
        padded[_take_slice(ndim, axis, slice(0, N))] = trunc
        if N % 2 == 0:
            se = _take_slice(ndim, axis, slice(N - 1, N))
            padded[se] = 0.5 * padded[se].real
        return padded
    s_head = _take_slice(ndim, axis, slice(0, N // 2 + 1))
    padded[s_head] = trunc[s_head]
    padded[_take_slice(ndim, axis, slice(Np - N // 2, Np))] = \
        trunc[_take_slice(ndim, axis, slice(N - N // 2, N))]
    if N % 2 == 0:
        padded[_take_slice(ndim, axis, slice(N // 2, N // 2 + 1))] *= 0.5
        padded[_take_slice(ndim, axis,
                           slice(Np - N // 2, Np - N // 2 + 1))] *= 0.5
    return padded


# ---------------------------------------------------------------------------
# backend planners
# ---------------------------------------------------------------------------

def _plan_device(shape, axes, dtype, transforms, device):
    """Forward and backward plans of the port's kernels on ``device``
    (``_plan_jax`` of the JAX package; role of reference libfft.py:48-79
    _Xfftn_plan_fftw).  The buffers are host arrays whose pages stay
    virtual unless the buffer API is used; the stage functions never
    touch them."""
    transforms = {} if transforms is None else transforms
    if tuple(axes) in transforms:
        plan_fwd, plan_bck = transforms[tuple(axes)]
    elif np.issubdtype(dtype, np.floating):
        plan_fwd, plan_bck = fftw.rfftn, fftw.irfftn
    else:
        plan_fwd, plan_bck = fftw.fftn, fftw.ifftn
    s = tuple(np.take(shape, axes))
    U = fftw.aligned(shape, dtype=dtype)
    xfftn_fwd = plan_fwd(U, s=s, axes=axes, device=device)
    V = xfftn_fwd.output_array
    xfftn_bck = plan_bck(V, s=s, axes=axes, output_array=U, device=device)
    return (xfftn_fwd, xfftn_bck)


class _Yfftn_wrap(object):
    """Wrap numpy/scipy host transforms to the FFTW call style
    (reference: libfft.py:146-185)."""

    def __init__(self, xfftn_obj, input_array, output_array, M, opt):
        self.xfftn = xfftn_obj
        self.opt = opt
        self.M = M
        self.input_array = input_array
        self.output_array = output_array

    def __call__(self, *args, **kwargs):
        self.opt.update(kwargs)
        self.output_array[...] = self.xfftn(self.input_array, **self.opt)
        if abs(self.M - 1) > 1e-8:
            self.output_array *= self.M
        return self.output_array

    def fn(self, x):
        """The transform of host array ``x`` (not a device path)."""
        y = np.asarray(self.xfftn(np.asarray(x), **self.opt))
        y = y.astype(np.asarray(self.output_array).dtype)
        if abs(self.M - 1) > 1e-8:
            y = y * self.M
        return y


def _plan_numpy(shape, axes, dtype, transforms):
    """Reference: libfft.py:81-102 (_Xfftn_plan_numpy)."""
    transforms = {} if transforms is None else transforms
    if tuple(axes) in transforms:
        plan_fwd, plan_bck = transforms[tuple(axes)]
    elif np.issubdtype(dtype, np.floating):
        plan_fwd, plan_bck = np.fft.rfftn, np.fft.irfftn
    else:
        plan_fwd, plan_bck = np.fft.fftn, np.fft.ifftn
    s = tuple(np.take(shape, axes))
    U = fftw.aligned(shape, dtype=dtype)
    V = plan_fwd(U, s=s, axes=axes).astype(np.dtype(dtype).char.upper())
    V = fftw.aligned_like(V)
    M = np.prod(s)
    # numpy: forward unscaled, backward scaled by 1/N -> undo with M
    return (_Yfftn_wrap(plan_fwd, U, V, 1, {'s': s, 'axes': axes}),
            _Yfftn_wrap(plan_bck, V, U, M, {'s': s, 'axes': axes}))


def _plan_scipy(shape, axes, dtype, transforms):
    """Reference: libfft.py:128-144 (_Xfftn_plan_scipy), complex only."""
    transforms = {} if transforms is None else transforms
    if tuple(axes) in transforms:
        plan_fwd, plan_bck = transforms[tuple(axes)]
    else:
        from scipy.fftpack import fftn, ifftn
        plan_fwd, plan_bck = fftn, ifftn
    s = tuple(np.take(shape, axes))
    U = fftw.aligned(shape, dtype=dtype)
    V = plan_fwd(U, shape=s, axes=axes)
    V = fftw.aligned_like(np.ascontiguousarray(V))
    M = np.prod(s)
    return (_Yfftn_wrap(plan_fwd, U, V, 1, {'shape': s, 'axes': axes}),
            _Yfftn_wrap(plan_bck, V, U, M, {'shape': s, 'axes': axes}))


def _plan_torch(shape, axes, dtype, transforms):
    raise NotImplementedError(
        "backend 'torch' (a host planner on torch.fft) is not ported: "
        "torch.fft is the port's test oracle, never its engine (ROADMAP "
        "Queue 1 item 8); use 'numpy' or 'scipy' for a host cross-check")


class _Xfftn_wrap(object):
    """Common buffer-style interface for serial transforms
    (reference: libfft.py:187-219)."""

    def __init__(self, xfftn_obj, input_array, output_array):
        self.xfftn = xfftn_obj
        self.input_array = input_array
        self.output_array = output_array

    def __call__(self, input_array=None, output_array=None, **options):
        if input_array is not None:
            self.input_array[...] = _host(input_array)
        self.xfftn(**options)
        if output_array is not None:
            output_array[...] = self.output_array
            return output_array
        return self.output_array


class FFTBase(object):
    """Base class for serial transforms (reference: libfft.py:221-311)."""

    def __init__(self, shape, axes=None, dtype=float, padding=False):
        shape = list(shape) if np.ndim(shape) else [shape]
        assert len(shape) > 0
        assert min(shape) > 0
        if axes is not None:
            axes = list(axes) if np.ndim(axes) else [axes]
            for i, axis in enumerate(axes):
                if axis < 0:
                    axes[i] = axis + len(shape)
        else:
            axes = list(range(len(shape)))
        assert min(axes) >= 0
        assert max(axes) < len(shape)
        assert 0 < len(axes) <= len(shape)
        assert sorted(axes) == sorted(set(axes))
        dtype = np.dtype(dtype)
        assert dtype.char in 'fdFD', \
            f"dtype {dtype} not in the precision tiers (f32/f64)"
        self.shape = shape
        self.axes = axes
        self.dtype = dtype
        self.padding = padding
        self.real_transform = np.issubdtype(dtype, np.floating)
        self.padding_factor = 1


class FFT(FFTBase):
    """Serial transform over a set of axes with optional dealiasing padding
    (reference: libfft.py:314-434).

    forward is normalized by default, backward is not, as in the
    reference (libfft.py:408-422).  ``device`` is where a device-backend
    plan runs: CUDA unless the caller asks for the CPU.
    """

    def __init__(self, shape, axes=None, dtype=float, padding=False,
                 backend='jax', transforms=None, device=None, **kw):
        FFTBase.__init__(self, shape, axes, dtype, padding)
        host_map = {'numpy': _plan_numpy, 'mkl_fft': _plan_numpy,
                    'scipy': _plan_scipy, 'torch': _plan_torch}
        if backend in host_map:
            self._host_backend = True
            self.fwd, self.bck = host_map[backend](
                self.shape, self.axes, self.dtype, transforms)
            self.M = 1. / np.prod(np.take(self.shape, self.axes))
            self.device = None
        elif backend in ('jax', 'fftw', 'pyfftw', 'pallas'):
            self._host_backend = False
            self.fwd, self.bck = _plan_device(self.shape, self.axes,
                                              self.dtype, transforms, device)
            self.M = self.fwd.get_normalization()
            self.device = self.fwd.device
        else:
            raise KeyError(backend)
        self.backend = backend
        U, V = self.fwd.input_array, self.fwd.output_array
        if backend == 'scipy':
            self.real_transform = False  # complex-only backend
        self.padding_factor = 1.0
        if padding is not False:
            self.padding_factor = padding[self.axes[-1]] \
                if np.ndim(padding) else padding
        if self._padded:
            assert len(self.axes) == 1, \
                "padding is only supported for single (non-collapsed) axes"
            trunc_array = self._get_truncarray(shape, V.dtype)
            self.forward = _Xfftn_wrap(self._forward, U, trunc_array)
            self.backward = _Xfftn_wrap(self._backward, trunc_array, U)
        else:
            self.forward = _Xfftn_wrap(self._forward, U, V)
            self.backward = _Xfftn_wrap(self._backward, V, U)

    @property
    def _padded(self):
        return abs(self.padding_factor - 1.0) > 1e-8

    # ------------------------------------------------------------------
    # stage functions on complex tensors (host arrays for host backends)
    # ------------------------------------------------------------------
    def _stage_shape(self, data_shape, planned_shape, axis):
        """The data's own shape with the planned extent along ``axis``."""
        sh = list(data_shape)
        sh[axis] = planned_shape[axis]
        return tuple(sh)

    def forward_fn(self, x, normalize=True):
        """Forward stage: core transform, truncation, normalization.  On
        a device backend, :meth:`forward_fn_p` between the complex
        boundary copies."""
        if not self._host_backend:
            y = self.forward_fn_p(
                pipeline_form(x, self.input_planar, self.device), normalize)
            return matfft.unplanar(y) if self.output_planar else y
        y = self.fwd.fn(x)
        if self._padded:
            axis = self.axes[-1]
            y = truncate_spectral(
                y, self._stage_shape(y.shape,
                                     self.forward.output_array.shape, axis),
                axis, self.real_transform)
        if normalize:
            y = y * self.M
        return y

    def backward_fn(self, x, normalize=False):
        """Backward stage: zero-padding, core transform.  On a device
        backend, :meth:`backward_fn_p` between the complex boundary
        copies."""
        if not self._host_backend:
            y = self.backward_fn_p(
                pipeline_form(x, self.output_planar, self.device), normalize)
            return matfft.unplanar(y) if self.input_planar else y
        if self._padded:
            axis = self.axes[-1]
            x = pad_spectral(
                x, self._stage_shape(x.shape, self.bck.input_array.shape,
                                     axis),
                axis, self.real_transform)
        y = self.bck.fn(x)
        if normalize:
            y = y * self.M
        return y

    # ------------------------------------------------------------------
    # stage functions on planar tensors (the pipeline form)
    # ------------------------------------------------------------------
    @property
    def input_planar(self):
        """True if this stage's pipeline-form input is planar."""
        return not self._host_backend and self.fwd.input_planar

    @property
    def output_planar(self):
        """True if this stage's pipeline-form output is planar."""
        return not self._host_backend and self.fwd.output_planar

    def forward_fn_p(self, p, normalize=True):
        """Planar forward stage: transform, truncation, normalization
        (pipeline form of :meth:`forward_fn`)."""
        assert not self._host_backend
        axis = self.axes[-1]
        if self._padded and self.output_planar:
            Nt = self.forward.output_array.shape[axis]
            sc = float(self.M) if normalize else None
            if self.real_transform:
                return matfft.rfftn_p(p, (axis,), trunc=Nt, scale=sc)
            return matfft.fft1d_p(p, axis, True, scale=sc, trunc=Nt)
        y = self.fwd.fn_p(p, normalize=False)
        if self._padded:
            # a padded r2r stage: real data, as the JAX package
            y = truncate_spectral(
                y, self._stage_shape(y.shape, self.forward.output_array.shape,
                                     axis),
                axis, self.real_transform)
        if normalize:
            y = y * self.M
        return y

    def backward_fn_p(self, p, normalize=False):
        """Planar backward stage: zero-padding, transform (pipeline form
        of :meth:`backward_fn`)."""
        assert not self._host_backend
        axis = self.axes[-1]
        if self._padded and self.output_planar:
            sc = float(self.M) if normalize else None
            if self.real_transform:
                return matfft.irfftn_p(p, (axis,),
                                       self.bck.output_array.shape[axis],
                                       scale=sc)
            return matfft.fft1d_p(p, axis, False, scale=sc,
                                  pad=self.bck.input_array.shape[axis])
        if self._padded:
            # a padded r2r stage: real data, as the JAX package
            p = pad_spectral(
                p, self._stage_shape(p.shape, self.bck.input_array.shape,
                                     axis),
                axis, self.real_transform)
        y = self.bck.fn_p(p, normalize=False)
        if normalize:
            y = y * self.M
        return y

    # ------------------------------------------------------------------
    # buffer-style path (serial user API, reference: libfft.py:408-422)
    # ------------------------------------------------------------------
    def _forward(self, **kw):
        normalize = kw.pop('normalize', True)
        y = self.forward_fn(self.forward.input_array, normalize=normalize)
        self.forward.output_array[...] = _host(y)
        return self.forward.output_array

    def _backward(self, **kw):
        normalize = kw.pop('normalize', False)
        y = self.backward_fn(self.backward.input_array, normalize=normalize)
        self.backward.output_array[...] = _host(y)
        return self.backward.output_array

    def _get_truncarray(self, shape, dtype):
        """The truncated spectral array (reference: libfft.py:424-434)."""
        axis = self.axes[-1]
        shape = list(shape)
        shape[axis] = int(np.round(shape[axis] / self.padding_factor))
        if self.real_transform:
            shape[axis] = shape[axis] // 2 + 1
        return fftw.aligned(shape, dtype=dtype)
