"""Planar-complex FFT on one device: the port's ``PlanarPFFT``.

Port of the single-device path of ``mpi4py_fft_tpu/parallel/planar.py``
(constructor :92-247, ``_forward_impl``/``_backward_impl`` :621-705,
``forward``/``backward`` :723-731, ``forward_fn``/``backward_fn``
:736-752, ``_check_shape`` :708, ``global_shape`` :787, and the quartered
schedule ``quartered``/``forward_fn_q``/``backward_fn_q`` :759-785).  A
complex field of global shape S is a real tensor of shape (2,) + S.  On
one device the pipeline is one transform per axis (``ops/matfft.py``) and
the 3/2-rule truncation or padding between them (``libfft.py``); the
pencil constraints of the JAX package do nothing there and are gone.
A 3-D c2c f32 plan without padding can also hold its volume as four
quarters (``ops/oop3d.py``) and transform them out of place pass by pass.

API sketch::

    pfft = PlanarPFFT(None, (1024, 1024, 1024), dtype='F')   # c2c, on CUDA
    u = torch.zeros(pfft.global_shape(False), device=pfft.device)
    u_hat = pfft.forward(u)      # planar (2, 1024, 1024, 1024), normalized
    u2 = pfft.backward(u_hat)

    qs = list(oop3d.split_q(u))              # when pfft.quartered
    qs = pfft.backward_fn_q(list(pfft.forward_fn_q(qs)))
    u3 = oop3d.assemble_q(qs)

float32 ('f'/'F') and float64 ('d'/'D') plans run the same pipeline, with
and without ``padding``: the kernels have an fp64 build, which takes the
place of the JAX package's double-single branch (``_forward_ds``/
``_backward_ds`` and its gates).  On CUDA, float64 axes over 1024 wait
for the fp64 build of the pair kernel, and the quartered schedule is
float32 only, as in the JAX package.

Several devices (``comm``/``grid`` of more than one device, or
``executor='shard_map'``) raise NotImplementedError until the distributed
layer arrives (ROADMAP Queue 1 item 4).
"""
import numpy as np
import torch

from ..ops import matfft, oop3d
from ..libfft import truncate_planar, pad_planar
from ..utils import resolve_device
from .pencil import _multi_device

__all__ = ['PlanarPFFT']


def _one_device(comm, grid, executor):
    multi = _multi_device('PlanarPFFT')
    if executor == 'shard_map':
        raise multi
    if executor not in ('auto', 'gspmd'):
        raise ValueError(f"unknown executor {executor!r}")
    if comm is not None and comm.Get_size() != 1:
        raise multi
    if grid is not None and int(np.prod(grid)) != 1:
        raise multi


class PlanarPFFT(object):
    """FFT in planar-complex form on one device.

    Parameters mirror the JAX package's ``PlanarPFFT``: c2c (complex input
    as planar (2,)+S, dtype 'F'/'D') and r2c/c2r (real input, dtype
    'f'/'d'), with optional 3/2-rule ``padding``.  ``device`` is where the
    plan runs: CUDA by default, ``'cpu'`` for the plain versions.  On one
    device ``pad_spectrum``, ``donate`` and ``a2a_chunks`` change nothing.
    """

    def __init__(self, comm=None, shape=None, axes=None, dtype='f',
                 grid=None, donate=False, padding=False, pad_spectrum=False,
                 executor='auto', a2a_chunks=None, device=None):
        _one_device(comm, grid, executor)
        shape = list(int(s) for s in shape)
        ndim = len(shape)
        if axes is None:
            axes = tuple(range(ndim))
        axes = tuple(a % ndim for a in axes)
        dtype = np.dtype(dtype)
        if dtype.char not in 'fdFD':
            raise ValueError(f"dtype must be one of f, d, F, D; got {dtype}")
        self.real_transform = dtype.char in 'fd'
        self.rdtype = np.dtype('float32') if dtype.char in 'fF' \
            else np.dtype('float64')
        self.device = resolve_device(device, 'PlanarPFFT')
        self._tdtype = torch.float32 if self.rdtype == np.float32 \
            else torch.float64

        # dealiasing: inflate physical shape, re-derive exact factors
        self._pad = [1.0] * ndim
        if padding is not False and padding is not None:
            padding = [padding] * ndim if np.ndim(padding) == 0 \
                else list(padding)
            if len(padding) != ndim:
                raise ValueError("padding needs one factor per dim")
            for ax in axes:
                if padding[ax] > 1.0 + 1e-6:
                    old = float(shape[ax])
                    shape[ax] = int(np.floor(shape[ax] * padding[ax]))
                    self._pad[ax] = shape[ax] / old
        shape = tuple(shape)

        self.axes = axes
        self._input_shape = shape
        # truncated spectral extents per axis (== padded extent when no
        # dealiasing); r2c halves the first-transformed axis
        self._trunc = {ax: int(np.round(shape[ax] / self._pad[ax]))
                       for ax in axes}
        out_shape = list(shape)
        for ax in axes:
            out_shape[ax] = self._trunc[ax]
        if self.real_transform:
            out_shape[axes[-1]] = self._trunc[axes[-1]] // 2 + 1
        self._output_shape = tuple(out_shape)
        self._norm = 1.0 / float(np.prod([shape[a] for a in axes]))

    @property
    def quartered(self):
        """True when forward_fn_q/backward_fn_q apply to this plan: plain
        3-D c2c in natural axis order, no dealiasing, float32, and quarter
        shapes the kernels take (one device is all the port has)."""
        return (not self.real_transform
                and len(self._input_shape) == 3
                and tuple(self.axes) == (0, 1, 2)
                and not any(self._padded(a) for a in self.axes)
                and oop3d.supported_q(self._input_shape, self.rdtype))

    def _check_quarters(self, qs):
        if not self.quartered:
            raise ValueError("this plan has no quartered schedule (see "
                             "PlanarPFFT.quartered)")
        X, Y, Z = self._input_shape
        want = (2, X // 2, Y, Z // 2)
        if len(qs) != 4:
            raise ValueError(f"need 4 quarters, got {len(qs)}")
        for q in qs:
            if tuple(q.shape) != want:
                raise ValueError(f"quarter of shape {tuple(q.shape)}, the "
                                 f"plan's quarters are {want}")
            if q.device != self.device or q.dtype != self._tdtype:
                raise ValueError(f"quarter of {q.dtype} on {q.device}, "
                                 f"plan of {self._tdtype} on {self.device}")

    def forward_fn_q(self, qs, normalize=True):
        """Forward transform of a quartered planar volume (see
        ``ops/oop3d.split_q``); returns the transformed quarters, with the
        normalization folded into the last pass.  A list given is emptied
        so that each input quarter is freed once its pass is done."""
        self._check_quarters(qs)
        return oop3d.fft3_q(qs, True,
                            scale=self._norm if normalize else None)

    def backward_fn_q(self, qs, normalize=False):
        """Backward transform of a quartered planar spectrum."""
        self._check_quarters(qs)
        return oop3d.fft3_q(qs, False,
                            scale=self._norm if normalize else None)

    def _padded(self, ax):
        return self._pad[ax] > 1.0 + 1e-8

    def _forward_impl(self, x, normalize):
        axes = self.axes
        ax0 = axes[-1]
        if self.real_transform:
            with torch.profiler.record_function("planar_stage0_r2c"):
                p = matfft.rfftn_p(x, (ax0,))
                if self._padded(ax0):
                    p = truncate_planar(p, 1 + ax0,
                                        self._trunc[ax0] // 2 + 1,
                                        hermitian=True)
        else:
            with torch.profiler.record_function("planar_stage0"):
                p = matfft.fft1d_p(x, ax0, True)
                if self._padded(ax0):
                    p = truncate_planar(p, 1 + ax0, self._trunc[ax0],
                                        hermitian=False)
        nmid = len(axes) - 1
        folded = False
        for i, ax in enumerate(reversed(axes[:-1])):
            last = (i == nmid - 1)
            sc = self._norm if (normalize and last) else None
            folded = folded or sc is not None
            with torch.profiler.record_function(f"planar_stage{i + 1}"):
                p = matfft.fft1d_p(p, ax, True, scale=sc)
                if self._padded(ax):
                    p = truncate_planar(p, 1 + ax, self._trunc[ax],
                                        hermitian=False)
        if normalize and not folded:
            p = p * self._norm
        return p

    def _backward_impl(self, p, normalize):
        axes = self.axes
        for i, ax in enumerate(axes[:-1]):
            with torch.profiler.record_function(f"planar_bstage{i}"):
                if self._padded(ax):
                    p = pad_planar(p, 1 + ax, self._input_shape[ax],
                                   hermitian=False)
                p = matfft.fft1d_p(p, ax, False)
        ax0 = axes[-1]
        sc = self._norm if normalize else None
        with torch.profiler.record_function("planar_bstage_last"):
            if self.real_transform:
                if self._padded(ax0):
                    p = pad_planar(p, 1 + ax0,
                                   self._input_shape[ax0] // 2 + 1,
                                   hermitian=True)
                return matfft.irfftn_p(p, (ax0,), self._input_shape[ax0],
                                       scale=sc)
            if self._padded(ax0):
                p = pad_planar(p, 1 + ax0, self._input_shape[ax0],
                               hermitian=False)
            return matfft.fft1d_p(p, ax0, False, scale=sc)

    def _check_shape(self, x, forward_output):
        want = tuple(self.global_shape(forward_output))
        got = tuple(x.shape)
        if got != want:
            raise ValueError(f"array shape {got} does not match the "
                             f"planned shape {want}")
        if x.device != self.device:
            raise ValueError(f"tensor on {x.device}, plan on {self.device}")
        if x.dtype != self._tdtype:
            raise TypeError(f"tensor of {x.dtype}, plan of {self._tdtype}")

    def forward(self, x, normalize=True):
        """Forward transform; real input (r2c) or planar input (c2c)."""
        self._check_shape(x, False)
        return self._forward_impl(x, bool(normalize))

    def backward(self, p, normalize=False):
        """Backward transform; planar input, real (c2r) or planar output."""
        self._check_shape(p, True)
        return self._backward_impl(p, bool(normalize))

    # PyTorch runs eagerly: the composable forms are the same calls
    forward_fn = forward
    backward_fn = backward

    def global_shape(self, forward_output=False):
        if forward_output:
            return (2,) + self._output_shape
        if self.real_transform:
            return self._input_shape
        return (2,) + self._input_shape
