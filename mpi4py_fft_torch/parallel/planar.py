"""Planar-complex FFT: the port's ``PlanarPFFT``.

Port of ``mpi4py_fft_tpu/parallel/planar.py``: the constructor
(:92-247), the per-shard executor (``_forward_local`` :443,
``_overlapped_step`` :510, ``_backward_local`` :528 and the padded r2c
extent ``_hpad_ext`` :154-173), ``forward``/``backward`` :723-752,
``global_shape`` :787, and the quartered schedule (``quartered``/
``forward_fn_q``/``backward_fn_q`` :759-785).  A complex field of global
shape S is a real tensor of shape (2,) + S.

One executor serves one rank and several, as ``PFFT``'s does
(``parallel/mpifft.py``); the JAX package's global-program pipeline
(``_forward_impl``/``_backward_impl`` :621-705) has no counterpart.
Each rank holds its block of the pencil decomposition
(``parallel/pencil.py``; ``comm`` a process group, see ``multihost``):
``forward`` takes this rank's block of the input and returns its block
of the spectrum.  Each stage is one engine call (``ops/matfft.py``) on
the local block, and one ``all_to_all_single`` over the group of the
swapped axes moves blocks between stages, chunked so that the exchanges
overlap the stages (``parallel/overlap.py``).  On one rank the block is
the whole field and nothing moves: an exchange over a group of one
returns its input, and no step adds a copy.  Each stage cuts its axis
back to its true extent first, so the kernels see the lengths of the
one-rank layout; the r2c stage writes zero rows up to the extent the
first exchange splits evenly (``hext``), and the engine runs a dealiased
stage's truncation or padding in the kernels where they take it (B with
``trunc``, E with ``trunc``/``pad`` and the scale, C with the Hermitian
pad in its read).  A 3-D c2c f32 plan without padding on one rank can
also hold its volume as four quarters (``ops/oop3d.py``) and transform
them out of place pass by pass.

API sketch::

    pfft = PlanarPFFT(None, (1024, 1024, 1024), dtype='F')   # c2c, on CUDA
    u = torch.zeros(pfft.local_shape(False), device=pfft.device)
    u_hat = pfft.forward(u)      # planar (2, 1024, 1024, 1024), normalized
    u2 = pfft.backward(u_hat)

    qs = list(oop3d.split_q(u))              # when pfft.quartered
    qs = pfft.backward_fn_q(list(pfft.forward_fn_q(qs)))
    u3 = oop3d.assemble_q(qs)

Each ``forward``/``backward`` call is one span, ``pfft.forward`` or
``pfft.backward`` (the names of ``PFFT``'s transforms, which never call
this class), around the stages' spans ``planar_stage*`` and
``planar_bstage*`` (``utils/profiling.py``; a stage chunked beside an
exchange is a span a chunk).

float32 ('f'/'F') and float64 ('d'/'D') plans run the same pipeline, with
and without ``padding``, on one rank or several: the kernels have an fp64
build, which takes the place of the JAX package's double-single branch
(``_forward_ds``/``_backward_ds``, its shard form ``_forward_ds_shmap``/
``_backward_ds_shmap`` and its gates).  Every extent runs
(``ops/matfft.py`` takes the lengths no kernel takes); the quartered
schedule is float32 and one rank only, as in the JAX package.
"""
import numpy as np
import torch

from ..ops import matfft, oop3d
from . import overlap
from .comm import plan_device
from .pencil import Pencil, Subcomm, exchange, fit_axis, fit_block
from ..utils.profiling import annotate

__all__ = ['PlanarPFFT']


def _whole(p, ax, n):
    """Axis ``ax`` (held whole) cut back to its true extent ``n``,
    contiguous: the kernels take the one-rank layout."""
    return fit_axis(p, ax, n).contiguous()


class PlanarPFFT(object):
    """FFT in planar-complex form, on one rank or over several.

    Parameters mirror the JAX package's ``PlanarPFFT``: c2c (complex input
    as planar (2,)+S, dtype 'F'/'D') and r2c/c2r (real input, dtype
    'f'/'d'), with optional 3/2-rule ``padding``; ``comm``/``grid`` lay
    the ranks out as there.  ``device`` is where the plan runs: the
    rank's device, else CUDA; ``'cpu'`` for the plain versions.
    ``executor`` selects no code: it is checked and reported under the
    JAX package's names, ``'gspmd'`` on one rank and ``'shard_map'`` on
    several (``'auto'`` takes the one that fits).  On several ranks
    ``a2a_chunks`` sets the chunks of each exchange and ``pad_spectrum``
    keeps the r2c axis at ``hext`` rows in the spectrum; on one rank they
    and ``donate`` change nothing.
    """

    def __init__(self, comm=None, shape=None, axes=None, dtype='f',
                 grid=None, donate=False, padding=False, pad_spectrum=False,
                 executor='auto', a2a_chunks=None, device=None):
        if executor not in ('auto', 'gspmd', 'shard_map'):
            raise ValueError(f"unknown executor {executor!r}")
        self._a2a_cfg = overlap.chunk_count(a2a_chunks)
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

        if grid is not None:
            dims = list(grid) + [1] * (ndim - len(grid))
        else:
            dims = [0] * ndim
            dims[axes[-1]] = 1
        self.subcomm = Subcomm(comm, dims)
        if self.subcomm[axes[-1]].Get_size() != 1:
            raise ValueError(f"the grid distributes axis {axes[-1]}, which "
                             f"the plan transforms first")
        self.device = plan_device(self.subcomm.comm, device, 'PlanarPFFT')
        self._nmesh = int(np.prod(self.subcomm.sizes))
        if executor == 'auto':
            executor = 'shard_map' if self._nmesh > 1 else 'gspmd'
        elif executor == 'shard_map' and self._nmesh == 1:
            raise ValueError("the per-shard executor ('shard_map') needs "
                             "more than one rank")
        elif executor == 'gspmd' and self._nmesh > 1:
            raise ValueError("several ranks run the per-shard executor "
                             "('shard_map'); the global-program 'gspmd' "
                             "is the JAX package's")
        self.executor = executor

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

        # the pencil chain over the spectral shape, first-transformed axis
        # last (reference mpifft.py:308-338)
        self.pencils = [Pencil(self.subcomm, out_shape, axes[-1])]
        for ax in reversed(axes[:-1]):
            self.pencils.append(self.pencils[-1].pencil(ax))
        self.pencil = [Pencil(self.subcomm, list(shape), axes[-1]),
                       self.pencils[-1]]

        # r2c: the halved axis (N//2+1 rows) is split by the exchanges;
        # the r2c kernel writes zero rows up to the lcm of the group sizes
        # that shard it, so that they split evenly (JAX planar.py:154-173).
        # pad_spectrum keeps those rows in the spectrum the caller gets.
        self._pad_spectrum = bool(pad_spectrum)
        self._hpad_ext = None
        if self.real_transform:
            hax = axes[-1]
            q = 1
            for pen in self.pencils:
                q = int(np.lcm(q, pen.subcomm[hax].Get_size()))
            nh = self._output_shape[hax]
            if q > 1 and nh % q:
                self._hpad_ext = (-(-nh // q)) * q
        spec = list(self._output_shape)
        if self._pad_spectrum and self._hpad_ext is not None:
            spec[axes[-1]] = self._hpad_ext
        self._spec_shape = tuple(spec)
        self._out_pencil = Pencil(self.pencils[-1].subcomm, spec,
                                  self.pencils[-1].axis)

    @property
    def quartered(self):
        """True when forward_fn_q/backward_fn_q apply to this plan: plain
        3-D c2c in natural axis order, no dealiasing, float32, and quarter
        shapes the kernels take, on one rank."""
        return (self._nmesh == 1
                and not self.real_transform
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

    def _cut(self, ax):
        """The forward stage's ``trunc`` along ``ax``: its truncated
        extent where it is dealiased, else None."""
        return self._trunc[ax] if self._padded(ax) else None

    def _grow(self, ax):
        """The backward stage's ``pad`` along ``ax``: its padded extent
        where it is dealiased, else None."""
        return self._input_shape[ax] if self._padded(ax) else None

    def _step(self, p, i, ax, pre, post, forward):
        """One pipeline step between pencils[i] and pencils[i + 1]: the
        exchange, with the stage ``pre`` before it (backward) or ``post``
        after it (forward), chunked along an axis that takes part in
        neither (JAX ``_overlapped_step`` :510).  Over a group of one it
        is the stage alone."""
        pa, pb = self.pencils[i], self.pencils[i + 1]
        g = pa.subcomm[pb.axis]
        if forward:
            split, concat = pa.axis, pb.axis
            n_split = self._spec_shape[split]
        else:
            split, concat = pb.axis, pa.axis
            n_split = self._input_shape[split]

        def start(q):
            return exchange(q, 1 + split, 1 + concat, g, n_split)

        cands = [a for a in range(len(self._input_shape))
                 if a not in (pa.axis, pb.axis, ax)]
        n, c = 1, 0
        if g.Get_size() > 1 and cands:
            c = max(cands, key=lambda a: p.shape[1 + a])
            n = overlap.resolve(self._a2a_cfg, p.numel() * p.element_size(),
                                p.shape[1 + c])
        return overlap.overlapped(p, 1 + c, n, pre, start, post)

    def _forward_local(self, x, normalize):
        """This rank's forward program (JAX ``_forward_local`` :443) on
        its input block held at ``padded_local_shape``."""
        axes = self.axes
        ax0 = axes[-1]
        if self.real_transform:
            with annotate("planar_stage0_r2c"):
                nt0 = self._trunc[ax0] // 2 + 1 if self._padded(ax0) \
                    else None
                p = matfft.rfftn_p(x, (ax0,), trunc=nt0, hext=(
                    self._hpad_ext or self._output_shape[ax0]))
        else:
            with annotate("planar_stage0"):
                p = matfft.fft1d_p(x, ax0, True, trunc=self._cut(ax0))
        nmid = len(axes) - 1
        folded = False
        for i, ax in enumerate(reversed(axes[:-1])):
            sc = self._norm if (normalize and i == nmid - 1) else None
            folded = folded or sc is not None

            def stage(pc, i=i, ax=ax, sc=sc):
                with annotate(f"planar_stage{i + 1}"):
                    pc = _whole(pc, 1 + ax, self._input_shape[ax])
                    return matfft.fft1d_p(pc, ax, True, scale=sc,
                                          trunc=self._cut(ax))
            p = self._step(p, i, ax, None, stage, True)
        if normalize and not folded:
            p = p * self._norm
        return p

    def _backward_local(self, p, normalize):
        """This rank's backward program (JAX ``_backward_local`` :528) on
        its spectrum block held at ``padded_local_shape``."""
        axes = self.axes
        for i, ax in enumerate(axes[:-1]):

            def stage(pc, i=i, ax=ax):
                with annotate(f"planar_bstage{i}"):
                    pc = _whole(pc, 1 + ax, self._trunc[ax])
                    return matfft.fft1d_p(pc, ax, False, pad=self._grow(ax))
            p = self._step(p, len(axes) - 2 - i, ax, stage, None, False)
        ax0 = axes[-1]
        N0 = self._input_shape[ax0]
        sc = self._norm if normalize else None
        with annotate("planar_bstage_last"):
            p = _whole(p, 1 + ax0, self._output_shape[ax0])
            if self.real_transform:
                return matfft.irfftn_p(p, (ax0,), N0, scale=sc)
            return matfft.fft1d_p(p, ax0, False, scale=sc,
                                  pad=self._grow(ax0))

    # ------------------------------------------------------------------
    def _check_shape(self, x, forward_output):
        want = tuple(self.local_shape(forward_output))
        got = tuple(x.shape)
        if got != want:
            raise ValueError(f"array shape {got} does not match the "
                             f"planned shape {want}")
        if x.device != self.device:
            raise ValueError(f"tensor on {x.device}, plan on {self.device}")
        if x.dtype != self._tdtype:
            raise TypeError(f"tensor of {x.dtype}, plan of {self._tdtype}")

    def forward(self, x, normalize=True):
        """Forward transform; real input (r2c) or planar input (c2c), this
        rank's block of it.  One span ``pfft.forward`` a call."""
        self._check_shape(x, False)
        with annotate('pfft.forward'):
            off = 0 if self.real_transform else 1
            x = fit_block(x, self.pencil[0].padded_local_shape(), off)
            return fit_block(self._forward_local(x, bool(normalize)),
                             self._out_pencil.subshape, 1)

    def backward(self, p, normalize=False):
        """Backward transform; planar input, real (c2r) or planar output,
        this rank's block of it.  One span ``pfft.backward`` a call."""
        self._check_shape(p, True)
        with annotate('pfft.backward'):
            p = fit_block(p, self._out_pencil.padded_local_shape(), 1)
            y = self._backward_local(p, bool(normalize))
            off = 0 if self.real_transform else 1
            return fit_block(y, self.pencil[0].subshape, off)

    # PyTorch runs eagerly: the composable forms are the same calls
    forward_fn = forward
    backward_fn = backward

    def global_shape(self, forward_output=False):
        if forward_output:
            return (2,) + self._spec_shape
        if self.real_transform:
            return self._input_shape
        return (2,) + self._input_shape

    def local_shape(self, forward_output=False):
        """This rank's block of :meth:`global_shape` (the whole of it on
        one rank)."""
        if forward_output:
            return (2,) + self._out_pencil.subshape
        if self.real_transform:
            return self.pencil[0].subshape
        return (2,) + self.pencil[0].subshape

    def local_slice(self, forward_output=False):
        """The view of this rank's block into the global array."""
        pen = self._out_pencil if forward_output else self.pencil[0]
        sl = tuple(slice(s, s + n) for s, n in
                   zip(pen.substart, pen.subshape))
        return sl if not forward_output and self.real_transform \
            else (slice(0, 2),) + sl
