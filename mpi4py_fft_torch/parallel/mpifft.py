"""Parallel-FFT plan and executors: the port's ``PFFT``.

Port of ``mpi4py_fft_tpu/parallel/mpifft.py``: ``_axis_stage_list``
(:442), ``Transform`` (:97, with the per-shard executor ``_impl_shmap``
:158 and ``_shmap_local`` :188) and ``PFFT`` (:481-805, the executor
choice :653-673 and ``_build_shmap_plans`` :708), after the reference
orchestrator (mpi4py_fft/mpifft.py).  The plan is built as there: walk
the axes groups last to first, plan a serial transform (``libfft.FFT``)
per group and a pencil rotation (``Transfer``) between groups, with the
r2c and dealiasing fixups of the global shape.  Each stage is a planar
stage function (``FFT.forward_fn_p``/``backward_fn_p``), which dispatches
the port's kernels, the fused dealiasing kernel ``fft_axis_tp`` included.
Logically complex data travels planar, (2,) + shape real tensors; ``fn``
takes complex tensors and converts at its boundary (one copy each way).

On one rank the executor is the chain of stages (a rotation moves
nothing), and the plan reports ``executor == 'gspmd'``, as the JAX
package falls back to it on a one-device mesh.  On several ranks
(``comm`` a process group) every rank runs the per-shard executor
(``'shard_map'``) on its blocks: the input block is held at its pencil's
``padded_local_shape``, each rotation is one ``all_to_all_single``
(``Transfer.forward_start``), chunked to overlap the stage after it
(``parallel/overlap.py``), each stage cuts its axes back to their true
extents first, and the output is this rank's block.  ``transforms=``
maps an axes group to its own pair of planners (an r2r kind an axis:
``fftw.dctn``/``idctn`` and friends); such a stage keeps real data, so
the exchanges around it move real blocks, with no planar axis.
"""
import numpy as np
import torch

from ..distarray import DistArray
from ..libfft import FFT
from ..ops import matfft
from ..ops.plan import _host
from ..utils import torch_dtype
from ..utils.profiling import annotate
from . import overlap
from .comm import COMM_WORLD, DeviceComm, plan_device
from .pencil import Pencil, Subcomm, fit_axis, fit_block

__all__ = ['PFFT', 'Transform']


def _real_dtype(dtype):
    """The real numpy dtype of the same precision."""
    return np.dtype('float32') if np.dtype(dtype).char in 'fF' \
        else np.dtype('float64')


class Transform(object):
    """One direction of a parallel transform (reference: mpifft.py:8-79).

    ``stages`` are the per-group stage functions; ``steps`` the pencil
    rotations before stages[1:], each ``(start, size, cands)``: the
    function that starts it on a block, its group's size and the axes it
    may be chunked along; ``slices`` the (axis, true extent) pairs each
    stage cuts its block to; ``direction`` 'forward' or 'backward', which
    names the span of each call, ``pfft.<direction>``.  Calling the
    object has the reference's buffer semantics; :meth:`fn` and
    :meth:`fn_p` are the functions to compose (e.g. into a DNS time
    step)."""

    def __init__(self, pfft, stages, steps, slices, pencils, in_shape,
                 in_dtype, out_shape, out_dtype, default_normalize,
                 host_mode, direction, planars=None):
        assert len(stages) == len(steps) + 1 == len(slices)
        assert len(pencils) == 2
        self._pfft = pfft
        self._stages = tuple(stages)
        self._steps = tuple(steps)
        self._slices = tuple(slices)
        self._pencil = tuple(pencils)
        self._in_shape = tuple(in_shape)
        self._in_dtype = np.dtype(in_dtype)
        self._out_shape = tuple(out_shape)
        self._out_dtype = np.dtype(out_dtype)
        self._default_normalize = default_normalize
        self._host_mode = host_mode
        self._span = 'pfft.' + direction
        # planars[i]: whether the data entering stage i is planar (a
        # logical complex array as (2,) + shape real); planars[-1]
        # describes the output
        if planars is None:
            planars = (False,) * (len(stages) + 1)
        assert len(planars) == len(stages) + 1
        self._planars = tuple(bool(b) for b in planars)
        self._input_buffer = None
        self._output_buffer = None

    @property
    def device(self):
        return self._pfft.device

    @property
    def _in_local(self):
        return self._pencil[0].subshape

    @property
    def _out_local(self):
        return self._pencil[1].subshape

    # -- the chain of stages (pipeline form: complex data is planar) -------
    def _impl(self, x, normalize):
        """The executor on this rank's block (JAX ``_impl_shmap`` :158 and
        ``_shmap_local`` :188): the block held at its pencil's padded
        local shape, each rotation an exchange over its group, chunked
        along an axis it and the next stage leave alone so that chunk
        k + 1's exchange is in flight during chunk k's stage, each stage
        on its axes cut to their true extents; on one rank a rotation
        moves nothing."""
        pl = self._planars
        x = fit_block(x, self._pencil[0].padded_local_shape(), int(pl[0]))
        for i, stage in enumerate(self._stages):
            rin = int(pl[i])

            def post(q, i=i, stage=stage, rin=rin):
                for ax, n in self._slices[i]:
                    q = fit_axis(q, rin + ax, n)
                with annotate(f"pfft_stage{i}"):
                    return stage(q.contiguous(), normalize)
            if i == 0:
                x = post(x)
                continue
            start, size, cands = self._steps[i - 1]
            n, c = 1, 0
            if size > 1 and cands:
                c = max(cands, key=lambda a: x.shape[rin + a])
                n = overlap.resolve(self._pfft._a2a_cfg,
                                    x.numel() * x.element_size(),
                                    x.shape[rin + c])
            x = overlap.overlapped(
                x, rin + c, n, None,
                lambda q, start=start, rin=rin: start(q, rank=rin), post,
                out_axis=int(pl[i + 1]) + c)
        return fit_block(x, self._pencil[1].subshape, int(pl[-1]))

    def _impl_host(self, y, normalize):
        for stage in self._stages:
            y = stage(y, normalize)
        return y

    def fn_p(self, x, normalize=None):
        """The transform in pipeline form: a logically complex input or
        output travels as a planar (2,) + shape real tensor."""
        normalize = self._default_normalize if normalize is None \
            else normalize
        with annotate(self._span):
            return self._impl(x, normalize)

    def fn(self, x, normalize=None):
        """The transform of a tensor.  Complex tensors go planar at the
        boundary and the output comes back complex (a planar input on a
        complex plan gives a planar output, as ``fn_p``); each boundary
        copy runs in its span, ``pfft.planar`` or ``pfft.unplanar``."""
        normalize = self._default_normalize if normalize is None \
            else normalize
        if self._host_mode:
            return self._impl_host(_host(x), normalize)
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x), device=self.device)
        with annotate(self._span):
            was_complex = x.is_complex()
            if self._planars[0] and was_complex:
                with annotate('pfft.planar', _copy_bytes(x)):
                    x = matfft.planar(x)
            y = self._impl(x, normalize)
            if self._planars[-1] and (was_complex or not self._planars[0]):
                with annotate('pfft.unplanar', _copy_bytes(y)):
                    y = matfft.unplanar(y)
        return y

    # -- reference-style properties ---------------------------------------
    @property
    def input_pencil(self):
        return self._pencil[0]

    @property
    def output_pencil(self):
        return self._pencil[1]

    def _buffer(self, shape, dtype, pencil):
        return DistArray(shape, subcomm=pencil.subcomm, val=0, dtype=dtype,
                         alignment=pencil.axis, device=self.device)

    @property
    def input_array(self):
        """Persistent input DistArray, made at first use (reference:
        mpifft.py:26-29)."""
        if self._input_buffer is None:
            self._input_buffer = self._buffer(self._in_shape,
                                              self._in_dtype, self._pencil[0])
        return self._input_buffer

    @property
    def output_array(self):
        """Persistent output DistArray, made at first use (reference:
        mpifft.py:31-34)."""
        if self._output_buffer is None:
            self._output_buffer = self._buffer(self._out_shape,
                                               self._out_dtype,
                                               self._pencil[1])
        return self._output_buffer

    # -- execution ---------------------------------------------------------
    def _tensor(self, x, dtype):
        """``x`` (DistArray, tensor or array) as a tensor of numpy
        ``dtype`` on the plan's device; no copy when it is one already."""
        if isinstance(x, DistArray):
            x = x.v
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(device=self.device, dtype=torch_dtype(dtype))

    def __call__(self, input_array=None, output_array=None, **kw):
        """Execute the transform (reference: mpifft.py:46-79).

        Input and output are this rank's blocks (the global arrays on one
        rank): DistArrays, tensors or numpy arrays.  ``planar=True`` (also
        taken when a real array of the planar input shape comes in on a
        complex plan) runs on planar data on both sides.  Without
        ``output_array`` the result lands in the persistent
        :attr:`output_array`; with it, only there."""
        normalize = kw.pop('normalize', self._default_normalize)
        planar = kw.pop('planar', None)
        if planar and self._host_mode:
            raise ValueError("planar=True needs a device backend; host-mode "
                             "plans (numpy/scipy) take complex arrays")
        if input_array is None:
            input_array = self.input_array
        shape = tuple(input_array.shape)
        if not self._host_mode and planar is None and self._planars[0]:
            dt = getattr(input_array, 'dtype', None)
            real = (dt.is_floating_point if isinstance(dt, torch.dtype)
                    else np.dtype(dt).kind == 'f')
            planar = real and shape == (2,) + self._in_local
        if planar:
            want = (2,) + self._in_local if self._planars[0] \
                else self._in_local
            if shape != want:
                raise ValueError(f"planar path expects shape {want}, got "
                                 f"{shape}")
            y = self.fn_p(self._tensor(input_array,
                                       _real_dtype(self._in_dtype)),
                          bool(normalize))
            if output_array is None:
                return y
            if self._planars[-1] and \
                    tuple(output_array.shape) != (2,) + self._out_local:
                y = matfft.unplanar(y)
            _assign(output_array, y)
            return output_array
        if shape != self._in_local:
            raise ValueError(f"input shape {shape} != planned "
                             f"{self._in_local}")
        if self._host_mode:
            x = _host(input_array.v if isinstance(input_array, DistArray)
                      else input_array)
            y = self._impl_host(x.astype(self._in_dtype), normalize)
            y = torch.from_numpy(np.ascontiguousarray(y)).to(self.device)
        else:
            y = self.fn(self._tensor(input_array, self._in_dtype),
                        bool(normalize))
        if output_array is not None:
            _assign(output_array, y)
            return output_array
        out = self.output_array
        out._data = y
        return out


def _copy_bytes(x):
    """Bytes a boundary copy of ``x`` moves: ``x`` read, as many written
    (a complex tensor and its planar form hold the same bytes)."""
    return 2 * x.numel() * x.element_size()


def _assign(dst, y):
    """Copy tensor ``y`` into a DistArray, tensor or numpy array."""
    if isinstance(dst, DistArray):
        dst._data.copy_(y)
    elif isinstance(dst, torch.Tensor):
        dst.copy_(y)
    else:
        dst[...] = y.cpu().numpy()


def _axis_stage_list(axes, ndim, darray=None):
    """Turn the user's ``axes`` argument into the stage list the planner
    walks: a list of axis groups, one serial-transform stage each.

    Accepted spellings: ``None`` (every array axis, one stage per axis —
    when planning from a ``darray``, rotated so the array's aligned axis
    is transformed first), a bare int, a flat sequence of ints, or a
    nested sequence where an inner tuple keeps several axes together in
    one stage.  Negative indices wrap; duplicates within a group are
    rejected.  (Semantics of reference mpifft.py:213-240.)
    """
    if axes is None:
        order = list(range(ndim))
        if darray is not None:
            # transform the already-aligned axis in the first stage
            shift = ndim - 1 - darray.alignment
            order = order[-shift:] + order[:-shift] if shift else order
        return [[a] for a in order]
    entries = [axes] if isinstance(axes, int) else list(axes)
    stages = []
    for entry in entries:
        if isinstance(entry, (int, np.integer)):
            group = [int(entry)]
        else:
            if not isinstance(entry, (tuple, list)):
                raise AssertionError(
                    f"axes entry {entry!r}: expected an int or a "
                    "tuple/list of ints")
            group = [int(a) for a in entry]
        group = [a + ndim if a < 0 else a for a in group]
        for a in group:
            assert 0 <= a < ndim, f"axis {a} out of range for {ndim}-D data"
        assert 0 < len(group) <= ndim, f"bad axes group size {len(group)}"
        assert len(set(group)) == len(group), \
            f"axes group {group} repeats an axis"
        stages.append(group)
    return stages


class PFFT(object):
    """Parallel transform (reference: mpifft.py:82-419).

    Parameters follow the reference PFFT.  ``comm`` may be ``None`` (the
    process group once one is up, else one device), a
    :class:`DeviceComm`, a list of one device or a prebuilt
    :class:`Subcomm`.  ``backend='jax'`` (the default, or its aliases
    ``'fftw'``, ``'pyfftw'``, ``'pallas'``) runs the port's kernels;
    ``'numpy'``/``'scipy'`` run the same plan on host arrays of one rank
    as a cross-check.  ``device`` is where the plan runs: the rank's
    device, else CUDA unless the caller asks for the CPU (a ``darray``'s
    device when planning from one).  ``a2a_chunks`` sets the chunks of
    each exchange on several ranks (``parallel/overlap.py``).
    """

    def __init__(self, comm=None, shape=None, axes=None, dtype=float,
                 grid=None, padding=False, collapse=False, backend='jax',
                 transforms=None, darray=None, device=None, **kw):
        executor = kw.pop('executor', None)
        if executor not in (None, 'auto', 'gspmd', 'shard_map'):
            raise ValueError(f"unknown executor {executor!r}")
        self._a2a_cfg = overlap.chunk_count(kw.pop('a2a_chunks', None))
        if shape is None:
            assert darray is not None
            shape = darray.pencil.shape
        if darray is not None and device is None:
            device = darray.v.device

        axes = _axis_stage_list(axes, len(shape), darray)
        self.axes = axes
        shape = list(shape)

        if darray is None:
            dtype = np.dtype(dtype)
            assert dtype.char in 'fdFD', \
                f"dtype {dtype}: the tiers are f32/f64 (no long double)"

            # dealiasing: a padding factor > 1 on a single-axis stage grows
            # that axis of the physical grid, and the factor is re-derived
            # from the rounded extent so that the 3/2-rule truncation is
            # exact (reference: mpifft.py:247-253)
            if padding is not False:
                assert len(padding) == len(shape), \
                    "padding needs one factor per array axis"
                padding = list(padding)
                for group in axes:
                    if len(group) != 1:
                        continue
                    (a,) = group
                    if padding[a] > 1.0 + 1e-6:
                        unpadded = shape[a]
                        shape[a] = int(shape[a] * padding[a])  # floor
                        padding[a] = shape[a] / float(unpadded)

            self._input_shape = tuple(shape)
            assert shape and min(shape) > 0, f"bad global shape {shape}"

            slab = kw.pop('slab', False)

            # device grid (reference: mpifft.py:259-290): every axis of
            # the first stage must lie on a trivial device group
            if grid is not None:
                assert not isinstance(comm, Subcomm), \
                    "grid= conflicts with a prebuilt Subcomm"
                assert slab is False, "grid= conflicts with slab="
                assert len(grid) <= len(shape)
                comm = Subcomm(self._comm(comm), tuple(grid)
                               + (1,) * (len(shape) - len(grid)))

            if isinstance(comm, Subcomm):
                assert slab is False, "slab= conflicts with a Subcomm"
                assert len(comm) == len(shape)
                self.subcomm = comm
            else:
                if slab is False or slab is None:
                    dims = [0 if i not in axes[-1] else 1
                            for i in range(len(shape))]
                else:
                    if slab is True:
                        slab = (axes[-1][-1] + 1) % len(shape)
                    elif slab < 0:
                        slab += len(shape)
                    assert 0 <= slab < len(shape), f"bad slab axis {slab}"
                    dims = [1] * len(shape)
                    dims[slab] = 0
                self.subcomm = Subcomm(self._comm(comm), dims)
        else:
            # a plan from an existing DistArray: its decomposition and
            # dtype hold (reference: mpifft.py:209-219)
            dtype = darray.dtype
            self.subcomm = darray.subcomm_tuple
            self._input_shape = tuple(shape)
            padding = False
        for a in axes[-1]:
            if self.subcomm[a].Get_size() != 1:
                raise ValueError(f"the grid distributes axis {a}, which the "
                                 f"plan transforms before any rotation")
        comm = getattr(self.subcomm, 'comm', None)
        if comm is None:        # a darray's axis groups
            comm = next((c.mesh.comm for c in self.subcomm
                         if c.mesh is not None), None)
        self._nmesh = int(np.prod([c.Get_size() for c in self.subcomm]))
        self.device = plan_device(comm, device, 'PFFT')

        # stage merging (reference: mpifft.py:298-306): a stage whose axes
        # all sit on trivial device groups folds onto the stage after it
        # (on one device, every stage)
        self.collapse = collapse
        if collapse is True:
            merged = []
            for group in reversed(axes):
                free = all(self.subcomm[a].Get_size() == 1 for a in group)
                if free and merged:
                    merged[0][:0] = group
                else:
                    merged.insert(0, list(group))
            axes = [g for g in merged if g]

        self.axes = tuple(map(tuple, axes))
        self.xfftn = []
        self.transfer = []
        self.pencil = [None, None]
        self.backend = backend

        # the stage chain, back to front (reference: mpifft.py:308-338):
        # the last axes group is transformed first; every earlier group
        # costs one pencil rotation and one serial transform
        def serial_fft(cur_shape, group):
            return FFT(cur_shape, group, dtype, padding, backend=backend,
                       transforms=transforms, device=self.device, **kw)

        def spectral_fixup(xfftn, group, subcomm):
            """After a stage that changes the global geometry (r2c
            halving, dealiasing truncation), the chain goes on with the
            transformed extents and dtype; returns the pencil the next
            rotation starts from, or None where nothing changed, as after
            an r2r stage (reference: mpifft.py:319-322/332-335)."""
            nonlocal shape, dtype
            out = xfftn.forward.output_array
            if shape[group[-1]] == out.shape[group[-1]]:
                return None
            dtype = out.dtype
            shape = list(out.shape)
            return Pencil(subcomm, shape, group[-1])

        first = self.axes[-1]
        cursor = Pencil(self.subcomm, shape, first[-1])
        self.pencil[0] = cursor
        xfftn = serial_fft(shape, first)
        self.xfftn.append(xfftn)
        cursor = spectral_fixup(xfftn, first, self.subcomm) or cursor

        for group in reversed(self.axes[:-1]):
            rotated = cursor.pencil(group[-1])
            self.transfer.append(cursor.transfer(rotated, dtype))
            xfftn = serial_fft(shape, group)
            self.xfftn.append(xfftn)
            cursor = spectral_fixup(xfftn, group, rotated.subcomm) or rotated

        self.pencil[1] = cursor
        self._output_shape = tuple(shape)

        host_mode = backend in ('numpy', 'scipy', 'mkl_fft')
        in_dtype = self.xfftn[0].forward.input_array.dtype
        out_dtype = self.xfftn[-1].forward.output_array.dtype
        # executor (JAX mpifft.py:653-673): the per-shard one on several
        # ranks; one rank reports the JAX package's one-device fallback
        if self._nmesh > 1:
            if host_mode:
                raise ValueError(f"backend {backend!r} runs on one rank")
            if executor == 'gspmd':
                raise ValueError("several ranks run the per-shard executor "
                                 "('shard_map'); the global-program "
                                 "'gspmd' is the JAX package's")
            self.executor = 'shard_map'
        else:
            self.executor = 'gspmd'
        if host_mode:
            fwd_stages = [o.forward_fn for o in self.xfftn]
            bck_stages = [o.backward_fn for o in self.xfftn[::-1]]
            fwd_planars = bck_planars = None
        else:
            fwd_stages = [o.forward_fn_p for o in self.xfftn]
            bck_stages = [o.backward_fn_p for o in self.xfftn[::-1]]
            fwd_planars = [self.xfftn[0].input_planar] + \
                [o.output_planar for o in self.xfftn]
            bck_planars = [self.xfftn[-1].output_planar] + \
                [o.input_planar for o in self.xfftn[::-1]]
        fwd_steps, bck_steps, fwd_slices, bck_slices = self._shard_plans()
        self.forward = Transform(
            self, fwd_stages, fwd_steps, fwd_slices, self.pencil,
            self._input_shape, in_dtype, self._output_shape, out_dtype,
            default_normalize=True, host_mode=host_mode,
            direction='forward', planars=fwd_planars)
        # backward rotations undo the forward ones, in reverse order
        self.backward = Transform(
            self, bck_stages, bck_steps, bck_slices, self.pencil[::-1],
            self._output_shape, out_dtype, self._input_shape, in_dtype,
            default_normalize=False, host_mode=host_mode,
            direction='backward', planars=bck_planars)

    def _shard_plans(self):
        """The rotations and stage cuts of both directions (role of JAX
        ``_build_shmap_plans`` :708): each rotation's start function,
        group size and chunk-axis candidates (the axes that take part in
        neither it nor the stage after it), and each stage's (axis, true
        extent) pairs."""
        ndim = len(self._input_shape)

        def steps(starts, objs):
            out = []
            for i, (start, t) in enumerate(starts):
                used = {t.axisA, t.axisB} | set(objs[i + 1].axes)
                out.append((start, t.size,
                            tuple(c for c in range(ndim) if c not in used)))
            return out

        def slices(objs, attr):
            return [tuple((ax, getattr(o, attr).input_array.shape[ax])
                          for ax in o.axes) for o in objs]

        fwd = steps([(t.forward_start, t) for t in self.transfer],
                    self.xfftn)
        bck = steps([(t.backward_start, t) for t in self.transfer[::-1]],
                    self.xfftn[::-1])
        return (fwd, bck, slices(self.xfftn, 'forward'),
                slices(self.xfftn[::-1], 'backward'))

    def _comm(self, comm):
        """The communicator of the plan: the world (the process group
        once one is up) by default."""
        if comm is None:
            return COMM_WORLD
        if isinstance(comm, (list, tuple)):
            comm = DeviceComm(comm)
        return comm

    # ---- reference API (reference: mpifft.py:349-419) -------------------
    def destroy(self):
        if isinstance(self.subcomm, Subcomm):
            self.subcomm.destroy()
        for trans in self.transfer:
            trans.destroy()

    def shape(self, forward_output=True):
        """Global shape of the transform data (as the JAX package; the
        reference returns the rank's local shape, :meth:`local_shape`)."""
        if forward_output is not True:
            return self._input_shape
        return self._output_shape

    def local_shape(self, forward_output=True, device_index=None):
        """The block shape of rank ``device_index``, this rank's by
        default (the reference's ``shape``)."""
        p = self.pencil[1] if forward_output else self.pencil[0]
        return p.local_shape(device_index)

    def local_slice(self, forward_output=True, device_index=None):
        """The view of rank ``device_index``'s block (this rank's by
        default) into the global array (reference: mpifft.py:368-386)."""
        ip = self.pencil[1] if forward_output else self.pencil[0]
        return tuple(slice(start, start + n) for start, n in
                     zip(ip.local_start(device_index),
                         ip.local_shape(device_index)))

    def global_shape(self, forward_output=False):
        """Reference: mpifft.py:388-400."""
        if forward_output:
            return self._output_shape
        return self._input_shape

    @property
    def dimensions(self):
        """Reference: mpifft.py:402-405."""
        return len(self._input_shape)

    def dtype(self, forward_output=False):
        """Reference: mpifft.py:407-419."""
        if forward_output:
            return self.xfftn[-1].forward.output_array.dtype
        return self.xfftn[0].forward.input_array.dtype
