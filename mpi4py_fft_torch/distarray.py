"""Distributed array with pencil metadata.

Port of ``mpi4py_fft_tpu/distarray.py`` (``DistArray`` :43,
``get_pencil_and_transfer`` :426, ``redistribute`` :431-470 with
``_reshard_data`` :472, ``newDistArray`` :524; reference:
mpi4py_fft/distarray.py).  As in the reference, a :class:`DistArray`
holds this rank's block of the global array, a tensor on the rank's
device, with the pencil that describes the decomposition: ``.shape``,
``.v`` and ``__array__`` are the block's, ``global_shape`` the whole
array's.  On one rank the block is the whole array.

Tensors of rank > 0 keep their first ``rank`` axes undistributed,
matching the reference (distarray.py:40-56).  ``redistribute`` between
pencils moves the blocks with the pencils' ``Transfer`` (one
``all_to_all_single``); between two undivided axes it relabels the
pencil, as the JAX package does.  ``write``/``read`` go through the
snapshot IO of ``mpi4py_fft_torch/io/``: each rank writes and reads its
own block.
"""
from numbers import Integral, Number

import numpy as np
import torch
import torch.distributed as dist

from .parallel.pencil import Pencil, Subcomm, AxisComm, COMM_SELF
from .parallel.comm import COMM_WORLD, plan_device
from .utils import torch_dtype

__all__ = ['DistArray', 'newDistArray', 'Function']


class DistArray(object):
    """This rank's block of a distributed array, with pencil metadata
    (reference: distarray.py:10-439).  ``device`` is where the block
    lies: the rank's device, else CUDA; ``'cpu'`` where the caller asks.
    ``buffer`` is the block's values, or the global array's, of which
    the rank takes its block."""

    def __init__(self, global_shape, subcomm=None, val=None, dtype=float,
                 buffer=None, strides=None, alignment=None, rank=0,
                 device=None):
        global_shape = tuple(int(s) for s in global_shape)
        dtype = np.dtype(dtype)
        self._rank = rank
        self._global_shape = global_shape
        self._p0 = None
        if len(global_shape[rank:]) >= 2:
            self._p0 = self._make_pencil(global_shape[rank:], subcomm,
                                         alignment)
        if isinstance(buffer, torch.Tensor) and device is None:
            device = buffer.device
        mesh = self._p0.mesh if self._p0 is not None else None
        device = plan_device(mesh.comm if mesh is not None else COMM_WORLD,
                             device, 'DistArray')
        tdt = torch_dtype(dtype)
        local = self._local_shape()
        if buffer is not None:
            if isinstance(buffer, DistArray):
                buffer = buffer.v
            if not isinstance(buffer, torch.Tensor):
                buffer = torch.from_numpy(
                    np.ascontiguousarray(np.asarray(buffer, dtype=dtype)))
            if tuple(buffer.shape) == global_shape and local != global_shape:
                buffer = buffer[self.local_slice()]
            self._data = buffer.to(device=device, dtype=tdt)
            assert tuple(self._data.shape) == local
        else:
            fill = val if isinstance(val, Number) else 0
            self._data = torch.full(local, fill, dtype=tdt, device=device)

    def _local_shape(self):
        if self._p0 is None:
            return self._global_shape
        return self._global_shape[:self._rank] + self._p0.subshape

    @staticmethod
    def _make_pencil(shape, subcomm, alignment):
        if isinstance(subcomm, Pencil):
            return subcomm
        if isinstance(subcomm, (tuple, list)) and \
                all(isinstance(s, AxisComm) for s in subcomm):
            assert len(subcomm) == len(shape)
        elif isinstance(subcomm, (tuple, list)) and \
                not isinstance(subcomm, Subcomm):
            assert len(subcomm) == len(shape)
            subcomm = Subcomm(COMM_WORLD, list(subcomm))
        elif subcomm is None:
            dims = [0] * len(shape)
            if alignment is not None:
                dims[alignment] = 1
            else:
                dims[-1] = 1
                alignment = len(dims) - 1
            subcomm = Subcomm(COMM_WORLD, dims)
        sizes = [s.Get_size() for s in subcomm]
        if alignment is None:
            alignment = int(np.flatnonzero(np.array(sizes) == 1)[-1])
        assert sizes[alignment] == 1
        return Pencil(subcomm, shape, axis=int(alignment))

    def _wrap(self, data):
        out = DistArray.__new__(DistArray)
        out._p0 = self._p0
        out._rank = self._rank
        out._global_shape = self._global_shape \
            if tuple(data.shape) == tuple(self._data.shape) \
            else tuple(data.shape)
        out._data = data
        return out

    # -- basic array protocol ---------------------------------------------
    @property
    def shape(self):
        """The block's shape, as the reference's; on one rank the global
        shape."""
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return np.dtype(str(self._data.dtype).replace('torch.', ''))

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def device(self):
        return self._data.device

    def __len__(self):
        return self.shape[0]

    def __array__(self, dtype=None, copy=None):
        a = self._data.detach().cpu().numpy()
        return a.astype(dtype) if dtype is not None else a

    def __repr__(self):
        return (f"DistArray(shape={self.shape}, dtype={self.dtype}, "
                f"rank={self.rank}, alignment="
                f"{self._p0.axis if self._p0 else None}, "
                f"device={self.device})")

    # -- metadata (reference: distarray.py:109-180) ------------------------
    @property
    def alignment(self):
        return self._p0.axis

    @property
    def global_shape(self):
        return self._global_shape

    @property
    def substart(self):
        return (0,) * self.rank + self._p0.substart

    @property
    def subcomm(self):
        return (COMM_SELF,) * self.rank + self._p0.subcomm

    @property
    def subcomm_tuple(self):
        """Axis groups of the distributed part only (a PFFT built from
        this array takes them, reference: mpifft.py:293)."""
        return self._p0.subcomm

    @property
    def commsizes(self):
        return [s.Get_size() for s in self.subcomm]

    @property
    def pencil(self):
        return self._p0

    @property
    def rank(self):
        return self._rank

    @property
    def dimensions(self):
        return len(self._p0.shape)

    @property
    def v(self):
        """The tensor holding the block (the reference's ``.v`` is the
        local ndarray view, distarray.py:177-180)."""
        return self._data

    # -- indexing (reference: distarray.py:155-175) ------------------------
    def __getitem__(self, i):
        if self._p0 is not None and self.rank > 0 and (
                isinstance(i, (Integral, slice)) or
                (isinstance(i, tuple) and len(i) <= self.rank)):
            return self._component(i)
        return self.__array__()[i]

    def _component(self, i):
        """A view of tensor components: only the first ``rank``
        (undistributed) axes are consumed or sliced."""
        data = self._data[i]
        new_rank = self.rank - (self.ndim - data.dim())
        assert new_rank >= 0
        out = self._wrap(data)
        out._rank = new_rank
        out._global_shape = (tuple(data.shape[:new_rank])
                             + self._global_shape[self.rank:])
        return out

    def __setitem__(self, i, value):
        if isinstance(value, DistArray):
            value = value.v
        if not isinstance(value, (torch.Tensor, Number)):
            value = torch.from_numpy(np.ascontiguousarray(
                np.asarray(value, dtype=self.dtype)))
        self._data[i] = value.to(self._data.device) \
            if isinstance(value, torch.Tensor) else value

    # -- arithmetic --------------------------------------------------------
    def _other(self, other):
        if isinstance(other, DistArray):
            return other._data
        if isinstance(other, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(other)).to(
                self._data.device)
        return other

    def __add__(self, o): return self._wrap(self._data + self._other(o))
    def __radd__(self, o): return self._wrap(self._other(o) + self._data)
    def __sub__(self, o): return self._wrap(self._data - self._other(o))
    def __rsub__(self, o): return self._wrap(self._other(o) - self._data)
    def __mul__(self, o): return self._wrap(self._data * self._other(o))
    def __rmul__(self, o): return self._wrap(self._other(o) * self._data)
    def __truediv__(self, o): return self._wrap(self._data / self._other(o))
    def __pow__(self, o): return self._wrap(self._data ** self._other(o))
    def __neg__(self): return self._wrap(-self._data)

    def astype(self, dtype):
        return self._wrap(self._data.to(torch_dtype(dtype)))

    def fill(self, val):
        self._data.fill_(val)

    def copy(self):
        return self._wrap(self._data.clone())

    # -- global access (reference: distarray.py:182-278) -------------------
    def get(self, gslice):
        """A global slice, on every rank (the reference gathers on rank 0,
        distarray.py:214-241)."""
        return self._gathered()[tuple(gslice)]

    def _gathered(self):
        """The global array on every rank, as numpy."""
        if self._p0 is None or self._p0.mesh is None:
            return self.__array__()
        blocks = [None] * self._p0.mesh.comm.Get_size()
        dist.all_gather_object(blocks, (self.local_slice(), self.__array__()),
                               group=self._p0.mesh.comm.group)
        out = np.zeros(self._global_shape, dtype=self.dtype)
        for sl, b in blocks:
            out[sl] = b
        return out

    def local_slice(self, device_index=None):
        """The view of rank ``device_index``'s block (this rank's by
        default) into the global array (reference: distarray.py:243-278)."""
        v = [slice(start, start + n) for start, n in
             zip(self._p0.local_start(device_index),
                 self._p0.local_shape(device_index))]
        return tuple([slice(0, s) for s in self._global_shape[:self.rank]]
                     + v)

    # -- redistribution (reference: distarray.py:280-363) ------------------
    def get_pencil_and_transfer(self, axis):
        """The pencil aligned with ``axis`` and the :class:`Transfer` into
        it (reference: distarray.py:280-296)."""
        p1 = self._p0.pencil(axis)
        return p1, self._p0.transfer(p1, self.dtype)

    def redistribute(self, axis=None, out=None):
        """Realign the array with ``axis``, or move it into ``out``, which
        keeps its own alignment (reference: distarray.py:298-363).  All
        tensor components move in one exchange.  Between two undivided
        axes a new alignment relabels the pencil and returns this array,
        as the JAX package does (mpi4py_fft_tpu/distarray.py:439-447)."""
        if axis == self.alignment:
            return self
        if axis is not None and isinstance(out, DistArray) and \
                axis != out.alignment:
            raise ValueError(f"redistribute: axis {axis} is not out's "
                             f"alignment {out.alignment}")
        if axis is not None and self.commsizes[self.rank + axis] == 1:
            self._p0 = self._p0.pencil(axis)
            return self
        if out is not None:
            if not isinstance(out, DistArray) or \
                    self.global_shape != out.global_shape:
                raise ValueError("redistribute: give an axis, or out= a "
                                 "DistArray of the same global shape")
            axis = out.alignment
            if self.commsizes == out.commsizes:
                out.v.copy_(self._data)
                return out
            for i in range(len(self._p0.shape)):
                if i not in (self.alignment, axis) and \
                        self._p0.subcomm[i] != out.pencil.subcomm[i]:
                    raise ValueError(f"redistribute: out distributes axis "
                                     f"{i} otherwise")
        if axis is None:
            raise ValueError("redistribute: give an axis, or out= a "
                             "DistArray of the same global shape")
        p1, transfer = self.get_pencil_and_transfer(axis)
        if out is None:
            out = DistArray(self.global_shape, subcomm=p1, dtype=self.dtype,
                            alignment=axis, rank=self.rank,
                            device=self.device)
        transfer.forward(self, out)
        transfer.destroy()
        return out

    # -- IO (reference: distarray.py:365-439) ------------------------------
    def write(self, filename, name='darray', step=0, global_slice=None,
              domain=None, as_scalar=False):
        """Write a snapshot to an HDF5 (``.h5``) or NetCDF file, or to a
        ``FileBase`` (reference: distarray.py:365-404); every rank of the
        array's group calls it and writes its own block."""
        from .io import HDF5File, NCFile, FileBase
        if isinstance(filename, str):
            writer = HDF5File if filename.endswith('.h5') else NCFile
            f = writer(filename, domain=domain, mode='a')
        else:
            assert isinstance(filename, FileBase)
            f = filename
        field = [self] if global_slice is None else [(self, global_slice)]
        f.write(step, {name: field}, as_scalar=as_scalar)

    def read(self, filename, name='darray', step=0):
        """Read a snapshot into this array (reference:
        distarray.py:406-439): each rank reads its own block's hyperslab,
        so the writer's ranks and alignment may differ from the
        reader's."""
        from .io import HDF5File, NCFile, FileBase
        if isinstance(filename, str):
            reader = HDF5File if filename.endswith('.h5') else NCFile
            f = reader(filename, mode='r')
        else:
            assert isinstance(filename, FileBase)
            f = filename
        f.read(self, name, step=step)


def newDistArray(pfft, forward_output=True, val=0, rank=0, view=False):
    """A new DistArray of a PFFT's input or output, on the plan's device
    (reference: distarray.py:442-485)."""
    global_shape = pfft.global_shape(forward_output)
    p0 = pfft.pencil[forward_output]
    dtype = pfft.dtype(forward_output)
    global_shape = (len(global_shape),) * rank + tuple(global_shape)
    z = DistArray(global_shape, subcomm=p0.subcomm, val=val, dtype=dtype,
                  alignment=p0.axis, rank=rank, device=pfft.device)
    return z.v if view else z


def Function(*args, **kwargs):
    """Deprecated alias of :func:`newDistArray` (reference:
    distarray.py:487-493); ``tensor=`` asks for ``rank=1``."""
    import warnings
    warnings.warn("Function() is deprecated; use newDistArray().",
                  FutureWarning)
    if 'tensor' in kwargs:
        kwargs['rank'] = 1
        del kwargs['tensor']
    return newDistArray(*args, **kwargs)
