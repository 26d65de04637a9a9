"""Pencil decomposition metadata on one device.

Port of ``mpi4py_fft_tpu/parallel/pencil.py`` (reference:
mpi4py_fft/pencil.py): ``blockdist`` (:38), ``Subcomm`` (:77), ``Pencil``
(:136: ``subshape``, ``substart``, ``pencil(axis)``, ``transfer``) and
``Transfer`` (:297).  On one device every axis group has size 1, a pencil
owns the whole array, and a ``Transfer`` moves no data: its
``forward_fn``/``backward_fn`` return their input and ``forward``/
``backward`` copy into the array they are given.  A group of more than
one device raises NotImplementedError until the distributed layer
(ROADMAP Queue 1 item 4), where a ``Transfer`` becomes an
``all_to_all_single``.
"""
import numpy as np
import torch

from ..utils import compute_dims
from .comm import DeviceComm, COMM_WORLD

__all__ = ['Subcomm', 'Pencil', 'Transfer', 'blockdist']


def _multi_device(what):
    return NotImplementedError(
        f"{what} on more than one device arrives with the distributed layer "
        f"(ROADMAP Queue 1 item 4)")


def blockdist(N, size, rank):
    """(count, start) of the block owned by ``rank`` under ceil-div
    sharding (role of reference pencil.py:5-9)."""
    q = -(-N // size)  # ceil
    s = min(rank * q, N)
    n = min(q, N - s)
    return (max(n, 0), s)


class AxisComm(object):
    """One axis of a Subcomm: a named group of devices of given size.
    Size-1 axes play the role of MPI ``COMM_SELF`` entries
    (reference: pencil.py:288-289)."""

    __slots__ = ('name', 'size')

    def __init__(self, name, size):
        self.name = name      # None when size == 1
        self.size = size

    def Get_size(self):
        return self.size

    def __eq__(self, other):
        return (isinstance(other, AxisComm) and other.name == self.name
                and other.size == self.size)

    def __hash__(self):
        return hash((self.name, self.size))

    def __repr__(self):
        return f"AxisComm({self.name!r}, {self.size})"


COMM_SELF = AxisComm(None, 1)


class Subcomm(tuple):
    """Tuple of per-axis device groups (reference: pencil.py:32-98):
    ``dims`` entries > 0 are fixed sizes, entries <= 0 are wildcards
    balanced over the device count."""

    def __new__(cls, comm=None, dims=None, reorder=True):
        if isinstance(comm, Subcomm):
            assert dims is None
            return comm
        if comm is None:
            comm = COMM_WORLD
        if isinstance(comm, (list, tuple)):
            comm = DeviceComm(comm)
        assert isinstance(comm, DeviceComm)
        nnodes = comm.Get_size()
        if dims is None:
            dims = [0]
        elif np.ndim(dims) > 0:
            assert len(dims) > 0
            dims = [max(0, int(d)) for d in dims]
        else:
            assert dims > 0
            dims = [0] * int(dims)
        if nnodes != 1 or any(d > 1 for d in dims):
            raise _multi_device('Subcomm')
        sizes = compute_dims(nnodes, dims)
        obj = super(Subcomm, cls).__new__(
            cls, [AxisComm(None, s) for s in sizes])
        obj.comm = comm
        return obj

    def destroy(self):
        """Nothing to free; parity no-op (reference: pencil.py:95-98)."""


def _pad_subcomm(subcomm, shape, axis):
    """Pad a short subcomm with size-1 axes and insert the aligned axis
    (reference pencil.py:285-289)."""
    subcomm = list(subcomm)
    while len(subcomm) < len(shape) - 1:
        subcomm.append(COMM_SELF)
    subcomm.insert(axis, COMM_SELF)
    return subcomm


class Pencil(object):
    """Distribution descriptor (reference: pencil.py:212-354): ``axis`` is
    the aligned (undistributed) axis, every other axis i is distributed
    over ``subcomm[i]``; on one device each group has size 1."""

    def __init__(self, subcomm, shape, axis=-1):
        assert len(shape) >= 2
        assert min(shape) >= 1
        assert -len(shape) <= axis < len(shape)
        assert 1 <= len(subcomm) <= len(shape)
        if axis < 0:
            axis += len(shape)
        if len(subcomm) < len(shape):
            subcomm = _pad_subcomm(subcomm, shape, axis)
        assert len(subcomm) == len(shape)
        assert subcomm[axis].Get_size() == 1
        if any(c.Get_size() != 1 for c in subcomm):
            raise _multi_device('Pencil')
        self.shape = tuple(shape)
        self.axis = axis
        self.subcomm = tuple(subcomm)

    def local_shape(self, device_index=0):
        """Shard shape on one device (role of reference ``subshape``,
        pencil.py:293-307)."""
        return tuple(blockdist(n, c.Get_size(), 0)[0]
                     for n, c in zip(self.shape, self.subcomm))

    def local_start(self, device_index=0):
        """Shard start offsets on one device (role of ``substart``)."""
        return tuple(blockdist(n, c.Get_size(), 0)[1]
                     for n, c in zip(self.shape, self.subcomm))

    @property
    def subshape(self):
        return self.local_shape(0)

    @property
    def substart(self):
        return self.local_start(0)

    def pencil(self, axis):
        """The partner pencil aligned with ``axis``: the two axes' groups
        swap (reference: pencil.py:309-323)."""
        assert -len(self.shape) <= axis < len(self.shape)
        if axis < 0:
            axis += len(self.shape)
        i, j = self.axis, axis
        subcomm = list(self.subcomm)
        subcomm[j], subcomm[i] = subcomm[i], subcomm[j]
        return Pencil(subcomm, self.shape, axis)

    def transfer(self, pencil, dtype):
        """A :class:`Transfer` into ``pencil`` (reference:
        pencil.py:325-354)."""
        penA, penB = self, pencil
        assert penA.shape == penB.shape
        assert penA.axis != penB.axis
        for i in range(len(penA.shape)):
            if i != penA.axis and i != penB.axis:
                assert penA.subcomm[i] == penB.subcomm[i]
        assert penA.subcomm[penB.axis] == penB.subcomm[penA.axis]
        return Transfer(self.shape, dtype, penA, penB)


class Transfer(object):
    """Redistribution between two pencils (reference: pencil.py:101-209).
    On one device both pencils hold the whole array, so nothing moves."""

    def __init__(self, shape, dtype, pencilA, pencilB):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.pencilA = pencilA
        self.pencilB = pencilB
        self.subshapeA, self.axisA = pencilA.subshape, pencilA.axis
        self.subshapeB, self.axisB = pencilB.subshape, pencilB.axis

    def forward_fn(self, x, rank=0):
        """``rank`` leading axes (e.g. the planar one) are not part of the
        pencil geometry."""
        return x

    def backward_fn(self, x, rank=0):
        return x

    @staticmethod
    def _copy(src, dst):
        """``src`` (a DistArray, tensor or array) into ``dst``, or ``src``
        itself without one."""
        if dst is None:
            return src
        data = getattr(src, 'v', src)        # a DistArray's tensor
        if isinstance(dst, torch.Tensor):
            dst.copy_(torch.as_tensor(data))
        elif isinstance(dst, np.ndarray) and isinstance(data, torch.Tensor):
            dst[...] = data.cpu().numpy()
        else:
            dst[...] = data
        return dst

    def forward(self, arrayA, arrayB=None):
        """From pencil A to pencil B (reference: pencil.py:168-183)."""
        return self._copy(arrayA, arrayB)

    def backward(self, arrayB, arrayA=None):
        """From pencil B to pencil A (reference: pencil.py:185-201)."""
        return self._copy(arrayB, arrayA)

    def destroy(self):
        """Nothing to free; parity no-op (reference: pencil.py:203-209)."""
