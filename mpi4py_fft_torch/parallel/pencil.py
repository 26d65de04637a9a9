"""Pencil decomposition over the ranks of a process group.

Port of ``mpi4py_fft_tpu/parallel/pencil.py`` (reference:
mpi4py_fft/pencil.py): ``blockdist`` (:38), ``Subcomm`` (:77),
``_pad_subcomm`` (:126), ``Pencil`` (:136: ``local_shape``/
``local_start``, ``padded_shape``, ``pencil(axis)``, ``transfer``) and
``Transfer`` (:297).  The model is the reference's, SPMD: every rank
holds its own local block.  A ``Subcomm`` lays the ranks out on a grid
row-major, as the JAX mesh reshapes its devices (:114-116), so that rank
r owns the block the JAX package puts on device r, and makes one process
group per line of each grid axis of size > 1.  A ``Transfer`` is one
``all_to_all_single`` over the group of the axis being swapped.

Blocks follow ceil-div sharding: along an axis of N points over p ranks,
rank r owns rows [r q, min((r + 1) q, N)) with q = ceil(N / p).  A local
block on the way through a pipeline is held at q rows, its valid rows
first and zeros after (``Pencil.padded_local_shape``, the JAX
``DistArray``'s padded shard), so that every exchange moves equal parts;
an axis a rank holds whole may carry zero rows past N.  On one rank every
group has size 1, a pencil owns the whole array and a ``Transfer`` moves
no data.
"""
import numpy as np
import torch
import torch.distributed as dist

from ..utils import compute_dims
from .comm import DeviceComm, COMM_WORLD

__all__ = ['Subcomm', 'Pencil', 'Transfer', 'blockdist']


def blockdist(N, size, rank):
    """(count, start) of the block owned by ``rank`` under ceil-div
    sharding (role of reference pencil.py:5-9)."""
    q = -(-N // size)  # ceil
    s = min(rank * q, N)
    n = min(q, N - s)
    return (max(n, 0), s)


class AxisComm(object):
    """One axis of a Subcomm: the process group of this rank's line along
    grid axis ``index``, of ``size`` ranks.  Size-1 axes play the role of
    MPI ``COMM_SELF`` entries (reference: pencil.py:288-289)."""

    __slots__ = ('name', 'size', 'index', 'group', 'mesh')

    def __init__(self, name, size, index=None, group=None, mesh=None):
        self.name = name      # None when size == 1
        self.size = size
        self.index = index    # grid axis
        self.group = group    # this rank's line along the axis
        self.mesh = mesh      # the Subcomm of the grid

    def Get_size(self):
        return self.size

    def Get_rank(self):
        """This rank's coordinate along the axis."""
        return 0 if self.size == 1 else self.mesh.coords[self.index]

    def __eq__(self, other):
        return (isinstance(other, AxisComm) and other.name == self.name
                and other.size == self.size)

    def __hash__(self):
        return hash((self.name, self.size))

    def __repr__(self):
        return f"AxisComm({self.name!r}, {self.size})"


COMM_SELF = AxisComm(None, 1)


class Subcomm(tuple):
    """Tuple of per-axis rank groups over one grid (reference:
    pencil.py:32-98): ``dims`` entries > 0 are fixed sizes, entries <= 0
    are wildcards balanced over the ranks.  The grid uses every rank of
    ``comm``; rank r sits at ``np.unravel_index(r, sizes)``."""

    def __new__(cls, comm=None, dims=None, reorder=True):
        if isinstance(comm, Subcomm):
            assert dims is None
            return comm
        if comm is None:
            comm = COMM_WORLD
        if isinstance(comm, (list, tuple)):
            comm = DeviceComm(comm)
        if not isinstance(comm, DeviceComm):
            raise TypeError(f"Subcomm of {type(comm).__name__}: give a "
                            f"DeviceComm, a device list or None")
        nnodes = comm.Get_size()
        if dims is None:
            dims = [0]
        elif np.ndim(dims) > 0:
            assert len(dims) > 0
            dims = [max(0, int(d)) for d in dims]
        else:
            assert dims > 0
            dims = [0] * int(dims)
        sizes = compute_dims(nnodes, dims)
        if int(np.prod(sizes)) != nnodes:
            raise ValueError(
                f"grid {sizes} uses {int(np.prod(sizes))} of the {nnodes} "
                f"ranks; a grid spans every rank of its group")
        obj = super(Subcomm, cls).__new__(
            cls, [AxisComm(f"p{i}" if s > 1 else None, s, i)
                  for i, s in enumerate(sizes)])
        obj.comm = comm
        obj.sizes = tuple(sizes)
        obj.coords = tuple(int(c) for c in
                           np.unravel_index(comm.Get_rank(), sizes))
        # one group per line of each axis of size > 1, made by every rank
        # in the same order (new_group is collective)
        for ax in obj:
            if ax.size == 1:
                continue
            ax.mesh = obj
            i = ax.index
            others = [s for j, s in enumerate(sizes) if j != i]
            for line in np.ndindex(*others):
                ranks = []
                for k in range(ax.size):
                    c = list(line)
                    c.insert(i, k)
                    ranks.append(int(np.ravel_multi_index(c, sizes)))
                g = comm.subgroup(ranks)
                if comm.Get_rank() in ranks:
                    ax.group = g
        return obj

    def destroy(self):
        """The groups stay with the communicator for later grids; parity
        no-op (reference: pencil.py:95-98)."""


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
    over ``subcomm[i]``."""

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
        for i, c in enumerate(subcomm):
            if shape[i] < c.Get_size():
                raise ValueError(f"axis {i}: extent {shape[i]} < ranks "
                                 f"{c.Get_size()}")
        self.shape = tuple(shape)
        self.axis = axis
        self.subcomm = tuple(subcomm)
        self.mesh = next((c.mesh for c in self.subcomm
                          if c.mesh is not None), None)

    def _axis_coord(self, i, device_index):
        """Coordinate of rank ``device_index`` (this rank: None) along the
        group of axis i."""
        c = self.subcomm[i]
        if c.Get_size() == 1:
            return 0
        if device_index is None:
            return c.Get_rank()
        return int(np.unravel_index(device_index, self.mesh.sizes)[c.index])

    def local_shape(self, device_index=None):
        """Block shape of rank ``device_index``, this rank's by default
        (role of reference ``subshape``, pencil.py:293-307)."""
        return tuple(blockdist(n, c.Get_size(), self._axis_coord(i,
                                                                 device_index))
                     [0] for i, (n, c) in enumerate(zip(self.shape,
                                                        self.subcomm)))

    def local_start(self, device_index=None):
        """Block start offsets of rank ``device_index`` (role of
        ``substart``)."""
        return tuple(blockdist(n, c.Get_size(), self._axis_coord(i,
                                                                 device_index))
                     [1] for i, (n, c) in enumerate(zip(self.shape,
                                                        self.subcomm)))

    @property
    def subshape(self):
        return self.local_shape()

    @property
    def substart(self):
        return self.local_start()

    def padded_shape(self):
        """Global shape with every distributed axis rounded up to a
        multiple of its group size (JAX pencil.py:216)."""
        return tuple(-(-n // c.Get_size()) * c.Get_size()
                     for n, c in zip(self.shape, self.subcomm))

    def needs_padding(self):
        return self.padded_shape() != self.shape

    def padded_local_shape(self):
        """The shape every rank's block is held at on the way through a
        pipeline: ceil(N / p) rows along each distributed axis, valid rows
        first."""
        return tuple(n // c.Get_size()
                     for n, c in zip(self.padded_shape(), self.subcomm))

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


def fit_axis(x, axis, n):
    """``x`` with axis ``axis`` cut or zero-padded at its end to ``n``
    rows (``x`` itself when it has ``n``)."""
    m = x.shape[axis]
    if m > n:
        return x.narrow(axis, 0, n)
    if m < n:
        pad = [0, 0] * (x.dim() - 1 - axis) + [0, n - m]
        return torch.nn.functional.pad(x, pad)
    return x


def fit_block(x, shape, off=0):
    """``x`` with its axes from ``off`` on fitted to ``shape``
    (contiguous)."""
    for i, n in enumerate(shape):
        x = fit_axis(x, off + i, n)
    return x.contiguous()


class _Done(object):
    """An exchange that moves nothing."""

    def __init__(self, x):
        self._x = x

    def wait(self):
        return self._x


class Exchange(object):
    """One pencil exchange in flight (role of the JAX package's tiled
    ``lax.all_to_all``, planar.py:428-441): the local block ``x`` is cut
    into ``p`` equal parts along ``split``, part j goes to rank j of the
    group, and the parts received are joined along ``concat``.  ``split``
    is an axis this rank holds whole, with at least ``n_split`` rows (its
    true extent; zero rows after it): it is fitted to p ceil(n_split / p)
    rows first, so that each rank receives its ceil-div block.  ``concat``
    is distributed over the group, at ceil(N / p) rows on every rank.
    ``wait()`` gives the result, contiguous, laid out as a tensor of its
    shape is on one device."""

    def __init__(self, x, split, concat, axcomm, n_split):
        p = axcomm.Get_size()
        q = -(-int(n_split) // p)
        x = fit_axis(x, split, p * q)
        shp = list(x.shape)
        self._rest = [k for k in range(len(shp)) if k != split]
        self._split, self._concat, self._p = split, concat, p
        self._final = list(shp)
        self._final[split] = q
        self._final[concat] = p * shp[concat]
        send = x.movedim(split, 0).reshape(
            [p, q] + [shp[k] for k in self._rest]).contiguous()
        self._out = torch.empty_like(send)
        self._send = send          # alive until the exchange is done
        self._work = dist.all_to_all_single(self._out, send,
                                            group=axcomm.group,
                                            async_op=True)

    def wait(self):
        self._work.wait()
        perm = []
        for k in range(len(self._final)):
            if k == self._split:
                perm.append(1)
            elif k == self._concat:
                perm += [0, 2 + self._rest.index(k)]
            else:
                perm.append(2 + self._rest.index(k))
        y = self._out.permute(perm).reshape(self._final).contiguous()
        self._send = self._out = None
        return y


def exchange(x, split, concat, axcomm, n_split):
    """Start the exchange of ``x`` over ``axcomm`` (see :class:`Exchange`);
    nothing moves over a group of one."""
    if axcomm.Get_size() == 1:
        return _Done(x)
    return Exchange(x, split, concat, axcomm, n_split)


class Transfer(object):
    """Redistribution between two pencils (reference: pencil.py:101-209):
    one ``all_to_all_single`` over the group of the swapped axes."""

    def __init__(self, shape, dtype, pencilA, pencilB):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.pencilA = pencilA
        self.pencilB = pencilB
        self.subshapeA, self.axisA = pencilA.subshape, pencilA.axis
        self.subshapeB, self.axisB = pencilB.subshape, pencilB.axis
        self._comm = pencilA.subcomm[pencilB.axis]

    @property
    def size(self):
        """The size of the group the exchange runs over."""
        return self._comm.Get_size()

    # -- on local blocks held at padded extents (the pipelines) ----------
    def forward_start(self, x, rank=0):
        """Start pencil A -> B on the block ``x``; ``rank`` leading axes
        (e.g. the planar one) are not part of the pencil geometry."""
        return exchange(x, rank + self.axisA, rank + self.axisB, self._comm,
                        self.shape[self.axisA])

    def backward_start(self, x, rank=0):
        return exchange(x, rank + self.axisB, rank + self.axisA, self._comm,
                        self.shape[self.axisB])

    def forward_fn(self, x, rank=0):
        return self.forward_start(x, rank).wait()

    def backward_fn(self, x, rank=0):
        return self.backward_start(x, rank).wait()

    # -- on this rank's blocks (reference semantics) ----------------------
    @staticmethod
    def _copy(src, dst):
        """Tensor ``src`` into ``dst`` (a DistArray, tensor or array), or
        ``src`` itself without one."""
        if dst is None:
            return src
        t = getattr(dst, 'v', dst)           # a DistArray's block
        if isinstance(t, torch.Tensor):
            t.copy_(src)
        else:
            t[...] = src.cpu().numpy()
        return dst

    def _move(self, array, out, src, dst, start):
        data = getattr(array, 'v', array)    # a DistArray's block
        if not isinstance(data, torch.Tensor):
            data = torch.from_numpy(np.ascontiguousarray(data))
        rank = data.dim() - len(self.shape)
        x = fit_block(data, src.padded_local_shape(), rank)
        y = fit_block(start(x, rank).wait(), dst.subshape, rank)
        return self._copy(y, out)

    def forward(self, arrayA, arrayB=None):
        """This rank's block of pencil A into its block of pencil B
        (reference: pencil.py:168-183)."""
        return self._move(arrayA, arrayB, self.pencilA, self.pencilB,
                          self.forward_start)

    def backward(self, arrayB, arrayA=None):
        """From pencil B to pencil A (reference: pencil.py:185-201)."""
        return self._move(arrayB, arrayA, self.pencilB, self.pencilA,
                          self.backward_start)

    def destroy(self):
        """Nothing to free; parity no-op (reference: pencil.py:203-209)."""
