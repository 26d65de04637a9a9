"""Backend-independent snapshot writer base, and the host staging of
blocks that both backends share.

Port of ``mpi4py_fft_tpu/io/file_base.py`` (reference semantics:
mpi4py_fft/io/file_base.py).  ``write`` takes a dict of group name ->
list of fields, where a field is either a whole array or a ``(array,
global_slice)`` 2-tuple; rank>0 tensors can be exploded into scalar
groups ``name + "{k}{l}"`` (reference: io/file_base.py:49-78).

A field is a :class:`~mpi4py_fft_torch.distarray.DistArray`: this rank's
block, a tensor on the rank's device.  The helpers below are the one
place a block meets the host: :func:`group_of` (the array's ranks),
:func:`owned_blocks` (every rank's block, from the pencil's metadata),
:func:`host_block` (device -> aligned host buffer, once a write),
:func:`slice_part` (this block's part of a global slice, cut out with
``utils.native.pack_block``) and :func:`read_block` (a hyperslab read
into an aligned host buffer, then into the block).
"""
import numpy as np
import torch
import torch.distributed as dist

from ..utils import native

__all__ = ('FileBase',)


class FileBase(object):
    """Base class for reading/writing distributed arrays
    (reference: io/file_base.py:8-140)."""

    def __init__(self, filename=None, domain=None):
        self.f = None
        self.filename = filename
        self.domain = domain

    def _check_domain(self, group, field):
        raise NotImplementedError

    @staticmethod
    def _scalar_views(name, array, as_scalar):
        """Yield ``(dataset_name, scalar_field)`` pairs for one field.

        Rank-0 arrays (and everything when ``as_scalar`` is off) pass
        through unchanged; higher tensor ranks are exploded into one
        scalar view per component, suffixed with the component's index
        digits (``v`` -> ``v0``, ``v1`` ... / ``T01`` ...).  A component
        is the DistArray of this rank's block of it (``_component``).
        """
        rank = getattr(array, 'rank', 0)
        if not as_scalar or rank == 0:
            yield name, array
            return
        for idx in np.ndindex(*array.shape[:rank]):
            yield name + ''.join(map(str, idx)), array._component(idx)

    def write(self, step, fields, **kw):
        """Write snapshot ``step`` of ``fields`` to the file.

        ``fields`` maps a dataset name to a list of entries, each either
        a DistArray (whole-domain snapshot) or an ``(array,
        global_slice)`` pair (slice snapshot).  Semantics follow the
        reference (io/file_base.py:34-78); every entry is flattened to
        ``(name, scalar_component, slice-or-None)`` records, each
        dispatched to the backend hook (`_write_group` /
        `_write_slice_step`).
        """
        self._staged = {}
        try:
            self._write_entries(step, fields, **kw)
        finally:
            self._staged = {}

    def _write_entries(self, step, fields, **kw):
        as_scalar = kw.get("as_scalar", False)
        for name, entries in fields.items():
            if not (isinstance(name, str) and
                    isinstance(entries, (tuple, list))):
                raise TypeError("fields must map str -> list of arrays "
                                "or (array, global_slice) pairs")
            for entry in entries:
                if isinstance(entry, (tuple, list)):
                    array, gslice = entry
                else:
                    array, gslice = entry, None
                for dname, comp in self._scalar_views(name, array,
                                                      as_scalar):
                    self._check_domain(dname, comp)
                    if gslice is None:
                        self._write_group(dname, comp, step, **kw)
                    else:
                        self._write_slice_step(dname, step, gslice,
                                               comp, **kw)

    def _host(self, field):
        """This rank's block of ``field`` on the host (:func:`host_block`),
        staged once a write: a field and its global slices share it."""
        v = field.v
        key = (v.data_ptr(), tuple(v.shape), v.stride(), v.dtype)
        if key not in self._staged:
            self._staged[key] = host_block(field)
        return self._staged[key]

    def read(self, u, name, **kw):
        raise NotImplementedError

    def close(self):
        self.f.close()

    def open(self, mode='r+'):
        raise NotImplementedError

    @staticmethod
    def backend():
        raise NotImplementedError

    def _write_slice_step(self, name, step, slices, field, **kwargs):
        raise NotImplementedError

    def _write_group(self, name, u, step, **kwargs):
        raise NotImplementedError

    @staticmethod
    def _get_slice_name(slices):
        """'slice_4_slice'-style name for a global slice spec
        (reference: io/file_base.py:119-128)."""
        parts = ['slice' if isinstance(ss, slice) else str(ss)
                 for ss in slices]
        return '_'.join(parts)

    @staticmethod
    def _slice_spec(slices):
        """Indices of the slice() entries of a global slice spec."""
        return np.nonzero([isinstance(x, slice) for x in slices])[0]


# -- the array's ranks and blocks ---------------------------------------

def group_of(field):
    """The communicator of ``field``'s ranks, or None where the array is
    held whole by one rank (no pencil, or a pencil on one rank)."""
    p0 = field.pencil
    return None if p0 is None or p0.mesh is None else p0.mesh.comm


def fields_group(fields):
    """The communicator of the ranks of every array in ``fields`` (the
    dict ``FileBase.write`` takes), or None for one rank; the arrays of
    one write share it."""
    comms = []
    for entries in fields.values():
        for e in entries:
            c = group_of(e[0] if isinstance(e, (tuple, list)) else e)
            if not any(c is d for d in comms):
                comms.append(c)
    if len(comms) > 1:
        raise ValueError("the arrays of one write lie on different groups "
                         "of ranks")
    return comms[0] if comms else None


def world():
    """The world communicator where a group of several ranks is up, else
    None: a file is created by its rank 0 while the others wait, as the
    reference's constructors open it on ``MPI.COMM_WORLD``."""
    from ..parallel.comm import COMM_WORLD
    return COMM_WORLD if COMM_WORLD.Get_size() > 1 else None


def size_rank(comm):
    return (1, 0) if comm is None else (comm.Get_size(), comm.Get_rank())


def barrier(comm):
    """``dist.barrier`` on ``comm``'s process group (the JAX package's
    ``sync_global_devices``); nothing on one rank."""
    if comm is not None:
        dist.barrier(group=comm.group)


def block_slice(field):
    """This rank's block of ``field`` in the global array."""
    if field.pencil is None:
        return tuple(slice(0, n) for n in field.global_shape)
    return field.local_slice()


def owned_blocks(field):
    """``(rank, global_slice)`` of every distinct block of ``field``
    across its ranks, from the pencil's metadata alone; where two ranks
    hold the same block, the first one owns it.  Empty blocks (a rank
    past the last rows of ``blockdist``) own nothing."""
    size, _ = size_rank(group_of(field))
    if size == 1:
        return [(0, block_slice(field))]
    seen, out = set(), []
    for r in range(size):
        sl = field.local_slice(r)
        if sl not in seen and all(s.stop > s.start for s in sl):
            seen.add(sl)
            out.append((r, sl))
    return out


def owns_block(field):
    """True where this rank writes its block (it is the first owner)."""
    _, rank = size_rank(group_of(field))
    return any(r == rank for r, _ in owned_blocks(field))


# -- host staging ---------------------------------------------------------

def host_block(field):
    """This rank's block of ``field`` on the host, in an aligned buffer
    (``utils.native.aligned_native``): one device -> host copy."""
    buf = native.aligned_native(field.shape, dtype=field.dtype)
    torch.from_numpy(buf).copy_(field.v)
    return buf


def slice_part(field, slices, host):
    """This block's part of the global slice ``slices`` (one entry an
    axis of ``field``: an index, or a slice that keeps the axis whole):
    ``(region, part)``, ``region`` the part's place in the slice's
    dataset and ``part`` a contiguous array cut out of ``host`` (the
    block on the host) with ``native.pack_block``; None where the block
    holds none of it."""
    block = block_slice(field)
    if any(b.stop == b.start for b in block):
        return None
    starts, sizes, region, keep = [], [], [], []
    for s, b in zip(slices, block):
        if isinstance(s, slice):
            starts.append(0)
            sizes.append(b.stop - b.start)
            region.append(b)
            keep.append(b.stop - b.start)
        else:
            k = int(s)
            if not b.start <= k < b.stop:
                return None
            starts.append(k - b.start)
            sizes.append(1)
    part = native.pack_block(host, starts, sizes)
    return tuple(region), part.reshape(keep)


def read_block(u, read):
    """Fill ``u``'s block from a file: ``read(buf, source_slice)`` reads
    the block's hyperslab of the dataset into the aligned host buffer
    ``buf``; the buffer then goes to the block's device."""
    buf = native.aligned_native(u.shape, dtype=u.dtype)
    if buf.size:
        read(buf, block_slice(u))
        u.v.copy_(torch.from_numpy(buf))
