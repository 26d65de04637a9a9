"""HDF5 snapshot backend.

Port of ``mpi4py_fft_tpu/io/h5py_file.py`` (reference semantics:
mpi4py_fft/io/h5py_file.py).  The reference opens the file through
MPI-IO and every rank writes its hyperslab simultaneously
(io/h5py_file.py:33, 147-152).  Here the ranks are those of the array's
``torch.distributed`` group (``field.pencil.mesh.comm``; one rank where
the array has no pencil or its pencil no group), and a write on several
ranks takes one of two mechanisms (``MPI4PY_FFT_TORCH_H5_MODE``):

  ``vds`` (default) — every rank streams its block into its own sidecar
      file ``<name>.p<rank>.h5`` in parallel (separate files: no
      locking, no coordination), then rank 0 stitches an HDF5 Virtual
      Dataset into the main file mapping each block source to its global
      hyperslab.  Readers (h5py, xdmf tools) see the same
      ``name/{ndim}D/{step}`` schema; the sidecars must travel with the
      main file.
  ``serial`` — the ranks take turns on the main file between
      ``dist.barrier`` calls: one self-contained file.

``HDF5File(..., repack=True)`` (or ``MPI4PY_FFT_TORCH_H5_REPACK=1``) keeps
the parallel sidecar streaming of ``vds`` mode but has rank 0 copy the
blocks into ordinary contiguous datasets at stitch time instead of
virtual ones; each rank then drains and deletes its own sidecar — one
portable self-contained file, as the reference's mpio artifact.

Rank r owns ``field.local_slice(r)``, which rank 0 computes for every
rank from the pencil alone; where two ranks hold the same block the
first writes it.  A rank stages its block to the host once a write
(``file_base.host_block``: device -> aligned host buffer).  The port's
blocks are exact, not padded, so the JAX package's ``_valid_region`` and
``_embed`` (mpi4py_fft_tpu/distarray.py:163-181) have no counterpart.

A global slice is never gathered whole: each rank contributes only its
block's part of it (``file_base.slice_part``, cut out with
``native.pack_block``).  On one rank and in ``serial`` mode each rank
writes its part in its turn; in ``vds`` and ``repack`` modes rank 0
gathers the parts (one dimension lower than the array) and writes them
at stitch time, into an ordinary dataset as the JAX package does.
``read`` reads each rank's block hyperslab only (``read_direct`` into an
aligned host buffer), so a file reads back on any number of ranks and
any alignment.

File schema (identical to the reference):

    name/{ndim}D/{step}                  whole snapshots
    name/{ndim}D/{slicename}/{step}      global-slice snapshots
    name/domain/x{i} | name/mesh/x{i}    domain metadata
"""
import os

import numpy as np
import torch.distributed as dist

from .file_base import (FileBase, barrier, block_slice, fields_group,
                        group_of, owned_blocks, owns_block, read_block,
                        size_rank, slice_part, world)

__all__ = ('HDF5File',)

# Several ranks open the main file in turns and while others hold their
# sidecars; HDF5's advisory file locking would deadlock that turn-taking,
# so it is disabled for this process — the role of the reference's
# MPI-IO coordination (reference: io/h5py_file.py:33).
os.environ.setdefault('HDF5_USE_FILE_LOCKING', 'FALSE')

_MODES = ('vds', 'serial')


def _h5_mode():
    mode = os.environ.get('MPI4PY_FFT_TORCH_H5_MODE', 'vds')
    if mode not in _MODES:
        raise ValueError(f"MPI4PY_FFT_TORCH_H5_MODE={mode!r}: one of "
                         f"{_MODES}")
    return mode


class HDF5File(FileBase):
    """Read/write snapshots in the reference HDF5 schema
    (reference: io/h5py_file.py:9-152)."""

    def __init__(self, h5name, domain=None, mode='a', **kw):
        FileBase.__init__(self, h5name, domain=domain)
        import h5py
        self._phase = None            # None | 'blocks' | 'stitch'
        self._sidecar = None
        self._repack = bool(kw.pop(
            'repack',
            os.environ.get('MPI4PY_FFT_TORCH_H5_REPACK', '0')
            not in ('0', 'false', 'False')))
        self._blk_groups = set()      # sidecar groups streamed this write
        self._src_cache = {}          # open sidecar handles during stitch
        self._slice_parts = {}        # gathered slice parts, rank 0
        comm = world()
        if size_rank(comm)[1] == 0:
            self.f = h5py.File(h5name, mode, **kw)
            self.close()
        barrier(comm)                 # the others wait for the file

    def _check_domain(self, group, field):
        """Store domain/mesh metadata + shape/rank attrs
        (reference: io/h5py_file.py:36-64)."""
        if self._phase == 'blocks':
            return                    # sidecar holds raw blocks only
        if self.domain is None:
            self.domain = ((0, 2 * np.pi),) * field.dimensions
        assert len(self.domain) == field.dimensions
        self.f.require_group(group)
        if "shape" not in self.f[group].attrs:
            self.f[group].attrs.create("shape", field.pencil.shape)
        if "rank" not in self.f[group].attrs:
            self.f[group].attrs.create("rank", field.rank)
        assert field.rank == self.f[group].attrs["rank"]
        assert np.all(field.pencil.shape == self.f[group].attrs["shape"])
        subgroup = "mesh" if isinstance(self.domain[0], np.ndarray) else "domain"
        self.f[group].require_group(subgroup)
        for i in range(field.dimensions):
            d = self.domain[i]
            if isinstance(d, np.ndarray):
                d0 = np.squeeze(d)
            else:
                d0 = np.array([d[0], d[1]])
            self.f[group][subgroup].require_dataset(
                f"x{i}", shape=d0.shape, dtype=d0.dtype, data=d0)

    @staticmethod
    def backend():
        return 'hdf5'

    def open(self, mode='r+'):
        import h5py
        self.f = h5py.File(self.filename, mode)

    # -- concurrent (VDS) machinery ------------------------------------
    @staticmethod
    def _blk_key(sl):
        """Sidecar dataset name for one global hyperslab."""
        return 'blk_' + '_'.join(f"{s.start}-{s.stop}" for s in sl)

    def _sidecar_name(self, p):
        return f"{self.filename}.p{p}.h5"

    def write(self, step, fields, **kw):
        """Write snapshot ``step`` (reference: io/h5py_file.py:74-119).

        Each rank writes only its own block (the reference's per-rank
        mpio writes, io/h5py_file.py:147-152).  Several ranks: concurrent
        sidecar streams + VDS stitch by default; ``serial`` mode takes
        turns."""
        comm = fields_group(fields)
        size, rank = size_rank(comm)
        if size == 1:
            self._write_open(step, fields, **kw)
            return
        if _h5_mode() == 'serial':
            for p in range(size):
                if rank == p:
                    self._write_open(step, fields, **kw)
                barrier(comm)
            return
        # ---- phase 1: every rank streams its block, in parallel --------
        import h5py
        self._phase = 'blocks'
        self._blk_groups = set()
        self._slice_parts = {}
        try:
            self._sidecar = h5py.File(self._sidecar_name(rank), 'a')
            try:
                FileBase.write(self, step, fields, **kw)
            finally:
                self._sidecar.close()
        finally:
            self._sidecar = None
            self._phase = None
        barrier(comm)
        # ---- phase 2: rank 0 stitches the main file ---------------------
        # (virtual datasets pointing at the sidecars, or — with
        # repack=True — contiguous copies drained from them)
        if rank == 0:
            self._phase = 'stitch'
            try:
                self._write_open(step, fields, **kw)
            finally:
                self._phase = None
                self._slice_parts = {}
                for f in self._src_cache.values():
                    f.close()
                self._src_cache = {}
        barrier(comm)
        if self._repack:
            # the main file is now self-contained; every rank drains the
            # groups it streamed this call from its own sidecar and
            # unlinks the file once nothing is left in it
            self._drain(self._sidecar_name(rank))
            barrier(comm)

    def _write_open(self, step, fields, **kw):
        self.open()
        try:
            FileBase.write(self, step, fields, **kw)
        finally:
            self.close()

    def _drain(self, side):
        import h5py
        if not (self._blk_groups and os.path.exists(side)):
            return
        with h5py.File(side, 'a') as sf:
            for grp in self._blk_groups:
                if grp in sf:
                    del sf[grp]
                # prune now-empty ancestor groups too
                parts = grp.split('/')
                for i in range(len(parts) - 1, 0, -1):
                    anc = '/'.join(parts[:i])
                    if anc in sf and len(sf[anc]) == 0:
                        del sf[anc]
            empty = len(sf) == 0
        if empty:
            os.remove(side)

    def read(self, u, name, **kw):
        """Read snapshot ``step`` into DistArray ``u``: each rank reads its
        own block's hyperslab, so the reader's ranks and alignment may
        differ from the writer's (reference: io/h5py_file.py:121-127 and
        docs/io.rst:61-62)."""
        step = kw.get('step', 0)
        self.open('r')
        try:
            dset = self.f["/".join((name, f"{u.dimensions}D", str(step)))]
            read_block(u, lambda buf, sl: dset.read_direct(buf,
                                                            source_sel=sl))
        finally:
            self.close()

    def _write_slice_step(self, name, step, slices, field, **kw):
        """Write a global slice of the array
        (reference: io/h5py_file.py:129-145): each rank's part of it."""
        rank = field.rank
        slices = list((slice(None),) * rank + tuple(slices))
        ndims = slices[rank:].count(slice(None))
        slname = self._get_slice_name(slices[rank:])
        sp = self._slice_spec(slices)
        group = "/".join((name, f"{ndims}D", slname))
        key = (group, str(step))
        if self._phase == 'blocks':
            # the parts meet on rank 0, which writes them at stitch time
            part = slice_part(field, slices, self._host(field)) \
                if owns_block(field) else None
            comm = group_of(field)
            parts = [None] * comm.Get_size() if comm.Get_rank() == 0 \
                else None
            dist.gather_object(part, parts,
                               dst=dist.get_global_rank(comm.group, 0),
                               group=comm.group)
            if parts is not None:
                self._slice_parts[key] = [p for p in parts if p is not None]
            return
        self.f.require_group(group)
        N = field.global_shape
        dset = self.f[group].require_dataset(
            str(step), shape=tuple(np.take(N, sp)), dtype=field.dtype)
        if self._phase == 'stitch':
            parts = self._slice_parts.pop(key)
        elif owns_block(field):
            parts = [slice_part(field, slices, self._host(field))]
        else:
            parts = []
        for region, part in filter(None, parts):
            dset[region] = part

    def _write_group(self, name, u, step, **kw):
        """Write the whole global array.

        One rank, or a ``serial`` turn: this rank's block straight into
        its hyperslab of the dataset.  'blocks' phase: this rank's block
        into its sidecar.  'stitch' phase: a virtual dataset mapping
        every rank's block source onto the global extent, or with
        ``repack`` the blocks copied out of the sidecars (reference mpio
        analogue: io/h5py_file.py:147-152)."""
        group = "/".join((name, f"{u.dimensions}D"))
        if self._phase == 'blocks':
            gpath = "/".join((group, str(step)))
            sgrp = self._sidecar.require_group(gpath)
            self._blk_groups.add(gpath)
            if owns_block(u):
                key = self._blk_key(block_slice(u))
                if key in sgrp:
                    sgrp[key][...] = self._host(u)
                else:
                    sgrp.create_dataset(key, data=self._host(u))
            return
        if self._phase == 'stitch':
            import h5py
            if self._repack:
                # contiguous single-artifact form: copy every rank's
                # block out of the sidecars (one serial pass on rank 0;
                # the parallel part already happened in phase 1)
                g = self.f.require_group(group)
                dset = g.require_dataset(str(step), shape=u.global_shape,
                                         dtype=u.dtype)
                for p, sl in owned_blocks(u):
                    if p not in self._src_cache:
                        self._src_cache[p] = h5py.File(
                            self._sidecar_name(p), 'r')
                    blk = self._src_cache[p][
                        "/".join((group, str(step), self._blk_key(sl)))]
                    dset[sl] = blk[...]
                return
            layout = h5py.VirtualLayout(shape=u.global_shape,
                                        dtype=u.dtype)
            for p, sl in owned_blocks(u):
                shape = tuple(s.stop - s.start for s in sl)
                # sidecars sit next to the main file: relative source
                # paths keep the file set relocatable as a unit
                src = h5py.VirtualSource(
                    os.path.basename(self._sidecar_name(p)),
                    "/".join((group, str(step), self._blk_key(sl))),
                    shape=shape, dtype=u.dtype)
                layout[sl] = src
            g = self.f.require_group(group)
            if str(step) in g:
                del g[str(step)]
            g.create_virtual_dataset(str(step), layout)
            return
        self.f.require_group(group)
        dset = self.f[group].require_dataset(str(step), shape=u.global_shape,
                                             dtype=u.dtype)
        if owns_block(u):
            dset[block_slice(u)] = self._host(u)
