"""NetCDF snapshot backend.

Port of ``mpi4py_fft_tpu/io/nc_file.py`` (reference semantics:
mpi4py_fft/io/nc_file.py: parallel netCDF4 with an unlimited ``time``
dimension, named spatial dims ``x,y,z,r,s,t``, tensor dims ``i,j,k``, and
flat variable naming ``name_slice_...``).

Backend selection: uses ``netCDF4`` when importable, otherwise
``scipy.io.netcdf_file`` (NetCDF-3 classic, 64-bit offsets).  The
variable/dimension layout is identical either way, so files interoperate
with the reference's readers.

On several ranks (the array's ``torch.distributed`` group) the ranks
take turns on the file between ``dist.barrier`` calls, each writing its
own block's hyperslab and its own part of each global slice (the role of
the reference's parallel-netCDF4 collective writes).  scipy's writer
reads the whole file on opening it for appending and rewrites it on
closing (its ``sync`` would rewrite it again, so the adapter's does
nothing), so each turn moves the whole file twice.  ``read`` takes this
rank's hyperslab of record ``step``; on scipy it opens the file
read-only (memory-mapped: only the hyperslab's pages are read, and
nothing is rewritten, so ranks read at the same time).
"""
import os

import numpy as np

from .file_base import (FileBase, barrier, block_slice, fields_group,
                        owns_block, read_block, size_rank, slice_part,
                        world)

__all__ = ('NCFile',)

try:
    from netCDF4 import Dataset as _NC4Dataset
    _HAVE_NC4 = True
except ImportError:
    _HAVE_NC4 = False


class _ScipyNC(object):
    """Minimal netCDF4-Dataset-like adapter over scipy.io.netcdf_file."""

    def __init__(self, filename, mode='r', **kw):
        from scipy.io import netcdf_file
        # scipy netcdf: version 2 allows large files
        self._f = netcdf_file(filename, mode=mode, version=2)

    @property
    def variables(self):
        return self._f.variables

    def createDimension(self, name, length):
        self._f.createDimension(name, length)

    def createVariable(self, name, dtype, dims):
        ch = np.dtype(dtype).char
        assert ch in 'fdilhb', \
            f"NetCDF-3 fallback cannot store dtype {dtype}"
        return self._f.createVariable(name, ch, tuple(dims))

    def __getitem__(self, name):
        return self._f.variables[name]

    def sync(self):
        """Nothing: scipy writes the whole file at every sync, and the
        file is written whole when it is closed, which every write (or
        rank's turn) does before it returns."""

    def close(self):
        self._f.close()


def _open_dataset(filename, mode, **kw):
    if _HAVE_NC4:
        return _NC4Dataset(filename, mode=mode, **kw)
    return _ScipyNC(filename, mode=mode, **kw)


def _set_collective(var, flag):
    # collective-mode toggling is a parallel-netCDF4 concept
    # (reference: io/nc_file.py:185-193); no-op on serial backends
    if hasattr(var, 'set_collective') and _HAVE_NC4:
        try:
            var.set_collective(flag)
        except (RuntimeError, ValueError):
            pass


class NCFile(FileBase):
    """Read/write snapshots in the reference NetCDF schema
    (reference: io/nc_file.py:13-206)."""

    def __init__(self, ncname, domain=None, mode='a', clobber=True, **kw):
        FileBase.__init__(self, ncname, domain=domain)
        self.dims = None
        comm = world()
        if size_rank(comm)[1] == 0:
            if mode == 'a' and not os.path.exists(ncname):
                mode = 'w'
            self.f = _open_dataset(ncname, mode=mode, **kw)
            if 'time' not in self.f.variables:
                self.f.createDimension('time', None)
                self.f.createVariable('time', np.float64, ('time',))
            self.close()
        barrier(comm)                 # the others wait for the file

    def _check_domain(self, group, field):
        """Create time/tensor/spatial dimensions and coordinate variables
        (reference: io/nc_file.py:60-91)."""
        N = field.global_shape[field.rank:]
        if self.domain is None:
            self.domain = [np.linspace(0, 2 * np.pi, N[i])
                           for i in range(field.dimensions)]
        assert len(self.domain) == field.dimensions
        if len(self.domain[0]) == 2:
            d = self.domain
            self.domain = [np.linspace(d[i][0], d[i][1], N[i])
                           for i in range(field.dimensions)]

        self.dims = ['time']
        for i in range(field.rank):
            ind = 'ijk'[i]
            self.dims.append(ind)
            if ind not in self.f.variables:
                self.f.createDimension(ind, field.dimensions)
                n = self.f.createVariable(ind, np.float64, (ind,))
                n[:] = np.arange(field.dimensions)

        for i in range(field.dimensions):
            xyz = 'xyzrst'[i]
            self.dims.append(xyz)
            if xyz not in self.f.variables:
                self.f.createDimension(xyz, N[i])
                nc_xyz = self.f.createVariable(xyz, np.float64, (xyz,))
                nc_xyz[:] = self.domain[i]
        self.f.sync()

    @staticmethod
    def backend():
        return 'netcdf4' if _HAVE_NC4 else 'netcdf3-scipy'

    def open(self, mode='r+'):
        if not _HAVE_NC4 and mode == 'r+':
            mode = 'a'
        self.f = _open_dataset(self.filename, mode=mode)

    def write(self, step, fields, **kw):
        """Write snapshot ``step``; the time axis is unlimited and ``step``
        values map to consecutive records (reference: io/nc_file.py:101-160).

        Several ranks take turns on the file, each writing only its own
        block's hyperslab and slice parts."""
        comm = fields_group(fields)
        size, rank = size_rank(comm)
        for p in range(size):
            if rank == p:
                self._write_turn(step, fields, **kw)
            barrier(comm)

    def _write_turn(self, step, fields, **kw):
        self.open()
        try:
            nc_t = self.f.variables.get('time')
            _set_collective(nc_t, True)
            time_vals = np.asarray(nc_t[:]) if nc_t.shape[0] \
                else np.empty(0)
            it = len(time_vals)
            if step in time_vals:
                it = int(np.argwhere(time_vals == step)[0][0])
            else:
                nc_t[it] = step
            FileBase.write(self, it, fields, **kw)
        finally:
            self.close()

    def read(self, u, name, **kw):
        """Read this rank's hyperslab of record ``step`` into DistArray
        ``u`` (reference: io/nc_file.py:162-168)."""
        step = kw.get('step', 0)
        self.open('r')
        try:
            var = self.f[name]

            def read(buf, sl):
                buf[...] = var[(step,) + sl]
            read_block(u, read)
            # no reference into scipy's memory map may outlive the close
            del var, read
        finally:
            self.close()

    def _write_slice_step(self, name, step, slices, field, **kw):
        """Write this rank's part of a global slice as variable
        ``name_slice_...`` (reference: io/nc_file.py:170-194)."""
        assert name not in self.dims
        rank = field.rank
        slices = list((slice(None),) * rank + tuple(slices))
        slname = self._get_slice_name(slices[rank:])
        sp = self._slice_spec(slices)
        sdims = ['time'] + list(np.take(self.dims, np.asarray(sp) + 1))
        fname = "_".join((name, slname))
        if fname not in self.f.variables:
            h = self.f.createVariable(fname, field.dtype, sdims)
        else:
            h = self.f.variables[fname]
        _set_collective(h, True)
        part = slice_part(field, slices, self._host(field)) \
            if owns_block(field) else None
        if part is not None:
            region, data = part
            h[(step,) + region] = data
        self.f.sync()

    def _write_group(self, name, u, step, **kw):
        """Write this rank's block of the array at record ``step``
        (reference: io/nc_file.py:196-206 writes each rank's
        local_slice)."""
        assert name not in self.dims
        if name not in self.f.variables:
            h = self.f.createVariable(name, u.dtype, self.dims)
        else:
            h = self.f.variables[name]
        _set_collective(h, True)
        if owns_block(u):
            h[(step,) + block_slice(u)] = self._host(u)
        self.f.sync()
