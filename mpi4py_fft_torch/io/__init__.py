"""Snapshot IO for distributed arrays.

Port of ``mpi4py_fft_tpu/io/`` (reference: mpi4py_fft/io/).  Each rank
of a ``torch.distributed`` group writes and reads only its own block of
a :class:`~mpi4py_fft_torch.distarray.DistArray`; on one rank the block
is the whole array.  The on-disk schemas (HDF5 group layout, NetCDF
variable naming, XDMF structure) are the JAX package's and the
reference's, so downstream tooling (ParaView/VisIt via XDMF) keeps
working.  h5py is imported where an HDF5 file is opened, so the package
imports without it.
"""
from .file_base import FileBase  # noqa: F401
from .h5py_file import HDF5File  # noqa: F401
from .nc_file import NCFile      # noqa: F401
from .generate_xdmf import generate_xdmf  # noqa: F401
