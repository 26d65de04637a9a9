"""Serial transform layer of the port (the port's 'fftw' module): the
Stockham kernels (``butterfly``), their build (``_build``), the planar
engine surface (``matfft``), the serial transform math with the r2r
kinds (``core``), and the reference's planner surface: planner functions
(``xfftn``), kind and flag enums (``kinds``), aligned host buffers, the
plan object and its factory, and the wisdom calls (``plan``), as
``mpi4py_fft_tpu/ops/__init__.py`` exposes them."""
from ..utils import aligned, aligned_like, get_alignment  # noqa: F401
from .kinds import *          # noqa: F401,F403  enums + flag_dict
from .plan import (FFT, get_planned_FFT, fftlib, get_fftw_lib,   # noqa: F401
                   export_wisdom, import_wisdom, forget_wisdom,
                   set_timelimit, cleanup)
from .xfftn import (fftn, ifftn, rfftn, irfftn, dctn,  # noqa: F401
                    idctn, dstn, idstn, hfftn, ihfftn, get_normalization,
                    inverse, dct_type, idct_type, dst_type, idst_type)
from . import core  # noqa: F401

# reference-compatible submodule names (mpi4py_fft/fftw/{factory,utilities})
from . import plan as factory      # noqa: F401
from .. import utils as utilities  # noqa: F401
