"""mpi4py_fft_torch — the PyTorch + CUDA port of mpi4py_fft_tpu.

Complex data is planar, as in the JAX package: a complex field of shape S
is a real ``(2,) + S`` tensor (index 0 = real part, 1 = imaginary part).
The transform work runs in hand-written CUDA kernels (``ops/csrc``) built
with ``nvcc`` at first use; on CPU tensors every kernel wrapper runs its
plain PyTorch version instead.

The port covers so far, on one device and over the ranks of a
``torch.distributed`` group (one process a rank, each holding its block:
``parallel/multihost.py``, ``parallel/pencil.py``; ``dryrun.py`` runs the
dry run on N ranks):

* the reference API: :class:`PFFT` with its :class:`Transform`\\ s, the
  pencil metadata (:class:`Subcomm`, :class:`Pencil`, :class:`Transfer`),
  :class:`DistArray`/:func:`newDistArray`, the serial ``libfft.FFT`` and
  the FFTW-style planners (``fftw``, ``fftlib``): c2c and r2c, float32
  and float64, with 3/2-rule padding, whose padded c2c stages run the
  fused dealiasing kernel ``fft_axis_tp``;
* the r2r transforms (``ops/core.py``): DCT/DST I-IV, DHT and R2HC/HC2R
  through the planners ``dctn``/``idctn``/``dstn``/``idstn``, ``FFT``
  with r2r kinds and ``PFFT(..., transforms=...)`` on one and several
  ranks, glue around the r2c/c2r kernels B and C;
* tracing and per-stage profiling (``utils/profiling.py``: ``trace``,
  the spans of ``annotate`` and their ``session`` table, ``stage_times``);
* the per-shard executors of :class:`PFFT` and :class:`PlanarPFFT` on
  several ranks, each exchange one ``all_to_all_single`` over the group
  of the swapped axes, and ``DistArray.redistribute`` between pencils;
* :class:`PlanarPFFT`: c2c and r2c, float32 and float64,
  with 3/2-rule padding; the quartered out-of-place schedule of 3-D
  float32 c2c volumes (``ops/oop3d.py``, ``PlanarPFFT.forward_fn_q``/
  ``backward_fn_q``);
* any extent on every axis of these plans: the Stockham kernels take
  2^a and 3*2^a up to 1024 (float32 c2c axes also 1536 and 2048 in one
  pass of the pair kernel, 4096 by the four-step), and every other
  length runs the mixed-radix and Bluestein engine of ``ops/matfft.py``,
  whose float32 last axes of S*128 points run the two-stage kernel J
  (``ops/fft2stage.py``);
* the two-axis plane kernels H and I (``ops.butterfly.fft_plane_p``,
  ``fft_plane_large_p``), entry points nothing dispatches;
* the JAX package's TPU probes (``scripts/tpu_*.py``) as on-card probes
  (``mpi4py_fft_torch.probes``) on the probe kernels of ``ops/probes.py``;
* snapshot IO (``io/``: :class:`HDF5File`, :class:`NCFile`,
  :func:`generate_xdmf`, ``DistArray.write``/``read``), each rank writing
  and reading its own block, staged through the host buffers and block
  pack/unpack of ``utils/native.py`` (the ``_hoststage`` extension, built
  with g++ at first use);
* the spectral DNS examples (``examples/spectral_dns_solver.py`` on
  ``PFFT``, its algebra in three float64 kernels a Runge-Kutta stage,
  ``ops/dns_algebra.py``; ``examples/spectral_dns_planar.py`` on
  ``PlanarPFFT``), and
  the ``transforms`` and ``darray`` examples on N ranks
  (``examples/transforms.py``, ``examples/darray.py``).
"""
import sys as _sys

import torch

from . import ops
from . import ops as fftw
from .ops.plan import fftlib
from .parallel.pencil import Subcomm, Pencil, Transfer
from .parallel.mpifft import PFFT, Transform
from .parallel.planar import PlanarPFFT
from .distarray import DistArray, newDistArray, Function
from .io import HDF5File, NCFile, generate_xdmf

# reference-compatible module names (mpi4py_fft/fftw/{xfftn,factory,
# utilities})
_sys.modules[__name__ + '.fftw'] = ops
_sys.modules[__name__ + '.fftw.xfftn'] = ops.xfftn
_sys.modules[__name__ + '.fftw.factory'] = ops.plan
_sys.modules[__name__ + '.fftw.utilities'] = ops.utilities

__version__ = '0.1.0'

__all__ = ['PFFT', 'Transform', 'PlanarPFFT', 'DistArray', 'newDistArray',
           'Function', 'fftw', 'ops', 'fftlib', 'Subcomm', 'Pencil',
           'Transfer', 'HDF5File', 'NCFile', 'generate_xdmf', 'entry',
           '__version__']


def entry(device=None):
    """Return ``(fn, example_args)``: the forward step of the flagship
    pipeline, a 64^3 r2c f32 ``PlanarPFFT`` with normalized planar
    spectral output (counterpart of ``__graft_entry__.entry``)."""
    N = (64, 64, 64)
    pfft = PlanarPFFT(None, N, dtype='f', device=device)
    x = torch.zeros(N, dtype=torch.float32, device=pfft.device)
    return pfft.forward, (x,)
