"""Mixed-transform demo on several ranks: the port of
``examples/transforms.py``.

An rfft along axis 0 with a DCT-III along axes 1 and 2 (a ``transforms``
dict), on a slab grid with collapsed axes (``fft``), the same plan with
3/2-rule padding on axis 0 (``pfft``), and a complex plan (``cfft``):
round trips of each, every rank on its own block of one global array.

``run`` is the program of one rank, started on every rank of a group
(the counterpart of ``mpirun -np R``)::

    python -m mpi4py_fft_torch.examples.transforms [N] --ranks 2 --device cpu
    python -m mpi4py_fft_torch.examples.transforms 512 --ranks 2 --backend gloo

or from Python, ``dryrun.launch(R,
'mpi4py_fft_torch.examples.transforms:run', {'N': 18})``.  It needs two
ranks or more, as the JAX example needs a mesh of more than one device:
with ``collapse=True`` every axes group that lies on groups of one rank
is merged, and on one rank that is every group, so ``fft.axes`` differs
from ``pfft.axes`` and the demo's first assertion fails, there as here.
"""
import argparse
import functools
import sys

import numpy as np

from mpi4py_fft_torch import PFFT, newDistArray
from mpi4py_fft_torch.fftw import dctn, idctn

OK = "transforms demo OK"
TARGET = 'mpi4py_fft_torch.examples.transforms:run'


def plans(comm, N=18, dtype='d', device=None):
    """The demo's three plans on ``comm``: ``fft`` (collapsed, slab),
    ``pfft`` (padded on axis 0) and ``cfft`` (complex)."""
    shape = np.array([N, N, N], dtype=int)
    dct = functools.partial(dctn, type=3)
    idct = functools.partial(idctn, type=3)
    transforms = {(1, 2): (dct, idct)}
    fft = PFFT(comm, shape, axes=None, collapse=True, grid=(-1,),
               transforms=transforms, dtype=dtype, device=device)
    pfft = PFFT(comm, shape, axes=((0,), (1, 2)), grid=(-1,),
                padding=[1.5, 1.0, 1.0], transforms=transforms, dtype=dtype,
                device=device)
    cfft = PFFT(comm, shape, dtype=np.dtype(dtype).char.upper(),
                device=device)
    return fft, pfft, cfft


def field(fft, seed, forward_output=False):
    """This rank's block of a global random array of the plan's input
    (or output) shape and dtype, the same on every rank for one seed."""
    rng = np.random.default_rng(seed)
    shape = fft.global_shape(forward_output)
    a = rng.random(shape)
    if np.dtype(fft.dtype(forward_output)).kind == 'c':
        a = a + 1j * rng.random(shape)
    return a[fft.local_slice(forward_output)]


def run(comm, N=18, dtype='d', device=None, seed=0):
    """The demo on this rank; rank 0 prints the OK line."""
    fft, pfft, cfft = plans(comm, N, dtype, device)
    assert fft.axes == pfft.axes, (fft.axes, pfft.axes)
    single = np.dtype(dtype).char in 'fF'
    tol = dict(rtol=1e-4, atol=1e-5) if single else {}

    u = newDistArray(fft, forward_output=False)
    u[:] = field(fft, seed)
    u_hat = newDistArray(fft, forward_output=True)
    u_hat = fft.forward(u, u_hat)
    uj = newDistArray(fft, forward_output=False)
    uj = fft.backward(u_hat, uj)
    assert np.allclose(np.asarray(uj), np.asarray(u), **tol)

    u_padded = newDistArray(pfft, forward_output=False)
    uc = np.asarray(u_hat).copy()
    u_padded = pfft.backward(u_hat, u_padded)
    u_hat = pfft.forward(u_padded, u_hat)
    assert np.allclose(np.asarray(u_hat), uc, **tol)

    uc = field(cfft, seed + 1, forward_output=True)
    u2 = cfft.backward(uc)
    u3 = cfft.forward(u2)
    assert np.allclose(uc, np.asarray(u3), **tol)

    for f in (fft, pfft, cfft):
        f.destroy()
    if comm.Get_rank() == 0:
        print(OK, flush=True)
    return {'rank': comm.Get_rank(), 'ranks': comm.Get_size(), 'N': N,
            'dtype': dtype, 'axes': [list(g) for g in fft.axes],
            'message': OK}


def main(argv=None):
    from mpi4py_fft_torch import dryrun
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('N', type=int, nargs='?', default=18)
    ap.add_argument('--dtype', default='d', choices=('d', 'f'))
    ap.add_argument('--ranks', type=int, default=2)
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    ap.add_argument('--backend', choices=('nccl', 'gloo'), default=None)
    args = ap.parse_args(argv)
    res = dryrun.launch(args.ranks, TARGET,
                        {'N': args.N, 'dtype': args.dtype},
                        device=args.device, backend=args.backend)
    print(res[0]['message'])
    return 0


if __name__ == '__main__':
    sys.exit(main())
