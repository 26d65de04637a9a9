"""DistArray redistribution demo on several ranks: the port of
``examples/darray.py``.

Redistributions between alignments, a ``PFFT`` planned from a
``DistArray``, and arrays of tensor rank 1 and 2.  Every rank holds its
block of each array, so the demo's sums and norms are reduced over the
group (the reference's ``allreduce``; the JAX example takes them on its
global arrays).

``run`` is the program of one rank, started on every rank of a group::

    python -m mpi4py_fft_torch.examples.darray --ranks 2 --device cpu

or from Python, ``dryrun.launch(R, 'mpi4py_fft_torch.examples.darray:run')``.
"""
import argparse
import sys

import numpy as np
import torch
import torch.distributed as dist

from mpi4py_fft_torch import DistArray, newDistArray, PFFT

OK = "darray demo OK"
TARGET = 'mpi4py_fft_torch.examples.darray:run'


def _allsum(comm, v):
    """The sum of ``v`` over the ranks of ``comm``."""
    t = torch.tensor([float(v)], dtype=torch.float64)
    if comm.distributed:
        if comm.backend == 'nccl':
            t = t.to(comm.device)
        dist.all_reduce(t, group=comm.group)
    return float(t[0])


def run(comm, device=None, seed=0):
    """The demo on this rank (the arrays span the world group, which
    ``comm`` is); rank 0 prints the OK line."""
    def _sum(a):
        return _allsum(comm, np.sum(np.asarray(a)))

    def _norm(a):
        a = np.asarray(a)
        return np.sqrt(_allsum(comm, np.vdot(a, a).real))

    rng = np.random.default_rng(seed)
    N = (16, 14, 12)
    z0 = DistArray(N, dtype=float, alignment=0, device=device)
    z0[:] = rng.integers(0, 10, N).astype(float)[z0.local_slice()]
    s0 = _sum(z0)
    z1 = z0.redistribute(2)
    s1 = _sum(z1)
    z2 = z1.redistribute(1)
    s2 = _sum(z2)
    assert s0 == s1 == s2, (s0, s1, s2)

    fft = PFFT(None, darray=z2, axes=(0, 2, 1))
    z3 = newDistArray(fft, forward_output=True)
    z2c = np.asarray(z2).copy()
    fft.forward(z2, z3)
    fft.backward(z3, z2)
    s0, s1 = _norm(z2), _norm(z2c)
    assert abs(s0 - s1) < 1e-10, s0 - s1

    v0 = newDistArray(fft, forward_output=False, rank=1)
    v0[...] = rng.random(v0.global_shape)[v0.local_slice()]
    v0c = np.asarray(v0).copy()
    v1 = newDistArray(fft, forward_output=True, rank=1)

    for i in range(3):
        v1[i] = fft.forward(v0[i], v1[i])
    for i in range(3):
        v0[i] = fft.backward(v1[i], v0[i])
    s0, s1 = _norm(v0c), _norm(v0)
    assert abs(s0 - s1) < 1e-10

    nfft = PFFT(None, darray=v0[0], axes=(0, 2, 1))
    for i in range(3):
        v1[i] = nfft.forward(v0[i], v1[i])
    for i in range(3):
        v0[i] = nfft.backward(v1[i], v0[i])
    s0, s1 = _norm(v0c), _norm(v0)
    assert abs(s0 - s1) < 1e-10

    N = (8, 8, 8)
    z = DistArray(N, dtype=float, alignment=0, device=device)
    z[:] = 3.0
    g0 = z.get((0, slice(None), 0))
    z2 = z.redistribute(2)
    z = z2.redistribute(out=z)
    g1 = z.get((0, slice(None), 0))
    assert np.all(g0 == g1)

    N = (3, 3, 8, 8, 8)
    z2 = DistArray(N, dtype=float, val=1, alignment=2, rank=2, device=device)
    z2[...] = 2.0
    z1 = z2.redistribute(1)
    z0 = z1.redistribute(0)
    assert abs(_norm(z2) - _norm(z0)) < 1e-12
    z1 = z0.redistribute(out=z1)
    z0 = z1.redistribute(out=z0)

    N = (8, 8, 8, 8, 8)
    m0 = DistArray(N, dtype=float, alignment=2, device=device)
    m0[:] = 1.5
    m1 = m0.redistribute(4)
    m0 = m1.redistribute(out=m0)
    assert abs(_norm(m0) - _norm(m1)) < 1e-10
    if comm.Get_rank() == 0:
        print(OK, flush=True)
    return {'rank': comm.Get_rank(), 'ranks': comm.Get_size(),
            'message': OK}


def main(argv=None):
    from mpi4py_fft_torch import dryrun
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--ranks', type=int, default=2)
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    ap.add_argument('--backend', choices=('nccl', 'gloo'), default=None)
    args = ap.parse_args(argv)
    res = dryrun.launch(args.ranks, TARGET, {}, device=args.device,
                        backend=args.backend)
    print(res[0]['message'])
    return 0


if __name__ == '__main__':
    sys.exit(main())
