"""Rank programs of tests/test_torch_dist.py and test_torch_dist_pfft.py.

``run`` is started on every rank of a gloo group by
``mpi4py_fft_torch.dryrun.launch`` (one fresh process a rank, CPU
tensors).  It reads the cases the test wrote (numpy inputs, made from a
seed), runs each through the port on this rank's blocks, and writes what
it got to ``<out>/<rank>.pkl``: blocks, block slices and errors.  No JAX
and nothing of the JAX package is imported here; the test holds the
blocks against the JAX package's results.
"""
import contextlib
import io
import pickle
import sys

import numpy as np
import torch

from mpi4py_fft_torch import PFFT, PlanarPFFT, DistArray, newDistArray
from mpi4py_fft_torch import dryrun
from mpi4py_fft_torch.parallel.pencil import Pencil, Subcomm
from mpi4py_fft_torch.ops import butterfly as tb


def _slices(sl):
    return tuple((s.start, s.stop) for s in sl)


def pencil(comm, shape, grid, X):
    """Block ownership of every pencil a grid takes, and the arrays'
    Transfer from the last axis's pencil to the first's."""
    sub = Subcomm(comm, list(grid))
    nd = len(shape)
    own = {}
    for axis in range(nd):
        try:
            p = Pencil(sub, shape, axis)
        except (AssertionError, ValueError):
            continue
        own[axis] = {'shape': p.local_shape(), 'start': p.local_start(),
                     'all': [(p.local_shape(r), p.local_start(r))
                             for r in range(comm.Get_size())]}
    pa = Pencil(sub, shape, nd - 1)
    pb = pa.pencil(0)
    t = pa.transfer(pb, X.dtype)
    sla = tuple(slice(s, s + n) for s, n in zip(pa.substart, pa.subshape))
    slb = tuple(slice(s, s + n) for s, n in zip(pb.substart, pb.subshape))
    b = np.zeros(pb.subshape, X.dtype)
    t.forward(np.ascontiguousarray(X[sla]), b)
    a = t.backward(torch.from_numpy(b))
    return {'own': own, 'fwd': b, 'fwd_slice': _slices(slb),
            'bwd': a.numpy(), 'bwd_slice': _slices(sla)}


def planar(comm, shape, dtype, padding, X, chunks=(1, 2)):
    """PlanarPFFT forward and backward of this rank's block of X, for each
    chunk count."""
    out = {}
    for c in chunks:
        pl = PlanarPFFT(comm, shape, dtype=dtype, padding=padding,
                        a2a_chunks=c, device='cpu')
        x = torch.from_numpy(np.ascontiguousarray(X[pl.local_slice(False)]))
        y = pl.forward(x)
        z = pl.backward(y)
        out[c] = {'executor': pl.executor, 'y': y.numpy(), 'z': z.numpy(),
                  'y_slice': _slices(pl.local_slice(True)),
                  'x_slice': _slices(pl.local_slice(False)),
                  'global': (pl.global_shape(False), pl.global_shape(True))}
    return out


def pfft(comm, shape, dtype, kw, X, chunks=(1, 2)):
    """PFFT's buffer call on DistArrays of this rank's block of X, and the
    backward of its spectrum, for each chunk count."""
    out = {}
    for c in chunks:
        fft = PFFT(comm, shape, dtype=dtype, device='cpu', a2a_chunks=c,
                   **kw)
        u = newDistArray(fft, False)
        u[...] = X[fft.local_slice(False)]
        uh = fft.forward(u)
        back = fft.backward(uh)
        out[c] = {'executor': fft.executor, 'y': np.asarray(uh),
                  'z': np.asarray(back),
                  'y_slice': _slices(fft.local_slice(True)),
                  'x_slice': _slices(fft.local_slice(False)),
                  'local': (fft.local_shape(False), fft.local_shape(True))}
    return out


def redistribute(comm, X, alignment, axis, rank):
    """``redistribute(axis)`` and ``redistribute(out=)`` of this rank's
    block of X (tensor rank ``rank``)."""
    gs = X.shape
    a = DistArray(gs, dtype=X.dtype, alignment=alignment, rank=rank,
                  device='cpu')
    a[...] = X[a.local_slice()]
    o = DistArray(gs, subcomm=a.pencil.pencil(axis), dtype=X.dtype,
                  rank=rank, device='cpu')
    o = a.redistribute(out=o)
    b = a.redistribute(axis)
    c = b.redistribute(out=DistArray(gs, dtype=X.dtype,
                                     alignment=alignment, rank=rank,
                                     device='cpu'))
    return {'b': np.asarray(b), 'b_slice': _slices(b.local_slice()),
            'b_align': b.alignment, 'c': np.asarray(c),
            'c_slice': _slices(c.local_slice()), 'o': np.asarray(o),
            'get': a.get(tuple(slice(None) for _ in gs))}


def dns(comm, n, seed):
    """The dry run's steps (``mpi4py_fft_torch.dryrun``) on this rank's
    blocks, and ``dryrun_multichip`` itself."""
    rng, u0, x = dryrun._inputs(n, seed)
    pl, U_hat, out, step = dryrun.dns_step(comm, n, u0, device='cpu')
    # the step again from the state without its Nyquist modes (see
    # nyquist_free in the test)
    spec = pl.local_slice(True)[1:]
    U0 = U_hat.clone()
    for ax, s in enumerate(spec):
        k = n // 2 - s.start
        if 0 <= k < s.stop - s.start:
            U0.select(2 + ax, k).zero_()
    fft, xl, y = dryrun.pfft_round_trip(comm, n, x, device='cpu')
    pds, xz, yz = dryrun.c2c_round_trip(comm, rng, device='cpu')
    return {'U_hat': U_hat.numpy(), 'out': out.numpy(),
            'out0': step(U0).numpy(),
            'spec_slice': _slices(pl.local_slice(True)),
            'pfft_executor': fft.executor,
            'pfft_y': y.numpy(), 'pfft_slice': _slices(fft.local_slice(False)),
            'c2c_y': yz.numpy(), 'c2c_slice': _slices(pds.local_slice(False)),
            'summary': dryrun.dryrun_multichip(comm, n=n, seed=seed,
                                               device='cpu')}


def refusals(comm):
    """A CUDA plan on a gloo group that was not named is refused."""
    got = []
    for make in (lambda: PlanarPFFT(comm, (8, 8, 8), device='cuda'),
                 lambda: PFFT(comm, (8, 8, 8), device='cuda')):
        try:
            make()
            got.append(None)
        except ValueError as e:
            got.append(str(e))
    return got


def staged(comm, shape, dtype, kw, X):
    """``stage_times`` of a PFFT's forward on this rank's block of X:
    its keys, the staged result against the fused one, and the block."""
    from mpi4py_fft_torch.utils.profiling import stage_times
    fft = PFFT(comm, shape, dtype=dtype, device='cpu', **kw)
    x = torch.from_numpy(np.ascontiguousarray(X[fft.local_slice(False)]))
    out = stage_times(fft.forward, x, reps=1)
    return {'keys': sorted(k for k in out if not k.startswith('_')),
            'equal': bool(torch.equal(out['_staged_result'],
                                      out['_fused_result'])),
            'y': out['_fused_result'].numpy(),
            'y_slice': _slices(fft.local_slice(True))}


def examples(comm):
    """The transforms and darray examples' ``run`` on this group: what
    each returns and what it printed."""
    from mpi4py_fft_torch.examples import darray, transforms
    out = {}
    for mod in (transforms, darray):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = mod.run(comm)
        out[mod.__name__.rsplit('.', 1)[1]] = (res, buf.getvalue())
    return out


def io_fields(u):
    """What the IO cases write of ``u`` at each step: the whole array
    and two global slices."""
    return {'u': [u, (u, [slice(None), 4, slice(None)]),
                  (u, [slice(None), 4, 4])]}


def io_write(comm, X, W, out, domain):
    """Snapshot writes of this rank's blocks of X (steps 0 and 1, with
    ``io_fields``' slices) and of the rank-1 tensor W (step 0): HDF5 in
    ``vds``, ``serial`` and ``repack`` modes and NetCDF, into ``out``.
    The slice writes may not gather the whole array: ``DistArray.get``
    and ``_gathered`` raise here, and the bytes of each part that
    ``gather_object`` carries are recorded."""
    import os
    import torch.distributed as dist
    from mpi4py_fft_torch import HDF5File, NCFile
    u = DistArray(X.shape, dtype=X.dtype, device='cpu')
    u[...] = X[u.local_slice()]
    w = DistArray(W.shape, dtype=W.dtype, rank=1, device='cpu')
    w[...] = W[w.local_slice()]
    sent = []
    real = dist.gather_object, DistArray.get, DistArray._gathered

    def spy(obj, *args, **kw):
        sent.append(0 if obj is None else obj[1].nbytes)
        return real[0](obj, *args, **kw)

    def refuse(*args, **kw):
        raise AssertionError("a snapshot write gathered the whole array")
    dist.gather_object = spy
    DistArray.get = DistArray._gathered = refuse
    files = {}
    try:
        for name, mode, repack in (('vds', 'vds', False),
                                   ('serial', 'serial', False),
                                   ('repack', 'vds', True)):
            os.environ['MPI4PY_FFT_TORCH_H5_MODE'] = mode
            files[name] = os.path.join(out, f'{name}.h5')
            f = HDF5File(files[name], domain=domain, mode='w',
                         repack=repack)
            for step in (0, 1):
                f.write(step, io_fields(u))
            f.write(0, {'w': [w]}, as_scalar=True)
        files['nc'] = os.path.join(out, 'turns.nc')
        f = NCFile(files['nc'], mode='w')
        for step in (0, 1):
            f.write(step, io_fields(u))
        f.write(0, {'w': [w]})
    finally:
        os.environ.pop('MPI4PY_FFT_TORCH_H5_MODE', None)
        dist.gather_object, DistArray.get, DistArray._gathered = real
    return {'files': files, 'sent': sent,
            'block': _slices(u.local_slice())}


def io_read(comm, files, shape):
    """Step 1 of ``u`` from each file, read into this rank's blocks under
    alignments 0 and 2: {(file, alignment): (block slice, block)}."""
    out = {}
    for path in files:
        for align in (0, 2):
            v = DistArray(shape, dtype='d', alignment=align, device='cpu')
            v.read(path, 'u', step=1)
            out[(path, align)] = (_slices(v.local_slice()), np.asarray(v))
    return out


KINDS = {'pencil': pencil, 'planar': planar, 'pfft': pfft,
         'redistribute': redistribute, 'dns': dns, 'refusals': refusals,
         'staged': staged, 'examples': examples, 'io_write': io_write,
         'io_read': io_read}


def run(comm, job, out):
    with open(job, 'rb') as f:
        cases = pickle.load(f)
    tb.reset_launches()
    res = {name: KINDS[kind](comm, **args)
           for name, (kind, args) in cases.items()}
    res['_modules'] = sorted(m for m in sys.modules
                             if m.split('.')[0] in ('jax', 'jaxlib',
                                                    'mpi4py_fft_tpu'))
    res['_launches'] = dict(tb.LAUNCHES)
    with open(f'{out}/{comm.Get_rank()}.pkl', 'wb') as f:
        pickle.dump(res, f)
    return {'rank': comm.Get_rank(), 'cases': len(cases)}
