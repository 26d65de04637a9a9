"""Multi-rank dry run of the port, and a launcher of one process a rank.

Counterpart of ``__graft_entry__.dryrun_multichip`` (:25-120) on
``torch.distributed`` ranks.  :func:`dryrun_multichip` runs on every
rank of ``comm``, with the same steps and inputs as there:

1. one float64 r2c spectral-DNS step (the JAX ``train_step``) through
   ``PlanarPFFT`` on ``Subcomm(comm, [0, 0, 1])`` (:35-77);
2. ``PFFT(comm, (n, n + 1, n), dtype='d', a2a_chunks=2)``, whose executor
   is the per-shard one on several ranks, forward and backward on
   ``fn_p``, the round trip at atol 1e-8 (:84-95);
3. the float64 c2c ``PlanarPFFT`` round trip at 2e-10 (:97-120: the JAX
   package's double-single block, here the fp64 build of the kernels).

Run it on N ranks::

    python -m mpi4py_fft_torch.dryrun --ranks 4 --device cpu
    python -m mpi4py_fft_torch.dryrun --ranks 2 --device cuda --backend gloo

Each rank prints one JSON line.  The defaults are the card and NCCL,
which puts one rank on a card: with more NCCL ranks than cards the
launcher refuses; it never switches backend on its own (gloo copies CUDA
tensors through host memory, so name it to run several ranks on one
card).  :func:`launch` runs any function ``module:name`` taking the
communicator on N fresh processes, one rank each.
"""
import argparse
import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

__all__ = ['dns_step', 'pfft_round_trip', 'c2c_round_trip',
           'dryrun_multichip', 'launch']

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NU, DT = 0.000625, 0.01


def _sizes(comm):
    from .parallel.pencil import Subcomm
    return [c.Get_size() for c in Subcomm(comm, [0, 0, 1])]


def _inputs(n, seed):
    """The JAX dry run's inputs, drawn in its order: the three velocity
    components, the uneven PFFT's input, the c2c plan's input."""
    rng = np.random.default_rng(seed)
    N = (n,) * 3
    u0 = [rng.random(N) for _ in range(3)]
    x = rng.random((n, n + 1, n))
    return rng, u0, x


def dns_step(comm, n, u0, device=None):
    """One float64 DNS step (the JAX ``train_step``, :41-77) on this
    rank's blocks; returns the plan and the spectral state before and
    after the step, this rank's blocks (3, 2) + block."""
    from .parallel.planar import PlanarPFFT
    N = (n,) * 3
    pfft = PlanarPFFT(comm, N, dtype='d', grid=tuple(_sizes(comm)),
                      device=device)
    dev = pfft.device
    sl = pfft.local_slice(True)[1:]
    k = [np.fft.fftfreq(m, 1. / m) for m in N[:-1]]
    k.append(np.fft.rfftfreq(N[-1], 1. / N[-1]))
    K = []
    for ax, (kv, s) in enumerate(zip(k, sl)):
        shp = [1, 1, 1]
        kv = kv[s]
        shp[ax] = kv.size
        K.append(torch.as_tensor(kv.reshape(shp), device=dev))
    K2 = K[0] ** 2 + K[1] ** 2 + K[2] ** 2
    KoK2 = [Ki / torch.where(K2 == 0, 1., K2) for Ki in K]
    fwd, bck = pfft.forward, pfft.backward

    def pmul_i(K_ax, p):
        """planar multiply by (1j * K): (re,im) -> (-K*im, K*re)."""
        return torch.stack([-K_ax * p[1], K_ax * p[0]])

    def train_step(U_hat):
        u = [bck(U_hat[j]) for j in range(3)]
        w = [bck(pmul_i(K[1], U_hat[2]) - pmul_i(K[2], U_hat[1])),
             bck(pmul_i(K[2], U_hat[0]) - pmul_i(K[0], U_hat[2])),
             bck(pmul_i(K[0], U_hat[1]) - pmul_i(K[1], U_hat[0]))]
        rhs = torch.stack([fwd(u[1] * w[2] - u[2] * w[1]),
                           fwd(u[2] * w[0] - u[0] * w[2]),
                           fwd(u[0] * w[1] - u[1] * w[0])])
        P_hat = sum(rhs[j] * KoK2[j] for j in range(3))
        rhs = rhs - torch.stack([P_hat * K[j] for j in range(3)])
        rhs = rhs - NU * K2 * U_hat
        return U_hat + DT * rhs

    xs = pfft.local_slice(False)
    U_hat = torch.stack([fwd(torch.as_tensor(np.ascontiguousarray(u[xs]),
                                             device=dev)) for u in u0])
    return pfft, U_hat, train_step(U_hat), train_step


def pfft_round_trip(comm, n, x, device=None, a2a_chunks=2):
    """The uneven r2c ``PFFT`` round trip (:84-95) on this rank's block;
    returns the plan, the input block and the round trip's block."""
    from .parallel.mpifft import PFFT
    fft = PFFT(comm, (n, n + 1, n), dtype='d', grid=tuple(_sizes(comm)),
               a2a_chunks=a2a_chunks, device=device)
    want = 'shard_map' if fft._nmesh > 1 else 'gspmd'
    if fft.executor != want:
        raise RuntimeError(f"PFFT executor {fft.executor!r}, not {want!r}")
    xl = torch.as_tensor(np.ascontiguousarray(x[fft.local_slice(False)]),
                         device=fft.device)
    y = fft.backward.fn_p(fft.forward.fn_p(xl, True), False)
    return fft, xl, y


def c2c_round_trip(comm, rng, nds=64, device=None):
    """The float64 c2c ``PlanarPFFT`` round trip (:97-120) on this rank's
    block of a (2, nds, nds, nds) input; returns the plan, the input
    block and the round trip's block."""
    from .parallel.planar import PlanarPFFT
    szs = [s for s in _sizes(comm) if s > 1][:2] or [1]
    pds = PlanarPFFT(comm, (nds,) * 3, dtype='D', grid=tuple(szs),
                     device=device)
    xz = rng.standard_normal((2, nds, nds, nds))
    xl = torch.as_tensor(np.ascontiguousarray(xz[pds.local_slice(False)]),
                         device=pds.device)
    return pds, xl, pds.backward(pds.forward(xl, True), False)


def dryrun_multichip(comm=None, n=None, seed=0, nds=64, device=None):
    """Run the dry run's three steps on this rank (every rank of ``comm``
    calls it); raise if a shape or a round trip is off.  ``n`` defaults
    to the JAX dry run's max(8, 2 * the largest grid axis).  Returns this
    rank's figures (JSON)."""
    sizes = _sizes(comm)
    n = max(8, 2 * max(sizes)) if n is None else int(n)
    rng, u0, x = _inputs(n, seed)
    t0 = time.perf_counter()
    pfft, U_hat, out, _ = dns_step(comm, n, u0, device)
    _sync(pfft.device)
    t1 = time.perf_counter()
    if out.shape != U_hat.shape or not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"DNS step: {tuple(out.shape)} against "
                           f"{tuple(U_hat.shape)}, or non-finite")
    fft, xl, y = pfft_round_trip(comm, n, x, device)
    err = float((y - xl).abs().max()) if xl.numel() else 0.0
    if y.shape != xl.shape or not err <= 1e-8:
        raise RuntimeError(f"PFFT round trip: max abs error {err:.3e}")
    pds, xz, yz = c2c_round_trip(comm, rng, nds, device)
    errz = float((yz - xz).abs().max()) if xz.numel() else 0.0
    if yz.shape != xz.shape or not errz <= 2e-10:
        raise RuntimeError(f"c2c round trip: max abs error {errz:.3e}")
    comm = pfft.subcomm.comm
    return {'rank': comm.Get_rank(), 'ranks': comm.Get_size(),
            'grid': sizes, 'n': n, 'device': str(pfft.device),
            'backend': comm.backend, 'executor': pfft.executor,
            'pfft_executor': fft.executor, 'step_block': list(out.shape),
            'step_s': t1 - t0, 'pfft_round_trip_err': err,
            'c2c_round_trip_err': errz}


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# the launcher: one fresh process a rank
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _check_launch(nranks, device, backend):
    if backend == 'nccl' or (backend is None and device == 'cuda'):
        cards = torch.cuda.device_count()
        if nranks > cards:
            raise ValueError(
                f"launch: {nranks} NCCL ranks and {cards} card(s): NCCL "
                f"puts one rank on a card (it refuses two on one GPU); "
                f"name backend='gloo' to run them on one card")
        if device != 'cuda':
            raise ValueError("launch: NCCL takes CUDA tensors; CPU ranks "
                             "run on gloo")
    if device == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("launch: device 'cuda' and no CUDA device; "
                           "pass device='cpu' for CPU ranks on gloo")


def launch(nranks, target, kwargs=None, device='cuda', backend=None,
           timeout=900, path=()):
    """Run ``target`` ('module:function', called as ``function(comm,
    **kwargs)`` with the world communicator) on ``nranks`` fresh
    processes, one rank each, joined over ``tcp://localhost``; return the
    JSON objects they return, by rank.  ``path``: directories the
    processes import from, besides this checkout.  Raises if a rank
    fails or the time runs out; every process started is stopped."""
    _check_launch(int(nranks), device, backend)
    port = _free_port()
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        [_ROOT, *path] + ([env['PYTHONPATH']] if env.get('PYTHONPATH')
                          else []))
    env['LOCAL_WORLD_SIZE'] = str(nranks)
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for r in range(nranks):
                out = open(os.path.join(tmp, f'{r}.out'), 'w+')
                env['LOCAL_RANK'] = str(r)
                cmd = [sys.executable, '-m', 'mpi4py_fft_torch.dryrun',
                       '--child', target, '--rank', str(r),
                       '--world', str(nranks), '--port', str(port),
                       '--device', device,
                       '--kwargs', json.dumps(kwargs or {})]
                if backend:
                    cmd += ['--backend', backend]
                procs.append((subprocess.Popen(cmd, stdout=out,
                                               stderr=subprocess.STDOUT,
                                               env=dict(env), cwd=_ROOT),
                              out))
            deadline = time.monotonic() + timeout
            for p, _ in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p, _ in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            logs = []
            for p, out in procs:
                out.seek(0)
                logs.append(out.read())
                out.close()
    results, failed = [], []
    for r, ((p, _), log) in enumerate(zip(procs, logs)):
        lines = [ln for ln in log.splitlines() if ln.startswith('RESULT ')]
        if p.returncode != 0 or not lines:
            failed.append(f"rank {r} (exit {p.returncode}):\n{log[-4000:]}")
        else:
            results.append(json.loads(lines[-1][len('RESULT '):]))
    if failed:
        raise RuntimeError("launch: " + "\n".join(failed))
    return results


def _child(args):
    from .parallel import multihost
    from .parallel.comm import COMM_WORLD
    if args.device == 'cpu':
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.world))
    multihost.initialize(f'tcp://localhost:{args.port}',
                         world_size=args.world, rank=args.rank,
                         backend=args.backend, device=args.device,
                         timeout=600)
    try:
        mod, name = args.child.split(':')
        fn = getattr(importlib.import_module(mod), name)
        res = fn(COMM_WORLD, **json.loads(args.kwargs))
        print('RESULT ' + json.dumps(res), flush=True)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)           # the other ranks may wait in a collective
    finally:
        multihost.finalize()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--ranks', type=int, default=2)
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    ap.add_argument('--backend', choices=('nccl', 'gloo'), default=None)
    ap.add_argument('--n', type=int, default=None,
                    help="the DNS grid and the PFFT's extents (default: "
                         "the JAX dry run's, max(8, 2 * the largest grid "
                         "axis))")
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--timeout', type=float, default=900)
    ap.add_argument('--child', help=argparse.SUPPRESS)
    ap.add_argument('--rank', type=int, help=argparse.SUPPRESS)
    ap.add_argument('--world', type=int, help=argparse.SUPPRESS)
    ap.add_argument('--port', type=int, help=argparse.SUPPRESS)
    ap.add_argument('--kwargs', default='{}', help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        _child(args)
        return 0
    try:
        _check_launch(args.ranks, args.device, args.backend)
    except (ValueError, RuntimeError) as e:
        print(f"dryrun: {e}", file=sys.stderr)
        return 2
    results = launch(args.ranks, 'mpi4py_fft_torch.dryrun:dryrun_multichip',
                     {'n': args.n, 'seed': args.seed}, device=args.device,
                     backend=args.backend, timeout=args.timeout)
    for res in results:
        print(json.dumps(res), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
