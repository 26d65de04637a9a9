"""One process per rank: bring-up of the ``torch.distributed`` process group.

Port of ``mpi4py_fft_tpu/parallel/multihost.py`` (``initialize`` :28,
``finalize`` :45, ``is_multihost``/``process_count``/``process_index``
:51-60, ``sync_global_devices`` :63).  The JAX package runs one
controller over every device; the port runs as the reference mpi4py-fft
does, one process per rank, each holding its own local blocks.  Every
rank calls :func:`initialize` once before building a plan::

    from mpi4py_fft_torch.parallel import multihost
    multihost.initialize('tcp://localhost:29500', world_size=4, rank=r)
    # ... the same program on every rank; COMM_WORLD spans the group

The backend follows the device: NCCL for CUDA tensors, gloo for CPU
tensors.  Gloo on CUDA tensors (it copies through host memory) is taken
only where the caller names it: a card holds one NCCL rank, so several
ranks on one card need it.  Each rank's device is
``cuda:(LOCAL_RANK % device_count)`` unless the caller asks for the CPU.
"""
import datetime
import os

import torch
import torch.distributed as dist

__all__ = ['initialize', 'finalize', 'is_multihost', 'process_count',
           'process_index', 'sync_global_devices', 'rank_device',
           'backend_named']

# what initialize() chose: the rank's device and whether the caller named
# the backend (None until a group is brought up here)
_state = {'device': None, 'named': False}


def _rank_device(device, rank):
    if device is not None and torch.device(device).type == 'cpu':
        return torch.device('cpu')
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "multihost.initialize: no CUDA device; pass device='cpu' for "
            "CPU ranks on gloo")
    local = int(os.environ.get('LOCAL_RANK', rank))
    return torch.device('cuda', local % torch.cuda.device_count())


def initialize(init_method=None, world_size=None, rank=None, backend=None,
               device=None, timeout=None):
    """Join the process group (idempotent).  ``init_method``,
    ``world_size`` and ``rank`` default to torch's environment
    rendezvous (``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``); ``backend``
    defaults to NCCL on CUDA and gloo on the CPU.  Returns this rank's
    device."""
    if dist.is_initialized():
        return rank_device()
    world_size = int(os.environ.get('WORLD_SIZE', 1)) \
        if world_size is None else int(world_size)
    rank = int(os.environ.get('RANK', 0)) if rank is None else int(rank)
    named = backend is not None
    want = torch.device('cuda' if device is None else device)
    if backend is None:
        backend = 'nccl' if want.type == 'cuda' else 'gloo'
    if backend == 'nccl':
        if want.type != 'cuda':
            raise ValueError("NCCL takes CUDA tensors; CPU ranks run on "
                             "gloo")
        local_ranks = int(os.environ.get('LOCAL_WORLD_SIZE', world_size))
        if local_ranks > torch.cuda.device_count():
            raise ValueError(
                f"{local_ranks} NCCL ranks on a host with "
                f"{torch.cuda.device_count()} CUDA device(s): NCCL puts one "
                f"rank on a card; name backend='gloo' for several ranks on "
                f"one card")
    dev = _rank_device(device, rank)
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    kw = {} if timeout is None else {
        'timeout': datetime.timedelta(seconds=float(timeout))}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)
    _state['device'], _state['named'] = dev, named
    return dev


def finalize():
    """Leave the process group."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _state['device'], _state['named'] = None, False


def rank_device():
    """This rank's device as :func:`initialize` chose it, or None when no
    group was brought up here."""
    return _state['device'] if dist.is_initialized() else None


def backend_named():
    """True when the caller named the backend at :func:`initialize`."""
    return dist.is_initialized() and _state['named']


def is_multihost():
    return process_count() > 1


def process_count():
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index():
    return dist.get_rank() if dist.is_initialized() else 0


def sync_global_devices(name='sync'):
    """Barrier across all ranks (role of a global MPI barrier); ``name``
    is kept for parity."""
    if dist.is_initialized():
        dist.barrier()
