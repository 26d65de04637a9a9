"""Communicator: the ranks of a ``torch.distributed`` process group.

Port of ``mpi4py_fft_tpu/parallel/comm.py`` (:6-47).  The JAX package's
communicator is an ordered group of devices driven by one controller; the
port's is the reference mpi4py-fft's, one process per rank:
``Get_size`` is the size of the process group, ``Get_rank`` this
process's rank in it, and ``device`` the rank's device.  Before a group
is brought up (``multihost.initialize`` or ``init_process_group``)
``COMM_WORLD`` is one device, rank 0 of 1.  A list of several devices in
one process is refused: the port runs one device per rank.
"""
import torch
import torch.distributed as dist

from ..utils import resolve_device
from . import multihost

__all__ = ['DeviceComm', 'COMM_WORLD', 'comm_world', 'plan_device']


class DeviceComm(object):
    """A process group (the default one unless ``group`` is given), or
    one device in a process that runs no group (``devices``: a list of
    one torch device)."""

    def __init__(self, devices=None, group=None):
        if devices is not None:
            devices = tuple(torch.device(d) for d in devices)
            if len(devices) != 1:
                raise ValueError(
                    f"DeviceComm of {len(devices)} devices in one process: "
                    f"the port runs one device per rank; start one process "
                    f"a rank (multihost.initialize) and let COMM_WORLD span "
                    f"them")
        self._devices = devices
        self._group = group
        self._subgroups = {}

    @property
    def distributed(self):
        """True when this communicator is a process group."""
        return self._devices is None and dist.is_available() and \
            dist.is_initialized()

    @property
    def group(self):
        """The process group, or None on one device."""
        if not self.distributed:
            return None
        return self._group if self._group is not None else dist.group.WORLD

    @property
    def backend(self):
        return dist.get_backend(self.group) if self.distributed else None

    @property
    def device(self):
        """This rank's device: the one given, the one
        ``multihost.initialize`` chose, or None (the plan's default)."""
        if self._devices is not None:
            return self._devices[0]
        return multihost.rank_device() if self.distributed else None

    def Get_size(self):
        return dist.get_world_size(self.group) if self.distributed else 1

    def Get_rank(self):
        return dist.get_rank(self.group) if self.distributed else 0

    def subgroup(self, ranks):
        """The process group of ``ranks`` (ranks of this communicator),
        made at the first call.  ``new_group`` is collective: every rank
        of the communicator must ask for every subgroup, members or not,
        in the same order."""
        ranks = tuple(int(r) for r in ranks)
        if ranks not in self._subgroups:
            glob = [dist.get_global_rank(self.group, r) for r in ranks] \
                if self._group is not None else list(ranks)
            self._subgroups[ranks] = dist.new_group(glob)
        return self._subgroups[ranks]

    def __len__(self):
        return self.Get_size()

    def __repr__(self):
        return f"DeviceComm(rank {self.Get_rank()} of {self.Get_size()})"


#: the world communicator: the default process group once one is up,
#: else one device
COMM_WORLD = DeviceComm()


def comm_world():
    return COMM_WORLD


def plan_device(comm, device, what):
    """The device a plan on ``comm`` runs on: ``device``, else the rank's
    device, else CUDA (``utils.resolve_device``: no silent CPU).  On a
    process group the backend must take the device's tensors: NCCL takes
    CUDA tensors only, and gloo takes CUDA tensors only where the caller
    named it (``multihost.initialize(backend='gloo')``)."""
    if device is None and comm is not None:
        device = getattr(comm, 'device', None)
    req = torch.device('cuda' if device is None else device)
    backend = getattr(comm, 'backend', None)
    if backend == 'nccl' and req.type != 'cuda':
        raise ValueError(f"{what}: NCCL takes CUDA tensors, the plan's "
                         f"device is {req}")
    if backend == 'gloo' and req.type == 'cuda' and \
            not multihost.backend_named():
        raise ValueError(
            f"{what}: a CUDA plan on a gloo group that was not named: gloo "
            f"copies CUDA tensors through host memory; use NCCL, or name "
            f"it with multihost.initialize(backend='gloo', device='cuda')")
    return resolve_device(req, what)
