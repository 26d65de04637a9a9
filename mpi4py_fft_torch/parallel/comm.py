"""Device-group handle, the stand-in for an MPI communicator.

Port of ``mpi4py_fft_tpu/parallel/comm.py``: ``DeviceComm`` keeps the
communicator surface (``Get_size``/``Get_rank``) that reference-shaped
code calls.  The port runs on one device until the distributed layer
arrives (ROADMAP Queue 1 item 4, where a group becomes a
``torch.distributed`` process group): ``COMM_WORLD`` is the current CUDA
device, or the CPU where there is none, and a group of more than one
device is refused where a plan is built on it.
"""
import torch

__all__ = ['DeviceComm', 'COMM_WORLD']


class DeviceComm(object):
    """An ordered group of torch devices acting as a communicator."""

    def __init__(self, devices=None):
        self._devices = tuple(torch.device(d) for d in devices) \
            if devices is not None else None

    @property
    def devices(self):
        if self._devices is None:
            if torch.cuda.is_available():
                return (torch.device('cuda', torch.cuda.current_device()),)
            return (torch.device('cpu'),)
        return self._devices

    def Get_size(self):
        return len(self.devices)

    def Get_rank(self):
        return 0

    def __len__(self):
        return len(self.devices)

    def __repr__(self):
        return f"DeviceComm({len(self.devices)} devices)"


#: the world communicator: one device
COMM_WORLD = DeviceComm()
