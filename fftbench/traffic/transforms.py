"""Traffic ``transforms``: the dealiased solver's transform mix of one RK
stage, with no algebra, back to back (one chain).

The port's side is the solver's padded plan, ``PFFT(None, N, padding=,
dtype=)`` with the configuration's 3/2 rule, called as the solver calls
it (``backward.fn`` and ``forward.fn`` on complex spectra and real
padded fields).  Its state is six spectra, as a stage's right-hand side
has the velocity and its curl.  A unit is one stage's mix:

* ``backward.fn`` of all six into padded fields, held at once;
* three in-place adds ``u_j += u_(j+3)``, in the place of the cross
  product, so that every backward's output reaches the state;
* ``forward.fn`` of those three, each result multiplied in place by half
  the advection of ``shift`` cells along the r2c axis
  (``exp(-2 pi i k shift / N)``);
* the three results become spectra 0-2, the old spectra 0-2, advected
  in place, spectra 3-5.

So every unit moves the state, and a unit that computes nothing, or
only part of it, ends where the reference's replay does not.  Set-up
warms up on the chain's own first unit.  A unit counts its 9 transforms.

Parameters: ``shift``: cells of the r2c axis a unit; ``trace_units``:
units in a traced run's profiler window.
"""
import math

import torch

from fftbench import catalog, compare, roofline

UNIT = 'transform'
METRIC = 'transform_ms'
CTYPES = {'d': torch.complex128, 'f': torch.complex64}
TRANSFORMS = 9


def inputs(cfg, params, seed, device):
    """``S``: the six spectra (6, N0, N1, N2 // 2 + 1) complex128, the
    normalized r2c of six standard normal fields, made on the device."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    S = []
    for _ in range(6):
        u = torch.randn(tuple(cfg['N']), generator=g, device=device,
                        dtype=torch.float64)
        S.append(torch.fft.rfftn(u, norm='forward'))
        del u
    return {'S': torch.stack(S)}


def advection(cfg, params, dtype, device):
    """``exp(-2 pi i k shift / N)`` for the N // 2 + 1 wavenumbers of the
    r2c axis (the last), shaped to broadcast over a spectrum."""
    n = int(cfg['N'][-1])
    k = torch.arange(n // 2 + 1, dtype=torch.float64, device=device)
    phase = k * (-2 * math.pi * float(params['shift']) / n)
    return torch.polar(torch.ones_like(phase), phase).to(dtype)


class Side(object):
    """The port's padded plan on the benchmark's spectra."""

    def __init__(self, cfg, params, device, inputs):
        from mpi4py_fft_torch import PFFT
        plan = PFFT(None, list(cfg['N']), padding=list(cfg['padding']),
                    dtype=cfg['dtype'], device=device)
        self._fwd, self._bck = plan.forward.fn, plan.backward.fn
        ct = CTYPES[cfg['dtype']]
        self.op = advection(cfg, params, ct, device)
        self.half_op = self.op * 0.5
        # six tensors of their own, as the state is after a unit, so
        # that no view keeps the inputs' block alive
        self.S = [s.clone() for s in inputs.pop('S').to(ct).unbind(0)]

    def warm(self):
        self.unit()

    def unit(self):
        u = [self._bck(s) for s in self.S]
        for j in range(3):
            u[j].add_(u[j + 3])
        del u[3:]
        new = [self._fwd(u[j]).mul_(self.half_op) for j in range(3)]
        del u
        self.S = new + [s.mul_(self.op) for s in self.S[:3]]
        return TRANSFORMS

    def result(self):
        return {'S': torch.stack(self.S)}

    def close(self):
        self._fwd = self._bck = None
        self.S = None


def control_side(cfg, params, device, inputs):
    """The port's own float32 plan of the same transforms: the control."""
    return Side(dict(cfg, dtype='f'), params, device, inputs)


def judge(cfg, params, seed, result, device, limits):
    """The reference (``reference/tg_dns_512_d_pad.py``'s padded
    transforms: its pad and truncate helpers around ``torch.fft``)
    replays the warm-up unit and as many as the window counted from the
    seed's spectra: the six spectra's relative L2 gap."""
    ref = catalog.reference(cfg['name'])
    solver = ref.Solver(cfg, device)
    op = advection(cfg, params, torch.complex128, device)
    S = list(inputs(cfg, params, seed, device)['S'].unbind(0))
    for _ in range(result['units'] // TRANSFORMS + 1):
        u = [solver.backward(s) for s in S]
        for j in range(3):
            u[j].add_(u[j + 3])
        del u[3:]
        new = [solver.forward(u[j]).mul_(0.5 * op) for j in range(3)]
        del u
        S = new + [s * op for s in S[:3]]
    return {'state_rel_l2': (compare.rel_l2(result['S'], torch.stack(S)),
                             limits['state_rel_l2'])}


def least_seconds(cfg):
    """Least seconds of one transform: the spectrum and the padded real
    grid each moved once, or the operations at the peak of the
    configuration's precision."""
    w = roofline.dealiased(cfg['N'], cfg['padding'], cfg['dtype'])
    return roofline.transform_least(w, cfg['dtype'])
