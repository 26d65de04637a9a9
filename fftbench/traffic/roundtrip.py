"""Traffic ``roundtrip``: a plan's ``forward.fn``, a spectral operator, then
``backward.fn``, back to back, each round trip on the field the last one
returned (one chain).

The port's side is ``PFFT(None, N, axes=, transforms=, padding=,
dtype=)`` from the configuration, on one rank, called as users call it:
real tensors in, complex spectra out.  Between the two transforms the
spectrum is advected along the plan's periodic (r2c) axis by ``shift``
cells of that axis, ``exp(-2 pi i k shift / N)`` on wavenumber k, as a
Fourier solver applies an operator between its transforms.  So every
round trip moves the field, and a round trip that computes nothing, or
only part of the field, leaves a state that the reference, replaying as
many round trips, does not reach.  Set-up warms both directions on a
second seeded field; the window starts the chain from the first.  Each
forward and each backward is one transform.

Parameters: ``shift``: cells of the periodic axis a round trip;
``trace_units``: round trips in a traced run's profiler window.
"""
import functools
import math

import torch

from fftbench import catalog, compare, roofline

UNIT = 'transform'
METRIC = 'transform_ms'
TYPES = {'d': torch.float64, 'f': torch.float32}
CTYPES = {'d': torch.complex128, 'f': torch.complex64}


def inputs(cfg, params, seed, device):
    """``x``: the chain's first field; ``w``: the warm-up's field; both
    standard normal, float64."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    shape = tuple(cfg['N'])
    x = torch.randn(shape, generator=g, device=device, dtype=torch.float64)
    w = torch.randn(shape, generator=g, device=device, dtype=torch.float64)
    return {'x': x, 'w': w}


def forward_axes(cfg):
    """The axes in the order the forward applies them (groups last
    first, a group's axes last first), and each axis's kind: ``'r2r'``,
    ``'r2c'`` (the first other axis) or ``'c2c'``."""
    r2r = {tuple(t['axes']) for t in cfg.get('transforms') or []}
    order, kinds, real = [], [], True
    for group in reversed(cfg['axes']):
        order += list(group)[::-1]
        if tuple(group) in r2r:
            kinds += ['r2r'] * len(group)
        elif real:
            kinds += ['r2c'] + ['c2c'] * (len(group) - 1)
            real = False
        else:
            kinds += ['c2c'] * len(group)
    return order, kinds


def shift_operator(cfg, params, dtype, device):
    """The advection of the spectrum by ``shift`` cells along the r2c
    axis: ``exp(-2 pi i k shift / N)`` for k = 0 .. N // 2, shaped to
    broadcast over the spectrum."""
    order, kinds = forward_axes(cfg)
    axis = order[kinds.index('r2c')]
    n = int(cfg['N'][axis])
    k = torch.arange(n // 2 + 1, dtype=torch.float64, device=device)
    phase = k * (-2 * math.pi * float(params['shift']) / n)
    op = torch.polar(torch.ones_like(phase), phase).to(dtype)
    shape = [1] * len(cfg['N'])
    shape[axis] = n // 2 + 1
    return op.view(shape)


def _transforms(cfg):
    """``transforms=`` of the configuration: axes -> (forward planner,
    backward planner) of ``mpi4py_fft_torch.fftw``."""
    from mpi4py_fft_torch import fftw
    out = {}
    for t in cfg.get('transforms') or []:
        fwd = functools.partial(getattr(fftw, t['forward']), type=t['type'])
        bck = functools.partial(getattr(fftw, t['backward']), type=t['type'])
        out[tuple(t['axes'])] = (fwd, bck)
    return out


class Side(object):
    """The port's plan on the benchmark's fields."""

    def __init__(self, cfg, params, device, inputs):
        from mpi4py_fft_torch import PFFT
        kw = {}
        if cfg.get('padding'):
            kw['padding'] = list(cfg['padding'])
        self.plan = PFFT(None, tuple(cfg['N']),
                         axes=tuple(tuple(a) for a in cfg['axes']),
                         transforms=_transforms(cfg), dtype=cfg['dtype'],
                         device=device, **kw)
        t = TYPES[cfg['dtype']]
        self.op = shift_operator(cfg, params, CTYPES[cfg['dtype']], device)
        self._w = inputs.pop('w').to(t)
        self.x = inputs.pop('x').to(t)
        self.X = None

    def warm(self):
        self.X = self.plan.forward.fn(self._w).mul_(self.op)
        self.plan.backward.fn(self.X)
        self._w = None

    def unit(self):
        self.X = self.plan.forward.fn(self.x).mul_(self.op)
        self.x = self.plan.backward.fn(self.X)
        return 2

    def result(self):
        return {'X': self.X, 'x': self.x}

    def close(self):
        self.plan = None
        self.X = self.x = None


def control_side(cfg, params, device, inputs):
    """The port's own float32 plan of the same transforms: the control."""
    return Side(dict(cfg, dtype='f'), params, device, inputs)


def judge(cfg, params, seed, result, device, limits):
    """The reference replays the chain from its first field, as many
    round trips as the window counted: the last advected spectrum and
    the last field against the port's."""
    ref = catalog.reference(cfg['name'])
    op = shift_operator(cfg, params, torch.complex128, device)
    x = inputs(cfg, params, seed, device)['x']
    for _ in range(result['units'] // 2):
        X = ref.forward(x, cfg).mul_(op)
        x = ref.backward(X, cfg)
    return {'fwd_rel_l2': (compare.rel_l2(result['X'], X),
                           limits['fwd_rel_l2']),
            'bwd_rel_l2': (compare.rel_l2(result['x'], x),
                           limits['bwd_rel_l2'])}


def least_seconds(cfg):
    """Least seconds of one transform: the real field and the spectrum
    each moved once, or the operations at the float64 peak."""
    order, kinds = forward_axes(cfg)
    work = roofline.real_transform(cfg['N'], order, kinds, cfg['dtype'])
    return roofline.transform_least(work, cfg['dtype'])
