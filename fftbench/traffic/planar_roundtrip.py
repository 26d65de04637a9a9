"""Traffic ``planar_roundtrip``: a c2c plan's ``forward``, a spectral
filter, then ``backward``, back to back, each round trip on the field the
last one returned (one chain).

The port's side is ``PlanarPFFT(None, N, axes=, dtype=)`` from the
configuration, on one rank, called as its users call it: a planar
complex field (2,) + N in, its planar spectrum out, normalized.  Between
the two transforms the spectrum is multiplied in place by
``exp(-nu_dt k0^2)``, k0 the integer wavenumber of axis 0 in ``fftfreq``
order: the integrating factor of a diffusive operator, as a split-step
solver applies one, one read and one write of the spectrum.  So every
round trip moves the field, and a round trip that computes nothing, only
part of the field, or leaves the filter out, ends where the reference's
replay does not.

Memory is the plan's three volumes and no more: the side drops the last
spectrum before each forward and the last field before each backward,
and set-up warms up on the chain's own first round trip (a second field
would be a fourth volume).  Each forward and each backward is one
transform.

Parameters: ``nu_dt``: the filter's coefficient (1e-3 / 512^2 makes
1024's Nyquist mode decay by exp(-0.001) a round trip);
``trace_units``: round trips in a traced run's profiler window.
"""
import math

import torch

from fftbench import catalog, roofline

UNIT = 'transform'
METRIC = 'transform_ms'
TYPES = {'D': torch.float64, 'F': torch.float32}
# the comparison's slabs along axis 0: rows a slab
SLAB = 64


def inputs(cfg, params, seed, device):
    """``x``: the chain's first field, planar (2,) + N, standard normal,
    float64, made on the device."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    return {'x': torch.randn((2,) + tuple(cfg['N']), generator=g,
                             device=device, dtype=torch.float64)}


def spectral_filter(cfg, params, dtype, device):
    """``exp(-nu_dt k0^2)`` for the N0 wavenumbers of axis 0, in
    ``fftfreq`` order (rank 1)."""
    n = int(cfg['N'][0])
    k = torch.fft.fftfreq(n, 1.0 / n, dtype=torch.float64, device=device)
    return torch.exp(-float(params['nu_dt']) * k * k).to(dtype)


class Side(object):
    """The port's plan on the benchmark's field."""

    def __init__(self, cfg, params, device, inputs):
        from mpi4py_fft_torch import PlanarPFFT
        t = TYPES[cfg['dtype']]
        self.plan = PlanarPFFT(None, tuple(cfg['N']),
                               axes=tuple(cfg['axes']), dtype=cfg['dtype'],
                               device=device)
        self.filt = spectral_filter(cfg, params, t, device).view(1, -1, 1, 1)
        self.x = inputs.pop('x').to(t)
        self.X = None

    def warm(self):
        self.unit()

    def unit(self):
        self.X = None
        X = self.plan.forward(self.x).mul_(self.filt)
        self.x = None
        self.x = self.plan.backward(X)
        self.X = X
        return 2

    def result(self):
        return {'X': self.X, 'x': self.x}

    def close(self):
        self.plan = None
        self.X = self.x = None


def control_side(cfg, params, device, inputs):
    """The port's own complex64 plan of the same transforms: the
    control."""
    return Side(dict(cfg, dtype='F'), params, device, inputs)


def rel_l2(p, z):
    """||p - z|| / ||z|| in float64 over every element, ``p`` planar (on
    any device, of any float type), ``z`` complex on the device, a slab
    of axis 0 at a time; NaN where either holds a NaN."""
    num = den = 0.0
    for i in range(0, z.shape[0], SLAB):
        zr = torch.view_as_real(z[i:i + SLAB]).to(torch.float64)
        q = p[:, i:i + SLAB].to(device=z.device, dtype=torch.float64)
        num += float((q - zr.movedim(-1, 0)).square().sum())
        den += float(zr.square().sum())
    return math.sqrt(num / den)


def judge(cfg, params, seed, result, device, limits):
    """The reference replays the chain from the seed's field, the warm-up
    round trip and as many as the window counted: the last filtered
    spectrum and the last field against the port's.  The port's results
    wait in host memory meanwhile (the replay's volumes and cuFFT's work
    space fill the card), and come back a slab at a time to be
    compared."""
    ref = catalog.reference(cfg['name'])
    got = {k: result.pop(k).cpu() for k in ('X', 'x')}
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    filt = spectral_filter(cfg, params, torch.float64, device).view(-1, 1, 1)
    x = ref.to_complex(inputs(cfg, params, seed, device)['x'])
    X = None
    for _ in range(result['units'] // 2 + 1):
        X = None
        X = ref.forward(x, cfg).mul_(filt)
        x = None
        x = ref.backward(X, cfg)
    return {'fwd_rel_l2': (rel_l2(got['X'], X), limits['fwd_rel_l2']),
            'bwd_rel_l2': (rel_l2(got['x'], x), limits['bwd_rel_l2'])}


def least_seconds(cfg):
    """Least seconds of one transform: the planar volume read once and
    written once, or 5 N log2 N operations a line of each axis at the
    peak of the configuration's precision."""
    N = [int(n) for n in cfg['N']]
    rt = cfg['dtype'].lower()
    nbytes = 2 * roofline.nbytes([2] + N, roofline.REAL_ITEMSIZE[rt])
    ops = sum(roofline.axis_ops(N, ax, real=False) for ax in range(len(N)))
    return roofline.least_seconds(nbytes, ops, rt)
