"""Traffic ``rk4``: the solver's RK4 step applied back to back, one chain.

The port's side is ``make_solver`` of
``mpi4py_fft_torch.examples.spectral_dns_solver`` with the configuration's
grid, box, viscosity, time step and padding.  Its initial state is not
the solver's own: the benchmark makes a Taylor-Green field plus a seeded,
divergence-free perturbation in physical space, and set-up turns it into
the spectral state with the plan's own ``forward.fn``, then runs the warm
steps.  The window applies ``step`` to the state it returned last.

Parameters (the cell's ``params``): ``warm_steps``; ``modes``, ``kmax``,
``amplitude`` of the perturbation (``modes`` Fourier modes with integer
wavenumbers in [-kmax, kmax] on each axis, each (a x k) sin(k.x + phi),
which is divergence-free, scaled to a total rms of ``amplitude``);
``trace_units``: steps in a traced run's profiler window.
"""
import math

import torch

from fftbench import catalog, compare, roofline

UNIT = 'step'
METRIC = 'step_ms'


def box(cfg):
    """The box lengths of the configuration."""
    return [p * math.pi for p in cfg['L_over_pi']]


def initial_field(cfg, params, seed, device):
    """(3,) + N float64 velocity in physical space: Taylor-Green plus the
    seeded perturbation."""
    N = cfg['N']
    L = box(cfg)
    g = torch.Generator(device=device).manual_seed(int(seed))
    m, kmax = int(params['modes']), int(params['kmax'])
    f64 = torch.float64
    k = torch.randint(-kmax, kmax + 1, (m, 3), generator=g, device=device)
    a = torch.randn((m, 3), generator=g, device=device, dtype=f64)
    phi = torch.rand((m,), generator=g, device=device, dtype=f64) \
        * (2 * math.pi)
    x = [torch.arange(n, dtype=f64, device=device) * (L[i] / n)
         for i, n in enumerate(N)]
    sh = [(-1, 1, 1), (1, -1, 1), (1, 1, -1)]
    s = [torch.sin(xi).view(sh[i]) for i, xi in enumerate(x)]
    c = [torch.cos(xi).view(sh[i]) for i, xi in enumerate(x)]
    u = torch.zeros((3,) + tuple(N), dtype=f64, device=device)
    u[0] = s[0] * c[1] * c[2]
    u[1] = -c[0] * s[1] * c[2]
    kt = k.to(f64) * torch.tensor([2 * math.pi / li for li in L],
                                  dtype=f64, device=device)
    d = torch.linalg.cross(a, kt)
    norm = torch.linalg.vector_norm(d, dim=1).clamp_min(1e-30)
    # each mode's rms is |d| / sqrt(2); the modes together reach
    # ``amplitude`` (modes with k = 0 give d = 0 and drop out)
    d = d / norm[:, None] * (params['amplitude'] * math.sqrt(2.0 / m))
    for kj, dj, pj in zip(kt.tolist(), d.tolist(), phi.tolist()):
        arg = (x[0] * kj[0]).view(sh[0]) + (x[1] * kj[1]).view(sh[1]) \
            + (x[2] * kj[2] + pj).view(sh[2])
        torch.sin(arg, out=arg)
        for i in range(3):
            u[i].add_(arg, alpha=dj[i])
        del arg
    return u


def inputs(cfg, params, seed, device):
    return {'u': initial_field(cfg, params, seed, device)}


def _padding(cfg):
    if list(cfg['padding']) != [1.5, 1.5, 1.5]:
        raise ValueError("the solver dealiases with padding=[1.5]*3 only")
    return True


class Side(object):
    """The port's solver on the benchmark's initial field."""

    def __init__(self, cfg, params, device, inputs):
        from mpi4py_fft_torch.examples import spectral_dns_solver as dns
        if cfg['dtype'] != 'd':
            raise ValueError("the solver runs float64 only")
        fft, U_tg, step, _ = dns.make_solver(
            N=tuple(cfg['N']), L=tuple(box(cfg)), nu=cfg['nu'],
            dt=cfg['dt'], padding=_padding(cfg), device=device)
        del U_tg
        u = inputs.pop('u')
        self.U = torch.stack([fft.forward.fn(u[i]) for i in range(3)])
        del u
        self._step = step
        self._warm = int(params['warm_steps'])

    def warm(self):
        for _ in range(self._warm):
            self.unit()

    def unit(self):
        self.U = self._step(self.U)
        return 1

    def result(self):
        return {'U_hat': self.U}

    def close(self):
        self._step = None
        self.U = None


class ReferenceSide(Side):
    """The plain reference in the port's place, at a precision of its
    own: the control."""

    def __init__(self, cfg, params, device, inputs, dtype):
        ref = catalog.reference(cfg['name'])
        self._solver = ref.Solver(cfg, device, dtype)
        u = inputs.pop('u')
        self.U = self._solver.initial(u)
        del u
        self._step = self._solver.step
        self._warm = int(params['warm_steps'])


def control_side(cfg, params, device, inputs):
    """The solver runs float64 only: the control is the reference in
    float32 (complex64) in its place."""
    return ReferenceSide(cfg, params, device, inputs, 'f')


def judge(cfg, params, seed, result, device, limits):
    """The reference from the same initial field, as many steps as the
    state took (the warm steps and those the window counted), and the
    state's relative L2 gap."""
    ref = catalog.reference(cfg['name'])
    u = inputs(cfg, params, seed, device)['u']
    U = ref.run(cfg, u, int(params['warm_steps']) + result['units'], device)
    del u
    gap = compare.rel_l2(result['U_hat'], U)
    return {'state_rel_l2': (gap, limits['state_rel_l2'])}


def least_seconds(cfg):
    """Least seconds of one step: its 36 transforms (4 stages of 6
    backward and 3 forward), each moving the spectrum and the padded
    real grid once; the algebra is not counted."""
    w = roofline.dealiased(cfg['N'], cfg['padding'], cfg['dtype'])
    t, bound = roofline.transform_least(w, cfg['dtype'])
    return 36 * t, bound
