"""The c2c configuration ``c2c_1024_D`` and its cell
``c2c_1024_D.planar_roundtrip`` at tiny sizes on the CPU: ``PlanarPFFT``
against the plain reference, the cell's comparison on the port, the
control and broken timed paths, and the side's memory discipline."""
import math

import pytest
import torch

from fftbench import catalog, run

CPU = torch.device('cpu')
NAME = 'c2c_1024_D.planar_roundtrip'
TINY = {'N': [16, 16, 16]}
CELL = catalog.workload(NAME)
TR = catalog.traffic(CELL['traffic'])
REF = catalog.reference('c2c_1024_D')


def _field(shape, seed, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((2,) + tuple(shape), generator=g, dtype=dtype)


@pytest.mark.parametrize('shape', [(16, 16, 16), (12, 10, 16)])
@pytest.mark.parametrize('dtype,tol', [('D', 1e-14), ('F', 2e-6)])
def test_planar_pfft_matches_the_reference(shape, dtype, tol):
    """Forward (normalized) and backward (unscaled) of the port's plan
    against ``torch.fft.fftn``/``ifftn`` on a seeded field; (12, 10, 16)
    takes the engine's routes on axes 0 and 1."""
    from mpi4py_fft_torch import PlanarPFFT
    t = torch.float64 if dtype == 'D' else torch.float32
    plan = PlanarPFFT(None, shape, dtype=dtype, device='cpu')
    x = _field(shape, 5)
    X = plan.forward(x.to(t))
    want = REF.forward(REF.to_complex(x), {})
    assert TR.rel_l2(X, want) < tol
    y = plan.backward(X)
    assert TR.rel_l2(y, REF.backward(want, {})) < tol
    assert TR.rel_l2(y, REF.to_complex(x)) < tol


def test_the_reference_is_numpy_fftn():
    import numpy as np
    x = _field((6, 8, 10), 2)
    z = REF.to_complex(x)
    want = np.fft.fftn(z.numpy()) / z.numel()
    assert np.abs(REF.forward(z, {}).numpy() - want).max() < 1e-15
    assert torch.allclose(REF.backward(REF.forward(z, {}), {}), z,
                          rtol=0, atol=1e-13)


def test_inputs_repeat_for_a_seed_and_differ_across_seeds():
    cfg = dict(catalog.config('c2c_1024_D'), **TINY)
    big = 2 ** 31 + 977
    a, b, c = (TR.inputs(cfg, CELL['params'], s, CPU)['x']
               for s in (big, big, big + 1))
    assert a.shape == (2, 16, 16, 16) and a.dtype == torch.float64
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_the_filter_decays_the_nyquist_mode_as_the_cell_says():
    cfg = catalog.config('c2c_1024_D')
    f = TR.spectral_filter(cfg, CELL['params'], torch.float64, CPU)
    assert f.shape == (1024,) and float(f[0]) == 1.0
    assert float(f[512]) == pytest.approx(math.exp(-1e-3), rel=1e-12)
    assert torch.equal(f[1:512], f[513:].flip(0))


def test_least_seconds_is_the_planar_volume_moved_once():
    t, bound = TR.least_seconds(catalog.config('c2c_1024_D'))
    assert bound == 'bytes'
    assert t == pytest.approx(2 * 2 * 1024 ** 3 * 8 / 3.35e12, rel=1e-12)
    assert t * 1e3 == pytest.approx(10.26, abs=0.01)


def test_the_side_holds_no_more_than_the_plan_needs():
    """Each forward runs with the last spectrum dropped, each backward
    with the last field dropped, and a unit counts two transforms."""
    cfg = dict(catalog.config('c2c_1024_D'), **TINY)
    side = TR.Side(cfg, CELL['params'], CPU,
                   TR.inputs(cfg, CELL['params'], 3, CPU))
    held = []
    fwd, bck = side.plan.forward, side.plan.backward

    def forward(x):
        held.append(('forward', side.X is None, side.x is x))
        return fwd(x)

    def backward(X):
        held.append(('backward', side.x is None))
        return bck(X)
    side.plan.forward, side.plan.backward = forward, backward
    side.warm()
    assert side.unit() == 2 and side.unit() == 2
    assert held == [('forward', True, True), ('backward', True)] * 3


def test_the_port_is_correct():
    line = run.run_cell(NAME, 2 ** 31 + 5, 0.2, False, 'cpu', cfg_over=TINY)
    assert line['correct'] is True, line['checks']
    assert set(line['checks']) == {'bound_share', 'fwd_rel_l2',
                                   'bwd_rel_l2'}
    assert line['attempted'] % 2 == 0 and line['attempted'] > 0
    for k in ('fwd_rel_l2', 'bwd_rel_l2'):
        assert line['checks'][k]['value'] < 1e-13


def test_the_control_is_not_correct():
    line = run.run_cell(NAME, 21, 0.2, False, 'cpu', cfg_over=TINY,
                        side_factory=TR.control_side)
    assert line['correct'] is False, line['checks']
    assert line['checks']['fwd_rel_l2']['value'] > 1e-7


def _broken(fault):
    class Broken(TR.Side):
        calls = 0

        def unit(self):
            self.calls += 1
            if self.calls == 1:
                return super().unit()
            self.X = None
            if fault == 'no_forward':
                X = self.x.clone().mul_(self.filt)
            else:
                X = self.plan.forward(self.x)
                if fault != 'no_filter':
                    X.mul_(self.filt)
            if fault == 'half':
                # half of the spectrum's rows left as the forward's input
                h = X.shape[1] // 2
                X[:, h:] = self.x[:, h:]
            self.x = None
            self.x = self.plan.backward(X)
            if fault == 'nan':
                self.x.view(-1)[3] = float('nan')
            self.X = X
            return 2
    return Broken


@pytest.mark.parametrize('fault', ['no_forward', 'no_filter', 'half', 'nan'])
def test_a_broken_timed_path_is_not_correct(fault):
    line = run.run_cell(NAME, 33, 0.2, False, 'cpu', cfg_over=TINY,
                        side_factory=_broken(fault))
    assert line['correct'] is False, line['checks']
    assert line['failed'] == line['attempted'] > 0
