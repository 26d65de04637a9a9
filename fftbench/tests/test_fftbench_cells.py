"""The traffic kinds and the references at a tiny size on the CPU, through
their own functions (the measurement path needs a card)."""
import math

import numpy as np
import pytest
import scipy.fft
import torch

from fftbench import catalog, compare, run

CPU = torch.device('cpu')
TINY = {'N': [16, 16, 16]}


def _cell(name):
    cell = catalog.workload(name)
    cfg = dict(catalog.config(cell['config']), **TINY)
    return cell, cfg, catalog.traffic(cell['traffic'])


def _drive(tr, cell, cfg, seed, calls, make=None):
    made = tr.inputs(cfg, cell['params'], seed, CPU)
    side = (make or tr.Side)(cfg, cell['params'], CPU, made)
    side.warm()
    units = sum(side.unit() for _ in range(calls))
    result = dict(side.result(), units=units)
    side.close()
    return tr.judge(cfg, cell['params'], seed, result, CPU, cell['limits'])


@pytest.mark.parametrize('name', ['tg_dns_512_d_pad.rk4',
                                  'r2r_dct3_512_d.roundtrip'])
def test_inputs_repeat_for_a_seed_and_differ_across_seeds(name):
    cell, cfg, tr = _cell(name)
    big = 2 ** 31 + 977
    a = tr.inputs(cfg, cell['params'], big, CPU)
    b = tr.inputs(cfg, cell['params'], big, CPU)
    c = tr.inputs(cfg, cell['params'], big + 1, CPU)
    for k in a:
        assert torch.equal(a[k], b[k])
        assert not torch.equal(a[k], c[k])


@pytest.mark.parametrize('name,calls', [('tg_dns_512_d_pad.rk4', 3),
                                        ('r2r_dct3_512_d.roundtrip', 20)])
def test_port_matches_the_reference(name, calls):
    cell, cfg, tr = _cell(name)
    for k, (v, lim) in _drive(tr, cell, cfg, 11, calls).items():
        assert v < 1e-13 < lim, (k, v)


@pytest.mark.parametrize('shift', [1, 3, -2])
def test_advection_by_whole_cells_is_a_roll(shift):
    """The round trip's operator moves the field along the periodic
    axis: by whole cells, the port's round trip is a roll."""
    cell, cfg, tr = _cell('r2r_dct3_512_d.roundtrip')
    params = dict(cell['params'], shift=shift)
    made = tr.inputs(cfg, params, 8, CPU)
    x = made['x'].clone()
    side = tr.Side(cfg, params, CPU, made)
    assert side.unit() == 2
    assert torch.allclose(side.x, torch.roll(x, shift, dims=0),
                          rtol=0, atol=1e-12)


def test_perturbation_is_divergence_free_and_sized():
    cell, cfg, tr = _cell('tg_dns_512_d_pad.rk4')
    # wavenumbers under the tiny grid's Nyquist (the cell's kmax = 16
    # is under 512's)
    params = dict(cell['params'], kmax=4)
    u = tr.inputs(cfg, params, 5, CPU)['u']
    tg = tr.inputs(cfg, dict(params, amplitude=0.0), 5, CPU)['u']
    L = [p * math.pi for p in cfg['L_over_pi']]
    U = torch.fft.fftn(u, dim=(1, 2, 3))
    k = [torch.fft.fftfreq(n, 1.0 / n, dtype=torch.float64) * 2 * math.pi / li
         for n, li in zip(cfg['N'], L)]
    div = (k[0][:, None, None] * U[0] + k[1][None, :, None] * U[1]
           + k[2][None, None, :] * U[2])
    assert float(div.abs().max()) < 1e-9 * float(U.abs().max())
    rms = float((u - tg).pow(2).sum(0).mean().sqrt())
    assert 0.5 * cell['params']['amplitude'] < rms \
        < 1.5 * cell['params']['amplitude']


def test_r2r_reference_is_scipy_dctn_then_rfft():
    cfg = dict(catalog.config('r2r_dct3_512_d'), N=[12, 10, 8])
    ref = catalog.reference('r2r_dct3_512_d')
    x = torch.randn(12, 10, 8, dtype=torch.float64)
    want = scipy.fft.rfft(scipy.fft.dctn(x.numpy(), type=3, axes=(1, 2)),
                          axis=0) / (12 * 20 * 16)
    X = ref.forward(x, cfg)
    assert np.abs(X.numpy() - want).max() < 1e-15 * 20
    y = ref.backward(X, cfg)
    assert float((y - x).abs().max()) < 1e-13


def test_dns_reference_dealiasing_is_the_3_2_rule():
    """The padded backward of a spectrum equals the unpadded one's
    Fourier series evaluated on the 3/2 grid, where no Nyquist mode is
    set; the padded forward of that field gives the spectrum back."""
    cfg = dict(catalog.config('tg_dns_512_d_pad'), **TINY)
    ref = catalog.reference('tg_dns_512_d_pad')
    s = ref.Solver(cfg, CPU)
    g = torch.Generator().manual_seed(3)
    u = torch.randn(16, 16, 16, generator=g, dtype=torch.float64)
    U = torch.fft.rfftn(u, norm='forward')
    U[8], U[:, 8], U[:, :, 8] = 0, 0, 0
    v = s.backward(U)
    assert v.shape == (24, 24, 24)
    P = torch.zeros(24, 24, 24, dtype=torch.complex128)
    full = torch.fft.fftn(torch.fft.irfftn(U, s=(16,) * 3, norm='forward'),
                          norm='forward')
    for i in range(16):
        for j in range(16):
            P[(i - 16) % 24 if i > 8 else i, (j - 16) % 24 if j > 8 else j,
              :8] = full[i, j, :8]
            P[(i - 16) % 24 if i > 8 else i, (j - 16) % 24 if j > 8 else j,
              -7:] = full[i, j, -7:]
    want = torch.fft.ifftn(P, norm='forward').real
    assert float((v - want).abs().max()) < 1e-12
    assert compare.rel_l2(s.forward(v), U) < 1e-14


def test_run_cell_on_the_cpu_reports_its_checks_last():
    line = run.run_cell('r2r_dct3_512_d.roundtrip', 4, 0.05, False, 'cpu',
                        cfg_over=TINY)
    assert line['correct'] and line['failed'] == 0 and line['attempted'] > 0
    assert list(line)[-1] == 'checks'
    assert set(line['checks']) == {'fwd_rel_l2', 'bwd_rel_l2', 'bound_share'}
    assert line['device']['platform'] == 'cpu'


def test_a_traced_run_exports_its_chrome_trace(tmp_path):
    path = tmp_path / 'traces' / 'roundtrip.json'
    line = run.run_cell('r2r_dct3_512_d.roundtrip', 4, 0.05, True, 'cpu',
                        cfg_over=TINY, export=path)
    assert line['correct'] and path.is_file()
    assert 'fftbench.window' in path.read_text()
