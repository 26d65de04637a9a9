"""The reader of ``real_inner_hbm_pct.xfer``: the float64 real kernels'
launches whose spans name an inner route (band or tile), on the CPU,
where the plain versions run in the kernels' place and name the route
they stand for."""
import pytest
import torch

from fftbench import catalog, roofline, run
from fftbench.metrics import real_inner_hbm_pct as metric
from mpi4py_fft_torch.ops import butterfly as bf
from mpi4py_fft_torch.utils.profiling import annotate, routes

TINY = {'N': [16, 16, 16]}


def _session(fns, units=1):
    """A profiled session of ``units`` pfft.forward spans, each calling
    every function of ``fns``."""
    with annotate('off'):
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(units):
            with annotate('pfft.forward'):
                for fn in fns:
                    fn()


def test_reads_the_inner_routes_of_the_four_spans():
    """Band and tile launches of the r2c, c2r, DCT-II and DCT-III count;
    the last axis (lines) and float32 launches do not."""
    x = torch.randn(512, 4, dtype=torch.float64)
    t = torch.randn(4, 256, 4, dtype=torch.float64)
    h = bf.rfft_axis_p(x, 0)
    _session([lambda: bf.rfft_axis_p(x, 0),
              lambda: bf.irfft_axis_p(h, 0, 512),
              lambda: bf.dct2_axis_p(t, 1), lambda: bf.dct3_axis_p(x, 0),
              lambda: bf.rfft_axis_p(t, 2),
              lambda: bf.dct2_axis_p(x.float(), 0)])
    table = routes()
    assert set(table['kernel.rfft_axis_p_f64']) == {'band', 'lines'}
    assert set(table['kernel.irfft_axis_p_f64']) == {'band'}
    assert set(table['kernel.dct2_axis_p_f64']) == {'tile'}
    rows = [r for name in metric.SPANS
            for route, r in table[name].items() if route != 'lines']
    assert len(rows) == 4
    want = 100.0 * sum(r['bytes'] for r in rows) \
        / sum(r['device_s'] for r in rows) / roofline.HBM_BYTES_PER_S
    got = metric.read({'units': 1}, {})
    assert got == pytest.approx(want, rel=1e-12) and got > 0


def test_none_where_nothing_is_read():
    """None where the session's units are not the window's, and where no
    launch of the four spans took an inner route."""
    x = torch.randn(512, 4, dtype=torch.float64)
    _session([lambda: bf.rfft_axis_p(x, 0)], units=2)
    assert metric.read({'units': 2}, {}) is not None
    assert metric.read({'units': 3}, {}) is None
    _session([lambda: bf.rfft_axis_p(x.T.contiguous(), 1),
              lambda: bf.fft_axis_p(torch.randn(2, 512, 4), 0)])
    assert metric.read({'units': 1}, {}) is None


def test_a_traced_roundtrip_reports_it():
    """The roundtrip cell lists the metric; a traced run on the CPU reads
    it from its inner-axis launches (axis 0's r2c and c2r, axis 1's
    DCTs, on the tile at 16 points)."""
    name = 'r2r_dct3_512_d.roundtrip'
    _, per_layer = catalog.metrics_of(catalog.benchmark(), name)
    assert 'real_inner_hbm_pct.xfer' in {m['name'] for m in per_layer}
    line = run.run_cell(name, 2 ** 31 + 11, 0.05, True, 'cpu',
                        cfg_over=TINY)
    assert line['correct']
    assert line['metrics']['real_inner_hbm_pct.xfer']['value'] > 0
