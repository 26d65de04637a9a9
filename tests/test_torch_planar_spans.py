"""``PlanarPFFT``'s unit spans and ``fft_axis_p``'s route record
(``utils/profiling.py`` ``routes``), and the benchmark's readers of them,
on the CPU: one ``pfft.forward`` or ``pfft.backward`` a call, routes that
split the kernel's row of the session without changing it, and a traced
run of the c2c cell at 16^3 that reports its per-layer metrics.

On the CPU each plain version runs in its kernel's span and names the
route the kernel would take."""
import pytest
import torch

from fftbench import catalog, run
from mpi4py_fft_torch import PFFT, PlanarPFFT
from mpi4py_fft_torch.ops import butterfly as bf
from mpi4py_fft_torch.utils import profiling
from mpi4py_fft_torch.utils.profiling import annotate, routes, session

TINY = {'N': [16, 16, 16]}
C2C = 'c2c_1024_D.planar_roundtrip'
ROUTED = ('last_axis_hbm_pct.c2c', 'inner_axes_hbm_pct.c2c')


def _profiled(fn):
    """``fn()`` under a profiler after a span found none, so that its
    spans make a new session; returns the session's table."""
    with annotate('off'):
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        fn()
    return session()


def _field(*shape, dtype=torch.float64):
    g = torch.Generator().manual_seed(7)
    return torch.randn(shape, generator=g, dtype=dtype)


@pytest.mark.parametrize('dtype', ['D', 'd', 'F'])
def test_each_call_is_one_unit_span(dtype):
    """A forward and a backward of PlanarPFFT on one rank: one
    ``pfft.forward`` and one ``pfft.backward``, around the stage spans
    and the kernels' launches (three a c2c transform)."""
    plan = PlanarPFFT(None, (16, 8, 16), dtype=dtype, device='cpu')
    t = torch.float32 if dtype == 'F' else torch.float64
    x = _field(*plan.local_shape(False), dtype=t)

    def work():
        plan.backward(plan.forward(x))
    tab = _profiled(work)
    assert tab['pfft.forward']['calls'] == tab['pfft.backward']['calls'] == 1
    assert {'planar_stage1', 'planar_bstage0', 'planar_bstage_last'} \
        <= set(tab)
    stages = sum(r['device_s'] for n, r in tab.items()
                 if n.startswith('planar_'))
    units = tab['pfft.forward']['device_s'] + tab['pfft.backward']['device_s']
    assert stages <= units
    if dtype != 'd':
        assert sum(r['launches'] for r in tab.values()) == 6


def test_pfft_units_are_unchanged():
    """PFFT's transforms never reach PlanarPFFT: one unit span a call,
    as before."""
    plan = PFFT(None, (8, 8, 8), dtype='d', device='cpu')
    u = _field(8, 8, 8)

    def work():
        plan.backward.fn(plan.forward.fn(u))
    tab = _profiled(work)
    assert tab['pfft.forward']['calls'] == tab['pfft.backward']['calls'] == 1
    assert sum(r['launches'] for r in tab.values()) == 6


@pytest.mark.parametrize('shape,axis,route', [
    ((4, 6, 16), 2, 'lines'), ((4, 6, 1024), 2, 'lines'),
    ((4, 16, 3), 1, 'tile'), ((512, 2), 0, 'band'),
    ((3, 768, 5), 1, 'band'), ((1024, 4, 4), 0, 'band'),
    ((6, 512, 1), 1, 'lines'), ((2, 640, 4), 1, 'tile')])
def test_axis_route_by_shape(shape, axis, route):
    assert bf.axis_route(shape, axis) == route


def test_the_routes_split_the_kernel_row():
    """Lines on the last axis, the band or the tile on inner axes; the
    routes add up to the kernel's row of the session, which keeps its
    calls, bytes and launches."""
    p = _field(2, 4, 16, 6)
    band = _field(2, 512, 4)

    def work():
        bf.fft_axis_p(p, 2)
        bf.fft_axis_p(p, 1)
        bf.fft_axis_p(bf.fft_axis_p(p, 1), 1, forward=False)
        bf.fft_axis_p(band, 0)
    tab = _profiled(work)
    row = tab['kernel.fft_axis_p_f64']
    assert set(tab) == {'kernel.fft_axis_p_f64'}
    split = routes()['kernel.fft_axis_p_f64']
    assert set(split) == {'lines', 'tile', 'band'}
    assert split['lines']['calls'] == 1 and split['tile']['calls'] == 3
    assert split['band']['calls'] == 1
    assert row['calls'] == row['launches'] == 5
    for k in ('calls', 'bytes', 'launches'):
        assert sum(r[k] for r in split.values()) == row[k]
    assert sum(r['device_s'] for r in split.values()) == pytest.approx(
        row['device_s'], rel=1e-12)
    assert split['band']['bytes'] == 2 * band.numel() * 8


def test_a_plain_planar_plan_names_its_routes():
    plan = PlanarPFFT(None, (16, 16, 16), dtype='D', device='cpu')
    x = _field(2, 16, 16, 16)
    _profiled(lambda: plan.backward(plan.forward(x)))
    split = routes()['kernel.fft_axis_p_f64']
    assert split['lines']['calls'] == 2 and split['tile']['calls'] == 4


def test_a_traced_c2c_cell_reports_its_metrics(tmp_path):
    """At 16^3 on the CPU a traced run of the c2c cell reports the
    launches exactly and both HBM shares; its trace holds the unit
    spans."""
    path = tmp_path / 'trace.json'
    line = run.run_cell(C2C, 2 ** 31 + 91, 0.05, True, 'cpu',
                        cfg_over=TINY, export=path)
    assert line['correct']
    m = line['metrics']
    assert m['port_launches.c2c']['value'] == 3
    for name in ROUTED:
        assert 0 < m[name]['value'] <= 100
    text = path.read_text()
    for span in ('pfft.forward', 'pfft.backward', 'planar_stage0',
                 'kernel.fft_axis_p_f64'):
        assert f'"{span}"' in text, span


@pytest.mark.parametrize('metric', ROUTED + ('port_launches.c2c',))
def test_a_reader_returns_none_when_the_units_disagree(metric):
    cfg = dict(catalog.config('c2c_1024_D'), **TINY)
    tr = catalog.traffic('planar_roundtrip')
    params = catalog.workload(C2C)['params']
    side = tr.Side(cfg, params, torch.device('cpu'),
                   tr.inputs(cfg, params, 3, torch.device('cpu')))
    _profiled(side.unit)
    reader = catalog.reader(metric)
    assert reader.read({'units': 3}, {}) is None
    v = reader.read({'units': 2}, {})
    assert v is not None and v > 0


@pytest.mark.parametrize('metric', ROUTED)
def test_a_program_without_routes_reads_none(metric, monkeypatch):
    """A program that keeps no route record (one before it) gives no
    reading and raises nothing."""
    plan = PlanarPFFT(None, (16, 16, 16), dtype='D', device='cpu')
    x = _field(2, 16, 16, 16)
    _profiled(lambda: plan.backward(plan.forward(x)))
    monkeypatch.delattr(profiling, 'routes')
    assert catalog.reader(metric).read({'units': 2}, {}) is None
