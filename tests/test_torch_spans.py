"""The port's spans and counters (``utils/profiling.py`` ``annotate``,
``launched``, ``session``), the byte count each kernel wrapper passes to
its span, and the benchmark's readers of them, on the CPU: a traced run
of each cell at 16^3 reports every metric built on the spans.

On the CPU each plain version runs in its kernel's span in the kernel's
place, and the session counts it as the kernel's launch."""
import time

import pytest
import torch

from fftbench import catalog, run
from mpi4py_fft_torch import PFFT
from mpi4py_fft_torch.ops import butterfly as bf
from mpi4py_fft_torch.ops import dns_algebra as da
from mpi4py_fft_torch.ops import fft2stage
from mpi4py_fft_torch.ops import probes as tp
from mpi4py_fft_torch.utils import profiling
from mpi4py_fft_torch.utils.profiling import annotate, launched, session

TINY = {'N': [16, 16, 16]}
CPU_ONLY = [torch.profiler.ProfilerActivity.CPU]


def _profiled(fn):
    """``fn()`` under a profiler after a span found none, so that its
    spans make a new session; returns the session's table."""
    with annotate('off'):
        pass
    with torch.profiler.profile(activities=CPU_ONLY):
        fn()
    return session()


def _span(name):
    with annotate(name):
        pass


def test_annotate_off_opens_no_range_and_records_nothing(monkeypatch):
    before = _profiled(lambda: _span('kept'))
    assert set(before) == {'kept'}

    def refuse(*a, **k):
        raise AssertionError("a range or an event while tracing is off")
    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    monkeypatch.setattr(torch.cuda, 'Event', refuse)
    assert annotate('a') is annotate('b', nbytes=64)
    with annotate('a', nbytes=64):
        launched()
    x = torch.randn(2, 3, 16, dtype=torch.float64)
    bf.fft_axis_p(x, 1)
    PFFT(None, (8, 8, 8), dtype='d', device='cpu').forward.fn(
        torch.ones((8, 8, 8), dtype=torch.float64))
    assert session() == before


def test_nesting_and_self_time():
    def work():
        with annotate('outer'):
            time.sleep(0.02)
            with annotate('inner'):
                time.sleep(0.03)
            with annotate('inner'):
                pass
    t = _profiled(work)
    outer, inner = t['outer'], t['inner']
    assert outer['calls'] == 1 and inner['calls'] == 2
    assert inner['device_s'] >= 0.03 and inner['self_s'] == inner['device_s']
    assert outer['device_s'] >= 0.05
    assert outer['self_s'] == pytest.approx(
        outer['device_s'] - inner['device_s'], abs=1e-12)
    assert 0.02 <= outer['self_s'] < outer['device_s'] - 0.03


def test_nbytes_add_up_over_calls():
    def work():
        with annotate('copy', nbytes=5):
            pass
        with annotate('copy', 7):
            pass
        with annotate('none'):
            pass
    t = _profiled(work)
    assert t['copy']['bytes'] == 12 and t['copy']['calls'] == 2
    assert t['none']['bytes'] == 0


def test_launches_go_to_the_innermost_span():
    x = torch.randn(2, 4, 16, dtype=torch.float32)

    def work():
        with annotate('a'):
            launched()
            with annotate('b'):
                launched()
            launched()
            bf.fft_axis_p(x, 1)
    t = _profiled(work)
    assert t['a']['launches'] == 2 and t['b']['launches'] == 1
    k = t['kernel.fft_axis_p']
    assert k['launches'] == k['calls'] == 1
    assert t['a']['self_s'] == pytest.approx(
        t['a']['device_s'] - t['b']['device_s'] - k['device_s'], abs=1e-12)


def test_a_new_session_when_a_profiler_starts_again(tmp_path):
    assert set(_profiled(lambda: _span('first'))) == {'first'}
    assert set(_profiled(lambda: _span('second'))) == {'second'}
    # trace() starts one whether or not a span found tracing off between
    with profiling.trace(str(tmp_path)):
        with annotate('third'):
            pass
    with profiling.trace(str(tmp_path)):
        with annotate('fourth'):
            pass
    assert set(session()) == {'fourth'}


def _r(*shape, dtype=torch.float32):
    return torch.randn(shape, dtype=dtype)


def _bytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


# (span, call returning (inputs, outputs), whether every element of the
# inputs is read)
P = _r(2, 6, 16, 3)
P64 = _r(2, 6, 16, 3, dtype=torch.float64)
# the DNS algebra's tensors: a (3, 6, 4, 3) spectral state, its
# wavenumbers, three spectra and six (6, 4, 5) grids
SPEC = (6, 4, 3)
KS = [_r(*[n if d == i else 1 for d, n in enumerate(SPEC)],
         dtype=torch.float64) for i in range(3)]
U3 = torch.randn((3,) + SPEC, dtype=torch.complex128)
U0 = torch.randn((3,) + SPEC, dtype=torch.complex128)
N3 = [torch.randn(SPEC, dtype=torch.complex128) for _ in range(3)]
G6 = [_r(6, 4, 5, dtype=torch.float64) for _ in range(6)]
WRAPPERS = {
    'fft_axis_p': ('fft_axis_p', lambda: ((P,), bf.fft_axis_p(P, 1)), True),
    'fft_axis_p_f64': ('fft_axis_p_f64',
                       lambda: ((P64,), bf.fft_axis_p(P64, 1)), True),
    'rfft_axis_p': ('rfft_axis_p_f64', lambda: (
        (P64[0],), bf.rfft_axis_p(P64[0], 1)), True),
    'rfft_axis_p_trunc': ('rfft_axis_p', lambda: (
        (P[0],), bf.rfft_axis_p(P[0], 1, trunc=6, scale=0.5)), True),
    'rfft_axis_p_hext': ('rfft_axis_p', lambda: (
        (P[0],), bf.rfft_axis_p(P[0], 1, hext=12)), True),
    'irfft_axis_p': ('irfft_axis_p', lambda: (
        (_r(2, 6, 9, 3),), bf.irfft_axis_p(_r(2, 6, 9, 3), 1, 16)), True),
    'irfft_axis_p_short': ('irfft_axis_p_f64', lambda: (
        (_r(2, 6, 5, 3, dtype=torch.float64),),
        bf.irfft_axis_p(_r(2, 6, 5, 3, dtype=torch.float64), 1, 16)), True),
    'irfft_axis_p_long': ('irfft_axis_p', lambda: (
        (_r(2, 6, 12, 3),), bf.irfft_axis_p(_r(2, 6, 12, 3), 1, 16)),
        False),
    'dct2_axis_p': ('dct2_axis_p', lambda: (
        (P[0],), bf.dct2_axis_p(P[0], 1)), True),
    'dct3_axis_p': ('dct3_axis_p_f64', lambda: (
        (P64[0],), bf.dct3_axis_p(P64[0], 1)), True),
    'fft_axis2_p': ('fft_axis2_p', lambda: (
        (P[:, :3], P[:, 3:]), bf.fft_axis2_p(P[:, :3], P[:, 3:], 1)), True),
    'fft_axis_pair_p': ('fft_axis_pair_p', lambda: (
        (P,), bf.fft_axis_pair_p(P, 1)), True),
    'fft_axis_tp_trunc': ('fft_axis_tp', lambda: (
        (_r(2, 4, 24, 3),), bf.fft_axis_tp(_r(2, 4, 24, 3), 1, trunc=16)),
        True),
    'fft_axis_tp_pad': ('fft_axis_tp_f64', lambda: (
        (_r(2, 4, 16, 3, dtype=torch.float64),),
        bf.fft_axis_tp(_r(2, 4, 16, 3, dtype=torch.float64), 1, False,
                       pad=24)), True),
    'fft_plane_p': ('fft_plane_p', lambda: (
        (_r(2, 3, 16, 8),), bf.fft_plane_p(_r(2, 3, 16, 8))), True),
    'fft_plane_large_p': ('fft_plane_large_p', lambda: (
        (_r(2, 2, 8, 512),), bf.fft_plane_large_p(_r(2, 2, 8, 512))), True),
    'fft2stage_p': ('fft2stage_p', lambda: (
        (_r(2, 3, 256),), fft2stage.fft2stage_p(_r(2, 3, 256), -1)), True),
    'block_copy': ('block_copy', lambda: (
        (_r(8, 16),), tp.block_copy(_r(8, 16), (4, 8))), True),
    'block_copy_pair': ('block_copy', lambda: (
        (_r(8, 16), _r(8, 16)),
        tp.block_copy(_r(8, 16), (4, 8), x2=_r(8, 16))), True),
    'move_even': ('move', lambda: (
        (_r(4, 16),), tp.move(_r(4, 16), 1, 'even')), False),
    'move_roll': ('move', lambda: (
        (_r(4, 16),), tp.move(_r(4, 16), 0, 'roll', shift=1)), True),
    'bfly': ('bfly', lambda: ((P,), tp.bfly(P, 1, 'adds', reps=2)), True),
    'fma_chain_f64': ('fma_chain_f64', lambda: (
        (_r(64, dtype=torch.float64),),
        tp.fma_chain(_r(64, dtype=torch.float64), 4)), True),
    'dns_curl': ('dns_curl_f64', lambda: (
        (U3, *KS), da.curl(U3, KS)), True),
    'dns_cross': ('dns_cross_f64', lambda: (
        tuple(G6), tuple(da.cross(G6[:3], G6[3:]))), True),
    # the first stage: the state is U, U0 and U1, read once
    'dns_project_rk': ('dns_project_rk_f64', lambda: (
        (*N3, U3, *KS),
        da.project_rk(N3, U3, U3, U3, KS, 0.1, 0.2, 0.3)), True),
    # the last stage reads no U0
    'dns_project_rk_last': ('dns_project_rk_f64', lambda: (
        (*N3, U3, U0, *KS),
        da.project_rk(N3, U3, U0, U3, KS, 0.1, 0.2)[1]), False),
}


@pytest.mark.parametrize('case', list(WRAPPERS))
def test_a_kernel_wrapper_counts_its_bytes(case):
    """Each wrapper's span holds its launch and the bytes its kernel
    cannot avoid moving: no more than its input and output tensors hold,
    all of them where it reads all of its input."""
    name, call, reads_all = WRAPPERS[case]
    got = {}

    def work():
        got['io'] = call()
    t = _profiled(work)
    ins, outs = got['io']
    outs = outs if isinstance(outs, tuple) else (outs,)
    row = t['kernel.' + name]
    assert row['calls'] == row['launches'] == 1
    assert set(t) == {'kernel.' + name}
    whole = _bytes(*ins, *outs)
    assert 0 < row['bytes'] <= whole
    assert (row['bytes'] == whole) == reads_all


CELLS = {'tg_dns_512_d_pad.rk4': ('step', 120),
         'r2r_dct3_512_d.roundtrip': ('xfer', 3)}
NEW = ('algebra_ms', 'boundary_ms', 'r2r_glue_ms', 'kernel_hbm_pct',
       'port_launches')


@pytest.mark.parametrize('name', list(CELLS))
def test_a_traced_cell_reports_the_span_metrics(name, tmp_path):
    """At 16^3 on the CPU a traced run reports every metric the cell
    lists that reads the spans, the launches exactly; its Chrome trace
    holds the spans as host ranges."""
    split, launches = CELLS[name]
    path = tmp_path / 'trace.json'
    line = run.run_cell(name, 2 ** 31 + 91, 0.05, True, 'cpu',
                        cfg_over=TINY, export=path)
    assert line['correct']
    _, per_layer = catalog.metrics_of(catalog.benchmark(), name)
    want = {m['name'] for m in per_layer if m['name'].split('.')[0] in NEW}
    assert len(want) == 4
    assert want <= set(line['metrics'])
    assert line['metrics'][f'port_launches.{split}']['value'] == launches
    text = path.read_text()
    for span in ('pfft.forward', 'pfft.backward', 'pfft_stage0',
                 'kernel.rfft_axis_p_f64', 'kernel.irfft_axis_p_f64'):
        assert f'"{span}"' in text, span
    if split == 'step':
        assert '"dns.step"' in text and '"kernel.fft_axis_tp_f64"' in text
        for span in ('kernel.dns_curl_f64', 'kernel.dns_cross_f64',
                     'kernel.dns_project_rk_f64'):
            assert f'"{span}"' in text, span
        assert 'algebra_hbm_pct.step' in line['metrics']
    else:
        assert '"r2r"' in text and '"pfft.planar"' in text
        for span in ('kernel.dct2_axis_p_f64', 'kernel.dct3_axis_p_f64'):
            assert f'"{span}"' in text, span


def test_the_solver_layers_add_up_to_its_step():
    """The step's eager algebra (the solver's self time), its algebra
    kernels and its transforms make the whole step; its launches are 3 a
    transform and 3 algebra kernels a stage."""
    from mpi4py_fft_torch.examples import spectral_dns_solver as dns
    _, U, step, _ = dns.make_solver(N=(8, 8, 8), padding=True, device='cpu')
    t = _profiled(lambda: step(U))
    algebra = [n for n in t if n.startswith('kernel.dns_')]
    assert sorted(algebra) == ['kernel.dns_cross_f64', 'kernel.dns_curl_f64',
                               'kernel.dns_project_rk_f64']
    parts = t['dns.step']['self_s'] + t['dns.rhs']['self_s'] \
        + t['pfft.forward']['device_s'] + t['pfft.backward']['device_s'] \
        + sum(t[n]['device_s'] for n in algebra)
    assert parts == pytest.approx(t['dns.step']['device_s'], rel=1e-9)
    assert t['pfft.forward']['calls'] + t['pfft.backward']['calls'] == 36
    assert all(t[n]['calls'] == t[n]['launches'] == 4 for n in algebra)
    assert sum(r['launches'] for r in t.values()) == 120


@pytest.mark.parametrize('metric', ['algebra_ms.step', 'algebra_hbm_pct.step',
                                    'boundary_ms.xfer',
                                    'r2r_glue_ms.xfer', 'kernel_hbm_pct.xfer',
                                    'port_launches.xfer'])
def test_a_reader_returns_none_when_the_units_disagree(metric):
    """The session counts its units (solver steps, else transforms); a
    summary of another count gets None, the same count a reading."""
    from mpi4py_fft_torch.examples import spectral_dns_solver as dns
    reader = catalog.reader(metric)
    if metric.endswith('.step'):
        _, U, step, _ = dns.make_solver(N=(8, 8, 8), padding=True,
                                        device='cpu')
        _profiled(lambda: step(U))
        units = 1
    else:
        cfg = dict(catalog.config('r2r_dct3_512_d'), **TINY)
        tr = catalog.traffic('roundtrip')
        side = tr.Side(cfg, {'shift': 0.5}, torch.device('cpu'),
                       tr.inputs(cfg, {}, 3, torch.device('cpu')))
        _profiled(side.unit)
        units = 2
    assert reader.read({'units': units + 1}, {}) is None
    v = reader.read({'units': units}, {})
    assert v is not None and v >= 0
