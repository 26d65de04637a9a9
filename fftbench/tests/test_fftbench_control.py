"""The comparison fails where it must: the control (one precision below
the configuration's) and the faults a cell can have, each driven through
the rest of a run with the timed path broken underneath."""
import time

import pytest
import torch

from fftbench import catalog, run

TINY = {'N': [16, 16, 16]}
CELLS = ['r2r_dct3_512_d.roundtrip', 'tg_dns_512_d_pad.rk4']


@pytest.mark.parametrize('name', CELLS)
def test_control_fails_and_the_port_passes(name):
    """The control takes the port's place in a whole run and is judged
    by the run's own comparison, as ``control.py`` drives it."""
    tr = catalog.traffic(catalog.workload(name)['traffic'])
    port = run.run_cell(name, 21, 0.2, False, 'cpu', cfg_over=TINY)
    ctrl = run.run_cell(name, 21, 0.2, False, 'cpu', cfg_over=TINY,
                        side_factory=tr.control_side)
    assert port['correct'] is True, port['checks']
    assert ctrl['correct'] is False, ctrl['checks']
    assert ctrl['attempted'] > 0


def _state(side, traffic):
    return side.U if traffic == 'rk4' else side.x


def _broken(traffic, fault):
    """The traffic's side with its timed call broken by ``fault``."""
    base = catalog.traffic(traffic).Side

    class Broken(base):
        calls = 0

        def unit(self):
            self.calls += 1
            if fault == 'unchanged' and self.calls > 1:
                # after the first, each call returns the state it was
                # given, taking time as the device would
                time.sleep(0.02)
                return 1 if traffic == 'rk4' else 2
            before = _state(self, traffic).clone()
            n = base.unit(self)
            out = _state(self, traffic)
            if fault == 'half':
                # half of the planes left as they were
                planes = out if traffic == 'roundtrip' else out[0]
                old = before if traffic == 'roundtrip' else before[0]
                h = planes.shape[0] // 2
                planes[h:] = old[h:]
            elif fault == 'altered':
                # one answer altered where the call produced it
                out.view(-1)[7] += 1e-3 * out.abs().max()
            return n
    return Broken


@pytest.mark.parametrize('fault', ['unchanged', 'half', 'altered'])
@pytest.mark.parametrize('name', CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    cell = catalog.workload(name)
    line = run.run_cell(name, 33, 0.2, False, 'cpu', cfg_over=TINY,
                        side_factory=_broken(cell['traffic'], fault))
    assert line['correct'] is False, line['checks']
    assert line['failed'] == line['attempted'] > 0


def test_a_sound_timed_path_is_correct():
    for name in CELLS:
        line = run.run_cell(name, 33, 0.2, False, 'cpu', cfg_over=TINY)
        assert line['correct'] is True, line['checks']


def test_nan_is_not_correct():
    class NaNSide(catalog.traffic('roundtrip').Side):
        def unit(self):
            n = super().unit()
            self.X = self.X * float('nan')
            return n
    line = run.run_cell('r2r_dct3_512_d.roundtrip', 3, 0.1, False, 'cpu',
                        cfg_over=TINY, side_factory=NaNSide)
    assert line['correct'] is False
    assert torch.isnan(torch.tensor(line['checks']['fwd_rel_l2']['value']))


def test_units_faster_than_their_bound_are_not_correct(monkeypatch):
    """A window whose units' least time exceeds the window cannot have
    run them: not correct, and no reference is run for them."""
    tr = catalog.traffic('roundtrip')
    monkeypatch.setattr(tr, 'least_seconds', lambda cfg: (1.0, 'bytes'))

    def no_reference(*a, **k):
        raise AssertionError('the reference ran')
    monkeypatch.setattr(tr, 'judge', no_reference)
    line = run.run_cell('r2r_dct3_512_d.roundtrip', 3, 0.1, False, 'cpu',
                        cfg_over=TINY)
    assert line['correct'] is False
    assert line['checks']['bound_share']['value'] > 1.0
