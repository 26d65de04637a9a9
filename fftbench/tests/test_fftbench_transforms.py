"""The cell ``tg_dns_512_d_pad.transforms`` (the dealiased solver's
transform mix without its algebra) at 16^3 on the CPU: the port is
correct, the control and broken timed paths are not, and a unit counts
its nine transforms."""
import pytest
import torch

from fftbench import catalog, run

CPU = torch.device('cpu')
NAME = 'tg_dns_512_d_pad.transforms'
TINY = {'N': [16, 16, 16]}
CELL = catalog.workload(NAME)
TR = catalog.traffic(CELL['traffic'])


def test_inputs_repeat_for_a_seed_and_differ_across_seeds():
    cfg = dict(catalog.config('tg_dns_512_d_pad'), **TINY)
    big = 2 ** 31 + 977
    a, b, c = (TR.inputs(cfg, CELL['params'], s, CPU)['S']
               for s in (big, big, big + 1))
    assert a.shape == (6, 16, 16, 9) and a.dtype == torch.complex128
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_a_unit_is_nine_transforms_of_the_padded_plan():
    from mpi4py_fft_torch.utils.profiling import annotate, session
    cfg = dict(catalog.config('tg_dns_512_d_pad'), **TINY)
    side = TR.Side(cfg, CELL['params'], CPU,
                   TR.inputs(cfg, CELL['params'], 4, CPU))
    with annotate('off'):
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert side.unit() == TR.TRANSFORMS == 9
    t = session()
    assert t['pfft.backward']['calls'] == 6
    assert t['pfft.forward']['calls'] == 3
    assert len(side.S) == 6
    assert all(s.shape == (16, 16, 9) for s in side.S)


def test_the_port_is_correct():
    line = run.run_cell(NAME, 2 ** 31 + 5, 0.3, False, 'cpu', cfg_over=TINY)
    assert line['correct'] is True, line['checks']
    assert line['attempted'] % 9 == 0 and line['attempted'] > 0
    assert line['checks']['state_rel_l2']['value'] < 1e-13


def test_the_control_is_not_correct():
    line = run.run_cell(NAME, 21, 0.3, False, 'cpu', cfg_over=TINY,
                        side_factory=TR.control_side)
    assert line['correct'] is False, line['checks']
    assert line['checks']['state_rel_l2']['value'] > 1e-8


def _broken(fault):
    class Broken(TR.Side):
        calls = 0

        def unit(self):
            self.calls += 1
            before = [s.clone() for s in self.S]
            n = super().unit()
            if self.calls == 1:
                return n
            if fault == 'unchanged':
                self.S = before
            elif fault == 'half':
                # half of the new spectra's planes left as they were
                h = self.S[0].shape[0] // 2
                for j in range(3):
                    self.S[j][h:] = before[j][h:]
            elif fault == 'nan':
                self.S[4].view(-1)[2] = float('nan')
            return n
    return Broken


@pytest.mark.parametrize('fault', ['unchanged', 'half', 'nan'])
def test_a_broken_timed_path_is_not_correct(fault):
    line = run.run_cell(NAME, 33, 0.3, False, 'cpu', cfg_over=TINY,
                        side_factory=_broken(fault))
    assert line['correct'] is False, line['checks']
    assert line['failed'] == line['attempted'] > 0
