"""The port's profiling tools (mpi4py_fft_torch/utils/profiling.py), the
port of tests/test_profiling.py, on the CPU.

``stage_times`` cuts a transform at its stage boundaries and runs the
pieces as the executor does (padded blocks, planar complex data): the
staged chain must compute the fused transform's result, and on the CPU
the same operations give it bit for bit.  Its several-rank form, each
``transpose<i>`` that rank's exchange, runs in tests/test_torch_dist.py's
2-rank group.
"""
import functools
import json

import numpy as np
import pytest

import torch

from mpi4py_fft_torch import PFFT, fftw
from mpi4py_fft_torch.utils.profiling import annotate, stage_times, trace


def _staged_keys(out, nstages):
    for i in range(nstages):
        assert f'stage{i}' in out, out.keys()
    for i in range(nstages - 1):
        assert f'transpose{i}' in out, out.keys()
    assert 'fused_total' in out


def _input(shape, typecode, seed):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(shape)
    if typecode in 'FD':
        u = u + 1j * rng.standard_normal(shape)
    return u.astype(typecode)


@pytest.mark.parametrize("typecode", ['f', 'D'])
def test_stage_times_matches_fused(typecode):
    """3 stages, 2 exchanges (nothing to move on one rank); the complex
    plan runs planar (a leading (2,) axis)."""
    shape = (16, 16, 16)
    fft = PFFT(None, shape, dtype=typecode, device='cpu')
    u = _input(shape, typecode, 11)
    out = stage_times(fft.forward, u, reps=1)
    _staged_keys(out, nstages=3)
    staged = out['_staged_result']
    fused = out['_fused_result']
    assert staged.shape == fused.shape
    assert torch.equal(staged, fused)
    want = fft.forward.fn_p(torch.from_numpy(u) if typecode == 'f' else
                            torch.from_numpy(np.stack([u.real, u.imag])))
    assert torch.equal(fused, want)
    for k, v in out.items():
        if not k.startswith('_'):
            assert v > 0.0


def test_stage_times_r2r_and_backward():
    """An r2r plan (the transforms example's: DCT-III on axes 1 and 2,
    then the rfft on axis 0) in both directions."""
    dct = (functools.partial(fftw.dctn, type=3),
           functools.partial(fftw.idctn, type=3))
    fft = PFFT(None, (18, 18, 18), axes=((0,), (1, 2)), dtype='d',
               transforms={(1, 2): dct}, device='cpu')
    u = _input((18, 18, 18), 'd', 3)
    fwd = stage_times(fft.forward, u, reps=1)
    _staged_keys(fwd, nstages=2)
    assert torch.equal(fwd['_staged_result'], fwd['_fused_result'])
    bwd = stage_times(fft.backward, fwd['_fused_result'], reps=1)
    assert torch.equal(bwd['_staged_result'], bwd['_fused_result'])
    assert np.allclose(bwd['_fused_result'].numpy(), u, atol=1e-12)


def test_stage_times_sum_approximates_total():
    """The stages' sum tracks the whole transform (the same work, staged);
    CPU times are noisy, so only a loose band is held."""
    fft = PFFT(None, (16, 16, 16), dtype='D', device='cpu')
    out = stage_times(fft.forward, _input((16, 16, 16), 'D', 5), reps=3)
    parts = sum(v for k, v in out.items()
                if k.startswith(('stage', 'transpose')))
    assert parts > 0 and out['fused_total'] > 0
    assert parts < 100 * out['fused_total']
    assert out['fused_total'] < 100 * parts


def test_trace_writes_the_stages(tmp_path):
    """``trace`` writes a Chrome trace holding the stages' ranges and
    ``annotate``'s."""
    fft = PFFT(None, (8, 8, 8), dtype='d', device='cpu')
    with trace(str(tmp_path)) as logdir:
        with annotate('my_range'):
            fft.forward.fn_p(torch.ones((8, 8, 8), dtype=torch.float64))
    assert logdir == str(tmp_path)
    files = list(tmp_path.glob('trace_*.json'))
    assert len(files) == 1
    names = {e.get('name') for e in
             json.loads(files[0].read_text())['traceEvents']}
    assert {'my_range', 'pfft_stage0', 'pfft_stage2'} <= names
