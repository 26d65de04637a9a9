"""The card's FMA rate with no device-memory traffic in the loop:
``scripts/tpu_vpu_peak.py`` (``_call`` :86) on ``fma_chain``, float32
and float64, over accumulators a thread.  2 flops an FMA, against the
data sheet's non-tensor peaks (67 and 34 TFLOP/s at 700 W)."""
import torch

from ..ops import probes as tp
from ._common import card, chain_ms, result, sm_count

SCRIPT = 'scripts/tpu_vpu_peak.py'
ITERS = 1 << 18
PEAK = {torch.float32: 67e12, torch.float64: 34e12}
# 8 blocks of 256 threads an SM: every SM full
THREADS_PER_SM = 2048


def run(device=None, n=None):
    dev = card(device)
    iters = n or ITERS
    rows = []
    for dtype, accs in ((torch.float32, (4, 8, 16)),
                        (torch.float64, (4, 8))):
        for acc in accs:
            numel = sm_count(dev) * THREADS_PER_SM * acc
            x = torch.ones(numel, dtype=dtype, device=dev)
            ms = chain_ms(lambda: tp.fma_chain(x, iters, acc, out=x),
                          reps=3, warm=1)
            flops = 2.0 * numel * iters
            rows.append(dict(variant=f'{dtype} acc={acc}', ms=ms,
                             tflops=flops / (ms * 1e-3) / 1e12,
                             of_peak=flops / (ms * 1e-3) / PEAK[dtype],
                             elements=numel, iters=iters, library_ms=None))
    best = {str(d): max(r['tflops'] for r in rows if r['variant'].startswith(
        str(d))) for d in PEAK}
    return result('vpu_peak', SCRIPT, dev, rows, best_tflops=best)
