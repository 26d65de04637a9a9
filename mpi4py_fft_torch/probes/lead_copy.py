"""Copies with the lead and mid kernels' block structure, and the
butterfly alone on lead blocks: ``scripts/tpu_lead_copy.py``
(``lead_copy`` :89, ``mid_copy`` :102, ``lead_bfly`` :119,
``lead_bfly_5d`` :137, ``make_leadQ`` :199) on ``block_copy`` and
``bfly``.  The 5-D view (2, N, G, 8, 128) is the same memory as the 4-D
one, and on the card its launch is the same one (a tile of A's lines
along axis 0), so one row stands for both; the Q-wide blocks become
tiles of fewer lines than A's (a tile holds at most 8192 points).  At
the script's n = 256 a volume (134 MB) is not much larger than the 50 MB
L2; the 1024^3 rows are the floors.  The butterfly rows name their transform
(``fft``: the complex shape and axis) for the cuFFT yardstick."""
import torch

from ..ops import probes as tp
from ._common import card, chain_ms, rand, result, row

SCRIPT = 'scripts/tpu_lead_copy.py'


def _one(dev, N):
    lane, sub = min(128, N), min(8, N)
    x = rand((2, N, N, N), dev, 3)
    y = x.new_empty(x.shape)
    rw = 2 * x.numel() * 4
    lib = chain_ms(lambda: y.copy_(x))
    xl, yl = x.view(2, N, N * N // lane, lane), y.view(2, N, N * N // lane,
                                                      lane)
    rows = [row(f'copy lead-structure n={N}', chain_ms(
        lambda: tp.block_copy(xl, (2, N, sub, lane), out=yl)), rw,
        library_ms=lib),
        row(f'copy mid-structure n={N}', chain_ms(
            lambda: tp.block_copy(x, (2, sub, N, lane), out=y)), rw,
            library_ms=lib)]
    fft = [[N, N, N], 0]
    rows.append(row(f'bfly lead n={N}', chain_ms(
        lambda: tp.bfly(x, 0, 'full', out=y)), rw, fft=fft))
    own = tp.tile_lines(N)
    for lines in (own // 4, own // 2, own):
        rows.append(row(f'bfly lead, tiles of {lines} lines n={N}',
                        chain_ms(lambda: tp.bfly(x, 0, 'full', lines=lines,
                                                 out=y)),
                        rw, fft=fft, lines=lines))
    return rows


def run(device=None, n=None):
    dev = card(device)
    rows = []
    for N in ((n,) if n else (256, 1024)):
        rows += _one(dev, N)
        torch.cuda.empty_cache()
    return result('lead_copy', SCRIPT, dev, rows)
