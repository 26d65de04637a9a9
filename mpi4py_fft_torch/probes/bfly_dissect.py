"""A's lead-axis pass at N = 1024 split into its parts, in place on lead
blocks: ``scripts/tpu_bfly_dissect.py`` (``mk_kernel`` :77: body_copy,
body_concat, body_adds; ``with_tw`` :152: body_full) on ``bfly``.  The
differences give the Stockham moves in shared memory (moves - copy), the
adds (adds - moves) and the twiddles with A's radix-16 plan
(full - adds).  The full row names its transform (``fft``) for the
cuFFT yardstick."""
from ..ops import probes as tp
from ._common import card, chain_ms, rand, result, row

SCRIPT = 'scripts/tpu_bfly_dissect.py'


def run(device=None, n=None):
    dev = card(device)
    n = n or 1024
    lane = min(128, n * n)
    x = rand((2, n, n * n // lane, lane), dev, 12)
    rw = 2 * x.numel() * 4
    y = x.new_empty(x.shape)
    lib = chain_ms(lambda: y.copy_(x))
    del y
    rows, ms = [], {}
    for mode, tag in (('copy', 'copy (DMA floor)'),
                      ('moves', 'concat-only (moves)'),
                      ('adds', 'adds-only (no twiddles)'),
                      ('full', 'full butterfly (A\'s plan)')):
        ms[mode] = chain_ms(lambda: tp.bfly(x, 0, mode, out=x))
        extra = {'fft': [list(x.shape[1:]), 0]} if mode == 'full' else {}
        rows.append(row(tag, ms[mode], rw,
                        library_ms=lib if mode == 'copy' else None,
                        mode=mode, **extra))
    split = {'load_store_ms': ms['copy'],
             'moves_ms': ms['moves'] - ms['copy'],
             'adds_ms': ms['adds'] - ms['moves'],
             'twiddles_and_plan_ms': ms['full'] - ms['adds']}
    return result('bfly_dissect', SCRIPT, dev, rows, n=n, split=split)
