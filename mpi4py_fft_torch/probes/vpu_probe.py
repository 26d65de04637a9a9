"""The butterfly applied reps = 1, 2, 3 times a tile, in place, each
slope-fitted over chained passes; the slope over reps is the compute of
one butterfly pass: ``scripts/tpu_vpu_probe.py`` (``mk.f`` :57) on
``bfly`` mode full on A's tile of ``tile_lines(n)`` lines, the
script's design (at n = 512 .. 1024 ``bfly`` would otherwise take A's
line or band kernel, whose passes after the first also regroup the
band).  The out-of-place pass, which the script gates to
n <= 512, runs at n."""
from ..ops import probes as tp
from ._common import card, pingpong, rand, result, row, slope

SCRIPT = 'scripts/tpu_vpu_probe.py'


def run(device=None, n=None):
    dev = card(device)
    n = n or 1024
    lane = min(128, n * n)
    x = rand((2, n, n * n // lane, lane), dev, 13)
    rw = 2 * x.numel() * 4
    rows, per = [], {}
    tile = tp.tile_lines(n)
    for reps in (1, 2, 3):
        a, b, ts = slope(lambda: tp.bfly(x, 0, 'full', reps, lines=tile,
                                          out=x))
        per[reps] = b
        rows.append(row(f'inplace bfly x{reps}', b, rw, overhead_ms=a,
                        k_ms=ts, reps=reps))
    compute = (per[3] - per[1]) / 2
    tiles = -(-(x.numel() // 2 // n) // tile)
    y = x.new_empty(x.shape)
    a, b, ts = slope(pingpong(lambda s, d: tp.bfly(s, 0, 'full', lines=tile,
                                                   out=d),
                              x, y))
    rows.append(row('OOP bfly x1', b, rw, overhead_ms=a, k_ms=ts))
    return result('vpu_probe', SCRIPT, dev, rows, n=n,
                  compute_ms_per_butterfly_pass=compute,
                  compute_us_per_tile=1e3 * compute / tiles,
                  load_store_intercept_ms=per[1] - compute)
