"""Copy rate against box shape, slope-fitted over chained in-place
passes: ``scripts/tpu_blockshape_probe.py`` (``copy`` :72, ``copy_oop``
:113) on ``block_copy``.  The out-of-place boxes, which the script gates
to n <= 512 for a 16 GB chip, run at 512 and at n."""
from ..ops import probes as tp
from ._common import card, chain_ms, pingpong, rand, result, row, slope

SCRIPT = 'scripts/tpu_blockshape_probe.py'


def _boxes(n):
    lane, sub = min(128, n), min(8, n)
    return (('lead (2,N,8,128) 512 B runs', (2, n, sub, lane)),
            ('lead (2,N,8,256) 1 KB runs', (2, n, sub, min(2 * lane, n))),
            ('lead (2,N,8,512) 2 KB runs', (2, n, sub, min(4 * lane, n))),
            ('lead (2,N,16,128) 2 runs a row', (2, n, 2 * sub, lane)),
            ('plane (2,1,N,N) contig', (2, 1, n, n)),
            ('2-plane (2,2,N,N) contig', (2, 2, n, n)),
            ('halfplane (2,1,N/2,N)', (2, 1, n // 2, n)))


def run(device=None, n=None):
    dev = card(device)
    n = n or 1024
    x = rand((2, n, n, n), dev, 1)
    rw = 2 * x.numel() * 4
    y = x.new_empty(x.shape)
    lib = chain_ms(lambda: y.copy_(x))
    del y
    rows = []
    for tag, box in _boxes(n):
        a, b, ts = slope(lambda: tp.block_copy(x, box, out=x))
        rows.append(row(f'{tag} in-place', b, rw, library_ms=lib,
                        box=list(box), overhead_ms=a, k_ms=ts))
    del x
    for m in sorted({min(512, n), n}):
        x = rand((2, m, m, m), dev, 2)
        y = x.new_empty(x.shape)
        rw = 2 * x.numel() * 4
        lib = chain_ms(lambda: y.copy_(x))
        lane, sub = min(128, m), min(8, m)
        for tag, box in (('OOP plane (2,1,N,N)', (2, 1, m, m)),
                         ('OOP lead (2,N,8,128)', (2, m, sub, lane))):
            step = pingpong(lambda s, d: tp.block_copy(s, box, out=d), x, y)
            a, b, ts = slope(step)
            rows.append(row(f'{tag} n={m}', b, rw, library_ms=lib,
                            box=list(box), overhead_ms=a, k_ms=ts))
        del x, y
    return result('blockshape', SCRIPT, dev, rows, n=n)
