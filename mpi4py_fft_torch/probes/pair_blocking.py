"""2-in/2-out copies of two (2, h, n, h) quarters in five blockings,
against the same copy as two 1-in/1-out calls, slope-fitted over chained
pair calls: ``scripts/tpu_pair_blocking_probe.py`` (``mkpair.f`` :66,
``single`` :96) on ``block_copy`` with two streams."""
from ..ops import probes as tp
from ._common import card, chain_ms, rand, result, row, slope

SCRIPT = 'scripts/tpu_pair_blocking_probe.py'


def run(device=None, n=None):
    dev = card(device)
    n = n or 1024
    h = n // 2
    lane, sub = min(128, h), min(8, n)
    q = (2, h, n, h)
    a, b = rand(q, dev, 6), rand(q, dev, 7)
    oa, ob = a.new_empty(q), a.new_empty(q)
    rw = 4 * a.numel() * 4                 # two quarters read and written
    state = [(a, b), (oa, ob)]

    def chained(f):
        def step():
            f(*state[0], *state[1])
            state.reverse()
        return step

    def lib_pair(x0, x1, y0, y1):
        y0.copy_(x0)
        y1.copy_(x1)
    lib = chain_ms(chained(lib_pair))
    rows = []
    for tag, box, order in (
            ('base 2d (2,h,8,128)', (2, h, sub, lane), None),
            ('wide (2,h,8,256)', (2, h, sub, min(2 * lane, h)), None),
            ('tall (2,h,16,128)', (2, h, 2 * sub, lane), None),
            ('gridT (j-major)', (2, h, sub, lane), (0, 1, 3, 2)),
            ('halfrow (2,h/2,8,128)', (2, h // 2, sub, lane), None)):
        f = (lambda x0, x1, y0, y1, box=box, order=order: tp.block_copy(
            x0, box, order, out=y0, x2=x1, out2=y1))
        a0, b0, ts = slope(chained(f), ks=(1, 4))
        rows.append(row(tag, b0, rw, library_ms=lib, box=list(box),
                        overhead_ms=a0, k_ms=ts))

    def single(x0, x1, y0, y1):
        tp.block_copy(x0, (2, h, sub, lane), out=y0)
        tp.block_copy(x1, (2, h, sub, lane), out=y1)
    a0, b0, ts = slope(chained(single), ks=(1, 4))
    rows.append(row('dual 1-in calls', b0, rw, library_ms=lib,
                    overhead_ms=a0, k_ms=ts))
    return result('pair_blocking', SCRIPT, dev, rows, n=n)
