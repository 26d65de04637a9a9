"""Launch overhead against per-pass time, time(k) = a + b*k over k = 1,
3, 5 chained passes: ``scripts/tpu_slope_probe.py`` (``copy_lead`` :74,
``copy_plane`` :88) on ``block_copy`` in place, and A at axes 0, 1, 2
and I (``fft_plane_large_p``) as they are."""
from ..ops import butterfly as bf
from ..ops import probes as tp
from ._common import card, rand, result, row, slope

SCRIPT = 'scripts/tpu_slope_probe.py'
KS = (1, 3, 5)


def run(device=None, n=None):
    dev = card(device)
    n = n or 1024
    lane, sub = min(128, n), min(8, n)
    x = rand((2, n, n, n), dev, 11)
    rw = 2 * x.numel() * 4
    rows = []
    for tag, box in (('copy lead-blocked', (2, n, sub, lane)),
                     ('copy contig planes', (2, 1, n, n))):
        a, b, ts = slope(lambda: tp.block_copy(x, box, out=x), KS)
        rows.append(row(tag, b, rw, overhead_ms=a, k_ms=ts))
    state = [x]

    def chained(fn):
        def step():
            state[0] = fn(state[0])
        return step
    for ax, tag in ((0, 'lead'), (1, 'mid'), (2, 'last')):
        a, b, ts = slope(chained(lambda y: bf.fft_axis_p(y, ax)), KS)
        rows.append(row(f'butterfly axis{ax} ({tag}): A', b, rw,
                        overhead_ms=a, k_ms=ts))
    a, b, ts = slope(chained(bf.fft_plane_large_p), KS)
    rows.append(row('plane_large (axes 1+2): I', b, 2 * rw, overhead_ms=a,
                    k_ms=ts))
    return result('slope', SCRIPT, dev, rows, n=n)
