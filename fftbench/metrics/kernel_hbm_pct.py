"""The port's kernels' bytes over their device time, in percent of the
card's HBM3 rate (``roofline.HBM_BYTES_PER_S``): the ``kernel.*`` spans,
each launch counting each element of its input read and of its output
written once.  That is a floor of the traffic (every tensor of the cells
is far over the 50 MB L2), so the share cannot pass 100%."""
from fftbench import roofline
from fftbench.metrics import _spans


def read(summary, ctx):
    got = _spans.table(summary)
    if got is None:
        return None
    rows = [r for n, r in got[0].items() if n.startswith('kernel.')]
    t = sum(r['device_s'] for r in rows)
    if t <= 0:
        return None
    return 100.0 * sum(r['bytes'] for r in rows) / t \
        / roofline.HBM_BYTES_PER_S
