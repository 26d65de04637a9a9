"""The solver's algebra kernels' bytes over their device time, in percent
of the card's HBM3 rate (``roofline.HBM_BYTES_PER_S``): the spans
``kernel.dns_*`` (``mpi4py_fft_torch/ops/dns_algebra.py``: the curl, the
cross product and the projection with the RK4 updates), each launch
counting each element of its distinct inputs read and of its outputs
written once, a floor of its traffic.  None where the session is not the
window's or no such span ran (a program that runs the algebra in eager
ops)."""
from fftbench import roofline
from fftbench.metrics import _spans


def read(summary, ctx):
    got = _spans.table(summary)
    if got is None:
        return None
    rows = [r for n, r in got[0].items() if n.startswith('kernel.dns_')]
    t = sum(r['device_s'] for r in rows)
    if t <= 0:
        return None
    return 100.0 * sum(r['bytes'] for r in rows) / t \
        / roofline.HBM_BYTES_PER_S
