"""The HBM share of ``fft_axis_p``'s launches by route, from the program's
own record: ``mpi4py_fft_torch.utils.profiling.routes()``, where each
launch's span (``kernel.fft_axis_p``, ``kernel.fft_axis_p_f64``) names
its route, ``'lines'`` on the last axis, ``'band'`` or ``'tile'`` on an
inner axis (``ops/butterfly.py`` ``axis_route``).

Bytes: each element of a launch's input read and of its output written
once (the span's own count), a floor of its traffic, over the launches'
device time, in percent of the card's HBM3 rate
(``roofline.HBM_BYTES_PER_S``).  None where the session is not the
window's (``_spans.table``), where the program keeps no route record,
or where no launch took the routes asked for.
"""
from fftbench import roofline
from fftbench.metrics import _spans

SPANS = ('kernel.fft_axis_p', 'kernel.fft_axis_p_f64')


def hbm_pct(summary, routes):
    """The share of the launches on ``routes`` (a tuple of route
    names)."""
    if _spans.table(summary) is None:
        return None
    from mpi4py_fft_torch.utils import profiling
    read = getattr(profiling, 'routes', None)
    if read is None:
        return None
    table = read()
    rows = [r for name in SPANS
            for route, r in table.get(name, {}).items() if route in routes]
    t = sum(r['device_s'] for r in rows)
    if t <= 0:
        return None
    return 100.0 * sum(r['bytes'] for r in rows) / t \
        / roofline.HBM_BYTES_PER_S
