"""B64's, C64's and the float64 DCT-II/III's launches on inner axes (the
column band and the tile): their bytes over their device time, in
percent of the card's HBM3 rate, from the program's own record:
``mpi4py_fft_torch.utils.profiling.routes()``, where each launch's span
(``kernel.rfft_axis_p_f64``, ``kernel.irfft_axis_p_f64``,
``kernel.dct2_axis_p_f64``, ``kernel.dct3_axis_p_f64``) names its route,
``'lines'`` on the last axis, ``'band'`` or ``'tile'`` on an inner axis
(``ops/butterfly.py`` ``real_route``).

Bytes: each element of a launch's input read and of its output written
once (the span's own count), as ``_routes.py`` counts A64's.  None where
the session is not the window's (``_spans.table``), where the program
keeps no route record, or where no launch of these spans named an inner
route (a program whose real kernels name no route).
"""
from fftbench import roofline
from fftbench.metrics import _spans

SPANS = ('kernel.rfft_axis_p_f64', 'kernel.irfft_axis_p_f64',
         'kernel.dct2_axis_p_f64', 'kernel.dct3_axis_p_f64')
ROUTES = ('band', 'tile')


def read(summary, ctx):
    if _spans.table(summary) is None:
        return None
    from mpi4py_fft_torch.utils import profiling
    routes = getattr(profiling, 'routes', None)
    if routes is None:
        return None
    table = routes()
    rows = [r for name in SPANS
            for route, r in table.get(name, {}).items() if route in ROUTES]
    t = sum(r['device_s'] for r in rows)
    if t <= 0:
        return None
    return 100.0 * sum(r['bytes'] for r in rows) / t \
        / roofline.HBM_BYTES_PER_S
