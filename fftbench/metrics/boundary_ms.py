"""Device milliseconds a unit in the reference API's boundary copies:
the spans ``pfft.planar`` and ``pfft.unplanar`` of ``Transform.fn``
(a complex tensor to its planar form and back)."""
from fftbench.metrics import _spans


def read(summary, ctx):
    return _spans.ms_per_unit(summary, ('pfft.planar', 'pfft.unplanar'),
                              'device_s')
