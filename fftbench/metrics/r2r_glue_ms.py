"""Device milliseconds a transform in the r2r glue: the self time of the
span ``r2r`` (``ops/core.py``, one an axis), the kernels it launches
(its ``kernel.*`` children) left out."""
from fftbench.metrics import _spans


def read(summary, ctx):
    return _spans.ms_per_unit(summary, ('r2r',), 'self_s')
