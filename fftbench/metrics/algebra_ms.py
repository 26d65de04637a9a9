"""Device milliseconds a step in the solver's own algebra: the self time
of its spans ``dns.step`` and ``dns.rhs``, whose transforms
(``pfft.forward``, ``pfft.backward``) are their children and left out."""
from fftbench.metrics import _spans


def read(summary, ctx):
    return _spans.ms_per_unit(summary, ('dns.step', 'dns.rhs'), 'self_s')
