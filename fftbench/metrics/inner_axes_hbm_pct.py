"""A64's (and A's) launches on inner axes, the column bands (and the
tile at other lengths): their bytes over their device time, in percent
of the card's HBM3 rate (``_routes.py``)."""
from fftbench.metrics import _routes


def read(summary, ctx):
    return _routes.hbm_pct(summary, ('band', 'tile'))
