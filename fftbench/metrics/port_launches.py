"""The port's kernel launches a unit, counted by the program at each
launch (``utils/profiling.py`` ``launched``): an exact count."""
from fftbench.metrics import _spans


def read(summary, ctx):
    got = _spans.table(summary)
    if got is None:
        return None
    rows, units = got
    return sum(r['launches'] for r in rows.values()) / units
