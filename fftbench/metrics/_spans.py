"""The program's own spans of the traced window, for the readers of the
metrics built on them: the newest session of
``mpi4py_fft_torch.utils.profiling`` (``session()``), a row a span name
with its calls, device and self seconds, bytes and kernel launches.

A session counts its own units: ``dns.step`` calls where the solver
ran, else ``pfft.forward`` and ``pfft.backward`` calls.  Where they
disagree with the summary's units, the spans are not the window's, and
the readers return None, as they do where the program keeps no session.
"""


def table(summary):
    """(rows, units) of the session, or None."""
    try:
        from mpi4py_fft_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, 'session', None)
    if read is None:
        return None
    rows = read()

    def calls(name):
        return rows[name]['calls'] if name in rows else 0
    units = calls('dns.step') if 'dns.step' in rows \
        else calls('pfft.forward') + calls('pfft.backward')
    if not units or units != summary['units']:
        return None
    return rows, units


def ms_per_unit(summary, names, key):
    """Milliseconds a unit of ``key`` ('device_s' or 'self_s') summed over
    the spans ``names``, or None where none of them ran."""
    got = table(summary)
    if got is None:
        return None
    rows, units = got
    if not any(n in rows for n in names):
        return None
    return sum(rows[n][key] for n in names if n in rows) / units * 1e3
