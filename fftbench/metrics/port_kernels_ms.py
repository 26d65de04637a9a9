"""Device milliseconds a unit in the port's own kernels (every kernel
outside PyTorch's and CUDA's libraries, ``tracewin.kind_of``)."""


def read(summary, ctx):
    t = sum(s for _, s, kind in summary['kernels'] if kind == 'port')
    return t / summary['units'] * 1e3 if summary['units'] else None
