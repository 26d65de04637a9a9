"""Device milliseconds a unit in kernels of PyTorch's and CUDA's
libraries (``tracewin.kind_of``): the application's algebra, the
reference API's boundary copies and the r2r glue."""


def read(summary, ctx):
    t = sum(s for _, s, kind in summary['kernels'] if kind == 'torch')
    return t / summary['units'] * 1e3 if summary['units'] else None
