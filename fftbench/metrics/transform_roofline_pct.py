"""The transforms' least time over the device's busy time in the traced
window, in percent.  The least time counts each transform's input read
once and its output written once, from the plan's shapes
(``roofline.py``); the busy time is the whole device's, whatever ran,
so moving work between the port's kernels and PyTorch's cannot carry
the share past 100%."""


def read(summary, ctx):
    if ctx.get('least_s') is None or summary['busy_s'] <= 0:
        return None
    return 100.0 * ctx['least_s'] * summary['units'] / summary['busy_s']
