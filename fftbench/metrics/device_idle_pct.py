"""Share of the traced window in which no kernel, copy or fill runs on
the device (one minus the union of their intervals over the window)."""


def read(summary, ctx):
    if summary['window_s'] <= 0 or summary['busy_s'] <= 0:
        return None
    return 100.0 * (1.0 - summary['busy_s'] / summary['window_s'])
