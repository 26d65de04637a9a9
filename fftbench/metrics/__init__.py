"""Per-layer readers, one module a quantity, found by the part of the
metric's name before its first dot (``torch_ops_ms.step`` and
``torch_ops_ms.xfer`` are both read by ``metrics/torch_ops_ms.py``).

Each has ``read(summary, ctx)``: ``summary`` is the traced window's
summary (``tracewin.summarize``), ``ctx`` holds ``least_s``, the least
seconds of one unit from the roofline (None where the traffic has
none).  A reader that finds nothing to read returns None, and the
metric is left out of the line.
"""
