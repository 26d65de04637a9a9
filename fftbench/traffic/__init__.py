"""Traffic kinds: one module each, found by the name a cell gives.

Each module has

* ``UNIT``, ``METRIC``: what one unit of work is and the end-to-end
  metric that the window's time over its units gives;
* ``inputs(cfg, params, seed, device)``: the benchmark's inputs, made
  from the seed on the device, the same for the same seed;
* ``Side(cfg, params, device, inputs)``: the port's side, built from the
  inputs, with ``warm()``, ``unit()`` (runs one call of the window and
  returns the units it completed), ``result()`` and ``close()``;
* ``judge(cfg, params, seed, result, device, limits)``: the plain
  reference from the same inputs, replaying as many units as the window
  counted (``result['units']``, set by the harness, not by the side),
  and ``{name: (value, limit)}`` for each number compared;
* ``least_seconds(cfg)``: the least time of one unit and the bound that
  holds, or None where the kind has no roofline;
* ``control_side(cfg, params, device, inputs)``: a side whose results
  come out one precision below the configuration's (the port's own
  lower path where it has one, else the reference computed lower).
"""
