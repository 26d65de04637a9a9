"""Examples of the port, each the counterpart of one in ``examples/``."""
