"""Pipeline layer of the port: the single-device planar ``PlanarPFFT``."""
from .planar import PlanarPFFT  # noqa: F401
