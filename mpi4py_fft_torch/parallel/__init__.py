"""Parallel layer of the port: the process group (``multihost``), the
pencil decomposition (``pencil``), the reference API's ``PFFT``
(``mpifft``) and the planar ``PlanarPFFT`` (``planar``)."""
from .planar import PlanarPFFT  # noqa: F401
