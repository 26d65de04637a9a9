"""Serial transform layer of the port: the Stockham kernels
(``butterfly``), their build (``_build``) and the planar engine surface
(``matfft``)."""
