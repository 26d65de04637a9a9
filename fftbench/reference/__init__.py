"""Plain references, one module a configuration, named after it.

Plain PyTorch (``torch.fft``, ``torch.matmul``) and NumPy only: nothing
here imports the port, JAX or the JAX package, and nothing takes a table
or a plan that the port made.
"""
