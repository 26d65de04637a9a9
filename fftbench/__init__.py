"""The benchmark of ``mpi4py_fft_torch`` on one NVIDIA H100.

One command, from the root of a checkout::

    python3 fftbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, cell, traffic kind or
per-layer metric sits in a file of its own, found by its name:
``configs/<config>.json``, ``workloads/<cell>.json``,
``traffic/<traffic>.py``, ``reference/<config>.py`` and
``metrics/<name>.py`` (see ``README.md``).  Nothing here imports JAX
or the JAX package; nothing under ``reference/`` imports the port.
"""
