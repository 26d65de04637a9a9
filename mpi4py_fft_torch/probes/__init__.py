"""On-card probes: the JAX package's TPU microbenchmarks
(``scripts/tpu_*.py``) on the port's probe kernels (``ops/probes.py``),
one module per script, each with ``run(device=None, n=None)`` returning
its rows (ms, GB/s read + write against the HBM peak, the PyTorch
yardstick).  Run them on a CUDA card:

    python -m mpi4py_fft_torch.probes [name ...]

Without a card they raise: a probe times the card.
"""
import importlib

# module -> the script it ports
SCRIPTS = {
    'dma': 'scripts/tpu_dma_probe.py',
    'blockshape': 'scripts/tpu_blockshape_probe.py',
    'lead_copy': 'scripts/tpu_lead_copy.py',
    'r3_profile': 'scripts/tpu_r3_profile.py',
    'plane_copy': 'scripts/tpu_plane_test.py',
    'pair_blocking': 'scripts/tpu_pair_blocking_probe.py',
    'oop3d_dissect': 'scripts/tpu_oop3d_dissect.py',
    'moves': 'scripts/tpu_probe_moves.py',
    'slope': 'scripts/tpu_slope_probe.py',
    'bfly_dissect': 'scripts/tpu_bfly_dissect.py',
    'vpu_probe': 'scripts/tpu_vpu_probe.py',
    'vpu_peak': 'scripts/tpu_vpu_peak.py',
    'long_n': 'scripts/tpu_longN_probe.py',
}
NAMES = tuple(SCRIPTS)


def module(name):
    if name not in SCRIPTS:
        raise ValueError(f"no probe {name!r}; the probes are {NAMES}")
    return importlib.import_module(f'{__name__}.{name}')
