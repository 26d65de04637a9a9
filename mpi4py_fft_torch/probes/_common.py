"""Timing helpers of the probe modules: CUDA events on the card."""
import statistics

import torch

# NVIDIA's H100 SXM data sheet at 700 W: HBM3 bandwidth
PEAK_BYTES_S = 3.35e12


def card(device=None):
    """The CUDA device the probes run on; raises without one (a probe
    times the card, and a CPU run times nothing of it)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probes time a CUDA card; none is available")
    dev = torch.device('cuda' if device is None else device)
    if dev.type != 'cuda':
        raise RuntimeError(f"the probes time a CUDA card, not {dev}")
    return dev


def sm_count(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def rand(shape, dev, seed, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand(shape, generator=g, device=dev, dtype=dtype) - 0.5


def chain_ms(step, k=1, reps=5, warm=2):
    """Median over ``reps`` of the time of ``k`` chained ``step()`` calls
    in one stream, between two CUDA events."""
    for _ in range(warm):
        step()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(k):
            step()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def slope(step, ks=(1, 5), reps=3):
    """The fit time(k) = a + b*k over k chained passes (the scripts'
    slope probes): (a, b, {k: time(k)}) in ms."""
    ts = {k: chain_ms(step, k, reps, warm=1) for k in ks}
    k0, k1 = min(ks), max(ks)
    b = (ts[k1] - ts[k0]) / (k1 - k0)
    return ts[k0] - b * k0, b, ts


def row(variant, ms, nbytes, library_ms=None, **extra):
    """One probe result: ``ms`` a pass moving ``nbytes`` (read + write),
    its rate and its share of the HBM peak, and the time of the PyTorch
    call that computes the same function (None where none does, or where
    the row names the transform it computes as ``fft=[shape, dim]``: the
    port never calls ``torch.fft``, so chip_smoke.py times that one)."""
    gbs = nbytes / (ms * 1e-3) / 1e9
    return dict(variant=variant, ms=ms, gbs_rw=gbs,
                of_peak=gbs * 1e9 / PEAK_BYTES_S, library_ms=library_ms,
                **extra)


def pingpong(fn, a, b):
    """A step for ``chain_ms`` that runs ``fn(src, dst)`` from one buffer
    into the other and swaps them: out-of-place passes chained."""
    state = [a, b]

    def step():
        fn(state[0], state[1])
        state.reverse()
    return step


def result(name, script, dev, rows, **extra):
    """A probe module's output: its rows, the script it ports and the card
    they ran on."""
    kind = torch.cuda.get_device_name(dev) if dev.type == 'cuda' \
        else str(dev)
    return dict(probe=name, script=script, device=kind, rows=rows, **extra)
