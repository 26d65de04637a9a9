"""A at N = 256, 512 and 1024 on ~2^28-point planes, at the lead, mid and
last positions, out of place and in place (the C entry with y = x), and
its fp64 build beside it: ``scripts/tpu_longN_probe.py`` (``mk.fn`` :76,
the JAX package's ``_kern_lead``/``_kern_mid``/``_kern_last``/
``_kern_last2``).  No new kernel: A as it is (``fft_axis_p`` with
``out=``).  Each in-place result is held against the out-of-place one
bit for bit, and a small batch against A's plain version."""
import torch

from ..ops import butterfly as bf
from ._common import card, chain_ms, rand, result, row

SCRIPT = 'scripts/tpu_longN_probe.py'
PLANE = 1 << 28


def _shapes(N):
    rows = max(1024, PLANE // N // 1024 * 1024)
    return (('lead', (2, N, rows), 0),
            ('mid', (2, 8 * (rows // 1024), N, 128), 1),
            ('last', (2, rows, N), 1))


def run(device=None, n=None):
    dev = card(device)
    out, held = [], 0
    for dtype in (torch.float32, torch.float64):
        tol = 2e-13 if dtype == torch.float64 else 5e-6
        for N in ((n,) if n else (256, 512, 1024)):
            small = rand((2, N, 1024), dev, 14, dtype)
            rel = float(torch.linalg.vector_norm(
                bf.fft_axis_p(small, 0) -
                bf.fft_axis_plain(small, 0)) /
                torch.linalg.vector_norm(bf.fft_axis_plain(small, 0)))
            if not rel <= tol:
                raise RuntimeError(f"A at N={N} {dtype}: rel {rel:.3e} "
                                   f"against its plain version")
            for pos, shape, ax in _shapes(N):
                x = rand(shape, dev, 15, dtype)
                rw = 2 * x.numel() * x.element_size()
                y = torch.full_like(x, float('nan'))
                bf.fft_axis_p(x, ax, out=y)
                z = x.clone()
                if not torch.equal(bf.fft_axis_p(z, ax, out=z), y):
                    raise RuntimeError(f"A in place differs from out of "
                                       f"place: {pos} N={N} {dtype}")
                held += 1
                del z
                tag = f'{pos} N={N} {str(dtype)[6:]}'
                out.append(row(f'{tag} alias=0', chain_ms(
                    lambda: bf.fft_axis_p(x, ax, out=y)), rw,
                    rel_vs_plain=rel))
                out.append(row(f'{tag} alias=1', chain_ms(
                    lambda: bf.fft_axis_p(x, ax, out=x)), rw))
                del x, y
            torch.cuda.empty_cache()
    return result('long_n', SCRIPT, dev, out, in_place_held=held)
