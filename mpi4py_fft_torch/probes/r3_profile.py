"""Strided against contiguous slabs, and the mid-axis butterfly on whole
slabs in place: ``scripts/tpu_r3_profile.py`` (``copy_strided`` :79,
``copy_contig`` :93, ``mid_contig`` :121) on ``block_copy`` and
``bfly``, at n = 512 and 1024.  The butterfly row names its transform
(``fft``) for the cuFFT yardstick."""
import torch

from ..ops import probes as tp
from ._common import card, chain_ms, rand, result, row

SCRIPT = 'scripts/tpu_r3_profile.py'


def run(device=None, n=None):
    dev = card(device)
    rows = []
    for m in ((n,) if n else (512, 1024)):
        lane, sub = min(128, m), min(8, m)
        x = rand((2, m, m, m), dev, 4)
        y = x.new_empty(x.shape)
        rw = 2 * x.numel() * 4
        lib = chain_ms(lambda: y.copy_(x))
        xs = x.view(2, m, m * m // lane, lane)
        ys = y.view(xs.shape)
        rows.append(row(f'copy strided (2,N,8,128) n={m}', chain_ms(
            lambda: tp.block_copy(xs, (2, m, sub, lane), out=ys)), rw,
            library_ms=lib))
        rows.append(row(f'copy contig (2,1,N,post) n={m}', chain_ms(
            lambda: tp.block_copy(x, (2, 1, m, m), out=y)), rw,
            library_ms=lib))
        del y, ys, xs
        rows.append(row(f'mid-axis contig butterfly (in place) n={m}',
                        chain_ms(lambda: tp.bfly(x, 1, 'full', out=x)), rw,
                        fft=[[m, m, m], 1]))
        del x
        torch.cuda.empty_cache()
    return result('r3_profile', SCRIPT, dev, rows)
