"""The copy floor beside the plane A/B: a fully contiguous copy and lead
blocks of 8, 16 and 32 sublanes: ``scripts/tpu_plane_test.py``
(``lead_copy`` :96, ``contig_copy`` :110) on ``block_copy``, at the
script's n = 256 (a 134 MB volume: L2 holds a third of it) and at 1024.
The plane A/B itself is chip_smoke.py's plane and times_any phases."""
import torch

from ..ops import probes as tp
from ._common import card, chain_ms, rand, result, row

SCRIPT = 'scripts/tpu_plane_test.py'


def run(device=None, n=None):
    dev = card(device)
    rows = []
    for m in ((n,) if n else (256, 1024)):
        lane = min(128, m)
        x = rand((2, m, m, m), dev, 5)
        y = x.new_empty(x.shape)
        rw = 2 * x.numel() * 4
        lib = chain_ms(lambda: y.copy_(x))
        w = min(256, m * m)
        xc, yc = x.view(2, m ** 3 // w, w), y.view(2, m ** 3 // w, w)
        r = min(4096, m ** 3 // w)
        rows.append(row(f'copy contiguous (floor) n={m}', chain_ms(
            lambda: tp.block_copy(xc, (2, r, w), out=yc)), rw,
            library_ms=lib, box=[2, r, w]))
        xl = x.view(2, m, m * m // lane, lane)
        yl = y.view(xl.shape)
        for sub in (8, 16, 32):
            if (m * m // lane) % sub:
                continue
            rows.append(row(f'copy lead-layout sub={sub} n={m}', chain_ms(
                lambda: tp.block_copy(xl, (2, m, sub, lane), out=yl)), rw,
                library_ms=lib, box=[2, m, sub, lane]))
        del x, y, xc, yc, xl, yl
        torch.cuda.empty_cache()
    return result('plane_copy', SCRIPT, dev, rows)
