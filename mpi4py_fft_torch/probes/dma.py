"""Copy floors of contiguous and lead-strided boxes, in place and out of
place, in both grid orders: ``scripts/tpu_dma_probe.py`` (``pallas_copy``
:69) on ``block_copy``, beside ``Tensor.copy_``."""
from ..ops import probes as tp
from ._common import card, chain_ms, rand, result, row

SCRIPT = 'scripts/tpu_dma_probe.py'


def run(device=None, n=None):
    dev = card(device)
    n = n or 1024
    lane, sub = min(128, n), min(8, n)
    x = rand((2, n, n, n), dev, 0)
    y = x.new_empty(x.shape)
    rw = 2 * x.numel() * 4
    lib = chain_ms(lambda: y.copy_(x))
    rows = [row('Tensor.copy_ (oop)', lib, rw, library_ms=lib)]
    for tag, box, order, inplace in (
            ('plane contig oop', (2, 1, n, n), None, False),
            ('plane contig in-place', (2, 1, n, n), None, True),
            ('lead strided oop', (2, n, sub, lane), None, False),
            ('lead strided in-place', (2, n, sub, lane), None, True),
            ('8-plane contig in-place', (2, sub, n, n), None, True),
            ('lead strided ip (swapped grid)', (2, n, sub, lane),
             (0, 1, 3, 2), True)):
        out = x if inplace else y
        ms = chain_ms(lambda: tp.block_copy(x, box, order, out=out))
        rows.append(row(tag, ms, rw, library_ms=lib, box=list(box)))
    return result('dma', SCRIPT, dev, rows, n=n)
