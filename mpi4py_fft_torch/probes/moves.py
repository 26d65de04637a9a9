"""The packed r2c kernel's in-kernel moves: ``scripts/tpu_probe_moves.py``
(``run`` :31, nine spellings of five functions) on ``move``.  The
script asks whether Mosaic lowers each move; CUDA has no such question,
so each is held bit for bit on the script's (64, 8, 128) arange, and the
deinterleave and reversal are timed at B's reads: the last axis of the
768^3 real volume of B's timed pass (chip_smoke.py phase times), each row
with its route and its rate over the least bytes the card moves
(``move_bytes``: x + y for the deinterleaves, whose sectors hold both
parities; 2 x for reverse and roll)."""
import torch

from ..ops import probes as tp
from ._common import card, chain_ms, result, row, rand

SCRIPT = 'scripts/tpu_probe_moves.py'
# the script's moves: (axis, kind, shift) of each spelling
MOVES = {
    'lead strided x[0::2]': (0, 'even', 0),
    'lead strided x[1::2]': (0, 'odd', 0),
    'lead flip jnp.flip(x,0)': (0, 'reverse', 0),
    'lead neg-step x[::-1]': (0, 'reverse', 0),
    'pltpu.roll lead': (0, 'roll', 1),
    'concat pages reversal': (0, 'reverse', 0),
    'concat pages deinterleave': (0, 'even', 0),
    'reshape pair-split (N/2,2,S,L) take even': (0, 'even', 0),
    'sublane flip jnp.flip(x,1)': (1, 'reverse', 0),
}


def run(device=None, n=None):
    dev = card(device)
    x = torch.arange(64 * 8 * 128, dtype=torch.float32,
                     device=dev).reshape(64, 8, 128)
    legal = {tag: bool(torch.equal(tp.move(x, *m), tp.move_plain(x, *m)))
             for tag, m in MOVES.items()}
    n = n or 768
    x = rand((n, n, n), dev, 10)
    rows = []
    for kind, shift, lib_fn in (
            ('even', 0, lambda y: y.copy_(x[..., 0::2])),
            ('odd', 0, lambda y: y.copy_(x[..., 1::2])),
            ('reverse', 0, lambda y: torch.flip(x, (-1,))),
            ('roll', 1, lambda y: torch.roll(x, 1, -1))):
        y = tp.move(x, -1, kind, shift)
        lib = chain_ms(lambda: lib_fn(y))
        rows.append(row(f'{kind} along the last axis of {n}^3', chain_ms(
            lambda: tp.move(x, -1, kind, shift, out=y)),
            tp.move_bytes(x, -1, kind), library_ms=lib,
            route=tp.move_route(x, -1, kind, shift, out=y)
            if x.is_cuda else None))
        del y
    return result('moves', SCRIPT, dev, rows, legal=legal)
