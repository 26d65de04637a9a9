"""The 2-in/2-out copy with the quartered schedule's x-pair blocking on
the four quarters of a volume, slope-fitted over chained passes:
``scripts/tpu_oop3d_dissect.py`` (``paircopy`` :104) on ``block_copy``
with two streams."""
from ..ops import probes as tp
from ._common import card, rand, result, row, slope

SCRIPT = 'scripts/tpu_oop3d_dissect.py'


def run(device=None, n=None):
    dev = card(device)
    n = n or 1024
    h = n // 2
    lane = min(128, n * h)
    v = (2, h, n * h // lane, lane)        # the x-pair view of a quarter
    qs = [rand(v, dev, 8 + i) for i in range(4)]
    outs = [q.new_empty(v) for q in qs]
    rw = 2 * 4 * qs[0].numel() * 4         # the volume read and written
    state = [qs, outs]
    box = (2, h, min(8, v[2]), lane)

    def step():
        (q00, q01, q10, q11), (o00, o01, o10, o11) = state
        tp.block_copy(q00, box, out=o00, x2=q10, out2=o10)
        tp.block_copy(q01, box, out=o01, x2=q11, out2=o11)
        state.reverse()

    def lib_step():
        for q, o in zip(*state):
            o.copy_(q)
        state.reverse()
    _, lib, _ = slope(lib_step, ks=(1, 3))
    a, b, ts = slope(step, ks=(1, 3))
    rows = [row('pair-copy (x blocking)', b, rw, library_ms=lib,
                box=list(box), overhead_ms=a, k_ms=ts)]
    return result('oop3d_dissect', SCRIPT, dev, rows, n=n)
