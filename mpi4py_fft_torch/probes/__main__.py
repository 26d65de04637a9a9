"""Run the probes on the card: ``python -m mpi4py_fft_torch.probes
[name ...]`` (all of them without a name); one JSON line each."""
import json
import sys

import torch

from . import NAMES, module
from ._common import card
from ..ops import _build


def main(argv):
    dev = card()
    _build.load()
    for name in argv or NAMES:
        print(json.dumps(module(name).run(dev)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
