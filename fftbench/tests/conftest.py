"""The benchmark's CPU tests import ``fftbench`` from the checkout's
root, whatever directory pytest starts in."""
import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
