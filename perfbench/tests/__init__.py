"""CPU tests of the benchmark harness (reduced sizes; no card).  The
program is imported from the checkout's ``src``."""

import sys
from pathlib import Path

_SRC = str(Path(__file__).resolve().parents[2] / "src")
if _SRC not in sys.path:
    sys.path.append(_SRC)
