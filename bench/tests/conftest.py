"""The benchmark's tests: ``python -m pytest -q bench/tests`` from the
repository's root (the suite under ``tests/`` does not collect them).
Tests marked ``gpu`` skip without a CUDA device; on the card: ``python
-m pytest -q -m gpu bench/tests``."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
