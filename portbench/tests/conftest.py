"""The benchmark's CPU tests: run from the root of the repository with
``python -m pytest portbench/tests -q``.  Tests marked ``cuda`` run only
where a card is seen, and decide so inside the test."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
