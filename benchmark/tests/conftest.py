"""Tests of the benchmark harness. Run from the checkout's root:

    python -m pytest benchmark/tests -q

Tests marked `cuda` run only where a card is visible (they decide inside the
test, never while the module is imported)."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]
