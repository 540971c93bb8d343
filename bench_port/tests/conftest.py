"""The benchmark's CPU tests: the checkout's root on the path, so that ``bench_port`` and
the program import as the benchmark imports them."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
