"""The benchmark's own tests: `python -m pytest benchmark/tests` from the
checkout's root. Tests marked `cuda` need a CUDA card and skip without
one (each decides inside itself)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skipped "
                            "without one")
