"""The benchmark's own tests: `python -m pytest pbrt_bench/tests -q` from
the repository's root. Tests marked `card` need a CUDA device and skip
without one (each decides inside the test)."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device; skips without one")
