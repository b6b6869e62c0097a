"""The benchmark's own tests: ``python3 -m pytest benchmark/tests`` from
the root of the repository. A test that needs a CUDA device carries the
``card`` marker and skips itself where there is none (it decides inside
the test, never while the module is imported)."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")
