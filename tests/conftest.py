import os
import sys

# NOTE: no XLA_FLAGS here — smoke tests and benches must see 1 device.
# Distributed tests spawn subprocesses that set the flag themselves.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one "
        "(run on the card with `python -m pytest -m cuda tests/`)")
