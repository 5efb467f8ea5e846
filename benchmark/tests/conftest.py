import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card and skips without one (on the card: "
        "pytest -m gpu benchmark/tests)")
