"""Settings for the benchmark's own tests (``python -m pytest benchmark``).
Tests that need the card carry the ``card`` marker and skip without one."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (run on the chip)")
