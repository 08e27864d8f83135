"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from
the root of the repository (CPU, reduced sizes).  Tests marked ``card``
need an NVIDIA card and skip without one."""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")
