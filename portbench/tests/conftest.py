"""The benchmark's CPU tests: ``python -m pytest portbench/tests -q`` from the
repository's root. Tests marked ``card`` run on a CUDA card only and skip
elsewhere; whether a card is there is decided inside the ``card`` fixture."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    from portbench.tests import tiny

    return tiny.make_root(str(tmp_path_factory.mktemp("portbench_root")))
