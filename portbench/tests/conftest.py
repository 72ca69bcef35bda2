"""The benchmark's own tests (not the repository's tier-1 suite).

    python3 -m pytest portbench/tests -q

Tests marked ``chip`` need a CUDA card and skip without one; on a machine
with a card they run the benchmark itself at its full size.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark runs only on one")
