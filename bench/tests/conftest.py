"""The benchmark's own tests (``python -m pytest bench/tests``). Tests
marked ``chip`` need a CUDA card and are skipped, inside their fixture,
where none is found."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skipped where there is none)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda")
