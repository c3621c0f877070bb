"""pytest settings of the benchmark's own tests (``python -m pytest benchmark/tests``).

``card`` marks a test that needs a CUDA card; it is skipped, with the reason,
where none is present. Whether there is one is decided inside a fixture,
never while a module is imported."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skipped without one)")


@pytest.fixture(autouse=True)
def _card_or_skip(request):
    if request.node.get_closest_marker("card") is not None:
        import torch

        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card; this machine has none")
