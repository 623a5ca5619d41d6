"""The benchmark's tests: CPU tests at small sizes, and tests marked
``card`` that need a CUDA card and skip without one."""
import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips on a machine without one")


@pytest.fixture
def card():
    """The CUDA card, or a skip: decided when a test runs, never while a
    module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the benchmark measures the port on "
                    "one); none on this machine")
    return torch.device("cuda", 0)
