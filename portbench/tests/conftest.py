"""Markers and fixtures of the benchmark's own tests (``python -m pytest
portbench/tests``). Tests that need the card carry the repo's ``cuda``
marker and ask for the ``card`` fixture, which skips without one."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU and nvcc (lemon_tpu_torch kernels); skips elsewhere")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from lemon_tpu_torch.core.device import resolve_device

    return resolve_device("cuda")
