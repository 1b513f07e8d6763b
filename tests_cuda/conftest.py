"""CUDA test tier: tests that need an NVIDIA card and ``nvcc``.

Run on a machine with a card, from the repository root:

    python -m pytest tests_cuda -q -o addopts=""

(``-o addopts=""`` drops the repository's default xdist flag.)  Tier-1
(``tests/``) does not collect this directory.  Without a card every test
here is skipped, with the reason; whether there is a card is decided in a
fixture, never while a module is imported.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card and nvcc (the tests_cuda tier)"
    )


@pytest.fixture(autouse=True, scope="session")
def _require_cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("cuda tier: no CUDA device (the kernel runs only on the card)")
    # the plain twin is the kernel's oracle: its Gram product in IEEE fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
