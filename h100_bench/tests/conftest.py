"""pytest settings of the benchmark's own tests: the ``cuda`` marker of
the tests that need an NVIDIA card, which skip elsewhere (each decides in
its fixture, at run time)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'cuda: needs a CUDA device; skipped where there is none')


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (run on the card)')
    return 'cuda'
