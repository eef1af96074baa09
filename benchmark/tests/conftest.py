"""Few CPU threads a test process: the CPU tests run several workers."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    torch.set_num_threads(2)
