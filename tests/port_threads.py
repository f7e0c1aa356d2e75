"""A module fixture for the port's test files: one intra-op torch thread
while a module's tests run. The suite runs in parallel worker
processes, and torch's default of one thread per core oversubscribes
the CPU several times over (a port test file ran 3-6x slower under it).
Each `tests/test_torch_*.py` imports it, which registers it there."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
