"""The relbench tests share the host with other test workers: pin each to
one thread, so that a run's timing does not depend on how many threads
every worker starts."""
import pytest
import torch


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
