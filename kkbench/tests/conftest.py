import pytest
import torch


@pytest.fixture(autouse=True)
def _few_threads():
    """The suite runs several workers at once: two threads each keeps
    these CPU fits from crowding one another out."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
