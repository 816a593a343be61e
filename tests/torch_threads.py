"""A module-scoped fixture that runs a test module's torch ops on one
thread. The port's CPU tests work on toy trees: with the suite split over
parallel workers, several torch threads per op only wait on one another
(the store-dispatch test of ``test_torch_refine.py`` took 200 times its
single-worker time)."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
