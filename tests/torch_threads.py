"""One intra-op thread for the port's CPU tests: an autouse fixture that each
``tests/test_torch_*.py`` module imports (not a test module itself).

The port's tests run many small torch ops beside JAX, while the suite runs
several test workers at once.  An op that fans out over every core then
waits on threads that the other workers keep busy, and the waiting threads
spin: a test runs several times slower than on one thread.  Module scope, so
that module-scoped fixtures (shared JAX and port runs) get it too.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
