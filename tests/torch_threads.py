"""One intra-op torch thread per test module of the port.

The suite runs one process per core (pytest-xdist), and torch's default of
one intra-op thread per core then makes its many small ops wait on each
other: the port's mapper on a 10-view scene took ~900 s per run with six
such processes on eight cores, and 2.5 s with one thread each. Test modules
import the fixture, which restores the count after the module.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
