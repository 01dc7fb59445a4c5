"""One PyTorch intra-op thread for a port test module.

The port's CPU paths are many small tensor ops. In a pytest-xdist worker
beside five others on the same cores, PyTorch's intra-op thread pool costs
more than it gains: on an 8-core CPU with every core busy, a [16, 7, 512]
plain multiply took 13 ms on one thread and 1.9 s on eight, and the idle
spinning of those threads also slows the JAX compiles running in the other
workers. Every port test module imports the autouse fixture below; it sets
one thread for the module's tests and restores the setting after."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
