"""PyTorch port tests: one intra-op thread while a port test runs.

Tier-1 runs six pytest workers on a shared machine.  The port's CPU
tests drive loops of small torch operations, and with torch's default
intra-op pool (a thread a core) the workers' pools contend for the same
cores: beside ten busy processes, 3 calls of the space-by-time dataset
path at 4 x 400 x 4 took 90 s on eight threads against 0.9 s on one
(0.9 s and 0.7 s on an idle machine).  Each port test module imports
:func:`one_torch_thread`, an autouse fixture that runs each of its
tests on one intra-op thread and restores the count afterwards.  The
tests hold the port to the JAX package within tolerances far above what
the thread count can change in a sum's order.
"""

import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def test_port_tests_run_on_one_intra_op_thread():
    assert torch.get_num_threads() == 1
