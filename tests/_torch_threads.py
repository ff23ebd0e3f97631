"""One intra-op thread for a port test module's CPU work.

Under ``pytest -n 6`` on an eight-core host each worker's PyTorch starts
one intra-op thread a core, so six modules of port tests ask for 48
threads, and every OpenMP region of a module waits for threads the
scheduler has parked.  On an 8-core host beside six busy 8-thread
processes ``test_torch_lm_step.py``'s example test took 149 s on
PyTorch's 8 threads, 100 s on 2 and 48 s on 1 (7.4 s on 1 thread with
the host idle).  A module that imports ``one_torch_thread`` runs its
tests on one thread and gives the count back after them.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
