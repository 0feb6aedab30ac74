"""One intra-op thread for the port's CPU tests.

The suite runs several pytest workers on the CPU at once.  A torch pool of
one thread per core in each of them oversubscribes the cores, and every
parallel region then waits for threads that the other workers hold: the
port's full-width ParamNerf init takes 0.25 s with eight threads on an idle
8-core machine, 32 s with eight threads beside seven busy processes, and
0.46 s with one.  A test module imports ``one_torch_thread``; pytest runs
it around the module, and the processes the module spawns inherit
OMP_NUM_THREADS=1."""

import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads, omp = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(threads)
    if omp is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = omp
