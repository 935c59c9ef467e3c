"""An autouse fixture for the port's multi-device tests: torch on one
intra-op thread during each test, restored after.

Under pytest-xdist each worker's torch starts one intra-op thread per core,
and six workers on eight cores then spin against each other: a Mode B run
on four logical CPU devices, whose batch is many small operators, took
217 s under six such processes against 1.9 s with one thread each. Import
it into a test module to use it."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
