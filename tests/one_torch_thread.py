"""A fixture for the port's CPU test files: each file's tests run on one
PyTorch intra-op thread, restored after the file.

The suite runs in several worker processes on one host (``-n 6 --dist
loadfile``); with PyTorch's default of a thread a core in each, the
port's small CPU ops spend most of their time contending for the cores.
Import it into a test module (``from one_torch_thread import
one_torch_thread``); pytest applies an autouse fixture found in the
module's namespace to every test there.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
