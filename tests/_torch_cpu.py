"""A fixture for the port's CPU tests: torch's intra-op pool at one thread.

pytest-xdist runs several test files side by side. Torch's default pool
takes every core in each worker, and its spinning threads then slow the
other workers' tests, the wall-clock budgets of ``tests/test_scale_slow.py``
among them. The tensors here are small, so one thread costs them little.

A test module takes it with ``from _torch_cpu import one_torch_thread``.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
