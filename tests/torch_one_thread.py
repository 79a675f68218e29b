"""One torch intra-op thread for the port's test files.

Each ``tests/test_torch_*.py`` imports :func:`one_torch_thread`, an
autouse fixture of module scope: while the file's tests run, torch's CPU
kernels use one thread, and the count is restored after the file.  Under
``pytest -n 6`` every worker would otherwise start one OpenMP thread per
core, six times the cores in all, and torch's small operators then spend
most of their time waiting at barriers for threads the kernel has not
scheduled.  The rank workers and the gang tools hold their ranks to one
thread for the same reason.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
