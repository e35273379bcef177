"""A fixture for the port's test modules whose plain kernels run many tiny
torch ops on the CPU (a Myers step per char and word, a k-means step per
iteration).

Under ``pytest -n N`` each worker process runs torch at its default
intra-op thread count, one thread per core, so N workers oversubscribe
the cores N-fold; on tiny ops the threads' hand-offs then dominate (the
sole-device growth case: 19 s alone, 680 s each in six concurrent
processes at 8 threads, 30 s each at 1 thread, on an 8-core host).  In a
worker this fixture gives torch its share of the cores for the module
and puts the old count back at its end; a run without xdist keeps the
default.  Import it into a test module::

    from torch_threads import torch_threads_per_worker  # noqa: F401
"""

import os

import pytest


@pytest.fixture(autouse=True, scope="module")
def torch_threads_per_worker():
    import torch

    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    if workers <= 1:
        yield
        return
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)
