"""A module-scoped cap on torch's intra-op threads for the port's CPU
training tests.

The tier-1 run puts six test processes on one machine. At torch's
default of one intra-op thread a core, a file that trains a model on the
CPU oversubscribes the cores and starves the timing-bound tests running
beside it (the service daemon's worker processes miss their 0.15 s
heartbeats in ``tests/test_failover.py``). Two threads keep these files
quick without that. The previous count is restored after the module.
"""

import pytest
import torch

TORCH_THREADS = 2


@pytest.fixture(scope='module', autouse=True)
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(TORCH_THREADS, before))
    yield
    torch.set_num_threads(before)
