"""A share of the host's cores for torch's intra-op pool while a port test
module runs.

torch sizes its intra-op pool to every core of the host. Under pytest-xdist
each worker process does so, and the port's heavy CPU tests (k-means over
ResNet-18, full-width forwards) then run that many threads per worker on
the same cores: 6 workers on 8 cores ran ``test_make_family_cli_calib``
and ``test_profile_command_runs_a_family`` about 20x slower than alone.
Each port test module takes the fixture below (imported under a private
name, it is autouse), which gives torch its share of the cores, the cores
over the xdist workers (all of them in a run without xdist), and restores
the pool's size after the module.
"""

import os

import pytest
import torch


def thread_share() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // max(1, workers))


@pytest.fixture(autouse=True, scope="module")
def torch_thread_cap():
    before = torch.get_num_threads()
    torch.set_num_threads(thread_share())
    try:
        yield torch.get_num_threads()
    finally:
        torch.set_num_threads(before)
