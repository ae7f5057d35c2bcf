"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
root of the checkout. CPU tests run the harness at small sizes on the
port's plain twins; tests marked ``gpu`` decide inside the test whether a
card is there."""

import os
import sys

import pytest
import torch

# few threads a test process: the tests run in parallel workers
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the cells at sizes a CPU test can hold: above the Morton search's dense
# branch (512 bodies), a few segments and epochs
SMALL = {
    "rollout": {"n_bodies": 1500, "segment_steps": 6, "samples": 2},
    "train": {"n_bodies": 1500, "snapshots": 4, "target_sources": 256},
}


@pytest.fixture
def small():
    return SMALL


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
