"""Shared fixtures of the benchmark's own tests.

Run from the root of the checkout: ``python -m pytest benchmark/tests -q``
(the ``gpu``-marked tests skip without a CUDA card).  The tests put the
checkout on ``sys.path`` themselves and import neither JAX nor ``fspt_tpu``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: A cell's traffic cut to a size the CPU runs in a second or two: the
#: program's plain PyTorch versions stand in for its kernels there.
SMALL = {"width": 48, "height": 32, "spp": 2, "max_depth": 4, "check_within": [1, 3],
         "check_block_lanes": 8192, "check_block_rows": 16, "trace_iterations": 2}

WORKLOADS = ("flagship-render", "flagship-recover-pool1", "flagship-recover-pool8")


@pytest.fixture
def cuda_card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def run_small(workload, seed=2_200_000_123, seconds=1.0, trace=False):
    """One run of ``workload`` on the CPU at :data:`SMALL`."""
    import torch

    from benchmark import run

    return run.run_cell(workload, seed, seconds, trace, torch.device("cpu"),
                        traffic_overrides=SMALL)
