"""On the card (skipped elsewhere): a short run of every cell comes out
correct, and the lower-precision control at the cell's own size does not.

    python -m pytest -m gpu benchmark/tests/test_bench_gpu.py -q
"""

from __future__ import annotations

import pytest
import torch

from conftest import WORKLOADS


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_short_run_is_correct(cuda_card, workload):
    from benchmark import run

    result, numbers = run.run_cell(workload, 3_000_000_777, 2.0, False, cuda_card)
    assert result["correct"], numbers
    assert result["device"]["platform"] == "gpu"


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct_on_the_card(cuda_card, workload):
    from benchmark import control, run

    overrides = {"check_within": [1, 4]} if "render" in workload else None
    with control.reference_in_place(workload, torch.bfloat16):
        result, numbers = run.run_cell(workload, 3_000_000_778, 2.0, False, cuda_card,
                                       traffic_overrides=overrides)
    assert not result["correct"], numbers
