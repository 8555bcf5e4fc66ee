"""The benchmark's run path with the timed path broken underneath: each
fault a cell can have must come out not correct, and the sound run correct.

The runs skip only the look for a card: they drive ``run_cell`` on the CPU,
where the program's plain versions stand in for its kernels, at a small
size.  One chip, so no cell has an exchange between chips to leave out.
"""

from __future__ import annotations

import pytest
import torch

from conftest import WORKLOADS, run_small


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    from benchmark.harness import cell as cells

    result, numbers = run_small(workload)
    assert result["correct"], numbers
    assert result["failed"] == 0
    assert set(result["metrics"]) == {e["name"] for e in cells.resolve(workload).end_to_end}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch", "answer_altered"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_fault_is_not_correct(workload, fault):
    from benchmark import control

    with control.planted(workload, fault):
        result, numbers = run_small(workload)
    assert not result["correct"], numbers
    assert result["failed"] >= 1


def test_the_control_is_not_correct():
    """The reference in bfloat16 in the program's place, in every cell."""
    from benchmark import control

    for workload in WORKLOADS:
        with control.reference_in_place(workload, torch.bfloat16):
            result, numbers = run_small(workload)
        assert not result["correct"], (workload, numbers)


def test_a_gradient_turned_about_fails_only_its_direction():
    """The pool-1 fault keeps the albedo gradient's norm: the gap of norms
    lets it pass, the norm of the difference does not."""
    from benchmark import control

    with control.planted("flagship-recover-pool1", "answer_altered"):
        result, numbers = run_small("flagship-recover-pool1")
    read = {name: (value, limit) for name, value, limit in numbers}
    assert read["first_grad_gap"][0] <= read["first_grad_gap"][1], read
    assert read["first_grad_diff"][0] > read["first_grad_diff"][1], read
    assert not result["correct"]
