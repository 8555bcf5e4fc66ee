"""The frozen work counts: held to counts worked out by hand, and the
flagship's to what the program's own count gives today."""

from __future__ import annotations

import json

import pytest

from conftest import ROOT

from benchmark.harness import workcount
from benchmark.reference import scene as ref_scene


def _tiny():
    """One sphere, one quad and one cuboid: 1 + 1 + 6 rows."""
    desc = {"materials": {"m": {"color": [0.5, 0.5, 0.5]}}, "sky": None,
            "camera": {"origin": [0, 0, -10], "target": [0, 0, 0], "fov_y": 45.0},
            "primitives": [
                {"kind": "sphere", "material": "m", "position": [0, 0, 0], "radius": 1.0},
                {"kind": "quad", "material": "m", "position": [0, 0, 0], "u": [1, 0, 0],
                 "v": [0, 1, 0]},
                {"kind": "cuboid", "material": "m", "position": [3, 0, 0], "width": 1,
                 "height": 1, "depth": 1}]}
    return ref_scene.build(desc).rows


def test_segment_ops_by_hand():
    # sphere 36, quad 19, six cuboid faces 6 × 19
    assert workcount.segment_ops(_tiny()) == 36 + 19 + 6 * 19


def test_render_frame_work_by_hand():
    rows = _tiny()
    ops, nbytes = workcount.render_frame_work(segments=1000, lanes=400, pixels=100, rows=rows)
    assert ops == 1000 * 169
    # lanes: 36 written + 32 read back; pixels: 48 read + 48 written
    assert nbytes == 400 * 68 + 100 * 96


def test_recover_step_work_by_hand():
    rows = _tiny()
    ops, nbytes = workcount.recover_step_work(2000, 50, rows, ("diffuse", "emissive"))
    assert (ops, nbytes) == (2000 * 169, 50 * 12)
    # a field that moves geometry: the reverse sweep adds twice the
    # cheapest row test (a plane-like row, 19) per segment
    ops, _ = workcount.recover_step_work(2000, 50, rows, ("diffuse", "param"))
    assert ops == 2000 * (169 + 2 * 19)


def test_least_time_and_its_bound():
    t, by = workcount.least_time(67e12, 1.0)
    assert by == "operations" and t == pytest.approx(1.0)
    t, by = workcount.least_time(1.0, 3.35e12)
    assert by == "bytes" and t == pytest.approx(1.0)


def test_flagship_count_equals_the_programs_today():
    """The frozen table and the reference's rows give the count the
    program's ``HostScene.segment_ops`` gives for the same scene."""
    import torch

    from fspt_tpu_torch.ops.cuda_trace import HostScene
    from fspt_tpu_torch.scene import samples

    config = json.loads((ROOT / "benchmark/configs/cornell_flagship.json").read_text())
    rows = ref_scene.from_config(config, ROOT).rows
    program = HostScene(samples.build("flagship", device=torch.device("cpu"))
                        .compile(device=torch.device("cpu")).geometry)
    assert workcount.segment_ops(rows) == program.segment_ops() == 300
    assert len(rows) == program.prim_count == 14
