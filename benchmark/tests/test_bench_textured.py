"""The textured configuration's cell, ``textured-render``: its manifest
entries, its frozen work count, and its run path with a fault and the
control, on the CPU (its maps cut to 64×64 and a 128×64 sky by the
configuration's own maker, the traffic conftest's :data:`SMALL` with
frame 0 alone checked); on the
card, a short run at the cell's size and the control there.
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from conftest import SMALL

from benchmark.harness import texdata, texwork, workcount

CPU = torch.device("cpu")
WORKLOAD = "textured-render"
SEED = 2_200_000_123
METRICS = {"roofline.render.textured", "launches.render.textured",
           "device_idle.render.textured", "host_ms.trace.render.textured"}
#: A control run's traffic: one warm-up frame, frame 0 alone checked.
CONTROL_TRAFFIC = {"warmup_frames": 1, "check_frames": 0}
#: The CPU runs' traffic: frame 0 alone checked, so that a window slowed by
#: other test workers still holds every checked frame.
TEX_SMALL = dict(SMALL, **CONTROL_TRAFFIC)


def _shrink(config):
    for spec in config["textures"].values():
        spec["shape"] = [64, 128] if "sky" in spec else [64, 64]
    return config


@pytest.fixture
def small_maps(monkeypatch):
    """The cell with its maps at 64×64 (the sky 128×64)."""
    from benchmark.harness import cell as cells

    resolve = cells.resolve

    def small(workload, root=cells.ROOT):
        c = resolve(workload, root)
        if workload == WORKLOAD:
            _shrink(c.config)
        return c

    monkeypatch.setattr(cells, "resolve", small)


def _run(trace=False, seed=SEED, traffic=TEX_SMALL, device=CPU, seconds=1.0):
    from benchmark import run

    return run.run_cell(WORKLOAD, seed, seconds, trace, device, traffic_overrides=traffic)


def reference_in_place(dtype, seed, small=True):
    """The reference in ``dtype``, on the maps of ``seed``, in the place of
    the tracer the render loop takes."""
    from benchmark import control
    from benchmark.harness import cell as cells
    from benchmark.reference import pathtrace as pt
    from benchmark.reference import scene as ref_scene
    from fspt_tpu_torch.ops import cuda_path

    c = cells.resolve(WORKLOAD)
    config = _shrink(c.config) if small else c.config
    scene = ref_scene.build(config["reference"]["scene"], texdata.make_maps(config, seed))

    def replacement(scene_pack, camera, cfg):
        tables = pt.Tables(scene, dtype, scene_pack.device)
        cam = pt.PinholeCamera(scene.camera, cfg.width, cfg.height)

        def trace(seed, sample0, lane0=0, n_lanes=None):
            L, n, d, m, s = pt.trace_frame(tables, cam, cfg.spp, cfg.max_depth, seed, sample0,
                                           c.traffic["check_block_lanes"])
            return SimpleNamespace(radiance=L.float(), aov_normal=n.float(),
                                   aov_depth=d.float(), aov_mat=m, segments=s.sum())

        return trace

    return control._swapped(cuda_path, "make_camera_path_tracer", replacement)


def test_the_manifest_resolves_the_cell():
    from benchmark.harness import cell as cells

    c = cells.resolve(WORKLOAD)
    assert c.entry["chips"] == 1 and c.entry["config"] == "textured_flagship_8k"
    assert c.traffic["driver"] == "render_textured"
    assert {e["name"] for e in c.end_to_end} == {"segments_per_s", "setup_s"}
    assert {m["name"] for m, _ in c.per_layer} == METRICS
    for m, _ in c.per_layer:
        assert m["workloads"] == [WORKLOAD] and m["moves"] == "segments_per_s"
    assert c.config["reduced"] == []
    assert texdata.texel_bytes(c.config) == c.config["texel_bytes"] == 1_610_612_736
    flagship = cells.resolve("flagship-render").traffic
    assert {k: v for k, v in c.traffic.items() if k not in ("driver", "why")} == {
        k: v for k, v in flagship.items() if k not in ("driver", "why")}


def test_the_frozen_work_count():
    """The frozen fetches a segment are the counted frame's, and each fetch
    adds one 32-byte sector to a render frame's bytes."""
    from benchmark.harness import cell as cells
    from benchmark.reference import scene as ref_scene

    assert texwork.SECTOR_BYTES == 32
    assert texwork.COUNTED_FETCHES > 0 and texwork.COUNTED_SEGMENTS > 0
    assert texwork.FETCHES_PER_SEGMENT == texwork.COUNTED_FETCHES / texwork.COUNTED_SEGMENTS
    assert 0.0 < texwork.FETCHES_PER_SEGMENT <= 1.0  # a slot fetches once at most
    config = _shrink(cells.resolve(WORKLOAD).config)
    rows = ref_scene.build(config["reference"]["scene"], texdata.make_maps(config, 1)).rows
    ops, nbytes = texwork.render_frame_work(1000, 400, 100, rows)
    w_ops, w_bytes = workcount.render_frame_work(1000, 400, 100, rows)
    assert ops == w_ops == 1000 * 300
    assert nbytes == w_bytes + 1000 * texwork.FETCHES_PER_SEGMENT * 32


def test_sound_run_is_correct(small_maps, capsys):
    from benchmark.harness import cell as cells

    result, numbers = _run()
    assert result["correct"], numbers
    assert result["failed"] == 0
    assert set(result["metrics"]) == {e["name"] for e in cells.resolve(WORKLOAD).end_to_end}
    err = capsys.readouterr().err
    assert "surface and" in err and "smooth texel pairs" in err


def test_traced_run_reports_its_metrics(small_maps):
    """A traced run on the CPU: the profiler holds no device operation, so
    only the host span's metric reads; the work counts the texel bytes."""
    result, numbers = _run(trace=True)
    assert result["correct"], numbers
    assert set(result["metrics"]) <= {"host_ms.trace.render.textured"}
    assert result["roofline_bound"]["ops"] > 0


def test_another_seeds_maps_are_not_correct(small_maps, monkeypatch):
    """The program given the maps of another seed than the reference's."""
    from benchmark.harness import cell as cells
    from fspt_tpu_torch.scene import samples

    other = texdata.make_maps(_shrink(cells.resolve(WORKLOAD).config), SEED + 1)
    monkeypatch.setitem(samples.SCENES, "textured_flagship",
                        lambda b, M, textures: samples.textured_flagship(b, M, other))
    result, numbers = _run()
    read = {name: value for name, value, _ in numbers}
    assert not result["correct"], numbers
    assert read["lane_mismatch"] > 0.05 and read["missing_frames"] == 0.0, read


def test_the_control_is_not_correct(small_maps):
    """The reference in bfloat16 in the program's place."""
    with reference_in_place(torch.bfloat16, SEED):
        result, numbers = _run()
    assert not result["correct"], numbers
    read = {name: value for name, value, _ in numbers}
    assert read["missing_frames"] == 0.0, read


def test_a_program_without_the_sample_fails_in_setup(small_maps, monkeypatch):
    """The parent's program has no textured_flagship sample: the run raises
    in set-up."""
    from fspt_tpu_torch.scene import samples

    monkeypatch.delitem(samples.SCENES, "textured_flagship")
    with pytest.raises(KeyError, match="textured_flagship"):
        _run()


@pytest.mark.gpu
def test_short_textured_run_is_correct(cuda_card):
    result, numbers = _run(device=cuda_card, traffic=None, seed=3_000_000_777, seconds=2.0)
    assert result["correct"], numbers
    assert result["device"]["platform"] == "gpu"


@pytest.mark.gpu
def test_the_control_is_not_correct_on_the_card(cuda_card, capsys):
    """The reference in bfloat16 in the program's place at the cell's size;
    the numbers it reads go to standard output."""
    with reference_in_place(torch.bfloat16, 3_000_000_779, small=False):
        result, numbers = _run(device=cuda_card, traffic=CONTROL_TRAFFIC, seed=3_000_000_779)
    with capsys.disabled():
        print("control (bfloat16):", {name: value for name, value, _ in numbers})
    assert not result["correct"], numbers
