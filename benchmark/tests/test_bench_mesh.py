"""The mesh configuration: its reference pieces against plain constructions
and the program, and the ``heightfield-render`` cell's run path with its
faults and control, on the CPU.

The cell's runs here are at a small size: the traffic of conftest's
:data:`SMALL` with 8 checked rows and one warm-up frame, and the
heightfield at ``grid=12`` (242 triangles) on both sides, the program's
sample and the reference's description, so that the brute-force reference
and the program's plain walk take seconds.  The plain walk is a loop of
small torch calls, ~0.5 s a frame alone and ten times that beside other
test workers, so these runs check frame 0 alone: a window holds at least
that frame, however slow.
"""

from __future__ import annotations

import functools
import json

import numpy as np
import pytest
import torch

from conftest import ROOT, SMALL

from benchmark.reference import mesh as ref_mesh
from benchmark.reference import pathtrace as pt
from benchmark.reference import scene as ref_scene

CPU = torch.device("cpu")
WORKLOAD = "heightfield-render"
MESH_SMALL = dict(SMALL, check_rows=8, warmup_frames=1, check_frames=0)
GRID = 12


def _config():
    return json.loads((ROOT / "benchmark/configs/heightfield_100k.json").read_text())


@pytest.fixture
def small_mesh(monkeypatch):
    """Both sides of the cell at ``grid=GRID``."""
    from benchmark.harness import cell as cells
    from fspt_tpu_torch.scene import samples

    monkeypatch.setitem(samples.SCENES, "heightfield",
                        functools.partial(samples.heightfield, grid=GRID))
    resolve = cells.resolve

    def small(workload, root=ROOT):
        c = resolve(workload, root)
        if workload == WORKLOAD:
            c.config["reference"]["scene"]["mesh"]["grid"] = GRID
        return c

    monkeypatch.setattr(cells, "resolve", small)


def _run(trace=False, seed=2_200_000_123):
    from benchmark import run

    return run.run_cell(WORKLOAD, seed, 1.0, trace, CPU, traffic_overrides=MESH_SMALL)


def test_a_quad_as_two_triangles_gives_the_quads_hits():
    """The floor quad of the configuration as two triangles: the brute-force
    mesh and the analytic row give the same hits, t and normal."""
    desc = {"materials": {"m": {"color": [0.5, 0.5, 0.5]}}, "sky": None,
            "camera": {"origin": [0, 0, -10], "target": [0, 0, 0], "fov_y": 45.0},
            "primitives": [{"kind": "quad", "material": "m", "position": [-60, -30, -60],
                            "u": [120, 0, 0], "v": [0, 0, 120]}]}
    tables = pt.Tables(ref_scene.build(desc), torch.float64, CPU)
    a, u, v = (np.array(x, np.float32) for x in ([-60, -30, -60], [120, 0, 0], [0, 0, 120]))
    mesh = ref_mesh.Mesh(np.stack([a, a]), np.stack([a + u, a + u + v]),
                         np.stack([a + u + v, a + v]), 0, torch.float64, CPU)
    g = torch.Generator().manual_seed(3)
    start = torch.rand((4096, 3), generator=g, dtype=torch.float64) * 160.0 - 80.0
    seg = torch.randn((4096, 3), generator=g, dtype=torch.float64) * 200.0
    t_q, n_q, _, _ = pt.closest_hit(tables, start, seg)
    t_m, tri = mesh.closest(start, seg)
    hit = t_q < pt.INVALID
    assert int(hit.sum()) > 500
    assert torch.equal(hit, tri >= 0)
    torch.testing.assert_close(t_m[hit], t_q[hit], rtol=1e-12, atol=1e-12)
    flip = torch.where((mesh.normal[tri[hit]] * n_q[hit]).sum(-1) < 0.0, -1.0, 1.0)
    torch.testing.assert_close(mesh.normal[tri[hit]] * flip[:, None], n_q[hit])


def test_the_thin_lens_at_aperture_0_is_the_pinhole():
    """At aperture 0 the thin lens gives PinholeCamera's segments; at the
    configuration's aperture every lens segment passes through its pinhole
    segment's focal-plane point, from the lens disc, and has length
    z_far."""
    cam = _config()["reference"]["scene"]["camera"]
    lanes = torch.arange(0, 48 * 32 * 2, 7)
    h0 = pt.seed_prefix(2_200_000_123)
    pin = pt.PinholeCamera(dict(cam, aperture_size=0.0), 48, 32)
    lens0 = ref_mesh.ThinLensCamera(dict(cam, aperture_size=0.0), 48, 32)
    for a, b in zip(pin.rays(h0, lanes, 2, 4, torch.float64),
                    lens0.rays(h0, lanes, 2, 4, torch.float64)):
        assert torch.equal(a, b)
    lens = ref_mesh.ThinLensCamera(cam, 48, 32)
    s0, d0, _ = pin.rays(h0, lanes, 2, 4, torch.float64)
    s1, d1, _ = lens.rays(h0, lanes, 2, 4, torch.float64)
    fn = torch.tensor(lens.focal_normal)
    focus = s0 + d0 * (-(s0 @ fn + lens.focal_w) / (d0 @ fn))[:, None]
    off = s1 - s0
    assert float(off.norm(dim=-1).max()) <= 1.5 + 1e-9 and float(off.norm(dim=-1).max()) > 0.5
    along = ((focus - s1) * d1).sum(-1) / (d1 * d1).sum(-1)
    torch.testing.assert_close(s1 + d1 * along[:, None], focus)
    torch.testing.assert_close(d1.norm(dim=-1), torch.full_like(along, lens.z_far))


def test_the_reference_mesh_is_the_programs():
    """The reference's own evaluation of the heightfield formula gives the
    program's triangles bit for bit (vertex order and values), and its
    materials and sky are the program's rows."""
    from benchmark.harness import program

    config = _config()
    config["reference"]["scene"]["mesh"]["grid"] = 40
    config["program"] = {"sample": "heightfield"}
    from fspt_tpu_torch.scene import samples

    b = samples.build("heightfield", device=CPU, grid=40)
    scene = b.compile(device=CPU)
    v0, v1, v2 = ref_mesh.heightfield(config["reference"]["scene"]["mesh"])
    order = np.argsort(scene.bvh.tri_id.numpy())
    assert np.array_equal(scene.bvh.tri_v0.numpy()[order], v0)
    assert np.array_equal(scene.bvh.tri_e1.numpy()[order], v1 - v0)
    assert np.array_equal(scene.bvh.tri_e2.numpy()[order], v2 - v0)
    tables = pt.Tables(ref_scene.from_config(config, ROOT), torch.float32, CPU)
    prog, _ = program.program_scene(ROOT, _config(), CPU)
    assert int(prog.sky_mat) == tables.sky
    assert torch.equal(prog.materials.mtype.long(), tables.family)
    assert torch.equal(prog.materials.diffuse, tables.diffuse)
    assert torch.equal(prog.materials.emissive, tables.emissive)
    assert int(scene.tri_shade.mat[0]) == ref_mesh.mesh_from_config(config, torch.float32, CPU).mat


def test_the_program_agrees_with_the_reference():
    """Kernel 13's plain version against the reference on every lane of a
    48×32×2 frame at grid 40, under the render LIMITS, its segments
    equal."""
    from benchmark.reference import render as ref_render
    from fspt_tpu_torch.config import RenderConfig
    from fspt_tpu_torch.ops import cuda_path
    from fspt_tpu_torch.scene import samples

    config = _config()
    config["reference"]["scene"]["mesh"]["grid"] = 40
    b = samples.build("heightfield", device=CPU, grid=40)
    tracer = cuda_path.make_camera_path_tracer(b.compile(device=CPU), b.cameras[0],
                                               RenderConfig(width=48, height=32, spp=2,
                                                            max_depth=4))
    scene = ref_scene.from_config(config, ROOT)
    mesh = ref_mesh.mesh_from_config(config, torch.float32, CPU)
    cam = ref_mesh.ThinLensCamera(scene.camera, 48, 32)
    out = tracer(3_000_000_123, 6)
    ref = ref_mesh.reference_band(scene, mesh, cam, 2, 4, 3_000_000_123, 3, range(32),
                                  torch.float32, CPU)
    fb = ref_render.empty_framebuffer(32, 48, CPU)
    prog = dict(radiance=out.radiance, normal=out.aov_normal, depth=out.aov_depth,
                mat=out.aov_mat, segments=int(out.segments), before=fb,
                after=ref_render.accumulate(fb, out.radiance, out.aov_normal, out.aov_depth,
                                            out.aov_mat, 32, 48, 2))
    numbers = ref_render.judge_frame(prog, ref, 32, 48, 2)
    for key, value in numbers.items():
        assert value <= ref_render.LIMITS[key], (key, value)
    assert numbers["segments_gap"] == 0.0


def test_sound_run_is_correct(small_mesh):
    from benchmark.harness import cell as cells

    result, numbers = _run()
    assert result["correct"], numbers
    assert result["failed"] == 0
    assert set(result["metrics"]) == {e["name"] for e in cells.resolve(WORKLOAD).end_to_end}
    assert set(result["metrics"]) == {"setup_s", "segments_per_s"}


def test_traced_run_reports_its_metrics(small_mesh):
    """A traced run on the CPU: the profiler holds no device operation, so
    only the host span's metric reads."""
    result, numbers = _run(trace=True)
    assert result["correct"], numbers
    assert set(result["metrics"]) <= {"host_ms.trace.render.heightfield"}
    assert result["roofline_bound"]["ops"] > 0


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch", "answer_altered"])
def test_fault_is_not_correct(small_mesh, fault):
    from benchmark import control_mesh

    with control_mesh.planted(WORKLOAD, fault):
        result, numbers = _run()
    assert not result["correct"], numbers
    assert result["failed"] >= 1


def test_the_control_is_not_correct(small_mesh):
    """The reference in bfloat16 in the program's place, on the control's
    traffic (one warm-up frame, frame 0 checked)."""
    from benchmark import control_mesh, run

    with control_mesh.reference_in_place(WORKLOAD, torch.bfloat16):
        result, numbers = run.run_cell(WORKLOAD, 2_200_000_123, 1.0, False, CPU,
                                       traffic_overrides=dict(MESH_SMALL,
                                                              **control_mesh.CONTROL_TRAFFIC))
    assert not result["correct"], numbers
    read = {name: value for name, value, _ in numbers}
    assert read["missing_frames"] == 0.0, read


def test_a_program_without_the_mesh_tracer_fails_in_setup(small_mesh, monkeypatch):
    """The parent's program gives no camera tracer for a BVH scene: the run
    raises in set-up."""
    from fspt_tpu_torch.ops import cuda_path

    monkeypatch.setattr(cuda_path, "make_camera_path_tracer", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="no camera-fused tracer"):
        _run()


def test_the_mesh_reference_loads_nothing_of_the_program():
    """``reference/mesh.py`` in a clean interpreter loads neither JAX nor
    the program (the import statements of every reference file are held
    by test_bench_isolation.py)."""
    from test_bench_isolation import FORBIDDEN, _tops

    tops = _tops("import benchmark.reference.mesh", reference_only=True)
    assert "torch" in tops
    assert not tops & (FORBIDDEN | {"fspt_tpu_torch"}), sorted(tops)


def test_the_mesh_work_count_by_hand():
    from benchmark.harness import meshwork, workcount

    rows = ref_scene.from_config(_config(), ROOT).rows
    assert meshwork.box_tests(99_458) == 30 and meshwork.box_tests(4) == 0
    assert meshwork.segment_ops(rows, 99_458) == 2 * 19 + 30 * 30 + 4 * 55
    ops, nbytes = meshwork.render_frame_work(1000, 400, 100, rows, 99_458)
    assert ops == 1000 * 1158
    assert nbytes == workcount.render_frame_work(1000, 400, 100, rows)[1]


@pytest.mark.gpu
def test_short_mesh_run_is_correct(cuda_card):
    from benchmark import run

    result, numbers = run.run_cell(WORKLOAD, 3_000_000_777, 2.0, False, cuda_card)
    assert result["correct"], numbers
    assert result["device"]["platform"] == "gpu"
