"""The plain reference against the program's plain PyTorch versions on the
CPU, at sizes the CPU holds: the same scene tables, the same frames, the
same recovery steps.  (On the card the benchmark's own check holds the
kernels to the reference at the timed sizes.)"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import ROOT

from benchmark.harness import program
from benchmark.reference import pathtrace as pt
from benchmark.reference import recover as ref_recover
from benchmark.reference import render as ref_render
from benchmark.reference import scene as ref_scene

CPU = torch.device("cpu")
CONFIGS = ("cornell_flagship", "cornell_textured")

#: The textured Cornell box, with the repository's small test textures: no
#: cell renders it (its textures are too small to stand for a user's), but
#: the reference's texture path is held to the program's here.
TEXTURED = {
    "name": "cornell_textured",
    "program": {
        "scene_file": "scenes/cornell.scene",
        "textured_cornell": {"wall_texture": "tests/data/piz_pattern.exr",
                             "sky_texture": "tests/data/piz_dome.exr", "wall_scale": 0.02,
                             "write_to": "build/benchmark/cornell_textured.scene"}},
    "reference": {
        "scene_file": "scenes/cornell.scene",
        "textures": {
            "red": {"texels": "tests/data/piz_pattern_gold.npy", "scale": 0.02},
            "green": {"texels": "tests/data/piz_pattern_gold.npy", "scale": 0.02},
            "ambient": {"texels": "tests/data/piz_dome_gold.npy", "scale": 1.0}}},
}


def _config(name):
    if name == TEXTURED["name"]:
        return TEXTURED
    return json.loads((ROOT / f"benchmark/configs/{name}.json").read_text())


@pytest.mark.parametrize("name", CONFIGS)
def test_material_tables_agree(name):
    config = _config(name)
    scene, _ = program.program_scene(ROOT, config, CPU)
    ref = pt.Tables(ref_scene.from_config(config, ROOT), torch.float32, CPU)
    assert int(scene.sky_mat) == ref.sky
    assert torch.equal(scene.materials.mtype.long(), ref.family)
    for col in ("diffuse", "emissive", "param"):
        assert torch.equal(getattr(scene.materials, col), getattr(ref, col)), col
    assert torch.equal(scene.materials.tex_id.long(), ref.tex_id)
    if ref.textured:
        assert torch.equal(scene.textures.texels, ref.texels)


@pytest.mark.parametrize("name", CONFIGS)
def test_frames_agree(name):
    """Radiance, AOVs and segments of two frames at 96×64×2, depth 8."""
    from fspt_tpu_torch.config import RenderConfig
    from fspt_tpu_torch.ops import cuda_path

    config = _config(name)
    scene, camera = program.program_scene(ROOT, config, CPU)
    cfg = RenderConfig(width=96, height=64, spp=2, max_depth=8)
    tracer = cuda_path.make_camera_path_tracer(scene, camera, cfg)
    rs = ref_scene.from_config(config, ROOT)
    cam = pt.PinholeCamera(rs.camera, 96, 64)
    for frame in (0, 7):
        out = tracer(3_000_000_123, frame * 2)
        L, n, d, m, s = ref_render.reference_frame(rs, cam, 2, 8, 3_000_000_123, frame, 1 << 14,
                                                   torch.float32, CPU)
        fb = ref_render.empty_framebuffer(64, 96, CPU)
        prog = dict(radiance=out.radiance, normal=out.aov_normal, depth=out.aov_depth,
                    mat=out.aov_mat, segments=int(out.segments), before=fb,
                    after=ref_render.accumulate(fb, out.radiance, out.aov_normal,
                                                out.aov_depth, out.aov_mat, 64, 96, 2))
        numbers = ref_render.judge_frame(prog, (L, n, d, m, s), 64, 96, 2)
        for key, value in numbers.items():
            assert value <= ref_render.LIMITS[key], (key, value)
        assert numbers["segments_gap"] == 0.0


@pytest.mark.parametrize("pool,fields", [(1, ("diffuse", "emissive")),
                                         (8, ("diffuse", "emissive", "param"))])
def test_recovery_steps_agree(pool, fields):
    """Three steps of the program's fused recovery step and the reference's
    follow, from the same start, at 48×32×2, depth 8."""
    from fspt_tpu_torch.config import RenderConfig
    from fspt_tpu_torch.parallel import train

    config = _config("cornell_flagship")
    scene, camera = program.program_scene(ROOT, config, CPU)
    cfg = RenderConfig(width=48, height=32, spp=2, max_depth=8)
    rs = ref_scene.from_config(config, ROOT)
    cam = pt.PinholeCamera(rs.camera, 48, 32)
    target = ref_recover.target_image(rs, cam, 2, 8, 5, 2, 16, torch.float32, CPU)
    rng = np.random.default_rng(5)
    start = {"diffuse": (scene.materials.diffuse * torch.from_numpy(
        rng.uniform(0.6, 1.4, (7, 3)).astype(np.float32))).clamp(0, 1),
        "emissive": scene.materials.emissive * 0.7, "param": scene.materials.param * 0.6}
    start = {k: start[k] for k in fields}
    traffic = dict(spp=2, max_depth=8, pool=pool, lr=0.02,
                   constraints={"diffuse": [0.0, 1.0], "emissive": [0.0, None]})
    step = train.make_fused_recovery_step(None, scene, camera, cfg, fields=fields, pool=pool,
                                          optimizer=lambda ps: torch.optim.Adam(ps, lr=0.02))
    params, state, losses = dict(start), step.init(start), []
    for i in range(3):
        params, state, loss = step(params, state, scene, camera, target, 6, i)
        losses.append(float(loss))
    ref = ref_recover.follow(rs, cam, traffic, 6, start, target, 3, 16, torch.float32)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    change = ref_recover.leaf_gaps({k: params[k] - start[k] for k in fields},
                                   {k: ref["values"][k] - start[k] for k in fields})
    assert max(change.values()) < 1e-5


def test_leaf_diffs_see_a_gradient_turned_about():
    """A leaf whose sign is flipped keeps its norm: the gap of norms reads
    0, the norm of the difference twice the leaf's norm."""
    ref = {"diffuse": torch.tensor([[0.3, -0.2, 0.1]] * 7), "emissive": torch.ones(7, 3),
           "param": torch.full((7,), 2.0)}
    prog = dict(ref, diffuse=-ref["diffuse"])
    assert max(ref_recover.leaf_gaps(prog, ref).values()) < 1e-12
    diffs = ref_recover.leaf_diffs(prog, ref)
    assert diffs["emissive"] == diffs["param"] == 0.0
    # against the median leaf's norm (the emission's), the larger here
    assert diffs["diffuse"] == pytest.approx(
        2 * float(torch.linalg.vector_norm(ref["diffuse"].double())) / 21 ** 0.5)
