"""The port's torch integrator against the reference's scalar NumPy oracle
(fspt_tpu/render/oracle.py), on the seven cases of
tests/test_integrator_vs_oracle.py:36-105, with their scenes, sizes, seeds
and bars.

Both renderers consume identical counter-based RNG streams, so the images
must match to float32 accumulation tolerance, not just statistically.  The
port runs ``render_step`` (brute-force intersection, plain torch) on the
CPU; the scene and camera come from the reference builder through
``convert``; the oracle renders the reference builder itself.
"""

import numpy as np
import pytest
import torch

from conftest import assert_images_close, build_cornell_box
from fspt_tpu.config import RenderConfig as RefConfig
from fspt_tpu.render import oracle
from fspt_tpu_torch import convert
from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.render import framebuffer as fb_mod
from fspt_tpu_torch.render import integrator

CPU = torch.device("cpu")


def _np_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _render_both(builder, cfg, seed, frames=1):
    scene = convert.scene_from_numpy(_np_tree(builder.compile()), device=CPU)
    camera = convert.camera_from_numpy(_np_tree(builder.cameras[0]), device=CPU)
    fb = fb_mod.create(cfg.height, cfg.width, device=CPU)
    total_segments = 0
    for frame in range(frames):
        fb, segs = integrator.render_step(scene, camera, cfg, fb, seed, frame)
        total_segments += int(segs)
    img_oracle, aux = oracle.render(builder, builder.cameras[0], RefConfig(**vars(cfg)), seed,
                                    frames=frames)
    return fb.mean.numpy(), img_oracle, fb, aux, total_segments


def test_cornell_diffuse_matches_oracle():
    builder = build_cornell_box()
    cfg = RenderConfig(width=24, height=16, spp=2, max_depth=4)
    img, img_oracle, fb, aux, segs = _render_both(builder, cfg, seed=7)
    assert_images_close(img, img_oracle, rtol=2e-3, atol=2e-4, frac=0.999)
    # Segment metric agrees (no fog in this scene → exact).
    assert segs == aux["segments"]
    # AOVs: depth and material id of the last sample.
    np.testing.assert_allclose(fb.depth.numpy(), aux["depth"], rtol=1e-4)
    np.testing.assert_array_equal(fb.mat.numpy(), aux["mat"])
    np.testing.assert_allclose(fb.normal.numpy(), aux["normal"], atol=1e-4)


@pytest.mark.parametrize("scene,size,depth,seed", [
    ("specular", (20, 14), 6, 11),
    ("fog", (16, 12), 4, 3),
])
def test_specular_and_fog_match_oracle(scene, size, depth, seed):
    builder = build_cornell_box(**{f"with_{scene}": True})
    cfg = RenderConfig(width=size[0], height=size[1], spp=2, max_depth=depth)
    img, img_oracle, _, _, _ = _render_both(builder, cfg, seed=seed)
    assert_images_close(img, img_oracle, rtol=5e-3, atol=5e-4, frac=0.995)


def test_fast_render_mode():
    builder = build_cornell_box()
    cfg = RenderConfig(width=16, height=12, spp=1, fast_render=True)
    img, img_oracle, _, _, _ = _render_both(builder, cfg, seed=5)
    assert_images_close(img, img_oracle, rtol=2e-3, atol=2e-4, frac=0.999)


def test_progressive_accumulation_matches():
    """Multi-frame accumulation equals the oracle's running mean."""
    builder = build_cornell_box()
    cfg = RenderConfig(width=12, height=8, spp=1, max_depth=3)
    img, img_oracle, fb, _, _ = _render_both(builder, cfg, seed=13, frames=3)
    assert_images_close(img, img_oracle, rtol=2e-3, atol=2e-4, frac=0.999)
    assert float(fb.count[0, 0]) == 3.0


def test_depth_of_field_camera():
    builder = build_cornell_box()
    builder.cameras[0] = builder.cameras[0]._replace(
        aperture_size=np.float32(1.5), focal_depth=np.float32(110.0))
    cfg = RenderConfig(width=12, height=8, spp=2, max_depth=2)
    img, img_oracle, _, _, _ = _render_both(builder, cfg, seed=17)
    assert_images_close(img, img_oracle, rtol=2e-3, atol=2e-4, frac=0.999)


def test_light_clamp():
    """A >10-radiance light hit at depth 0 is tone-clamped (engine.cpp:148-151)."""
    from fspt_tpu import materials as M
    from fspt_tpu.camera import Camera
    from fspt_tpu.materials import MaterialSpec
    from fspt_tpu.scene.builder import SceneBuilder

    b = SceneBuilder()
    hot = b.add_material(MaterialSpec(M.LIGHT, emissive=(40.0, 40.0, 40.0)))
    b.add_sphere((0, 0, 0), 20.0, hot)
    b.add_camera(Camera.create(origin=(0, 0, -100), aperture_size=0.0))
    cfg = RenderConfig(width=8, height=6, spp=1)
    img, img_oracle, _, _, _ = _render_both(b, cfg, seed=1)
    assert_images_close(img, img_oracle, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(img[3, 4]), 10.0, rtol=1e-3)
