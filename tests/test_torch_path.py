"""The plain versions of kernels 2 and 3, and the port's integrator, against
the reference's XLA integrator (which the reference's own tests pin to its
Pallas kernels).

All renders share one size (20×16, 2 spp, depth 6), so the reference's
eager XLA ops compile once per file.

Bar (tests/test_pallas_path.py:20-28): radiance within rtol 1e-4 / atol
1e-5, equal segment counts, equal material AOVs, depth at rtol 1e-4.  The
two packages run the same arithmetic, but torch's and XLA's float32
``sin``/``cos``/``tan``/``pow`` on the CPU may differ in the last bit; a lane
whose branch (``u0 < reflectivity``, a near-tie hit) flips on such a bit
follows another path.  So radiance must agree on ≥ 99.9 % of values, as the
reference allows for its DoF + fog test; everything else is exact or at the
stated tolerance.
"""

import numpy as np
import pytest
import torch

from conftest import build_cornell_box
from fspt_tpu.camera import generate_rays as ref_generate_rays
from fspt_tpu.config import RenderConfig as RefConfig
from fspt_tpu.render import integrator as ref_integrator
from fspt_tpu_torch import convert
from fspt_tpu_torch import materials as M
from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.ops import cuda_path
from fspt_tpu_torch.render import integrator
from fspt_tpu_torch.scene.builder import SceneBuilder

FRACTION = 0.999


def _np_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _port(b, camera=None):
    """Reference builder → (ref scene, ref camera, port scene, port camera)."""
    scene = b.compile()
    cam = camera if camera is not None else b.cameras[0]
    return (scene, cam, convert.scene_from_numpy(_np_tree(scene), device="cpu"),
            convert.camera_from_numpy(_np_tree(cam), device="cpu"))


def _compare(out, ref, frac=FRACTION, depth_rtol=1e-4):
    close = np.isclose(out.radiance.numpy(), np.asarray(ref.radiance),
                       rtol=1e-4, atol=1e-5)
    assert close.mean() >= frac, close.mean()
    assert int(out.segments) == int(ref.segments)
    np.testing.assert_array_equal(out.aov_mat.numpy(), np.asarray(ref.aov_mat))
    np.testing.assert_allclose(out.aov_depth.numpy(), np.asarray(ref.aov_depth),
                               rtol=depth_rtol)


def test_camera_fused_body_matches_integrator_specular():
    rs, rc, ps, pc = _port(build_cornell_box(with_specular=True))
    cfg = RenderConfig(width=20, height=16, spp=2, max_depth=6)
    out = cuda_path.make_camera_path_tracer(ps, pc, cfg)(7, 0)
    ref = ref_integrator.render_wavefront(rs, rc, RefConfig(**vars(cfg)), 7, 0)
    _compare(out, ref)


def test_camera_fused_body_with_dof_and_fog():
    b = build_cornell_box(with_specular=True, with_fog=True)
    cam = b.cameras[0]._replace(aperture_size=np.float32(1.5),
                                focal_depth=np.float32(110.0))
    rs, rc, ps, pc = _port(b, cam)
    cfg = RenderConfig(width=20, height=16, spp=2, max_depth=6)
    out = cuda_path.make_camera_path_tracer(ps, pc, cfg)(3, 2)
    ref = ref_integrator.render_wavefront(rs, rc, RefConfig(**vars(cfg)), 3, 2)
    close = np.isclose(out.radiance.numpy(), np.asarray(ref.radiance),
                       rtol=1e-4, atol=1e-5)
    assert close.mean() >= FRACTION, close.mean()


def test_camera_fused_band_split_is_exact():
    _, _, ps, pc = _port(build_cornell_box())
    cfg = RenderConfig(width=16, height=8, spp=1, max_depth=3)
    tracer = cuda_path.make_camera_path_tracer(ps, pc, cfg)
    full = tracer(5, 0)
    half = cfg.width * cfg.height // 2
    lower = tracer(5, 0, lane0=0, n_lanes=half)
    upper = tracer(5, 0, lane0=half, n_lanes=half)
    assert torch.equal(full.radiance, torch.cat([lower.radiance, upper.radiance]))
    assert torch.equal(full.aov_mat, torch.cat([lower.aov_mat, upper.aov_mat]))
    assert int(full.segments) == int(lower.segments) + int(upper.segments)


def test_rays_in_body_matches_trace_radiance():
    rs, rc, ps, _ = _port(build_cornell_box(with_specular=True))
    cfg = RenderConfig(width=20, height=16, spp=2, max_depth=6)
    start, seg, pix, smp = (np.array(x) for x in
                            ref_generate_rays(rc, cfg.width, cfg.height, cfg.spp, 7, 0))
    tracer = cuda_path.make_path_tracer(ps, cfg, z_far=float(np.asarray(rc.z_far)))
    t = torch.from_numpy
    out = tracer(t(start), t(seg), t(pix), t(smp), 7)
    ref = ref_integrator.trace_radiance(rs, RefConfig(**vars(cfg)), start, seg,
                                        pix, smp, 7, rc.z_far)
    _compare(out, ref)


@pytest.mark.parametrize("fast", [False, True])
def test_render_wavefront_matches_reference(fast):
    rs, rc, ps, pc = _port(build_cornell_box(with_specular=True, with_fog=True))
    cfg = RenderConfig(width=20, height=16, spp=2, max_depth=6, fast_render=fast)
    out = integrator.render_wavefront(ps, pc, cfg, 9, 4)
    ref = ref_integrator.render_wavefront(rs, rc, RefConfig(**vars(cfg)), 9, 4)
    _compare(out, ref)
    np.testing.assert_allclose(out.aov_normal.numpy(), np.asarray(ref.aov_normal),
                               rtol=1e-4, atol=1e-5)


def test_textured_scene_raises_and_bvh_scene_refused():
    """A textured scene takes the texture-deferred tracer (kernel 4); the
    rays-in tracer declines it, as the reference's does; a BVH-sized mesh
    compiles with a BVH, and both megakernel tracers refuse it (it takes
    the queued mesh path), as the reference's do."""
    b = SceneBuilder()
    tex = b.add_texture(np.ones((4, 4, 3), np.float32))
    b.add_sphere((0, 0, 0), 1.0, b.add_material(
        M.MaterialSpec(M.DIFFUSE, diffuse=(1, 1, 1), tex_id=tex)))
    scene = b.compile(device="cpu")
    cfg = RenderConfig(width=8, height=8, spp=1)
    cam = convert.camera_from_numpy(_np_tree(build_cornell_box().cameras[0]), device="cpu")
    tracer = cuda_path.make_camera_path_tracer(scene, cam, cfg)
    assert hasattr(tracer, "plain_planes")
    assert tracer(1, 0).radiance.shape == (64, 3)
    assert cuda_path.make_path_tracer(scene, cfg) is None
    tri = np.zeros((64, 3), np.float32)
    b.add_triangles(tri, tri + (1, 0, 0), tri + (0, 1, 0), 0)
    mesh = b.compile(device="cpu")
    assert mesh.bvh is not None and mesh.tri_shade.mat.shape == (64,)
    assert cuda_path.make_camera_path_tracer(mesh, cam, cfg) is None
    assert cuda_path.make_path_tracer(mesh, cfg) is None
