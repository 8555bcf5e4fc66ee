"""The port's differentiable planar path (fspt_tpu_torch/ops/diff_path.py),
the autograd reference of its gradient kernels, against the reference's XLA
``ops/diff_path.py`` under ``jax.grad``.

Bars, the reference's own: radiance within rtol 1e-4 / atol 1e-5 with equal
segment counts (tests/test_pallas_path.py:20-28); material gradients within
rtol 1e-3 / atol 1e-7 (tests/test_pallas_grad.py:57); camera gradients within
rtol 2e-3 (tests/test_pallas_grad.py:345).  On the all-families view the
ior and frost gradients of ``mean(img²)`` are below 1e-7 (a refracted ray
bends, but what it lands on shades alike nearby), the reflectivity gradient
is 0 (it only picks a lobe), and the roughness (``param``) gradient carries
the signal of the scalar fields.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import build_cornell_box
from fspt_tpu import materials as RM
from fspt_tpu.camera import Camera as RefCamera
from fspt_tpu.config import RenderConfig as RefConfig
from fspt_tpu.ops import diff_path as ref_diff_path
from fspt_tpu.scene.builder import SceneBuilder as RefBuilder
from fspt_tpu_torch import convert
from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.ops import diff_path
from fspt_tpu_torch.ops.cuda_path import camera_from_pvec, camera_pvec
from fspt_tpu_torch.scene import samples

FIELDS = ("diffuse", "emissive", "param", "ior", "reflectivity", "frost")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(scene, cam):
    return (convert.scene_from_numpy(_np_tree(scene), device="cpu"),
            convert.camera_from_numpy(_np_tree(cam), device="cpu"))


def _grads(loss, leaves):
    """``torch.autograd.grad`` with zeros for leaves the loss does not reach
    (the reference's ``jax.grad`` gives zeros there)."""
    gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return {k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(leaves.items(), gs)}


@pytest.fixture(scope="module")
def all_families_grads():
    """Image and table gradients of ``mean(img²)`` on the all-families scene,
    32×32, 2 spp, depth 4: the reference's under ``jax.grad`` and the port's
    under torch autograd."""
    b = RefBuilder()
    samples.SCENES["all_families"](b, RM)
    scene = b.compile()
    cam = RefCamera.create(origin=samples.CAMERA_ORIGIN, aperture_size=0.0)
    cfg = RenderConfig(width=32, height=32, spp=2, max_depth=4)
    z_far = float(np.asarray(cam.z_far))
    ref_fn = ref_diff_path.make_image_fn(scene, RefConfig(**vars(cfg)), z_far=z_far)

    def ref_loss(p):
        img, segs = ref_fn(scene.materials._replace(**p), cam, 5, 0, 0, cfg.height)
        return jnp.mean(img ** 2), (img, segs)

    params = {k: getattr(scene.materials, k) for k in FIELDS}
    (_, (ref_img, ref_segs)), ref_g = jax.value_and_grad(ref_loss, has_aux=True)(params)

    ps, pc = _port(scene, cam)
    img_fn = diff_path.make_image_fn(ps, cfg, z_far=z_far)
    leaves = {k: getattr(ps.materials, k).clone().requires_grad_() for k in FIELDS}
    img, segs = img_fn(ps.materials._replace(**leaves), pc, 5, 0, 0, cfg.height)
    grads = _grads((img ** 2).mean(), leaves)
    return dict(ref_img=np.asarray(ref_img), ref_segs=int(ref_segs), ref_g=_np_tree(ref_g),
                img=img.detach().numpy(), segs=int(segs), grads=grads)


def test_radiance_matches_reference_specular():
    b = build_cornell_box(with_specular=True)
    scene, cam = b.compile(), b.cameras[0]
    cfg = RenderConfig(width=8, height=8, spp=2, max_depth=3)
    z_far = float(np.asarray(cam.z_far))
    ref = ref_diff_path.make_diff_path(scene, RefConfig(**vars(cfg)), z_far=z_far)(
        scene.materials, cam, 5, 2)
    ps, pc = _port(scene, cam)
    out = diff_path.make_diff_path(ps, cfg, z_far=z_far)(ps.materials, pc, 5, 2)
    np.testing.assert_allclose(out.radiance.numpy(), np.asarray(ref.radiance), rtol=1e-4,
                               atol=1e-5)
    assert int(out.segments) == int(ref.segments)
    np.testing.assert_array_equal(out.aov_mat.numpy(), np.asarray(ref.aov_mat))


def test_all_families_image_matches_reference(all_families_grads):
    r = all_families_grads
    assert r["segs"] == r["ref_segs"]
    np.testing.assert_allclose(r["img"], r["ref_img"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("field", FIELDS)
def test_material_gradients_match_reference(all_families_grads, field):
    r = all_families_grads
    ref = np.asarray(r["ref_g"][field])
    if field in ("diffuse", "emissive", "param"):
        assert np.abs(ref).max() > 1e-3, field
    np.testing.assert_allclose(r["grads"][field].numpy(), ref, rtol=1e-3, atol=1e-7,
                               err_msg=field)


def test_camera_gradients_match_reference_thin_lens():
    """The reference test's thin-lens camera (tests/test_pallas_grad.py:313-314):
    aperture > 0 runs the depth-of-field code, so all nine camera scalars get
    a gradient of the lane-level dual-buffer loss (summed, not averaged, so
    that atol stays far below every entry's size)."""
    b = build_cornell_box(with_specular=True)
    scene = b.compile()
    cam = RefCamera.create(origin=(3.0, -2.0, -140.0), target=(1.0, 0.5, 0.0),
                           aperture_size=1.5, focal_depth=120.0)
    cfg = RenderConfig(width=16, height=12, spp=2, max_depth=3)
    z_far = float(np.asarray(cam.z_far))
    target = np.random.default_rng(2).random((cfg.height, cfg.width, 3), dtype=np.float32)
    tgt_lane = np.repeat(target.reshape(-1, 3), cfg.spp, axis=0)
    planar = ref_diff_path.make_diff_path(scene, RefConfig(**vars(cfg)), z_far=z_far)

    def ref_loss(cv):
        c = cam._replace(origin=cv[0:3], target=cv[3:6], fov_y=cv[6], aperture_size=cv[7],
                         focal_depth=cv[8])
        a = planar(scene.materials, c, 5, 3 * cfg.spp).radiance
        bb = planar(scene.materials, c, 5, (3 + 10007) * cfg.spp).radiance
        return jnp.sum((a - tgt_lane) * (bb - tgt_lane))

    cvec = jnp.concatenate([cam.origin, cam.target, jnp.stack([
        cam.fov_y, cam.aperture_size, cam.focal_depth])])
    ref_v, ref_g = jax.value_and_grad(ref_loss)(cvec)

    ps, pc = _port(scene, cam)
    trace = diff_path.make_diff_path(ps, cfg, z_far=z_far)
    leaf = camera_pvec(pc).requires_grad_()
    c = camera_from_pvec(pc, leaf)
    tl = torch.from_numpy(tgt_lane)
    a = trace(ps.materials, c, 5, 3 * cfg.spp).radiance
    bb = trace(ps.materials, c, 5, (3 + 10007) * cfg.spp).radiance
    loss = ((a - tl) * (bb - tl)).sum()
    (g,) = torch.autograd.grad(loss, [leaf])
    np.testing.assert_allclose(float(loss.detach()), float(ref_v), rtol=1e-5)
    assert np.abs(np.asarray(ref_g)).min() > 1e-5  # every camera scalar moves it
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), rtol=2e-3, atol=1e-7)


def test_remat_equals_plain_backward():
    b = build_cornell_box(with_specular=True)
    scene, cam = b.compile(), b.cameras[0]
    ps, pc = _port(scene, cam)
    cfg = RenderConfig(width=8, height=8, spp=2, max_depth=3)
    out = {}
    for remat in (False, True):
        img_fn = diff_path.make_image_fn(ps, cfg, z_far=float(pc.z_far), remat=remat)
        leaves = {k: getattr(ps.materials, k).clone().requires_grad_()
                  for k in ("diffuse", "emissive", "param")}
        cv = camera_pvec(pc).requires_grad_()
        img, segs = img_fn(ps.materials._replace(**leaves), camera_from_pvec(pc, cv), 5, 1, 0,
                           cfg.height)
        g = _grads((img ** 2).mean(), {**leaves, "camera": cv})
        out[remat] = (img.detach(), int(segs), g)
    (img0, s0, g0), (img1, s1, g1) = out[False], out[True]
    assert torch.equal(img0, img1) and s0 == s1
    for k in g0:
        assert float(g0[k].abs().max()) > 0, k
        assert torch.equal(g0[k], g1[k]), k


@pytest.mark.parametrize("name", ["textured", "heightfield"])
def test_declines_textured_and_bvh_scenes(name):
    kw = dict(grid=10) if name == "heightfield" else {}
    b = samples.build(name, device="cpu", **kw)
    scene = b.compile(device="cpu")
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=2)
    assert diff_path.make_diff_path(scene, cfg) is None
    assert diff_path.make_image_fn(scene, cfg) is None
