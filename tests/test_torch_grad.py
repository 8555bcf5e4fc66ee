"""The gradient front doors of the port (kernels 7 and 8, plain versions on
the CPU) against the reference's planar differentiable path
(ops/diff_path.py) under ``jax.value_and_grad``, which the reference's own
tests pin to its kernels 7-8 (tests/test_pallas_grad.py:128-252), and
against central differences.

Bars, the reference's own: images at the path bar (rtol 1e-4 / atol 1e-5 on
≥ 99.9 % of values: a last-bit ``sin``/``cos`` difference between torch and
XLA can flip a lane's branch), gradients at rtol 1e-3 / atol 1e-7
(tests/test_pallas_grad.py:153-159: the affine fold sums the path in
another order than the planar chain), the fused loss at rtol 1e-5, the
texel gradient within 2e-2 of central differences (float32 steps).
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
from fspt_tpu.ops.diff_path import make_diff_path, make_image_fn
from fspt_tpu.scene.builder import SceneBuilder as RefBuilder
from fspt_tpu_torch import convert
from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.ops import cuda_grad

FRACTION = 0.999


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(b, **cfg_kw):
    scene, cam = b.compile(), b.cameras[0]
    cfg = RenderConfig(**cfg_kw)
    ps = convert.scene_from_numpy(_np_tree(scene), device="cpu")
    pc = convert.camera_from_numpy(_np_tree(cam), device="cpu")
    return scene, cam, ps, pc, cfg


def _leaves(ps, names=("diffuse", "emissive")):
    return {k: getattr(ps.materials, k).clone().requires_grad_() for k in names}


def test_affine_image_and_grads_match_planar_reference():
    scene, cam, ps, pc, cfg = _setup(build_cornell_box(with_specular=True),
                                     width=16, height=16, spp=2, max_depth=4)
    di = make_image_fn(scene, RefConfig(**vars(cfg)), z_far=float(np.asarray(cam.z_far)))

    def loss_d(p):
        img, segs = di(scene.materials._replace(**p), cam, 5, 0, 0, cfg.height)
        return jnp.mean(img ** 2), (img, segs)

    params = {"diffuse": scene.materials.diffuse, "emissive": scene.materials.emissive}
    (vd, (img_d, seg_d)), gd = jax.value_and_grad(loss_d, has_aux=True)(params)

    gi = cuda_grad.make_affine_grad_image_fn(ps, pc, cfg)
    leaves = _leaves(ps)
    img, segs = gi(leaves, 5, 0, 0, cfg.height)
    loss = (img ** 2).mean()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert int(segs) == int(seg_d)
    close = np.isclose(img.detach().numpy(), np.asarray(img_d), rtol=1e-4, atol=1e-5)
    assert close.mean() >= FRACTION, close.mean()
    np.testing.assert_allclose(float(loss.detach()), float(vd), rtol=1e-5)
    for name, g in zip(leaves, grads):
        assert np.abs(np.asarray(gd[name])).max() > 0, name
        np.testing.assert_allclose(g.numpy(), np.asarray(gd[name]), rtol=1e-3,
                                   atol=1e-7, err_msg=name)


def _textured_floor():
    """The reference test's textured scene (tests/test_pallas_grad.py:178)."""
    b = RefBuilder()
    tex = np.stack(np.meshgrid(np.linspace(0.2, 0.9, 8),
                               np.linspace(0.3, 0.8, 8))[:1] * 3,
                   axis=-1).reshape(8, 8, 3).astype(np.float32)
    tid = b.add_texture(tex)
    mat = b.add_material(RM.MaterialSpec(RM.DIFFUSE, diffuse=(1, 1, 1), tex_id=tid,
                                         tex_scale=1.0))
    light = b.add_material(RM.MaterialSpec(RM.LIGHT, emissive=(9.0, 9.0, 9.0)))
    sky = b.add_material(RM.MaterialSpec(RM.LIGHT, emissive=(0.1, 0.2, 0.3)))
    b.set_sky(sky)
    b.add_quad_uv((-40, -10, -40), (80, 0, 0), (0, 0, 80), mat)
    b.add_quad_uv((-15, 30, -15), (30, 0, 0), (0, 0, 30), light)
    b.add_camera(RefCamera.create(origin=(0, 20, -70), target=(0, -5, 0),
                                  aperture_size=0.0))
    return b


def test_texel_gradient_matches_central_differences():
    _, _, ps, pc, cfg = _setup(_textured_floor(), width=12, height=12, spp=2,
                               max_depth=3)
    gi = cuda_grad.make_affine_grad_image_fn(ps, pc, cfg)
    texels0 = ps.textures.texels

    def loss(texels):
        img, _ = gi({"texels": texels}, 5, 0, 0, cfg.height)
        return (img ** 2).mean()

    leaf = texels0.clone().requires_grad_()
    (g,) = torch.autograd.grad(loss(leaf), [leaf])
    gn = g.numpy()
    ti, tc = np.unravel_index(np.abs(gn).argmax(), gn.shape)
    eps = 1e-2
    dv = torch.zeros_like(texels0)
    dv[ti, tc] = eps
    with torch.no_grad():
        fd = (float(loss(texels0 + dv)) - float(loss(texels0 - dv))) / (2 * eps)
    np.testing.assert_allclose(float(gn[ti, tc]), fd, rtol=2e-2, atol=1e-6)


def test_fused_loss_matches_lane_level_planar_reference():
    scene, cam, ps, pc, cfg = _setup(build_cornell_box(with_specular=True),
                                     width=16, height=12, spp=2, max_depth=3)
    rcfg = RefConfig(**vars(cfg))
    trace = make_diff_path(scene, rcfg, z_far=float(np.asarray(cam.z_far)))
    target = np.random.default_rng(0).random((cfg.height, cfg.width, 3),
                                             dtype=np.float32)
    tgt_lane = jnp.repeat(jnp.asarray(target).reshape(-1, 3), cfg.spp, axis=0)

    def ref_loss(p, f0):
        table = scene.materials._replace(**p)
        a = trace(table, cam, 5, f0 * cfg.spp)
        b = trace(table, cam, 5, (f0 + 10007) * cfg.spp)
        loss = jnp.mean((a.radiance - tgt_lane) * (b.radiance - tgt_lane))
        return loss, a.segments + b.segments

    params = {"diffuse": scene.materials.diffuse, "emissive": scene.materials.emissive}
    (ref_v, ref_segs), ref_g = jax.value_and_grad(ref_loss, has_aux=True)(params, 3)

    fused = cuda_grad.make_fused_loss_grad_fn(ps, pc, cfg)
    loss, grads, segs = fused({k: getattr(ps.materials, k) for k in params},
                              torch.from_numpy(target), 5, 3, 0, cfg.height)
    np.testing.assert_allclose(float(loss), float(ref_v), rtol=1e-5)
    assert int(segs) == int(ref_segs)
    for k in params:
        assert np.abs(np.asarray(ref_g[k])).max() > 0, k
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(ref_g[k]), rtol=1e-3,
                                   atol=1e-8, err_msg=k)


@pytest.mark.parametrize("front_door", ["affine_image", "fused_loss"])
def test_band_split_gradients_sum_to_full_frame(front_door):
    _, _, ps, pc, cfg = _setup(build_cornell_box(), width=16, height=8, spp=1,
                               max_depth=3)
    if front_door == "affine_image":
        gi = cuda_grad.make_affine_grad_image_fn(ps, pc, cfg)

        def band_grads(y0, rows):
            leaves = _leaves(ps)
            img, _ = gi(leaves, 5, 0, y0, rows)
            return dict(zip(leaves, torch.autograd.grad((img ** 2).sum(),
                                                        list(leaves.values()))))
    else:
        fused = cuda_grad.make_fused_loss_grad_fn(ps, pc, cfg)
        target = torch.from_numpy(np.random.default_rng(1).random(
            (cfg.height, cfg.width, 3), dtype=np.float32))
        params = {k: getattr(ps.materials, k) for k in ("diffuse", "emissive")}

        def band_grads(y0, rows):
            # Undo the per-call 1/(3n) so bands add up.
            _, grads, _ = fused(params, target[y0:y0 + rows], 5, 0, y0, rows)
            return {k: g * (3 * rows * cfg.width * cfg.spp) for k, g in grads.items()}

    full = band_grads(0, 8)
    lower, upper = band_grads(0, 4), band_grads(4, 4)
    for k in full:
        assert float(full[k].abs().max()) > 0, k
        np.testing.assert_allclose((lower[k] + upper[k]).numpy(), full[k].numpy(),
                                   rtol=1e-4, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("kwargs", [
    dict(fields=("diffuse", "param")), dict(fields=("ior",)),
    dict(fields=("diffuse", "camera")), dict(affine=False), dict(remat=True),
])
def test_fused_loss_refuses_path_adjoint_requests(kwargs):
    _, _, ps, pc, cfg = _setup(build_cornell_box(), width=8, height=8, spp=1,
                               max_depth=2)
    with pytest.raises(NotImplementedError, match="path-body-adjoint"):
        cuda_grad.make_fused_loss_grad_fn(ps, pc, cfg, **kwargs)


def test_pack_params_round_trip():
    _, _, ps, _, _ = _setup(build_cornell_box(), width=8, height=8)
    mats = ps.materials
    fields = ("glow", "diffuse", "frost")
    params = {"diffuse": mats.diffuse, "glow": mats.glow, "frost": mats.frost}
    pvec = cuda_grad.pack_params(params, fields)
    assert pvec.shape == (cuda_grad.param_count(mats, fields),)
    back = cuda_grad.unpack_params(pvec, mats, fields)
    for k in fields:
        assert torch.equal(back[k], params[k]), k


def test_fused_loss_takes_fields_in_any_order():
    """The reference's kernels read the packed vector in canonical column
    order whatever order ``fields`` names (pallas_grad.py:_TableView); the
    port's kernel 8 takes each column by name, so the order is free."""
    _, _, ps, pc, cfg = _setup(build_cornell_box(), width=8, height=8, spp=1,
                               max_depth=3)
    target = torch.full((cfg.height, cfg.width, 3), 0.3)
    params = {k: getattr(ps.materials, k) for k in ("diffuse", "emissive")}
    got = {}
    for fields in (("diffuse", "emissive"), ("emissive", "diffuse")):
        fused = cuda_grad.make_fused_loss_grad_fn(ps, pc, cfg, fields=fields)
        got[fields] = fused(params, target, 5, 1, 0, cfg.height)
    (la, ga, _), (lb, gb, _) = got.values()
    assert float(la) == float(lb)
    for k in params:
        assert torch.equal(ga[k], gb[k]), k
