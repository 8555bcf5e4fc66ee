"""The port's one-device recovery steps (parallel/train.py) against the
reference's ``make_recovery_step`` (on the planar differentiable path, and
its default branch: autograd of the whole renderer), the kernel-8 and
kernel-9/10 routes through their plain versions, and the port examples.

Bar: parameters after three SGD steps at rtol 1e-3 (the gradients' own bar,
tests/test_pallas_grad.py:153-159; the steps move the parameters by
lr·grad, so they inherit it).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import build_cornell_box
from fspt_tpu.config import RenderConfig as RefConfig
from fspt_tpu.ops.diff_path import make_image_fn
from fspt_tpu.parallel import make_mesh
from fspt_tpu.parallel.train import make_recovery_step as ref_make_recovery_step
from fspt_tpu.parallel.train import render_image_rows as ref_render_image_rows
from fspt_tpu_torch import convert
from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.examples import (recover_albedo, recover_camera, recover_texture,
                                     recover_vertices, recover_vertices_bvh)
from fspt_tpu_torch.ops import cuda_grad
from fspt_tpu_torch.parallel import train


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(specular=True, **cfg_kw):
    b = build_cornell_box(with_specular=specular)
    scene, cam = b.compile(), b.cameras[0]
    cfg = RenderConfig(**cfg_kw)
    ps = convert.scene_from_numpy(_np_tree(scene), device="cpu")
    pc = convert.camera_from_numpy(_np_tree(cam), device="cpu")
    r = np.random.default_rng(0)
    start = {"diffuse": np.clip(np.asarray(scene.materials.diffuse)
                                * r.uniform(0.5, 1.5, (scene.materials.count, 3)), 0, 1),
             "emissive": np.asarray(scene.materials.emissive) * 0.6}
    start = {k: v.astype(np.float32) for k, v in start.items()}
    target = r.random((cfg.height, cfg.width, 3), dtype=np.float32)
    return scene, cam, ps, pc, cfg, start, target


def test_sgd_steps_match_reference_recovery_step():
    # The reference step compiles its whole planar value_and_grad: a small
    # scene and depth keep that compile short.
    scene, cam, ps, pc, cfg, start, target = _setup(specular=False, width=16, height=8,
                                                    spp=2, max_depth=2)
    rcfg = RefConfig(**vars(cfg))
    di = make_image_fn(scene, rcfg, z_far=float(np.asarray(cam.z_far)))

    def render_fn(params, sc, camera, seed, frame_idx, y0, rows):
        img, _ = di(sc.materials._replace(**params), camera, seed, frame_idx, y0, rows)
        return img

    ref_step = ref_make_recovery_step(make_mesh(1), rcfg, render_fn=render_fn, pool=8)
    ref_params = {k: jnp.asarray(v) for k, v in start.items()}
    step = train.make_fused_recovery_step(None, ps, pc, cfg, pool=8)
    params = convert.params_from_numpy(start, device="cpu")
    for it in range(3):
        ref_params, ref_loss = ref_step(ref_params, scene, cam, jnp.asarray(target), 5, it)
        params, loss = step(params, ps, pc, torch.from_numpy(target), 5, it)
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-3, atol=1e-9)
    for k in start:
        assert not np.allclose(np.asarray(ref_params[k]), start[k]), k  # they moved
        np.testing.assert_allclose(params[k].numpy(), np.asarray(ref_params[k]),
                                   rtol=1e-3, atol=1e-6, err_msg=k)


def test_pool_1_step_takes_the_fused_loss_route():
    _, _, ps, pc, cfg, start, target = _setup(width=16, height=8, spp=2, max_depth=3)
    params = convert.params_from_numpy(start, device="cpu")
    tgt = torch.from_numpy(target)
    step = train.make_fused_recovery_step(None, ps, pc, cfg, pool=1, lr=0.5)
    new, loss = step(params, ps, pc, tgt, 5, 2)
    # The kernel-8 front door (its plain version on the CPU) gives exactly
    # this loss and step; the kernel-7 route would pool spp-averaged pixels.
    fused = cuda_grad.make_fused_loss_grad_fn(ps, pc, cfg)
    f_loss, grads, _ = fused(params, tgt, 5, 2, 0, cfg.height)
    assert float(loss) == float(f_loss)
    for k in params:
        box = train.DEFAULT_CONSTRAINTS[k]
        np.testing.assert_array_equal(new[k].numpy(),
                                      (params[k] - 0.5 * grads[k]).clamp(*box).numpy())


def test_recovery_refuses_what_later_slices_bring():
    _, _, ps, pc, cfg, _, _ = _setup(width=8, height=8, spp=1, max_depth=2)
    with pytest.raises(NotImplementedError, match="torch.distributed"):
        train.make_recovery_step(object(), cfg, render_fn=lambda *a: None)
    # The default branch (autograd of the renderer) and the path-body
    # adjoint's requests now build steps; the camera needs construction 1,
    # as in the reference (fspt_tpu/parallel/train.py:248-251).
    assert callable(train.make_recovery_step(None, cfg))
    with pytest.raises(ValueError, match="camera recovery needs the fused loss kernel"):
        train.make_fused_recovery_step(None, ps, pc, cfg, fields=("diffuse", "camera"))
    assert callable(train.make_fused_recovery_step(None, ps, pc, cfg,
                                                   fields=("diffuse", "camera"), pool=1))
    assert callable(train.make_fused_recovery_step(None, ps, pc, cfg, fields=("param",),
                                                   pool=4))


def test_default_step_is_autograd_of_render_image_rows():
    """The default branch: the pooled dual-buffer loss of two
    ``render_image_rows`` renders of ``_apply_params(scene, params)`` and its
    torch autograd step (whose gradients the next test holds against
    ``jax.grad`` of the reference's ``render_image_rows``)."""
    _, _, ps, pc, cfg, start, target = _setup(specular=False, width=8, height=8, spp=2,
                                              max_depth=3)
    params = convert.params_from_numpy(start, device="cpu")
    tgt = torch.from_numpy(target)
    new, loss = train.make_recovery_step(None, cfg, pool=4, lr=0.5)(params, ps, pc, tgt, 5, 1)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    scene = train._apply_params(ps, leaves)
    img_a = train.render_image_rows(scene, pc, cfg, 5, 1, 0, cfg.height)
    img_b = train.render_image_rows(scene, pc, cfg, 5, 1 + 10007, 0, cfg.height)
    ref = (train._pool(img_a - tgt, 4) * train._pool(img_b - tgt, 4)).mean()
    grads = dict(zip(leaves, torch.autograd.grad(ref, list(leaves.values()))))
    assert float(loss) == float(ref.detach())
    for k in params:
        assert float(grads[k].abs().max()) > 0, k
        want = (params[k] - 0.5 * grads[k]).clamp(*train.DEFAULT_CONSTRAINTS[k])
        np.testing.assert_array_equal(new[k].numpy(), want.detach().numpy())


@pytest.mark.parametrize("column,spp,scale,probe", [
    ("diffuse", 4, 1.0, (0, 0)), ("emissive", 2, 0.8, (3, 1)),
])
def test_render_image_rows_gradients_match_reference_and_fd(column, spp, scale, probe):
    """tests/test_grad.py:50-79 at its sizes: the gradient of ``mean((img -
    target)²)`` through ``render_image_rows`` against ``jax.grad`` of the
    reference's, and one central difference of the port's own loss."""
    b = build_cornell_box()
    scene, cam = b.compile(), b.cameras[0]
    cfg = RenderConfig(width=8, height=8, spp=spp, max_depth=3)
    rcfg = RefConfig(**vars(cfg))
    ref_target = ref_render_image_rows(scene, cam, rcfg, seed=9, frame_idx=1, y0=0,
                                       rows=cfg.height) * scale

    def ref_loss(value):
        s = scene._replace(materials=scene.materials._replace(**{column: value}))
        img = ref_render_image_rows(s, cam, rcfg, seed=5, frame_idx=0, y0=0, rows=cfg.height)
        return jnp.mean((img - ref_target) ** 2)

    ref_g = np.asarray(jax.grad(ref_loss)(getattr(scene.materials, column)))
    ps = convert.scene_from_numpy(_np_tree(scene), device="cpu")
    pc = convert.camera_from_numpy(_np_tree(cam), device="cpu")
    target = train.render_image_rows(ps, pc, cfg, 9, 1, 0, cfg.height) * scale

    def loss(value):
        s = train._apply_params(ps, {column: value})
        img = train.render_image_rows(s, pc, cfg, 5, 0, 0, cfg.height)
        return ((img - target) ** 2).mean()

    value = getattr(ps.materials, column).clone().requires_grad_()
    (g,) = torch.autograd.grad(loss(value), [value])
    assert np.abs(ref_g).max() > 0
    np.testing.assert_allclose(g.numpy(), ref_g, rtol=1e-3, atol=1e-7)
    h = 1e-2
    e = torch.zeros_like(value)
    e[probe] = h
    with torch.no_grad():
        fd = (float(loss(value + e)) - float(loss(value - e))) / (2 * h)
    np.testing.assert_allclose(float(g[probe]), fd, rtol=2e-3)


def test_pool_8_scalar_field_step_takes_kernels_9_10():
    """Construction 2: the step's loss and update are those of the pooled
    dual-buffer loss through ``make_grad_image_fn`` (kernels 9-10, plain on
    the CPU)."""
    _, _, ps, pc, cfg, start, target = _setup(width=16, height=8, spp=2, max_depth=3)
    fields = ("diffuse", "param")
    params = {"diffuse": torch.from_numpy(start["diffuse"]),
              "param": ps.materials.param.clone()}
    tgt = torch.from_numpy(target)
    step = train.make_fused_recovery_step(None, ps, pc, cfg, fields=fields, pool=8, lr=0.5)
    new, loss = step(params, ps, pc, tgt, 5, 2)
    gi = cuda_grad.make_grad_image_fn(ps, pc, cfg, fields=fields)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    img_a, _ = gi(leaves, 5, 2, 0, cfg.height)
    img_b, _ = gi(leaves, 5, 2 + 10007, 0, cfg.height)
    ref = (train._pool(img_a - tgt, 8) * train._pool(img_b - tgt, 8)).mean()
    grads = dict(zip(fields, torch.autograd.grad(ref, list(leaves.values()))))
    assert float(loss) == float(ref.detach())
    assert float(grads["param"].abs().max()) > 0
    box = train.DEFAULT_CONSTRAINTS
    for k in fields:
        want = params[k] - 0.5 * grads[k]
        if k in box:
            want = want.clamp(*box[k])
        np.testing.assert_array_equal(new[k].numpy(), want.detach().numpy())


def test_recover_camera_loss_falls_on_the_cpu(tmp_path):
    res = recover_camera.run(["--device", "cpu", "--width", "24", "--height", "24",
                              "--iters", "12", "--coarse-spp", "8", "--fine-spp", "2",
                              "--target-frames", "4", "--grad-frames", "2",
                              "--out", str(tmp_path / "cam")])
    assert res["loss_end"] < res["loss_start"], res
    assert res["origin_err_end"] < res["origin_err_start"], res


# Sample counts of the camera example's stages, cut to a CPU run's size; the
# BVH vertex example at its smallest grid, without its convergence check
# (two iterations cannot converge).
TINY_ARGS = {recover_camera: ["--coarse-spp", "4", "--fine-spp", "2", "--target-frames", "2",
                              "--grad-frames", "1"],
             recover_vertices_bvh: ["--grid", "7", "--no-check"]}


@pytest.mark.parametrize("example,outputs", [
    (recover_albedo, ("target.png", "recovered.png")),
    (recover_texture, ("_render.png", "_target.png")),
    (recover_camera, ("target.png", "recovered.png")),
    (recover_vertices, ("target.png", "recovered.png")),
    (recover_vertices_bvh, ()),
])
def test_examples_run_on_the_cpu(example, outputs, tmp_path, capsys):
    out = str(tmp_path / "out")
    rc = example.main(["--device", "cpu", "--width", "16", "--height", "12", "--iters", "2"]
                      + (["--out", out] if outputs else []) + TINY_ARGS.get(example, []))
    assert rc == 0
    printed = capsys.readouterr().out
    assert printed.count("iter ") == 2
    for name in outputs:
        path = os.path.join(out, name) if not name.startswith("_") else out + name
        assert os.path.getsize(path) > 0, path
