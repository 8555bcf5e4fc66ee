"""The port's one-device recovery steps (parallel/train.py) against the
reference's ``make_recovery_step`` on the planar differentiable path, the
kernel-8 route through its plain version, and the two port examples.

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
from fspt_tpu_torch import convert
from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.examples import recover_albedo, recover_texture
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
    with pytest.raises(NotImplementedError, match="diff_path"):
        train.make_recovery_step(None, cfg)
    with pytest.raises(NotImplementedError, match="path-body-adjoint"):
        train.make_fused_recovery_step(None, ps, pc, cfg, fields=("diffuse", "camera"))
    with pytest.raises(NotImplementedError, match="path-body-adjoint"):
        train.make_fused_recovery_step(None, ps, pc, cfg, fields=("param",), pool=4)


@pytest.mark.parametrize("example,outputs", [
    (recover_albedo, ("target.png", "recovered.png")),
    (recover_texture, ("_render.png", "_target.png")),
])
def test_examples_run_on_the_cpu(example, outputs, tmp_path, capsys):
    out = str(tmp_path / "out")
    rc = example.main(["--device", "cpu", "--width", "16", "--height", "12",
                       "--iters", "2", "--out", out])
    assert rc == 0
    printed = capsys.readouterr().out
    assert printed.count("iter ") == 2
    for name in outputs:
        path = os.path.join(out, name) if not name.startswith("_") else out + name
        assert os.path.getsize(path) > 0, path
