"""Differentiable recovery on one device: gradient steps on scene parameters.

Port of fspt_tpu/parallel/train.py for one device: optimize material albedo,
emission, glow or texels so the rendered image matches a target (the
reference's BASELINE configs 4-5).  The reference shards rays over a device
mesh and ``pmean``-reduces the gradients; this slice takes ``mesh=None``
only, and the sharded form comes with the port's parallel slice.

The renderers differentiated here are the gradient kernels of
ops/cuda_grad.py: kernel 8 (the fused dual-buffer loss) and kernel 7 (the
affine slot planes, folded under torch autograd).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fspt_tpu_torch.config import RenderConfig

DISTRIBUTED_SLICE = ("a device mesh comes with the parallel slice of the port "
                     "(torch.distributed); pass mesh=None")
DIFF_PATH_SLICE = ("recovery by autograd of the whole renderer "
                   "(render_image_rows) comes with the slice that ports "
                   "ops/diff_path.py; pass render_fn or loss_and_grad_fn")

# Physical box constraints per material-table column; projecting onto them
# after each step breaks the albedo↔emission gauge freedom (radiance only
# constrains their products, so unconstrained recovery can trade a dim light
# against >1 albedos).
DEFAULT_CONSTRAINTS = {
    "diffuse": (0.0, 1.0),
    "emissive": (0.0, None),
    "glow": (0.0, None),
}


def _apply_params(scene, params):
    """Swap the optimizable columns into the scene's material table."""
    table = scene.materials._replace(**params)
    return scene._replace(materials=table)


def _pool(x, p):
    """Mean over p×p patches of an [H,W,3] image (thin images pool less)."""
    h, w = x.shape[0], x.shape[1]
    py, px = max(1, min(p, h)), max(1, min(p, w))
    ph, pw = h - h % py, w - w % px
    return x[:ph, :pw].reshape(ph // py, py, pw // px, px, 3).mean(dim=(1, 3))


class RecoveryState(NamedTuple):
    """An optimizer and the leaf tensors it updates (``step.init``)."""

    optimizer: torch.optim.Optimizer
    leaves: dict


def make_recovery_step(mesh, cfg: RenderConfig, param_names=("diffuse", "emissive"),
                       lr: float = 0.5, optimizer=None, constraints=None,
                       pool: int = 8, render_fn=None, loss_fn=None,
                       loss_and_grad_fn=None):
    """A gradient step on the named parameters (material-table columns or
    ``texels``), on one device.

    Returns ``step(params, scene, camera, target, seed, frame_idx) →
    (params, loss)``, with ``target`` the full [H,W,3] image and ``params``
    a dict of tensors; plain SGD at ``lr``, then the clip to
    ``constraints`` (default :data:`DEFAULT_CONSTRAINTS`).

    ``optimizer`` makes a ``torch.optim`` optimizer from a list of tensors
    (e.g. ``lambda ps: torch.optim.Adam(ps, lr=0.05)``).  With it, the
    reference's optax form applies: ``state = step.init(params)`` and
    ``step(params, state, scene, camera, target, seed, frame_idx) →
    (params, state, loss)``.

    The loss: ``render_fn(params, scene, camera, seed, frame_idx, y0,
    rows) → [rows,W,3]`` image renders two independently sampled buffers
    (``frame_idx`` and ``frame_idx + 10007``); their residuals are pooled
    over ``pool``×``pool`` patches and
    multiplied (the dual-buffer product: unbiased where plain MSE against a
    Monte Carlo render is not).  ``loss_fn(img_a, img_b, target)`` replaces
    that objective; torch autograd gives the gradient.
    ``loss_and_grad_fn(params, target, seed, frame_idx, y0, rows) → (loss,
    grads, segments)`` replaces all of it (the fused loss kernel,
    ops/cuda_grad.make_fused_loss_grad_fn).

    ``mesh`` must be None, and one of the hooks must be given: the
    reference's sharded form and its default (autograd of the whole
    renderer) come with later slices and raise ``NotImplementedError``, as
    its ``pair_render_fn`` hook (whose one caller, the BVH vertex recovery,
    is not ported) does not exist yet.
    """
    if mesh is not None:
        raise NotImplementedError(DISTRIBUTED_SLICE)
    if render_fn is None and loss_and_grad_fn is None:
        raise NotImplementedError(DIFF_PATH_SLICE)
    rows = cfg.height
    box = DEFAULT_CONSTRAINTS if constraints is None else constraints

    def loss_and_grads(params, scene, camera, target, seed, frame_idx):
        if loss_and_grad_fn is not None:
            loss, grads, _segs = loss_and_grad_fn(params, target, seed, frame_idx, 0, rows)
            return loss, grads
        leaves = {k: params[k].detach().clone().requires_grad_() for k in param_names}
        live = {**params, **leaves}
        img_a = render_fn(live, scene, camera, seed, frame_idx, 0, rows)
        img_b = render_fn(live, scene, camera, seed, frame_idx + 10007, 0, rows)
        if loss_fn is not None:
            loss = loss_fn(img_a, img_b, target)
        else:
            loss = (_pool(img_a - target, pool) * _pool(img_b - target, pool)).mean()
        grads = torch.autograd.grad(loss, [leaves[k] for k in param_names],
                                    allow_unused=True)
        return loss.detach(), {k: torch.zeros_like(leaves[k]) if g is None else g
                               for k, g in zip(param_names, grads)}

    def clip_(params):
        with torch.no_grad():
            for k, v in params.items():
                if k in box:
                    v.clamp_(*box[k])
        return params

    if optimizer is not None:
        def init(params):
            leaves = {k: params[k].detach().clone() for k in param_names}
            return RecoveryState(optimizer(list(leaves.values())), leaves)

        def step_opt(params, state, scene, camera, target, seed, frame_idx):
            with torch.no_grad():
                for k, leaf in state.leaves.items():
                    leaf.copy_(params[k])
            loss, grads = loss_and_grads(dict(params, **state.leaves), scene, camera,
                                         target, seed, frame_idx)
            for k, leaf in state.leaves.items():
                leaf.grad = grads[k].to(leaf.dtype)
            state.optimizer.step()
            clip_(state.leaves)
            out = dict(params, **{k: v.detach().clone() for k, v in state.leaves.items()})
            return out, state, loss

        step_opt.init = init
        return step_opt

    def step(params, scene, camera, target, seed, frame_idx):
        loss, grads = loss_and_grads(params, scene, camera, target, seed, frame_idx)
        new = clip_({k: params[k].detach() - lr * g for k, g in grads.items()})
        return dict(params, **new), loss

    return step


def make_fused_recovery_step(mesh, scene, camera, cfg: RenderConfig,
                             fields=("diffuse", "emissive"), lr: float = 0.5,
                             optimizer=None, constraints=None, pool: int = 8,
                             loss_fn=None):
    """The one gradient front door: recovery on the port's gradient
    kernels, fastest applicable construction chosen automatically —

    1. the fused loss kernel (kernel 8: dual-buffer loss and every
       gradient in one launch per step) when the default lane-level loss
       applies (``pool=1``, no ``loss_fn``), the fields are radiometric
       (diffuse, emissive, glow) and the scene has no texture;
    3. otherwise the affine-deferred fold (kernel 7), for radiometric fields
       and ``"texels"``, with any image loss through torch autograd of
       loss∘fold.

    The reference tries construction 2 (the in-kernel-adjoint pair, kernels
    9-10) before 3 on an untextured scene (fspt_tpu/parallel/train.py:
    253-264).  For radiometric fields construction 3 computes the same
    gradient, exactly up to float re-association: the path never depends on
    these values (pallas_path.py:245-248, pallas_grad.py:550-551).  Requests
    only construction 2 serves — scalar fields (param, ior, reflectivity,
    frost) and ``"camera"`` — raise ``NotImplementedError``: they need the
    adjoint of the path body, a later slice.

    Returns the step of :func:`make_recovery_step`; ``mesh`` must be None.
    Raises ValueError for a scene the megakernels do not take.
    """
    from fspt_tpu_torch.ops.cuda_grad import (PATH_ADJOINT_SLICE, RADIOMETRIC_FIELDS,
                                              make_affine_grad_image_fn,
                                              make_fused_loss_grad_fn)

    if mesh is not None:
        raise NotImplementedError(DISTRIBUTED_SLICE)
    fields = tuple(fields)
    if loss_fn is None and pool == 1 and "texels" not in fields:
        fused = make_fused_loss_grad_fn(scene, camera, cfg, fields=fields)
        if fused is not None:
            return make_recovery_step(None, cfg, param_names=fields, lr=lr,
                                      optimizer=optimizer, constraints=constraints,
                                      pool=1, loss_and_grad_fn=fused)
    other = set(fields) - RADIOMETRIC_FIELDS - {"texels"}
    if other:
        raise NotImplementedError(f"recovery of {sorted(other)} {PATH_ADJOINT_SLICE}")
    img_fn = make_affine_grad_image_fn(scene, camera, cfg)
    if img_fn is None:
        raise ValueError("scene can't use the megakernels (BVH or over 512 primitives)")

    def render_fn(params, _scene, _camera, seed, frame_idx, y0, rows):
        img, _segs = img_fn(params, seed, frame_idx, y0, rows)
        return img

    return make_recovery_step(None, cfg, param_names=fields, lr=lr, optimizer=optimizer,
                              constraints=constraints, pool=pool, render_fn=render_fn,
                              loss_fn=loss_fn)
