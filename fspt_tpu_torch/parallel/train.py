"""Differentiable recovery: gradient steps on scene parameters, sharded over a mesh.

Port of fspt_tpu/parallel/train.py: optimize material albedo, emission,
glow, texels, the scalar fields, the camera or triangle vertices so the
rendered image matches a target (the reference's BASELINE configs 4-5).
Rays are data-parallel over the mesh of parallel/mesh.py: each rank
renders its scanline band, and the loss and the gradients are
``all_reduce``-averaged over the ranks (the reference's ``pmean``) before
the update, so the replicated parameters stay equal on every rank.
``mesh=None`` is one device.

The renderers differentiated here: the gradient kernels of
ops/cuda_grad.py — kernel 8 (the fused dual-buffer loss, affine or whole
chain), kernels 9-10 (the path tracer with run-time parameters and its
adjoint) and kernel 7 (the affine slot planes, folded under torch autograd) —
and, by default, torch autograd of the whole wavefront renderer
(:func:`render_image_rows`); vertex recovery differentiates the wavefront
renderer through the brute-force intersector or, on BVH scenes, through the
hit-id replay of ops/diff_intersect.py.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.render import integrator
from fspt_tpu_torch.utils import profiling
from fspt_tpu_torch.utils import vecmath as vm

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


def apply_vertices(scene, params):
    """Swap optimizable vertices ``{v0, v1, v2}`` into the geometry,
    rebuilding the derived fields (edges, geometric and flat shading
    normals, 2·area) so the brute-force intersector stays differentiable in
    them."""
    v0, v1, v2 = params["v0"], params["v1"], params["v2"]
    e1, e2 = v1 - v0, v2 - v0
    cr = vm.cross(e1, e2)
    area2 = torch.linalg.vector_norm(cr, dim=-1)
    ng = cr / torch.clamp(area2, min=1e-30)[:, None]
    g = scene.geometry._replace(tri_v0=v0, tri_e1=e1, tri_e2=e2, tri_ng=ng,
                                tri_area2=area2, tri_n0=ng, tri_n1=ng, tri_n2=ng)
    return scene._replace(geometry=g)


def render_image_rows(scene, camera, cfg: RenderConfig, seed, frame_idx, y0, rows,
                      intersector=None):
    """Differentiable mean-radiance image of a scanline band ``[rows,W,3]``
    (the wavefront integrator under torch autograd)."""
    out = integrator.render_wavefront(scene, camera, cfg, seed, frame_idx * cfg.spp,
                                      y0=y0, rows=rows, intersector=intersector)
    return out.radiance.reshape(rows, cfg.width, cfg.spp, 3).mean(dim=2)


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
                       apply_fn=_apply_params, pool: int = 8, intersector_bind=None,
                       render_fn=None, pair_render_fn=None, loss_fn=None,
                       loss_and_grad_fn=None):
    """A gradient step on the named parameters (material-table columns or
    ``texels``), on one device (``mesh=None``) or sharded over ``mesh``
    (parallel/mesh.make_mesh).

    Returns ``step(params, scene, camera, target, seed, frame_idx) →
    (params, loss)``, with ``target`` the full [H,W,3] image and ``params``
    a dict of tensors, replicated on every rank; plain SGD at ``lr``, then
    the clip to ``constraints`` (default :data:`DEFAULT_CONSTRAINTS`).

    Under a mesh of ``n`` ranks each rank renders its band, rows ``y0 =
    rank·H/n`` to ``y0 + H/n`` (``ValueError`` where ``n`` does not divide
    the height), against its slice of ``target``; every hook below gets
    that ``(y0, rows)``; the loss and the gradients are averaged over the
    ranks (``all_reduce``) before the update, so every rank applies the
    same one.  Pooling patches do not cross bands, so the objective
    depends on the rank count unless ``pool == 1``.

    ``optimizer`` makes a ``torch.optim`` optimizer from a list of tensors
    (e.g. ``lambda ps: torch.optim.Adam(ps, lr=0.05)``).  With it, the
    reference's optax form applies: ``state = step.init(params)`` and
    ``step(params, state, scene, camera, target, seed, frame_idx) →
    (params, state, loss)``.

    The loss: two independently sampled buffers (``frame_idx`` and
    ``frame_idx + 10007``) are rendered, by default with
    :func:`render_image_rows` of ``apply_fn(scene, params)`` (torch
    autograd of the whole renderer; ``intersector_bind(params)`` gives its
    intersector), or by ``render_fn(params, scene, camera, seed, frame_idx,
    y0, rows) → [rows,W,3]``, or both at once by ``pair_render_fn(params,
    scene, camera, seed, frame_idx, y0, rows) → (img_a, img_b)`` (renderers
    that share work between the buffers, as the two-phase BVH replay does);
    their residuals are pooled over ``pool``×``pool`` patches and
    multiplied (the dual-buffer product: unbiased where plain MSE against a
    Monte Carlo render is not).  ``loss_fn(img_a, img_b, target)`` replaces
    that objective; torch autograd gives the gradient.
    ``loss_and_grad_fn(params, target, seed, frame_idx, y0, rows) → (loss,
    grads, segments)`` replaces all of it (the fused loss kernel,
    ops/cuda_grad.make_fused_loss_grad_fn).

    Under a recording profiler each step is the span ``fspt.recover.step``
    and holds ``fspt.recover.grad`` (the loss and gradients) and then
    ``fspt.recover.optimizer`` (the update, the clip and the parameters
    handed back), as :func:`utils.profiling.span` records them.
    """
    if mesh is None:
        rows, y0 = cfg.height, 0
    else:
        if cfg.height % mesh.size != 0:
            raise ValueError(f"height {cfg.height} not divisible by {mesh.size} devices")
        if not mesh.member:
            raise ValueError("this rank is outside the mesh")
        rows = cfg.height // mesh.size
        y0 = mesh.rank * rows
    box = DEFAULT_CONSTRAINTS if constraints is None else constraints

    def band_loss_and_grads(params, scene, camera, target, seed, frame_idx):
        if loss_and_grad_fn is not None:
            loss, grads, _segs = loss_and_grad_fn(params, target, seed, frame_idx, y0, rows)
            return loss, grads
        leaves = {k: params[k].detach().clone().requires_grad_() for k in param_names}
        live = {**params, **leaves}
        if pair_render_fn is not None:
            img_a, img_b = pair_render_fn(live, scene, camera, seed, frame_idx, y0, rows)
        elif render_fn is not None:
            img_a = render_fn(live, scene, camera, seed, frame_idx, y0, rows)
            img_b = render_fn(live, scene, camera, seed, frame_idx + 10007, y0, rows)
        else:
            scene = apply_fn(scene, live)
            inter = None if intersector_bind is None else intersector_bind(live)
            img_a = render_image_rows(scene, camera, cfg, seed, frame_idx, y0, rows,
                                      intersector=inter)
            img_b = render_image_rows(scene, camera, cfg, seed, frame_idx + 10007, y0, rows,
                                      intersector=inter)
        if loss_fn is not None:
            loss = loss_fn(img_a, img_b, target)
        else:
            loss = (_pool(img_a - target, pool) * _pool(img_b - target, pool)).mean()
        grads = torch.autograd.grad(loss, [leaves[k] for k in param_names],
                                    allow_unused=True)
        return loss.detach(), {k: torch.zeros_like(leaves[k]) if g is None else g
                               for k, g in zip(param_names, grads)}

    def loss_and_grads(params, scene, camera, target, seed, frame_idx):
        if mesh is None:
            return band_loss_and_grads(params, scene, camera, target, seed, frame_idx)
        loss, grads = band_loss_and_grads(params, scene, camera, target[y0:y0 + rows], seed,
                                          frame_idx)
        names = list(grads)
        mean = mesh.pmean([loss] + [grads[k] for k in names])
        return mean[0], dict(zip(names, mean[1:]))

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
            with profiling.span("fspt.recover.step"):
                with torch.no_grad():
                    for k, leaf in state.leaves.items():
                        leaf.copy_(params[k])
                with profiling.span("fspt.recover.grad"):
                    loss, grads = loss_and_grads(dict(params, **state.leaves), scene, camera,
                                                 target, seed, frame_idx)
                with profiling.span("fspt.recover.optimizer"):
                    for k, leaf in state.leaves.items():
                        leaf.grad = grads[k].to(leaf.dtype)
                    state.optimizer.step()
                    clip_(state.leaves)
                    out = dict(params, **{k: v.detach().clone()
                                          for k, v in state.leaves.items()})
                return out, state, loss

        step_opt.init = init
        return step_opt

    def step(params, scene, camera, target, seed, frame_idx):
        with profiling.span("fspt.recover.step"):
            with profiling.span("fspt.recover.grad"):
                loss, grads = loss_and_grads(params, scene, camera, target, seed, frame_idx)
            with profiling.span("fspt.recover.optimizer"):
                new = clip_({k: params[k].detach() - lr * g for k, g in grads.items()})
                return dict(params, **new), loss

    return step


def make_fused_recovery_step(mesh, scene, camera, cfg: RenderConfig,
                             fields=("diffuse", "emissive"), lr: float = 0.5,
                             optimizer=None, constraints=None, pool: int = 8,
                             loss_fn=None):
    """The one gradient front door: recovery on the port's gradient
    kernels, fastest applicable construction chosen automatically, as the
    reference chooses it (fspt_tpu/parallel/train.py:240-276) —

    1. the fused loss kernel (kernel 8: dual-buffer loss and every gradient
       in one launch per step; material columns and the ``"camera"``
       9-vector of :func:`ops.cuda_path.camera_pvec`) when the default
       lane-level loss applies (``pool=1``, no ``loss_fn``) on an
       untextured scene;
    2. the in-kernel-adjoint pair (kernels 9-10, band images through a
       ``torch.autograd.Function``) on an untextured scene, for any material
       column and any image loss;
    3. the affine-deferred fold (kernel 7), for textured scenes and
       ``"texels"``: radiometric fields only, with any image loss through
       torch autograd of loss∘fold.

    ``params`` of the returned step is a dict of the selected fields (e.g.
    ``{"diffuse": [M,3], "camera": camera_pvec(cam)}``).  ``"camera"`` needs
    construction 1 and raises ``ValueError`` elsewhere.  Returns the step of
    :func:`make_recovery_step` on ``mesh`` (each rank launches its band;
    the gradients are averaged over the ranks).  Raises ValueError
    for a scene the megakernels do not take (use make_recovery_step then).
    """
    from fspt_tpu_torch.ops.cuda_grad import (CAMERA_FIELD, RADIOMETRIC_FIELDS,
                                              make_affine_grad_image_fn,
                                              make_fused_loss_grad_fn,
                                              make_grad_image_fn)

    fields = tuple(fields)
    if loss_fn is None and pool == 1 and "texels" not in fields:
        fused = make_fused_loss_grad_fn(scene, camera, cfg, fields=fields)
        if fused is not None:
            return make_recovery_step(mesh, cfg, param_names=fields, lr=lr,
                                      optimizer=optimizer, constraints=constraints,
                                      pool=1, loss_and_grad_fn=fused)
    if CAMERA_FIELD in fields:
        raise ValueError("camera recovery needs the fused loss kernel (untextured "
                         "scene the megakernels take, pool=1, default loss)")
    img_fn = None
    if "texels" not in fields:
        img_fn = make_grad_image_fn(scene, camera, cfg, fields=fields)
    if img_fn is None and set(fields) <= RADIOMETRIC_FIELDS | {"texels"}:
        img_fn = make_affine_grad_image_fn(scene, camera, cfg)
    if img_fn is None:
        raise ValueError("scene can't use the gradient kernels; use make_recovery_step")

    def render_fn(params, _scene, _camera, seed, frame_idx, y0, rows):
        img, _segs = img_fn(params, seed, frame_idx, y0, rows)
        return img

    return make_recovery_step(mesh, cfg, param_names=fields, lr=lr, optimizer=optimizer,
                              constraints=constraints, pool=pool, render_fn=render_fn,
                              loss_fn=loss_fn)


VERTICES = ("v0", "v1", "v2")


def make_vertex_recovery_step(mesh, cfg: RenderConfig, lr: float = 0.05, optimizer=None,
                              pool: int = 1):
    """Vertex recovery on a scene without a BVH (BASELINE config 5):
    ``params`` is ``{"v0", "v1", "v2": [T,3]}``, the geometry is rebuilt
    from them (:func:`apply_vertices`) and torch autograd runs through the
    brute-force intersector.  ``cfg.edge_eps`` should be > 0, so that
    silhouette motion is differentiable; no constraints.  Rays shard over
    ``mesh`` as in :func:`make_recovery_step`."""
    return make_recovery_step(mesh, cfg, param_names=VERTICES, lr=lr, optimizer=optimizer,
                              constraints={}, apply_fn=apply_vertices, pool=pool)


def make_bvh_vertex_recovery_step(mesh, cfg: RenderConfig, scene, lr: float = 0.05,
                                  optimizer=None, pool: int = 1, shade_normals="flat",
                                  queue: int | None = None, use_queue: bool = False,
                                  replay: str = "wavefront"):
    """Vertex recovery on a BVH scene (100 k triangles and more) by
    two-phase hit-id replay (reference parallel/train.py:294-426):

    1. **record**, without gradients: both sample buffers go through one
       render at ``2·spp`` (samples ``[0, spp)`` are buffer A, ``[spp,
       2·spp)`` buffer B) with the replay intersector of
       ops/diff_intersect.py over the fast mesh intersector (kernels 1, 5
       and 6), keeping each segment's winner id and hit flag: the unrolled
       wavefront (default) or, with ``use_queue``, the regenerating queue's
       ``record_hits``;
    2. **replay**, differentiable: the wavefront renders the same paths
       again through :func:`ops.diff_intersect.make_recorded_replay`, one
       Möller–Trumbore of the recorded winner per segment reading the
       vertex tensors; torch autograd sees no traversal.

    ``params`` is ``{"v0", "v1", "v2": [T,3]}`` in original triangle order
    (start from ``diff_intersect.tris_from_scene``).  The BVH stays that of
    the scene's build-time vertices: hits stay exact while moved triangles
    stay inside their treelet boxes.  ``shade_normals="flat"`` re-derives
    the shading normals from the vertices, ``"fixed"`` keeps the baked ones.
    ``replay`` is ``"wavefront"`` or ``"auto"`` (the same); the reference's
    ``"planar"`` replay is in ROADMAP.md's "Not ported" list and raises
    ``ValueError``.  The returned step carries ``record(params, scene,
    camera, seed, frame_idx, y0, rows) → (ids, hitm)``, phase 1 alone.
    Rays shard over ``mesh`` as in :func:`make_recovery_step`: each rank
    records and replays its band.
    """
    import dataclasses

    from fspt_tpu_torch.ops.diff_intersect import (flat_normals, make_diff_mesh_intersector,
                                                   make_recorded_replay, tris_from_scene)
    from fspt_tpu_torch.render.queue import DEFAULT_QUEUE, render_queued

    if replay == "planar":
        raise ValueError("the planar replay (make_planar_recorded_replay) is in ROADMAP.md's "
                         "'Not ported' list; use replay='wavefront'")
    if replay not in ("wavefront", "auto"):
        raise ValueError(f"unknown replay {replay!r}")
    if shade_normals not in ("flat", "fixed"):
        raise ValueError(f"unknown shade_normals {shade_normals!r}")
    diff = make_diff_mesh_intersector(scene)
    if diff is None:
        raise ValueError("scene has no BVH; use make_vertex_recovery_step")
    baked = tris_from_scene(scene)
    replay_bind = make_recorded_replay(scene)
    cfg2 = dataclasses.replace(cfg, spp=2 * cfg.spp)
    q = queue or DEFAULT_QUEUE

    def bind_tris(params):
        tr = dict(baked, **{k: params[k] for k in VERTICES})
        if shade_normals == "flat":
            tr["n0"] = tr["n1"] = tr["n2"] = flat_normals(tr["v0"], tr["v1"], tr["v2"])
        return tr

    @torch.no_grad()
    def record(params, scene_in, camera, seed, frame_idx, y0, rows):
        """Phase 1: the winner ids and hit flags ``[N, D]`` of both buffers."""
        inner = diff.bind(bind_tris({k: params[k].detach() for k in VERTICES}))
        if use_queue:
            _, (ids, hitm) = render_queued(scene_in, camera, cfg2, seed, frame_idx * cfg2.spp,
                                           y0=y0, rows=rows, intersector=inner, queue=q,
                                           aovs=False, record_hits=True)
            return ids, hitm
        rec = []

        def recorder(start, seg, alive=None):
            h = inner(start, seg, alive)
            rec.append((h.prim_id, h.hit))
            return h

        recorder.accepts_alive = True
        integrator.render_wavefront(scene_in, camera, cfg2, seed, frame_idx * cfg2.spp,
                                    y0=y0, rows=rows, intersector=recorder)
        return (torch.stack([i for i, _ in rec], dim=1),
                torch.stack([h for _, h in rec], dim=1))

    def pair_render(params, scene_in, camera, seed, frame_idx, y0, rows):
        ids, hitm = record(params, scene_in, camera, seed, frame_idx, y0, rows)
        out = integrator.render_wavefront(scene_in, camera, cfg2, seed, frame_idx * cfg2.spp,
                                          y0=y0, rows=rows,
                                          intersector=replay_bind(bind_tris(params), ids, hitm))
        rad = out.radiance.reshape(rows, cfg.width, 2, cfg.spp, 3)
        return rad[:, :, 0].mean(dim=2), rad[:, :, 1].mean(dim=2)

    step = make_recovery_step(mesh, cfg, param_names=VERTICES, lr=lr, optimizer=optimizer,
                              constraints={}, apply_fn=lambda s, p: s, pool=pool,
                              pair_render_fn=pair_render)
    step.record = record
    return step
