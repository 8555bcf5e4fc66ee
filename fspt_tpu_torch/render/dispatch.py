"""Render-path selection for camera-dynamic steps.

Port of fspt_tpu/render/dispatch.py.  ``make_scene_step`` returns a step
that takes the camera as a live argument (no per-pose setup):

1. BVH scenes → the treelet mesh intersector (ops/cuda_bvh.py: kernel 1
   seeds, kernels 5 and 6 cull and sweep) streamed through the
   regenerating ray queue (render/queue.py);
2. analytic scenes up to 512 primitives → the CUDA intersect kernel
   (ops/cuda_trace.py, kernel 1) inside the torch integrator's shading loop;
3. otherwise → the torch flattened-BVH walk or brute force.

The camera-fused megakernels are chosen by callers with a fixed camera
(cli.py): kernel 2, or kernel 13 for an untextured BVH scene
(ops/cuda_path.make_camera_path_tracer), so a fixed-camera mesh frame does
not take branch 1.  ``make_cached_scene_step`` adds the first-hit cache to
branch 1; the CLI keeps it on the queue, whose estimator a checkpoint
records.
"""

from __future__ import annotations

from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.ops.cuda_trace import make_cuda_intersector
from fspt_tpu_torch.render import framebuffer as fb_mod
from fspt_tpu_torch.render import integrator
from fspt_tpu_torch.scene.builder import ScenePack

MESH_PATH = "queued wavefront + cuda treelet BVH"


def make_scene_step(scene: ScenePack, cfg: RenderConfig, queue: int | None = None):
    """Returns ``(name, step)`` with
    ``step(scene, camera, fb, seed, frame_idx) → (fb, segments)``.
    ``queue`` is the ray queue's lane count on the mesh path (``None``:
    ``render.queue.DEFAULT_QUEUE``).

    The intersectors pack the build-time scene's primitives and triangles;
    the ``scene`` passed to ``step`` feeds only live material/texture tables.
    """
    if scene.bvh is not None and cfg.edge_eps == 0.0:
        from fspt_tpu_torch.ops.cuda_bvh import make_mesh_intersector
        from fspt_tpu_torch.render.queue import DEFAULT_QUEUE, render_queued

        inter = make_mesh_intersector(scene)
        if inter is not None:
            q = DEFAULT_QUEUE if queue is None else queue

            def step(scene_in, camera, fb, seed, frame_idx):
                rows = fb.mean.shape[0]
                out = render_queued(scene_in, camera, cfg, seed, frame_idx * cfg.spp,
                                    rows=rows, intersector=inter, queue=q)
                fb = fb_mod.accumulate(fb, out.radiance, out.aov_normal, out.aov_depth,
                                       out.aov_mat, rows, cfg.width, cfg.spp)
                return fb, out.segments

            return MESH_PATH, step

    intersector = None
    if scene.bvh is None:
        intersector = make_cuda_intersector(scene.geometry)
    if intersector is not None:
        name = "cuda intersect + torch shade"
    elif scene.bvh is not None:
        name = "torch + flattened-BVH traversal"
    else:
        name = "torch brute force"

    def step(scene_in, camera, fb, seed, frame_idx):
        return integrator.render_step(scene_in, camera, cfg, fb, seed,
                                      frame_idx, intersector=intersector)

    return name, step


def make_cached_scene_step(scene: ScenePack, cfg: RenderConfig, queue: int | None = None):
    """First-hit-cached progressive step for BVH scenes (reference
    ImagePlaneCache, engine.h:46-65 + engine.cpp:33-105).

    Returns ``(name, step, cache_fn)``: ``cache_fn(scene, camera, seed) →
    pose`` builds the warm-start bundle for the camera pose, and
    ``step(scene, camera, fb, seed, frame_idx, pose) → (fb, segments)``
    renders one frame with depth 0 resolved outside the queue.  The camera
    stream is frozen at ``cam_sample0 = 0``; the bounce stream advances per
    frame.  ``(None, None, None)`` when the scene has no queued BVH path or
    the configuration cannot warm-start (fast render, depth < 2,
    ``edge_eps``): callers fall back to :func:`make_scene_step`.  Rebuild
    the pose whenever the camera changes.  ``queue`` is the ray queue's lane
    count and the pose pass's chunk (``None``: ``DEFAULT_QUEUE``).
    """
    if (scene.bvh is None or cfg.edge_eps != 0.0 or cfg.effective_depth < 2
            or cfg.fast_render):
        return None, None, None
    from fspt_tpu_torch.ops.cuda_bvh import make_mesh_intersector
    from fspt_tpu_torch.render.queue import (DEFAULT_QUEUE, compute_warm_pose,
                                             render_queued, warm_frame)

    inter = make_mesh_intersector(scene)
    if inter is None:
        return None, None, None
    q = DEFAULT_QUEUE if queue is None else queue

    def cache_fn(scene_in, camera, seed):
        return compute_warm_pose(scene_in, camera, cfg, seed, 0, intersector=inter,
                                 chunk=q)

    def step(scene_in, camera, fb, seed, frame_idx, pose):
        rows = fb.mean.shape[0]
        warm = warm_frame(scene_in, camera, cfg, pose, seed, frame_idx * cfg.spp, 0,
                          rows=rows)
        out = render_queued(scene_in, camera, cfg, seed, frame_idx * cfg.spp, rows=rows,
                            intersector=inter, queue=q, cam_sample0=0,
                            warm=warm)
        fb = fb_mod.accumulate(fb, out.radiance, out.aov_normal, out.aov_depth,
                               out.aov_mat, rows, cfg.width, cfg.spp)
        return fb, out.segments

    return MESH_PATH + " + first-hit cache", step, cache_fn
