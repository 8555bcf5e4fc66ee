"""Render-path selection for camera-dynamic steps.

Port of fspt_tpu/render/dispatch.py.  ``make_scene_step`` returns a step
that takes the camera as a live argument (no per-pose setup):

1. analytic scenes up to 512 primitives → the CUDA intersect kernel
   (ops/cuda_trace.py, kernel 1) inside the torch integrator's shading loop;
2. otherwise → the torch brute-force intersector.

BVH scenes, the reference's first branch, come with the mesh slice.  The
camera-fused megakernel is chosen by callers with a fixed camera (cli.py).
"""

from __future__ import annotations

from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.ops.cuda_trace import make_cuda_intersector
from fspt_tpu_torch.render import integrator
from fspt_tpu_torch.scene.builder import ScenePack


def make_scene_step(scene: ScenePack, cfg: RenderConfig):
    """Returns ``(name, step)`` with
    ``step(scene, camera, fb, seed, frame_idx) → (fb, segments)``.

    The intersector packs the build-time scene's primitives; the ``scene``
    passed to ``step`` feeds only live material/texture tables.
    """
    if scene.bvh is not None:
        raise NotImplementedError("BVH scenes come with the mesh slice of the port")
    intersector = make_cuda_intersector(scene.geometry)
    if intersector is not None:
        name = "cuda intersect + torch shade"
    else:
        name = "torch brute force"

    def step(scene_in, camera, fb, seed, frame_idx):
        return integrator.render_step(scene_in, camera, cfg, fb, seed,
                                      frame_idx, intersector=intersector)

    return name, step
