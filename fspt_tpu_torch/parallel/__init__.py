"""Parallel and training layers of the port on torch.distributed.

The reference's parallel story is one thread per hardware thread, each
owning a band of scanlines with a join per frame (reference
engine.cpp:261-281).  Here a band is a rank: a 1-D mesh over the ranks of
a torch.distributed world (parallel/mesh.py, NCCL on the card, gloo on the
CPU), each rank renders its band, the framebuffer lives band-sharded with
no forward collective, and gradient reduction (``all_reduce``) appears only
in the differentiable path.
"""

from fspt_tpu_torch.parallel.mesh import make_mesh, mesh_devices
from fspt_tpu_torch.parallel.render import (make_sharded_megakernel_step,
                                            make_sharded_render_step, sharded_framebuffer)
from fspt_tpu_torch.parallel.scene_shard import (make_scene_sharded_render_step,
                                                 shard_scene_triangles)
from fspt_tpu_torch.parallel.train import (apply_vertices, make_bvh_vertex_recovery_step,
                                           make_fused_recovery_step, make_recovery_step,
                                           make_vertex_recovery_step)

__all__ = [
    "make_mesh",
    "mesh_devices",
    "make_sharded_render_step",
    "make_sharded_megakernel_step",
    "sharded_framebuffer",
    "make_scene_sharded_render_step",
    "shard_scene_triangles",
    "make_recovery_step",
    "make_fused_recovery_step",
    "make_vertex_recovery_step",
    "make_bvh_vertex_recovery_step",
    "apply_vertices",
]
