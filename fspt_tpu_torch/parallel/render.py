"""Sharded forward rendering: scanline bands over the mesh's ranks.

Port of fspt_tpu/parallel/render.py.  Each rank owns ``height/n``
scanlines, the reference's per-thread bands (reference
engine.cpp:174-182, 261-274): the framebuffer lives band-sharded, one band
a rank, so the forward path needs no collective but the segment count's
``all_reduce``.  RNG streams key on global pixel ids, so the image is
bit-identical for any rank count (tests/test_torch_parallel.py).

Each step carries its per-rank body as ``step.local(band, ...)``: the work
of rank ``band`` alone, with no collective, so one process can run every
band of a larger world (chip_smoke.py does, on one card).
"""

from __future__ import annotations

from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.render import framebuffer as fb_mod
from fspt_tpu_torch.render import integrator


def _rows_local(mesh, height: int) -> int:
    if height % mesh.size != 0:
        raise ValueError(f"height {height} not divisible by {mesh.size} devices")
    return height // mesh.size


def sharded_framebuffer(mesh, height: int, width: int) -> fb_mod.Framebuffer:
    """This rank's band of a ``height × width`` framebuffer: ``[height/n,
    width]`` on the mesh's device."""
    return fb_mod.create(_rows_local(mesh, height), width, device=mesh.device)


def gather_framebuffer(mesh, fb_local: fb_mod.Framebuffer) -> fb_mod.Framebuffer:
    """The full framebuffer from every rank's band (``all_gather``, rank
    order): the reference's read of its global sharded array.  Collective."""
    return fb_mod.Framebuffer(*(mesh.all_gather(x) for x in fb_local))


def make_sharded_render_step(mesh, cfg: RenderConfig, intersector=None,
                             queue: int | None = None):
    """``step(scene, camera, fb_local, seed, frame_idx) → (fb_local,
    segments)``: this rank renders its band (rows ``rank·rows_local`` on),
    and ``segments`` is the whole frame's (``all_reduce``), a tensor on the
    device.

    ``intersector`` goes to the integrator (the CUDA intersect kernel, the
    treelet mesh intersector); ``queue`` puts each band on the regenerating
    ray queue (render/queue.py) and needs an ``intersector``.
    ``step.local(band, scene, camera, fb_local, seed, frame_idx)`` is band
    ``band``'s render with its own segment count.
    """
    rows_local = _rows_local(mesh, cfg.height)
    if queue is not None and intersector is None:
        raise ValueError("queue mode needs an intersector")

    def local(band, scene, camera, fb_local, seed, frame_idx):
        y0 = band * rows_local
        if queue is not None:
            from fspt_tpu_torch.render.queue import render_queued

            out = render_queued(scene, camera, cfg, seed, frame_idx * cfg.spp, y0=y0,
                                rows=rows_local, intersector=intersector, queue=queue)
            fb_local = fb_mod.accumulate(fb_local, out.radiance, out.aov_normal,
                                         out.aov_depth, out.aov_mat, rows_local, cfg.width,
                                         cfg.spp)
            return fb_local, out.segments
        return integrator.render_step(scene, camera, cfg, fb_local, seed, frame_idx, y0=y0,
                                      intersector=intersector)

    def step(scene, camera, fb_local, seed, frame_idx):
        fb_local, segs = local(mesh.rank, scene, camera, fb_local, seed, frame_idx)
        return fb_local, mesh.all_reduce(segs)

    step.local = local
    return step


def make_sharded_megakernel_step(mesh, scene_pack, camera, cfg: RenderConfig):
    """Band-sharded step on the camera-fused kernel (kernel 2, kernel 4 on
    a textured scene, or kernel 13 on an untextured BVH scene;
    ops/cuda_path.make_camera_path_tracer): each rank
    traces its own contiguous lane band in one launch, with no forward
    collective but the segment count's ``all_reduce``.

    Returns ``step(fb_local, seed, frame_idx) → (fb_local, segments)`` with
    the scene and camera baked, or None when the scene cannot be
    specialized.  ``step.local(band, fb_local, seed, frame_idx)`` is band
    ``band``'s launch with its own segment count.
    """
    from fspt_tpu_torch.ops.cuda_path import make_camera_path_tracer

    tracer = make_camera_path_tracer(scene_pack, camera, cfg)
    if tracer is None:
        return None
    rows_local = _rows_local(mesh, cfg.height)
    lanes_local = rows_local * cfg.width * cfg.spp

    def local(band, fb_local, seed, frame_idx):
        out = tracer(seed, frame_idx * cfg.spp, lane0=band * lanes_local, n_lanes=lanes_local)
        fb_local = fb_mod.accumulate(fb_local, out.radiance, out.aov_normal, out.aov_depth,
                                     out.aov_mat, rows_local, cfg.width, cfg.spp)
        return fb_local, out.segments

    def step(fb_local, seed, frame_idx):
        fb_local, segs = local(mesh.rank, fb_local, seed, frame_idx)
        return fb_local, mesh.all_reduce(segs)

    step.local = local
    step.tracer = tracer
    return step
