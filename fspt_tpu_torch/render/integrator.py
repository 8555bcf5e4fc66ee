"""The wavefront path integrator in plain torch.

Port of fspt_tpu/render/integrator.py: the reference's recursive
``TraceStep`` (engine.cpp:59-159) as an iterative bounce loop over a ray
SoA — intersect → shade → spawn for the whole wavefront per bounce.  This
is the port's general render path (any scene, textured and BVH ones
included); the CUDA megakernels in ops/cuda_path.py replace it on the
CLI's analytic path, and render/queue.py reschedules it for BVH scenes.

Semantics kept from the reference: depth cap → loop length; fast-render
white above depth 1; miss → sky ×3; backface flip; ε-offset 0.03; affine
``L += T·bias; T *= coef``; depth-0 fog resolved one bounce later; the
depth-0 light tone clamp; AOVs captured at depth 0.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from fspt_tpu_torch import materials as mat_mod
from fspt_tpu_torch.camera import Camera, generate_rays
from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.ops import rng
from fspt_tpu_torch.ops.intersect import KIND_TRIANGLE, Hit, intersect_scene
from fspt_tpu_torch.render import framebuffer as fb_mod
from fspt_tpu_torch.scene.builder import ScenePack
from fspt_tpu_torch.utils import vecmath as vm


def _intersect_with_bvh(scene: ScenePack, start, seg) -> Hit:
    """Closest hit: analytic primitives (brute force) ∪ BVH triangles, the
    closer one winning (reference scene.cpp:227-248, mesh.cpp:154-160)."""
    from fspt_tpu_torch.ops.bvh import traverse_bvh

    base = intersect_scene(scene.geometry, start, seg)
    t_tri, tri_id, u, v = traverse_bvh(scene.bvh, start, seg)
    return merge_triangle_hit(scene.tri_shade, base, start, seg, t_tri, tri_id, u, v,
                              tri_hit_wins=(tri_id >= 0) & (t_tri < base.t))


def merge_triangle_hit(ts, base: Hit, start, seg, t_tri, tri_id, u, v, tri_hit_wins) -> Hit:
    """``base`` with the lanes of ``tri_hit_wins`` replaced by their
    triangle hit, whose shading attributes are gathered from ``ts``
    (a TriShade) by original triangle id."""
    tid = torch.clamp(tri_id, min=0).long()
    u3, v3 = u[:, None], v[:, None]
    normal = ts.n0[tid] + (ts.n1[tid] - ts.n0[tid]) * u3 + (ts.n2[tid] - ts.n0[tid]) * v3
    texcoords = ts.t0[tid] + (ts.t1[tid] - ts.t0[tid]) * u3 + (ts.t2[tid] - ts.t0[tid]) * v3
    w = tri_hit_wins
    t = torch.where(w, t_tri, base.t)
    return Hit(
        t=t,
        point=start + seg * t[:, None],
        normal=torch.where(w[:, None], normal, base.normal),
        texcoords=torch.where(w[:, None], texcoords, base.texcoords),
        mat=torch.where(w, ts.mat[tid], base.mat),
        prim_kind=torch.where(w, KIND_TRIANGLE, base.prim_kind),
        hit=base.hit | (tri_id >= 0),
        prim_id=torch.where(w, tri_id, -1).to(torch.int32),
    )


def intersect_full(scene: ScenePack, start, seg) -> Hit:
    """Closest hit against the full scene: analytic primitives ∪ BVH
    triangles."""
    if scene.bvh is not None:
        return _intersect_with_bvh(scene, start, seg)
    return intersect_scene(scene.geometry, start, seg)


def edge_reparameterize(cfg: RenderConfig, edge_dist, active, seg, sh, ue, throughput):
    """Silhouette gradients (reference integrator.py:171-201).

    Near a triangle edge the expected image is ``alpha·L_surface + (1 −
    alpha)·L_background`` with ``alpha`` the coverage smoothed over
    ``cfg.edge_eps``.  The blend is sampled (pass through the surface with
    probability ``1 − alpha``, uniform ``ue``) and the throughput carries
    ``alpha / detach(alpha)`` (or its pass-through twin): 1 in value, the
    boundary term ``∂alpha / alpha`` in derivative.  Returns the throughput
    and the shade record with the pass-through lanes continuing straight on.
    """
    alpha = torch.clamp(edge_dist / cfg.edge_eps, 0.0, 1.0)
    pass_thru = active & (ue >= alpha)
    keep = active & ~pass_thru
    ratio = torch.where(
        pass_thru, (1.0 - alpha) / torch.clamp((1.0 - alpha).detach(), min=1e-6),
        torch.where(keep, alpha / torch.clamp(alpha.detach(), min=1e-6), 1.0))
    p3 = pass_thru[:, None]
    sh = sh._replace(
        direction=torch.where(p3, vm.normalize(seg), sh.direction),
        bias=torch.where(p3, 0.0, sh.bias),
        coef=torch.where(p3, 1.0, sh.coef),
        will_indirect=sh.will_indirect | pass_thru,
        is_light=sh.is_light & ~pass_thru,
        is_fog=sh.is_fog & ~pass_thru)
    return throughput * ratio[:, None], sh


class TraceOutput(NamedTuple):
    radiance: torch.Tensor  # [N,3]
    aov_normal: torch.Tensor  # [N,3]
    aov_depth: torch.Tensor  # [N]
    aov_mat: torch.Tensor  # [N] int32
    segments: torch.Tensor  # scalar: path segments traced (rays/s metric)
    #: [2] int64: the BVH node steps and triangle tests of the segments
    #: (kernel 13's tracer), or None.
    walk: Optional[torch.Tensor] = None
    #: [3] int64: kernel 13's warp-wide leaf phases, the leaves tested in
    #: them and its warp walks (its counting build on the card), or None.
    phases: Optional[torch.Tensor] = None
    #: [2] int64: the slots that fetched a texel of a surface row and those
    #: that fetched the sky's (kernel 4's ``trace.counted``), or None.
    fetches: Optional[torch.Tensor] = None


def trace_radiance(scene: ScenePack, cfg: RenderConfig, start, seg,
                   pixel_idx, sample_idx, seed, z_far,
                   intersector=None) -> TraceOutput:
    """Trace a ray wavefront to completion and return per-lane radiance.

    ``intersector(start, seg) → Hit`` overrides :func:`intersect_full`
    (e.g. the CUDA intersector of ops/cuda_trace.py); one with
    ``accepts_alive`` (the mesh intersector of ops/cuda_bvh.py) also gets
    the lanes' liveness and skips the dead ones.  With ``cfg.edge_eps > 0``
    and an intersector that gives ``Hit.edge_dist`` (brute force, the replay
    of ops/diff_intersect.py), silhouettes are edge-reparameterized.
    """
    table = scene.materials
    tex = scene.textures
    dev = start.device
    z_far = torch.as_tensor(z_far, dtype=torch.float32, device=dev)

    n_lanes = start.shape[0]
    f32 = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    radiance = f32(n_lanes, 3)
    throughput = torch.ones((n_lanes, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((n_lanes,), dtype=torch.bool, device=dev)
    segments = torch.zeros((), dtype=torch.int64, device=dev)

    fog_active = torch.zeros((n_lanes,), dtype=torch.bool, device=dev)
    fog_from = f32(n_lanes, 3)
    fog_diffuse = f32(n_lanes, 3)
    fog_density = f32(n_lanes)
    fog_u = f32(n_lanes)

    aov_normal = f32(n_lanes, 3)
    aov_depth = f32(n_lanes)
    aov_mat = torch.zeros((n_lanes,), dtype=torch.int32, device=dev)
    primary_light_hit = torch.zeros((n_lanes,), dtype=torch.bool, device=dev)

    for depth in range(cfg.effective_depth):
        segments = segments + alive.sum()

        if intersector is None:
            hit = intersect_full(scene, start, seg)
        elif getattr(intersector, "accepts_alive", False):
            hit = intersector(start, seg, alive)
        else:
            hit = intersector(start, seg)

        # Backface flip → is_internal (scene.cpp:238-247).
        side = vm.dot(hit.normal, start - hit.point)
        internal = side < 0.0
        normal = torch.where(internal[:, None], -hit.normal, hit.normal)

        # Depth-0 fog resolves one bounce late: the reference's absorption
        # term uses the next hit point or the segment end on a miss
        # (material.cpp:330-337, engine.cpp:89-91).
        if depth >= 1:
            light_pos = torch.where(hit.hit[:, None], hit.point, start + seg)
            dist = vm.length(light_pos - fog_from)
            thresh = torch.clamp(dist * dist * fog_density * 0.00005, 0.0, 1.0)
            absorbed = fog_active & (fog_u < thresh)
            radiance = radiance + torch.where(
                (absorbed & alive)[:, None], throughput * fog_diffuse, 0.0)
            alive = alive & ~absorbed
            fog_active = torch.zeros_like(fog_active)

        # Misses sample the sky (engine.cpp:92-101).
        miss = alive & ~hit.hit
        view_dir = vm.normalize(seg)
        sky_rgb = mat_mod.sample_sky(table, tex, scene.sky_mat, view_dir)
        radiance = radiance + torch.where(miss[:, None], throughput * sky_rgb, 0.0)

        active = alive & hit.hit
        view = vm.normalize(hit.point - start)
        uniforms = rng.bounce_uniforms(seed, pixel_idx, sample_idx, depth,
                                       cfg.bounce_slots)
        sh = mat_mod.shade(table, tex, hit.mat, view, normal, hit.texcoords,
                           uniforms)
        if cfg.edge_eps > 0.0 and hit.edge_dist is not None:
            throughput, sh = edge_reparameterize(cfg, hit.edge_dist, active, seg, sh,
                                                 rng.edge_uniform(seed, pixel_idx,
                                                                  sample_idx, depth),
                                                 throughput)

        if depth == 0:
            aov_normal = torch.where(hit.hit[:, None], normal, view_dir)
            aov_depth = torch.where(hit.hit, vm.length(hit.point - start), z_far)
            aov_mat = torch.where(hit.hit, hit.mat,
                                  scene.sky_mat.to(torch.int32)).to(torch.int32)
            primary_light_hit = hit.hit & sh.is_light
            mark = active & sh.is_fog
            fog_active = mark
            fog_from = torch.where(mark[:, None], hit.point, fog_from)
            fog_diffuse = torch.where(mark[:, None], sh.fog_diffuse, fog_diffuse)
            fog_density = torch.where(mark, sh.fog_density, fog_density)
            fog_u = torch.where(mark, uniforms[:, 3], fog_u)

        radiance = radiance + torch.where(active[:, None], throughput * sh.bias, 0.0)
        throughput = torch.where(active[:, None], throughput * sh.coef, throughput)

        new_start = hit.point + sh.direction * cfg.ray_offset
        new_seg = sh.direction * (z_far - cfg.ray_offset)
        start = torch.where(active[:, None], new_start, start)
        seg = torch.where(active[:, None], new_seg, seg)

        alive = active & sh.will_indirect

    if cfg.fast_render:
        # Lanes that would recurse past depth 1 return white (engine.cpp:67-70).
        radiance = radiance + torch.where(alive[:, None], throughput, 0.0)

    # Depth-0 light tone clamp (engine.cpp:148-151).
    norm = torch.sqrt(torch.clamp(vm.dot(radiance, radiance), min=1e-20))
    clamp = primary_light_hit & (norm > cfg.light_clamp)
    scale = torch.where(clamp, cfg.light_clamp / norm, 1.0)
    radiance = radiance * scale[:, None]

    return TraceOutput(radiance=radiance, aov_normal=aov_normal,
                       aov_depth=aov_depth, aov_mat=aov_mat, segments=segments)


def render_wavefront(scene: ScenePack, camera: Camera, cfg: RenderConfig,
                     seed, sample0, y0=0, rows=None,
                     intersector=None) -> TraceOutput:
    """Generate the rows×W×spp primary wavefront and trace it."""
    start, seg, pixel_idx, sample_idx = generate_rays(
        camera, cfg.width, cfg.height, cfg.spp, seed, sample0, y0=y0, rows=rows)
    return trace_radiance(scene, cfg, start, seg, pixel_idx, sample_idx,
                          seed, camera.z_far, intersector=intersector)


def render_step(scene: ScenePack, camera: Camera, cfg: RenderConfig,
                fb: fb_mod.Framebuffer, seed, frame_idx, y0=0,
                intersector=None):
    """One progressive frame: trace spp samples/pixel and accumulate.
    Returns the updated framebuffer and the segment count."""
    rows = fb.mean.shape[0]
    out = render_wavefront(scene, camera, cfg, seed, frame_idx * cfg.spp,
                           y0=y0, rows=rows, intersector=intersector)
    fb = fb_mod.accumulate(fb, out.radiance, out.aov_normal, out.aov_depth,
                           out.aov_mat, rows, cfg.width, cfg.spp)
    return fb, out.segments
