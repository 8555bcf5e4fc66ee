"""Brute-force batched ray–primitive intersection in torch.

Port of fspt_tpu/ops/intersect.py (reference math/intersect.cpp,
object.cpp): every primitive type is tested against the whole wavefront as
``[N, P]`` tensors and the masked argmin picks the closest hit, first
primitive on ties.  This is the port's general intersector, used where the
CUDA intersector does not apply.  Rays are segments ``start + seg·t,
t∈[0,1]``; a miss is ``t = 2.0`` (math/trace.cpp:18-21).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fspt_tpu_torch.scene.geometry import GeometryPack, INVALID_PARAM
from fspt_tpu_torch.utils import vecmath as vm

# Primitive kind codes (argmin tie order = this order).
KIND_SPHERE, KIND_PLANE, KIND_DISC, KIND_QUAD, KIND_CUBOID, KIND_TRIANGLE = range(6)


class Hit(NamedTuple):
    """Per-lane closest-hit record (reference object.h:47-61)."""

    t: torch.Tensor  # [N] param in [0,1]; INVALID_PARAM = miss
    point: torch.Tensor  # [N,3]
    normal: torch.Tensor  # [N,3] shading normal (pre backface-flip)
    texcoords: torch.Tensor  # [N,2]
    mat: torch.Tensor  # [N] int32 material row
    prim_kind: torch.Tensor  # [N] int32 (0..5) winning primitive type
    hit: torch.Tensor  # [N] bool
    # World distance from the hit to the winning triangle's nearest edge
    # (3e38 for other primitives); differentiable w.r.t. the vertices, it
    # drives the integrator's edge reparameterization.
    edge_dist: torch.Tensor | None = None
    # Original index of the winning triangle (−1 for analytic primitives and
    # misses), set by the BVH paths: ops/diff_intersect.py replays it.
    prim_id: torch.Tensor | None = None


def _best(t_candidates, valid):
    """Masked min over the primitive axis → (t_best [N], idx [N])."""
    t = torch.where(valid, t_candidates, INVALID_PARAM)
    idx = torch.argmin(t, dim=-1)
    return torch.gather(t, -1, idx[:, None])[:, 0], idx


def _mm(a, b):
    """``[N,K] x [P,K] → [N,P]`` dot products in full float32."""
    return (a[:, None, :] * b[None, :, :]).sum(dim=-1)


def _plane_t(plane, start, seg):
    """One-sided fast ray-plane over [N,P]; intersect.cpp:728-745."""
    n = plane[..., :3]
    ts = _mm(seg, n)
    ns = -(_mm(start, n) + plane[..., 3][None, :])
    not_parallel = torch.abs(ts) >= vm.EPSILON
    t = ns / torch.where(not_parallel, ts, 1.0)
    valid = not_parallel & (t >= 0.0) & (t <= 1.0)
    return t, valid


def intersect_spheres(g: GeometryPack, start, seg):
    oc = start[:, None, :] - g.sph_center[None, :, :]  # [N,S,3]
    a = vm.dot(seg, seg)[:, None]
    b = 2.0 * (oc * seg[:, None, :]).sum(dim=-1)
    oc2 = (oc * oc).sum(dim=-1)
    rr = (g.sph_radius * g.sph_radius)[None, :]
    c = oc2 - rr
    d = b * b - 4.0 * a * c
    # A zero segment (a lane that stopped on a light keeps one) meets no
    # sphere; guarding it as the missing rays are keeps its masked values
    # finite, so their zero cotangents stay zero (the reference divides by
    # 2a = 0, and its vertex gradient turns NaN from depth 3 on).
    ok = (d >= 0.0) & (a > 0.0)
    sq = torch.sqrt(torch.where(ok, d, 1.0))
    inside = oc2 <= rr
    t = torch.where(inside, -b + sq, -b - sq) / torch.where(a > 0.0, 2.0 * a, 1.0)
    valid = ok & (t >= 0.0) & (t <= 1.0) & g.sph_valid[None, :]
    t_best, idx = _best(t, valid)
    center = g.sph_center[idx]
    point = start + seg * t_best[:, None]
    normal = vm.normalize(point - center)
    return t_best, dict(normal=normal, mat=g.sph_mat[idx])


def intersect_planes(g: GeometryPack, start, seg):
    t, valid = _plane_t(g.pln_plane, start, seg)
    t_best, idx = _best(t, valid & g.pln_valid[None, :])
    return t_best, dict(normal=g.pln_plane[idx, :3], mat=g.pln_mat[idx])


def intersect_discs(g: GeometryPack, start, seg):
    t, valid = _plane_t(g.dsc_plane, start, seg)
    point_all = start[:, None, :] + seg[:, None, :] * t[..., None]
    in_radius = vm.length(point_all - g.dsc_origin[None]) <= g.dsc_radius[None, :]
    t_best, idx = _best(t, valid & in_radius & g.dsc_valid[None, :])
    return t_best, dict(normal=g.dsc_plane[idx, :3], mat=g.dsc_mat[idx])


def intersect_quads(g: GeometryPack, start, seg):
    t, valid = _plane_t(g.qud_plane, start, seg)
    point_all = start[:, None, :] + seg[:, None, :] * t[..., None]
    ph = point_all - g.qud_origin[None]
    tangent_dist = (g.qud_tangent[None] * ph).sum(dim=-1)
    bitangent_dist = (g.qud_bitangent[None] * ph).sum(dim=-1)
    inside = (torch.abs(bitangent_dist) <= g.qud_half_w[None, :]) & (
        torch.abs(tangent_dist) <= g.qud_half_h[None, :])
    t_best, idx = _best(t, valid & inside & g.qud_valid[None, :])
    return t_best, dict(normal=g.qud_plane[idx, :3], mat=g.qud_mat[idx])


def intersect_cuboids(g: GeometryPack, start, seg):
    planes = g.cub_planes  # [C,6,4]
    n = planes[..., :3]
    ts = (seg[:, None, None, :] * n[None]).sum(dim=-1)  # [N,C,6]
    ns = -((start[:, None, None, :] * n[None]).sum(dim=-1) + planes[..., 3][None])
    not_parallel = torch.abs(ts) >= vm.EPSILON
    t = ns / torch.where(not_parallel, ts, 1.0)
    valid = not_parallel & (t >= 0.0) & (t <= 1.0)

    point = start[:, None, None, :] + seg[:, None, None, :] * t[..., None]  # [N,C,6,3]
    # Adjacent-face half-space test (object.cpp:140-150): for face i, every
    # face j with j//2 != i//2 must have plane_distance(point) <= 0.
    dists = ((point[:, :, :, None, :] * n[None, :, None, :, :]).sum(dim=-1)
             + planes[..., 3][None, :, None, :])  # [N,C,6(f),6(j)]
    fi = torch.arange(6, device=start.device)[:, None] // 2
    fj = torch.arange(6, device=start.device)[None, :] // 2
    adjacent = (fi != fj)[None, None]
    inside = torch.all(torch.where(adjacent, dists <= 0.0, True), dim=-1)

    t_face = torch.where(valid & inside, t, INVALID_PARAM)
    t_cub, face = torch.min(t_face, dim=-1)  # [N,C]
    t_best, idx = _best(t_cub, (t_cub < INVALID_PARAM) & g.cub_valid[None, :])
    face_best = torch.gather(face, -1, idx[:, None])[:, 0]
    return t_best, dict(normal=planes[idx, face_best, :3], mat=g.cub_mat[idx])


def intersect_triangles(g: GeometryPack, start, seg):
    """Möller–Trumbore over [N,T]; barycentric outputs for interpolation."""
    pvec = vm.cross(seg[:, None, :].expand(-1, g.tri_e2.shape[0], -1),
                    g.tri_e2[None].expand(seg.shape[0], -1, -1))
    det = (g.tri_e1[None] * pvec).sum(dim=-1)
    # |det| = |n·seg|·|e1×e2|: the reference's unit-normal epsilon test.
    not_parallel = torch.abs(det) >= vm.EPSILON * g.tri_area2[None, :]
    inv_det = 1.0 / torch.where(not_parallel, det, 1.0)
    tvec = start[:, None, :] - g.tri_v0[None]
    u = (tvec * pvec).sum(dim=-1) * inv_det
    qvec = vm.cross(tvec, g.tri_e1[None].expand_as(tvec))
    v = (seg[:, None, :] * qvec).sum(dim=-1) * inv_det
    t = (g.tri_e2[None] * qvec).sum(dim=-1) * inv_det
    valid = (not_parallel & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t >= 0.0) & (t <= 1.0) & g.tri_valid[None, :])
    t_best, idx = _best(t, valid)
    u_best = torch.gather(u, -1, idx[:, None])
    v_best = torch.gather(v, -1, idx[:, None])
    # Barycentric interpolation (intersect.cpp:131-145, mesh.cpp:277-322).
    n0, n1, n2 = g.tri_n0[idx], g.tri_n1[idx], g.tri_n2[idx]
    normal = n0 + (n1 - n0) * u_best + (n2 - n0) * v_best
    t0, t1, t2 = g.tri_t0[idx], g.tri_t1[idx], g.tri_t2[idx]
    texcoords = t0 + (t1 - t0) * u_best + (t2 - t0) * v_best
    return t_best, dict(normal=normal, mat=g.tri_mat[idx], texcoords=texcoords,
                        edge_dist=edge_distance(g.tri_e1[idx], g.tri_e2[idx],
                                                g.tri_area2[idx], u_best[:, 0],
                                                v_best[:, 0]))


def edge_distance(e1, e2, area2, u, v):
    """World distance from the hit at barycentrics ``(u, v)`` to the
    triangle's nearest edge: each barycentric times the height over its
    edge (2·area / edge length)."""
    d_u = u * area2 / torch.clamp(vm.length(e2), min=1e-30)
    d_v = v * area2 / torch.clamp(vm.length(e1), min=1e-30)
    d_w = (1.0 - u - v) * area2 / torch.clamp(vm.length(e2 - e1), min=1e-30)
    return torch.minimum(torch.minimum(d_u, d_v), d_w)


def intersect_scene(g: GeometryPack, start, seg) -> Hit:
    """Closest hit across every primitive type (brute force, no BVH);
    Scene::Trace's linear path (scene.cpp:230-233)."""
    results = [f(g, start, seg) for f in (
        intersect_spheres, intersect_planes, intersect_discs,
        intersect_quads, intersect_cuboids, intersect_triangles)]
    ts = torch.stack([r[0] for r in results], dim=0)  # [6,N]
    t_best, kind = torch.min(ts, dim=0)
    kind = kind.to(torch.int32)
    hit = t_best < INVALID_PARAM

    point = start + seg * t_best[:, None]
    normal = results[0][1]["normal"]
    mat = results[0][1]["mat"]
    for k in range(1, 6):
        m = kind == k
        normal = torch.where(m[:, None], results[k][1]["normal"], normal)
        mat = torch.where(m, results[k][1]["mat"], mat)

    # Texcoords by winner type (object.cpp:31, 67, 106, 158, 231; mesh interp).
    tc_sphere = vm.sphere_map_texcoords(results[0][1]["normal"])
    tc_planar = vm.planar_map_texcoords(point, normal)
    planar = (kind == KIND_PLANE) | (kind == KIND_DISC) | (kind == KIND_QUAD)
    texcoords = torch.where(planar[:, None], tc_planar, tc_sphere)
    texcoords = torch.where((kind == KIND_CUBOID)[:, None], tc_planar * 0.1, texcoords)
    texcoords = torch.where((kind == KIND_TRIANGLE)[:, None],
                            results[5][1]["texcoords"], texcoords)

    edge_dist = torch.where(kind == KIND_TRIANGLE, results[5][1]["edge_dist"], 3.0e38)
    return Hit(t=t_best, point=point, normal=normal, texcoords=texcoords,
               mat=mat.to(torch.int32), prim_kind=kind, hit=hit, edge_dist=edge_dist)
