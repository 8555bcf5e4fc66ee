"""Differentiable BVH-scene intersection by hit-id replay.

Port of fspt_tpu/ops/diff_intersect.py.  Which triangle a ray hits is
piecewise constant in every continuous parameter, so a BVH walk has no
useful derivative.  The replay makes that precise and cheap:

1. the fast mesh intersector (ops/cuda_bvh.make_mesh_intersector: kernels 1,
   5 and 6) runs on detached inputs under ``torch.no_grad()`` and decides
   what each lane hits (``Hit.prim_id``, −1 for analytic primitives and
   misses);
2. one Möller–Trumbore of the single winning triangle recomputes t, point,
   normal, texcoords and ``edge_dist`` from the (possibly optimized) vertex
   tensors, exactly differentiable in the ray and the vertices;
3. analytic lanes take the brute-force intersector (ops/intersect.py),
   differentiable and cheap because a BVH scene keeps only its analytic
   primitives in ``scene.geometry``.

Silhouettes, where the winner changes, are the integrator's edge
reparameterization (``cfg.edge_eps``), which reads the replayed
``edge_dist``.  The reference's planar replay renderer
(``make_planar_recorded_replay``) is not ported: it measured slower than the
wavefront replay (reference parallel/train.py:330-338).
"""

from __future__ import annotations

import torch

from fspt_tpu_torch.ops.intersect import KIND_TRIANGLE, Hit, edge_distance, intersect_scene
from fspt_tpu_torch.utils import vecmath as vm


def tris_from_scene(scene_pack) -> dict:
    """The scene's triangles in original order, the layout the replay binds:
    ``v0, v1, v2`` ([T,3]), shading normals ``n0..n2``, texcoords
    ``t0..t2`` and ``mat``.  Swap optimized tensors in for the vertices."""
    bvh = scene_pack.bvh
    order = torch.argsort(bvh.tri_id.long())
    v0, e1, e2 = bvh.tri_v0[order], bvh.tri_e1[order], bvh.tri_e2[order]
    ts = scene_pack.tri_shade
    return dict(v0=v0, v1=v0 + e1, v2=v0 + e2, n0=ts.n0, n1=ts.n1, n2=ts.n2,
                t0=ts.t0, t1=ts.t1, t2=ts.t2, mat=ts.mat)


def flat_normals(v0, v1, v2):
    """Unit geometric normals of the triangles (all three shading slots)."""
    cr = vm.cross(v1 - v0, v2 - v0)
    return cr / torch.clamp(torch.linalg.vector_norm(cr, dim=-1, keepdim=True), min=1e-30)


def _gather_rows(tid_raw, n_rows):
    """The triangle row each lane's replay gathers: its winner, or for a
    lane without one (−1) a stand-in row whose values ``torch.where``
    discards.  The stand-ins are spread over the rows, not all on row 0:
    the gathers' backward (a sorted ``index_put``) adds each row's lanes in
    turn, and with a million lanes on row 0 a vertex step at 512²×4 lanes
    took about 1.3 s on an H100 instead of about 0.13 s
    (``tests/test_torch_kernels_gpu.py::test_vertex_gather_rules``)."""
    lane = torch.arange(tid_raw.shape[0], device=tid_raw.device)
    return torch.where(tid_raw >= 0, tid_raw.long(), lane % n_rows)


def _replay_hit(tr, geometry, start, seg, tid_raw, fh_hit) -> Hit:
    """Differentiable Hit from a decided winner: ``tid_raw`` (−1 = analytic
    or miss) and ``fh_hit`` carry the traversal's piecewise-constant
    decision; every continuous field is recomputed from ``tr``."""
    tri_hit = tid_raw >= 0
    tid = _gather_rows(tid_raw, tr["v0"].shape[0])
    v0 = tr["v0"][tid]
    e1 = tr["v1"][tid] - v0
    e2 = tr["v2"][tid] - v0
    pvec = vm.cross(seg, e2)
    det = vm.dot(e1, pvec)
    inv = 1.0 / torch.where(torch.abs(det) > 1e-30, det, 1.0)
    tvec = start - v0
    u = vm.dot(tvec, pvec) * inv
    qvec = vm.cross(tvec, e1)
    v = vm.dot(seg, qvec) * inv
    t_tri = vm.dot(e2, qvec) * inv

    u3, v3 = u[:, None], v[:, None]
    n0, n1, n2 = tr["n0"][tid], tr["n1"][tid], tr["n2"][tid]
    normal = n0 + (n1 - n0) * u3 + (n2 - n0) * v3
    t0, t1, t2 = tr["t0"][tid], tr["t1"][tid], tr["t2"][tid]
    texcoords = t0 + (t1 - t0) * u3 + (t2 - t0) * v3
    edge_dist = edge_distance(e1, e2, torch.linalg.vector_norm(vm.cross(e1, e2), dim=-1),
                              u, v)

    # The fast path decided the winner; base only serves non-triangle lanes.
    base = intersect_scene(geometry, start, seg)
    th = tri_hit[:, None]
    t = torch.where(tri_hit, t_tri, base.t)
    return Hit(
        t=t,
        point=start + seg * t[:, None],
        normal=torch.where(th, normal, base.normal),
        texcoords=torch.where(th, texcoords, base.texcoords),
        mat=torch.where(tri_hit, tr["mat"][tid], base.mat),
        prim_kind=torch.where(tri_hit, KIND_TRIANGLE, base.prim_kind),
        hit=fh_hit,
        edge_dist=torch.where(tri_hit, edge_dist, base.edge_dist),
        prim_id=tid_raw,
    )


def make_recorded_replay(scene_pack):
    """Replay intersector over pre-recorded winners: ``bind(tris, ids,
    hitm)`` with ``ids``/``hitm`` ``[N, D]`` (phase 1 of the two-phase
    vertex recovery) returns an intersector whose ``d``-th call replays
    column ``d``.  Each bound intersector serves one render."""
    geometry = scene_pack.geometry

    def bind(tris, ids, hitm):
        counter = iter(range(int(ids.shape[1])))

        def intersect(start, seg, alive=None):
            d = next(counter)
            return _replay_hit(tris, geometry, start, seg, ids[:, d], hitm[:, d])

        intersect.accepts_alive = True
        return intersect

    return bind


def make_diff_mesh_intersector(scene_pack):
    """The replay intersector of a BVH scene: ``inter(start, seg[, alive])
    → Hit`` on the scene's own triangles, and ``inter.bind(tris)`` for a
    dict of (optimized) triangle tensors in the layout of
    :func:`tris_from_scene`.  None for a scene without a BVH."""
    from fspt_tpu_torch.ops.cuda_bvh import make_mesh_intersector

    if scene_pack.bvh is None:
        return None
    fast = make_mesh_intersector(scene_pack)
    if fast is None:
        return None
    baked = tris_from_scene(scene_pack)
    geometry = scene_pack.geometry

    def bind(tris=None):
        tr = baked if tris is None else tris

        def intersect(start, seg, alive=None):
            with torch.no_grad():
                fh = fast(start.detach(), seg.detach(), alive)
            return _replay_hit(tr, geometry, start, seg, fh.prim_id, fh.hit)

        intersect.accepts_alive = True
        return intersect

    inter = bind()
    inter.bind = bind
    return inter
