"""Scene-level sharding: the triangles distributed over the mesh's ranks.

Port of fspt_tpu/parallel/scene_shard.py.  Replication keeps the whole
scene on every rank, right for every scene that fits; this is the capacity
path for scenes that do not.  Each rank owns a spatially contiguous shard
of the triangles (its own sub-BVH or treelet tables and shading rows), the
rays are replicated, every rank intersects only its shard, and the closest
hit merges over the mesh: ``all_reduce(MIN)`` on ``t``, the lowest rank on
ties, ``all_reduce(SUM)`` of each field selected on the winner,
``all_reduce(MAX)`` of the hit flag (:func:`merge_hits`).

Each rank builds its own shard only.  The reference pads the shards to
common shapes and stacks them so that they ride ``shard_map``; here each
rank holds its own tensors, so the fast path's tables are just
``cuda_bvh.make_culled_traverser(build_treelet_chunks(shard triangles))``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.ops.bvh import FlatBVH, build_bvh, traverse_bvh
from fspt_tpu_torch.ops.intersect import KIND_TRIANGLE, Hit, intersect_scene
from fspt_tpu_torch.render import framebuffer as fb_mod
from fspt_tpu_torch.render import integrator
from fspt_tpu_torch.scene.builder import ScenePack, TriShade

BIG = 3.0e38  # a miss's t in the merge


class TriangleShard(NamedTuple):
    """One shard: its vertices (shard order), a sub-BVH whose ``tri_id`` is
    shard-local (it indexes ``shade`` and ``gids``), the shading rows,
    ``gids`` (shard-local → global id) and the triangles' box."""

    v0: np.ndarray
    v1: np.ndarray
    v2: np.ndarray
    bvh: FlatBVH
    shade: TriShade
    gids: torch.Tensor  # [T_s] int32
    box_lo: torch.Tensor  # [3]
    box_hi: torch.Tensor  # [3]


def _scene_triangles(scene: ScenePack):
    """The BVH scene's triangles in original id order: ``(v0, v1, v2)``."""
    bvh = scene.bvh
    order0 = np.argsort(bvh.tri_id.cpu().numpy())
    v0 = bvh.tri_v0.cpu().numpy()[order0]
    return v0, v0 + bvh.tri_e1.cpu().numpy()[order0], v0 + bvh.tri_e2.cpu().numpy()[order0]


def shard_scene_triangles(scene: ScenePack, n_shards: int, shards=None):
    """Split a BVH scene's triangles into ``n_shards`` spatially contiguous
    shards: sorted by centroid along the widest centroid axis (stable),
    split evenly at ``np.linspace`` bounds.

    Returns ``(built, order, bounds)``: ``built`` maps each shard index in
    ``shards`` (all by default; a rank passes its own) to its
    :class:`TriangleShard`, on the scene's device; shard ``s`` holds the
    triangles ``order[bounds[s]:bounds[s + 1]]``.
    """
    if scene.bvh is None:
        raise ValueError("scene sharding needs a BVH scene")
    v0, v1, v2 = _scene_triangles(scene)
    n_tris = len(v0)
    if n_tris < n_shards:
        raise ValueError(
            f"scene has {n_tris} triangles but {n_shards} shards were requested; scene "
            "sharding is the capacity path for large scenes — replicate small scenes "
            "instead (or use fewer shards)")
    cent = (v0 + v1 + v2) / 3.0
    axis = int(np.argmax(cent.max(axis=0) - cent.min(axis=0)))
    order = np.argsort(cent[:, axis], kind="stable")
    bounds = np.linspace(0, n_tris, n_shards + 1).astype(np.int64)
    dev = scene.device
    ts = scene.tri_shade
    built = {}
    for s in range(n_shards) if shards is None else shards:
        idx = order[bounds[s]:bounds[s + 1]]
        a, b, c = v0[idx], v1[idx], v2[idx]
        sel = torch.from_numpy(idx).to(dev)
        built[s] = TriangleShard(
            v0=a, v1=b, v2=c, bvh=build_bvh(a, b, c, device=dev),
            shade=TriShade(*(x[sel] for x in ts)),
            gids=torch.from_numpy(idx.astype(np.int32)).to(dev),
            box_lo=torch.from_numpy(np.minimum(a, np.minimum(b, c)).min(axis=0)).to(dev),
            box_hi=torch.from_numpy(np.maximum(a, np.maximum(b, c)).max(axis=0)).to(dev))
    return built, order, bounds


def merge_hits(hit: Hit, rank, n: int, reduce) -> Hit:
    """The closest hit over ``n`` shards: ``reduce(x, op)`` reduces ``x``
    over the shards with ``op`` (``"min"``, ``"sum"``, ``"max"``) and gives
    every shard the result; ``rank`` is the shard's index.  ``t`` takes the
    minimum (misses at :data:`BIG`), the lowest rank wins ties, every field
    is the winner's (a sum where only the winner adds), the hit flag the
    maximum; a lane no shard hits keeps its own ``t`` and gets ``prim_id``
    −1.  The rule of the reference's ``_merge_hits``
    (fspt_tpu/parallel/scene_shard.py:125-156)."""
    t_cand = torch.where(hit.hit, hit.t, BIG)
    t_min = reduce(t_cand, "min")
    is_min = hit.hit & (t_cand == t_min)
    win_rank = reduce(torch.where(is_min, torch.as_tensor(rank, dtype=torch.int32,
                                                          device=t_cand.device), n)
                      .to(torch.int32), "min")
    sel = is_min & (win_rank == rank)
    floats = torch.cat([hit.t[..., None], hit.point, hit.normal, hit.texcoords], dim=-1)
    ints = torch.stack([hit.mat, hit.prim_kind, hit.prim_id], dim=-1).to(torch.int32)
    floats = reduce(torch.where(sel[..., None], floats, 0.0), "sum")
    ints = reduce(torch.where(sel[..., None], ints, 0), "sum")
    any_hit = reduce(hit.hit.to(torch.int32), "max") > 0
    return Hit(t=torch.where(any_hit, floats[..., 0], hit.t), point=floats[..., 1:4],
               normal=floats[..., 4:7], texcoords=floats[..., 7:9], mat=ints[..., 0],
               prim_kind=ints[..., 1], hit=any_hit,
               prim_id=torch.where(any_hit, ints[..., 2], -1))


_OPS = {"min": dist.ReduceOp.MIN, "sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _merge_hits(hit: Hit, mesh) -> Hit:
    """:func:`merge_hits` over the mesh's ranks (``all_reduce``); the
    identity on a mesh of one."""
    if mesh.size == 1:
        return hit
    return merge_hits(hit, mesh.rank, mesh.size, lambda x, op: mesh.all_reduce(x, _OPS[op]))


def merge_stacked_hits(hits: list) -> Hit:
    """:func:`merge_hits` of the shards' hits held in one process (shard
    ``s`` is ``hits[s]``): the same rule, reduced over a stacked axis."""
    n = len(hits)
    stacked = Hit(*(None if f[0] is None else torch.stack(f) for f in zip(*hits)))
    ops = {"min": lambda x: x.amin(0), "sum": lambda x: x.sum(0), "max": lambda x: x.amax(0)}
    rank = torch.arange(n, dtype=torch.int32, device=hits[0].t.device)[:, None]
    merged = merge_hits(stacked._replace(edge_dist=None), rank, n,
                        lambda x, op: ops[op](x)[None])
    return Hit(*(None if f is None else f[0] for f in merged))


def _local_hit(base: Hit, start, seg, shard: TriangleShard, t_tri, tid_l, u, v, wins):
    """``base`` with the lanes of ``wins`` replaced by the shard's triangle
    hit; ``prim_id`` is the global triangle id (−1 elsewhere)."""
    tid = torch.clamp(tid_l, min=0).long()
    sh = shard.shade
    u3, v3 = u[:, None], v[:, None]
    normal = sh.n0[tid] + (sh.n1[tid] - sh.n0[tid]) * u3 + (sh.n2[tid] - sh.n0[tid]) * v3
    tex = sh.t0[tid] + (sh.t1[tid] - sh.t0[tid]) * u3 + (sh.t2[tid] - sh.t0[tid]) * v3
    t = torch.where(wins, t_tri, base.t)
    w3 = wins[:, None]
    return Hit(t=t, point=start + seg * t[:, None],
               normal=torch.where(w3, normal, base.normal),
               texcoords=torch.where(w3, tex, base.texcoords),
               mat=torch.where(wins, sh.mat[tid], base.mat),
               prim_kind=torch.where(wins, KIND_TRIANGLE, base.prim_kind).to(torch.int32),
               hit=base.hit | wins,
               prim_id=torch.where(wins, shard.gids[tid], -1).to(torch.int32))


def make_shard_intersector(scene: ScenePack, shard: TriangleShard, fast: bool = False):
    """``bind(scene_in) → fn(start, seg, alive=None) → Hit``: the closest
    hit against the analytic primitives and this shard's triangles alone
    (before the merge).

    ``fast=False``: the analytic primitives of ``scene_in`` by brute force
    and the shard's sub-BVH walk (ops/bvh.traverse_bvh).  ``fast=True``:
    kernel 1 (ops/cuda_trace) on the build-time primitives (brute force of
    ``scene_in`` above 512), each t clipped at the ray's exit from the
    shard's box, the rays sorted stably by Morton key against that box,
    kernels 5 and 6 on the shard's treelet tables, then ``post``; the
    bound ``fn.sweep_inputs(start, seg, alive)`` gives the sorted rays and
    their seeds as the sweep sees them, and ``bind.traverser`` is the
    shard's culled traverser.
    """
    from fspt_tpu_torch.ops import cuda_bvh
    from fspt_tpu_torch.ops.cuda_trace import make_cuda_intersector

    if not fast:
        def bind(scene_in):
            def intersect(start, seg, alive=None):
                base = intersect_scene(scene_in.geometry, start, seg)
                t_tri, tid_l, u, v = traverse_bvh(shard.bvh, start, seg)
                wins = (tid_l >= 0) & (t_tri < base.t)
                return _local_hit(base, start, seg, shard, t_tri, tid_l, u, v, wins)

            intersect.accepts_alive = True
            return intersect

        return bind

    base_fn = make_cuda_intersector(scene.geometry)
    trav = cuda_bvh.make_culled_traverser(
        cuda_bvh.build_treelet_chunks(shard.v0, shard.v1, shard.v2), device=scene.device)
    lo, hi = shard.box_lo, shard.box_hi

    def bind(scene_in):
        def base_hit(start, seg):
            return (base_fn(start, seg) if base_fn is not None
                    else intersect_scene(scene_in.geometry, start, seg))

        def sweep_inputs(start, seg, alive=None, base=None):
            """The rays sorted as the sweep sees them: ``(start, seg,
            t_init, perm)``."""
            if base is None:
                base = base_hit(start, seg)
            t_init = torch.minimum(base.t, cuda_bvh.box_exit(start, seg, lo, hi))
            if alive is not None:
                t_init = torch.where(alive, t_init, 0.0)
            perm = torch.argsort(cuda_bvh.morton_keys(start, seg, alive, lo, hi), stable=True)
            return start[perm], seg[perm], t_init[perm], perm

        def intersect(start, seg, alive=None):
            base = base_hit(start, seg)
            start_s, seg_s, t_init_s, perm = sweep_inputs(start, seg, alive, base)
            t_sorted, best_sorted = trav.raw(start_s, seg_s, t_init_s)
            t_kern = torch.empty_like(t_sorted)
            best = torch.empty_like(best_sorted)
            t_kern[perm] = t_sorted
            best[perm] = best_sorted
            t_tri, tid_l, u, v = trav.post(start, seg, t_kern, best)
            # Seeded with the analytic t: any triangle hit is strictly closer.
            return _local_hit(base, start, seg, shard, t_tri, tid_l, u, v, tid_l >= 0)

        intersect.accepts_alive = True
        intersect.sweep_inputs = sweep_inputs
        return intersect

    bind.traverser = trav
    return bind


def make_scene_sharded_render_step(mesh, cfg: RenderConfig, scene: ScenePack,
                                   fast: bool = False, queue: int = 1 << 17):
    """Render step with the triangles sharded over the mesh and the rays
    replicated: ``step(scene_in, camera, fb, seed, frame_idx) → (fb,
    segments)``, the full frame, equal on every rank (no ``all_reduce`` of
    the segments: every rank traced the same ones).

    Each rank intersects the whole wavefront against its own shard
    (:func:`make_shard_intersector`), and the closest hits merge over the
    mesh each bounce.  ``fast=False`` runs the unrolled integrator on the
    sub-BVH walk; ``fast=True`` the regenerating queue (``queue`` lanes,
    render/queue.py) on kernels 1, 5 and 6.  The queue tests its loop
    condition on the host each iteration; its state is replicated and the
    merged hits are equal on every rank, so all ranks run the same trip
    count in lockstep (a rank that diverged would hang the merge's
    collectives).

    Baked-scene contract: the shard (sub-BVH or treelet tables, shading
    rows, global ids) is built once from ``scene``; ``scene_in`` supplies
    only the live analytic geometry, materials and textures.  A
    ``scene_in`` whose triangles differ renders the baked triangles
    against the new materials: rebuild the step for a new triangle set.
    ``step.shard`` is this rank's :class:`TriangleShard`.
    """
    if not mesh.member:
        raise ValueError("this rank is outside the mesh")
    built, _, _ = shard_scene_triangles(scene, mesh.size, shards=(mesh.rank,))
    shard = built[mesh.rank]
    bind = make_shard_intersector(scene, shard, fast=fast)

    def step(scene_in, camera, fb, seed, frame_idx):
        local = bind(scene_in)

        def intersect(start, seg, alive=None):
            return _merge_hits(local(start, seg, alive), mesh)

        intersect.accepts_alive = True
        if not fast:
            return integrator.render_step(scene_in, camera, cfg, fb, seed, frame_idx,
                                          intersector=intersect)
        from fspt_tpu_torch.render.queue import render_queued

        out = render_queued(scene_in, camera, cfg, seed, frame_idx * cfg.spp,
                            intersector=intersect, queue=queue)
        fb = fb_mod.accumulate(fb, out.radiance, out.aov_normal, out.aov_depth, out.aov_mat,
                               cfg.height, cfg.width, cfg.spp)
        return fb, out.segments

    step.shard = shard
    return step
