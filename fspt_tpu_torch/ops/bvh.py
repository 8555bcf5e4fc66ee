"""Flattened BVH: host-side build → flat tensors → stackless traversal.

Port of fspt_tpu/ops/bvh.py.  The tree is a binary BVH flattened to
pre-order arrays with miss links (escape indices), so traversal is a loop
with no stack:

    at node i:  AABB hit?  internal → i+1 (first child is next in pre-order)
                           leaf     → intersect its triangle range, then miss[i]
                AABB miss? → miss[i]

:func:`build_bvh` builds with the native library (utils/native.py);
:func:`_build_bvh_numpy` / :func:`_build_bvh_preorder` are the plain NumPy
builder with the same output, which the tests hold the native one against.
:func:`traverse_bvh` is the miss-link walk in torch, a ``while`` loop over
lanes with one host sync per iteration: the port's plain BVH intersector,
the plain version of kernel 11 (ops/cuda_bvh.make_bvh_traverser) and the
reference that the treelet paths (ops/cuda_bvh.py) are held against.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np
import torch

from fspt_tpu_torch.config import resolve_device
from fspt_tpu_torch.scene.geometry import INVALID_PARAM
from fspt_tpu_torch.utils import vecmath as vm

MAX_LEAF_TRIS = 4
_FAR = 3.0e38  # above every valid t: the masked slots of a leaf


class FlatBVH(NamedTuple):
    """Pre-order flattened BVH with miss links (tensors on one device)."""

    bmin: torch.Tensor  # [M,3] float32
    bmax: torch.Tensor  # [M,3]
    first: torch.Tensor  # [M] int32 — leaf: first tri slot; internal: unused
    count: torch.Tensor  # [M] int32 — 0 for internal nodes
    miss: torch.Tensor  # [M] int32 — next node on miss/after leaf; M = done
    # Reordered triangle data (leaf ranges are contiguous).
    tri_v0: torch.Tensor  # [T,3]
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    tri_area2: torch.Tensor  # [T]
    tri_id: torch.Tensor  # [T] int32 — original triangle index

    @property
    def n_nodes(self) -> int:
        return self.bmin.shape[0]


def flat_bvh(order, bmin, bmax, first, count, miss, v0, v1, v2, device) -> FlatBVH:
    """Pack a pre-order build (NumPy) and the triangles into a FlatBVH."""
    v0o, v1o, v2o = v0[order], v1[order], v2[order]
    e1, e2 = v1o - v0o, v2o - v0o
    area2 = np.linalg.norm(np.cross(e1, e2), axis=-1)
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
    return FlatBVH(bmin=f32(bmin), bmax=f32(bmax), first=i32(first), count=i32(count),
                   miss=i32(miss), tri_v0=f32(v0o), tri_e1=f32(e1), tri_e2=f32(e2),
                   tri_area2=f32(area2), tri_id=i32(order))


def build_bvh(v0, v1, v2, max_leaf: int = MAX_LEAF_TRIS, device=None) -> FlatBVH:
    """Median-split BVH over triangle centroids, built by the native library."""
    from fspt_tpu_torch.utils import native

    v0, v1, v2 = (np.asarray(v, np.float32) for v in (v0, v1, v2))
    return flat_bvh(*native.build_bvh(v0, v1, v2, max_leaf), v0, v1, v2,
                    resolve_device(device))


def _build_bvh_numpy(v0, v1, v2, max_leaf):
    tmin = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    tmax = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    centroid = ((tmin + tmax) * 0.5).astype(np.float32)
    return _build_bvh_preorder(tmin, tmax, centroid, max_leaf)


def _build_bvh_preorder(tmin, tmax, centroid, max_leaf):
    """Recursive pre-order emission with miss links patched after each left
    subtree (the right sibling's index is known only then)."""
    n = len(tmin)
    order: list[int] = []
    bmin_l: list = []
    bmax_l: list = []
    first_l: list = []
    count_l: list = []
    miss_l: list = []
    done = -1  # "exit traversal"; replaced by n_nodes at the end

    def emit(idx, miss_target):
        slot = len(bmin_l)
        bmin_l.append(tmin[idx].min(axis=0))
        bmax_l.append(tmax[idx].max(axis=0))
        first_l.append(0)
        count_l.append(0)
        miss_l.append(miss_target)
        if len(idx) <= max_leaf:
            first_l[slot] = len(order)
            count_l[slot] = len(idx)
            order.extend(idx.tolist())
            return slot
        axis = int(np.argmax(bmax_l[slot] - bmin_l[slot]))
        srt = np.argsort(centroid[idx, axis], kind="stable")
        half = len(idx) // 2
        left_root = emit(idx[srt[:half]], miss_target=None)
        right_root = len(bmin_l)
        for i in range(left_root, right_root):
            if miss_l[i] is None:
                miss_l[i] = right_root
        emit(idx[srt[half:]], miss_target=miss_target)
        return slot

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(10000, old_limit))
    try:
        emit(np.arange(n), miss_target=done)
    finally:
        sys.setrecursionlimit(old_limit)

    n_nodes = len(bmin_l)
    miss = np.array([n_nodes if m in (done, None) else m for m in miss_l], np.int64)
    return (np.asarray(order, np.int64), np.stack(bmin_l), np.stack(bmax_l),
            np.asarray(first_l, np.int64), np.asarray(count_l, np.int64), miss)


def _slab_entry(bmin, bmax, start, seg):
    """Segment/AABB test and entry param (0 when the origin is inside)."""
    inv = 1.0 / torch.where(torch.abs(seg) < 1e-30,
                            torch.where(seg >= 0, 1e-30, -1e-30), seg)
    t0 = (bmin - start) * inv
    t1 = (bmax - start) * inv
    tnear = torch.amax(torch.minimum(t0, t1), dim=-1)
    tfar = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = (tnear <= tfar) & (tfar >= 0.0) & (tnear <= 1.0)
    return hit, torch.clamp(tnear, min=0.0)


def traverse_bvh(bvh: FlatBVH, start, seg, t_init=None, max_leaf: int = MAX_LEAF_TRIS):
    """Closest triangle hit for every lane: ``(t [N], tri_id [N], u [N],
    v [N])`` with tri_id −1 on a miss.  ``t_init`` seeds each lane's best t
    (INVALID_PARAM by default); a lane with ``t_init ≤ 0`` is dead and walks
    nothing.  ``max_leaf`` must be at least the tree's largest leaf (the
    ``max_leaf`` it was built with)."""
    return walk_bvh(bvh, start, seg, t_init, max_leaf)[:4]


def walk_bvh(bvh: FlatBVH, start, seg, t_init=None, max_leaf: int = MAX_LEAF_TRIS):
    """:func:`traverse_bvh` plus, per lane, the nodes it tested and the
    triangles it tested (int32): the plain version of kernel 11
    (ops/cuda_bvh.make_bvh_traverser), operation for operation."""
    n = start.shape[0]
    dev = start.device
    m = bvh.n_nodes
    n_tris = bvh.tri_v0.shape[0]
    if int(bvh.count.max()) > max_leaf:
        raise ValueError(f"a leaf holds {int(bvh.count.max())} triangles, more than "
                         f"max_leaf={max_leaf}")
    t_best = (torch.full((n,), INVALID_PARAM, dtype=torch.float32, device=dev)
              if t_init is None else t_init.to(torch.float32).clone())
    node = torch.where(t_best > 0.0, 0, m).to(torch.int64)
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    visits = torch.zeros((n,), dtype=torch.int32, device=dev)
    tested = torch.zeros((n,), dtype=torch.int32, device=dev)
    count_all = bvh.count.long()
    first_all = bvh.first.long()
    miss_all = bvh.miss.long()
    sx, sy, sz = start[:, 0:1], start[:, 1:2], start[:, 2:3]
    dx, dy, dz = seg[:, 0:1], seg[:, 1:2], seg[:, 2:3]
    slots = torch.arange(max_leaf, device=dev)

    while bool((node < m).any()):
        nidx = torch.clamp(node, max=m - 1)
        active = node < m
        box_hit, entry = _slab_entry(bvh.bmin[nidx], bvh.bmax[nidx], start, seg)
        box_hit = box_hit & (entry <= t_best) & active
        count = count_all[nidx]
        first = first_all[nidx]
        is_leaf = count > 0
        visits += active.to(torch.int32)
        leaf_work = box_hit & is_leaf
        tested += torch.where(leaf_work, count, 0).to(torch.int32)

        # Möller–Trumbore of a leaf's slots at once ([N, max_leaf]), the
        # cross-product form term by term (kernel 11 adds the same terms in
        # the same order).  The first slot of the smallest t wins, as a
        # strict < in slot order does.
        tid = torch.clamp(first[:, None] + slots, 0, n_tris - 1)
        v0, e1, e2 = bvh.tri_v0[tid], bvh.tri_e1[tid], bvh.tri_e2[tid]
        e1x, e1y, e1z = e1[..., 0], e1[..., 1], e1[..., 2]
        e2x, e2y, e2z = e2[..., 0], e2[..., 1], e2[..., 2]
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        np_ = torch.abs(det) >= vm.EPSILON * bvh.tri_area2[tid]
        inv = 1.0 / torch.where(np_, det, 1.0)
        tx, ty, tz = sx - v0[..., 0], sy - v0[..., 1], sz - v0[..., 2]
        u = (tx * pvx + ty * pvy + tz * pvz) * inv
        qvx = ty * e1z - tz * e1y
        qvy = tz * e1x - tx * e1z
        qvz = tx * e1y - ty * e1x
        v = (dx * qvx + dy * qvy + dz * qvz) * inv
        t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
        ok = ((leaf_work[:, None] & (slots < count[:, None])) & np_ & (u >= 0) & (v >= 0)
              & (u + v <= 1) & (t >= 0) & (t <= 1) & (t < t_best[:, None]))
        t_min, j = torch.where(ok, t, _FAR).min(dim=1)
        hit = ok.any(dim=1)
        pick = lambda x: x.gather(1, j[:, None])[:, 0]  # noqa: E731
        t_best = torch.where(hit, t_min, t_best)
        best_tri = torch.where(hit, bvh.tri_id[pick(tid)], best_tri)
        best_u = torch.where(hit, pick(u), best_u)
        best_v = torch.where(hit, pick(v), best_v)

        descend = box_hit & ~is_leaf
        nxt = torch.where(descend, nidx + 1, miss_all[nidx])
        node = torch.where(active, nxt, node)
    return t_best, best_tri, best_u, best_v, visits, tested
