"""BVH traversal of meshes: kernels 5 (cull), 6 (sweep), 11 and 12 (walks).

Counterpart of fspt_tpu/ops/pallas_bvh.py's culled treelet path
(``build_treelet_chunks``, ``treelet_tables``, ``morton_keys``,
``make_culled_traverser``, ``make_mesh_intersector``).  The mesh is cut into
treelets of 128 triangles; rays go in blocks of :data:`BLOCK_RAYS`:

1. kernel 5, ``treelet_cull_kernel`` (csrc/fspt_bvh.cu), replaces the Pallas
   kernel of ``make_culled_traverser.pallas_cull`` (``cull_kernel``): the
   exact slab test of every ray of a block against every treelet box,
   min-reduced over the block's rays to one ``[B, L]`` entry-t key;
2. :func:`order_from_key` packs each key with its leaf id into one int32
   and sorts each row with ``torch.sort`` (XLA in the reference): the
   block's surviving leaves front to back;
3. kernel 6, ``treelet_sweep_kernel``, replaces ``make_culled_traverser.
   sweep`` (the parity ``kernel`` and the ``ring_kernel``): each block walks
   its leaf list, tests every ray against the leaf's 128 triangles with the
   sign-folded Möller–Trumbore of the reference's epilogue, keeps
   ``(t_best, best = leaf·128 + slot)`` per ray and stops once the next
   leaf's entry t passes the block's worst hit; on the card eight threads
   share a ray and the blocks start heaviest first (:func:`block_order`);
4. :func:`post` recomputes the exact t, u, v and original triangle id of
   each ray's winner, in torch.

Möller–Trumbore as linear forms: with ray features ``F = [d, c = o×d, o,
1, t0]`` (16 floats a ray), the four numerators of a triangle are

    det   = d·(e2×e1)
    u_num = c·e2 − d·(e2×v0)
    v_num = −c·e1 − d·(v0×e1)
    t_num = o·(e1×e2) − v0·(e1×e2)

so each triangle is 19 weights, kept with ``EPSILON·area`` as 20 floats
(:class:`TreeletTables`, ``weights [L, 128, 20]``).  The TPU kernel ran them
as one MXU matmul; Hopper has gathers, so the port keeps no lane packing
and sums each numerator term by term.  Kernel and plain version add the
same non-zero terms in the same order (the kernels build with
``-fmad=false``), so they agree bit for bit, and a ray's winner depends
only on its block: which 64 rays share a block (the Morton sort, kept
stable as ``jnp.argsort`` is) decides near-tie winners.

Two tree walks in csrc/fspt_bvh.cu, one thread a ray over packed node
records (:func:`walk_nodes`), leaves postponed until the warp tests them
together, replace the reference's other two Pallas traversers (its callers
are tests only; the port's are chip_smoke.py and the tests):

* kernel 11, ``bvh_walk_kernel`` (:func:`make_bvh_traverser`), replaces
  ``pallas_bvh.make_bvh_traverser``: the miss-link walk of
  ``ops/bvh.traverse_bvh`` over a tree with ``max_leaf``-triangle leaves,
  cross-product Möller–Trumbore, whose plain version is
  :func:`ops.bvh.walk_bvh`;
* kernel 12, ``treelet_walk_kernel`` (:func:`make_treelet_traverser`),
  replaces ``pallas_bvh.make_treelet_traverser``: the same walk over a tree
  of 128-triangle leaves, each leaf tested with kernel 6's weight form, by
  the warp's lanes together on the card (plain version
  :func:`plain_treelet_walk`, per ray :func:`_leaf_test`).

The plain versions (:func:`plain_cull`, :func:`plain_sweep`,
:func:`ops.bvh.walk_bvh`, :func:`plain_treelet_walk`) take the same inputs
and give the same outputs; a wrapper uses them only for tensors on the CPU.
On a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from fspt_tpu_torch.ops import _build
from fspt_tpu_torch.ops.bvh import FlatBVH, _slab_entry, walk_bvh
from fspt_tpu_torch.scene.geometry import INVALID_PARAM
from fspt_tpu_torch.utils import vecmath as vm

TREELET = 128  # triangles per leaf
BLOCK_RAYS = 64  # rays per block (csrc kRays)
GROUP = 8  # leaves swept between two early-exit tests
N_FEATURES = 16  # floats per ray feature row; 11 used
W_ROWS = 20  # floats per triangle: 19 Möller–Trumbore weights + EPSILON·area
BIG = 3.0e38  # culled / pad key
NO_HIT = 0x7FFFFFFF

# Float operations of one ray against one treelet box in the cull (6 subs,
# 6 muls, 12 min/max, 3 compares and 2 selects, rounded up) and of one ray
# against one triangle in the sweep (numerators 33, sign fold 4, the test
# 9, the packed key 5): the counts behind chip_smoke.py's bounds.
OPS_PER_SLAB = 30
OPS_PER_TRIANGLE = 51
# Float operations of the cross-product Möller–Trumbore of kernel 11 (two
# crosses 18, three dots and the scale 17, the origin offset 3, the
# parallel test 3, the reciprocal 2, the range tests 9, rounded up) and of a
# node's slab test in the walks (as the cull's).
OPS_PER_MT_TRIANGLE = 58
OPS_PER_NODE = OPS_PER_SLAB

TREELET_CULL = _build.KernelCounter(
    "treelet_cull", "fspt_bvh", "fspt_treelet_cull",
    "fspt_tpu/ops/pallas_bvh.py:1396 make_culled_traverser.pallas_cull (body cull_kernel :1337)")
TREELET_SWEEP = _build.KernelCounter(
    "treelet_sweep", "fspt_bvh", "fspt_treelet_sweep",
    "fspt_tpu/ops/pallas_bvh.py:1460 make_culled_traverser.sweep (bodies kernel :1056, "
    "ring_kernel :1232)")
BVH_WALK = _build.KernelCounter(
    "bvh_walk", "fspt_bvh", "fspt_bvh_walk",
    "fspt_tpu/ops/pallas_bvh.py:251 make_bvh_traverser (body kernel :94)")
TREELET_WALK = _build.KernelCounter(
    "treelet_walk", "fspt_bvh", "fspt_treelet_walk",
    "fspt_tpu/ops/pallas_bvh.py:676 make_treelet_traverser (body kernel :538)")


# ---------------------------------------------------------------------------
# Host side: treelets and their tables


def build_treelet_chunks(v0, v1, v2, leaf: int = TREELET, device=None) -> FlatBVH:
    """Balanced k-d chunking into full treelets: a leaf-only FlatBVH.

    Splits the widest centroid axis at a multiple of ``leaf`` nearest the
    median, so every treelet is full except one (reference
    ``pallas_bvh.build_treelet_chunks``, exact in NumPy).  Leaves carry
    ``count > 0`` and ``miss = i + 1``; there are no internal nodes.
    """
    from fspt_tpu_torch.ops.bvh import flat_bvh

    v0, v1, v2 = (np.asarray(v, np.float32) for v in (v0, v1, v2))
    n = v0.shape[0]
    cent = (v0 + v1 + v2) / 3.0
    chunks = []

    def split(idx):
        m = len(idx)
        if m <= leaf:
            chunks.append(idx)
            return
        c = cent[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, axis], kind="stable")
        k = int(round((m / 2) / leaf)) * leaf
        k = min(max(k, leaf), ((m - 1) // leaf) * leaf)
        split(idx[order[:k]])
        split(idx[order[k:]])

    split(np.arange(n, dtype=np.int64))
    order = np.concatenate(chunks)
    lo = np.minimum(v0, np.minimum(v1, v2))[order]
    hi = np.maximum(v0, np.maximum(v1, v2))[order]
    sizes = np.array([len(c) for c in chunks], np.int32)
    first = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    bmin = np.stack([np.minimum.reduceat(lo[:, a], first) for a in range(3)], axis=1)
    bmax = np.stack([np.maximum.reduceat(hi[:, a], first) for a in range(3)], axis=1)
    miss = np.arange(1, len(chunks) + 1, dtype=np.int32)
    return flat_bvh(order, bmin, bmax, first, sizes, miss, v0, v1, v2,
                    torch.device("cpu") if device is None else device)


class TreeletTables(NamedTuple):
    """The leaves of a treelet BVH in the layout kernels 5 and 6 read.

    ``weights[l, j]`` holds triangle ``j`` of leaf ``l``: its 19
    Möller–Trumbore weights (det 0-2 on d; u 3-5 on d, 6-8 on c; v 9-14
    likewise; t 15-17 on o, 18 the constant) and ``EPSILON·area`` (19).
    Slots past a leaf's count have zero weights and ``EPSILON·3e38``: they
    never hit.  The triangle arrays serve :func:`post`.
    """

    lbmin: torch.Tensor  # [L,3] float32 leaf boxes
    lbmax: torch.Tensor  # [L,3]
    weights: torch.Tensor  # [L,128,20] float32
    leaf_first: torch.Tensor  # [L] int32 first triangle slot of each leaf
    tri_v0: torch.Tensor  # [T,3]
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    tri_id: torch.Tensor  # [T] int32 original triangle id

    @property
    def n_leaves(self) -> int:
        return self.lbmin.shape[0]


def treelet_tables(bvh: FlatBVH, device=None) -> TreeletTables:
    """Tables of the leaves (``count > 0``) of ``bvh``, in node order; each
    leaf holds at most :data:`TREELET` triangles."""
    f = lambda t: t.detach().cpu().numpy()
    count, first = f(bvh.count), f(bvh.first)
    leaves = np.nonzero(count > 0)[0]
    assert count[leaves].max() <= TREELET, "leaves of at most 128 triangles"
    v0, e1, e2 = f(bvh.tri_v0), f(bvh.tri_e1), f(bvh.tri_e2)
    n_leaves = len(leaves)

    # Triangle slot → (leaf ordinal, column).
    sizes = count[leaves].astype(np.int64)
    leaf_of = np.repeat(np.arange(n_leaves), sizes)
    starts = first[leaves].astype(np.int64)
    slot = np.concatenate([np.arange(s, s + c) for s, c in zip(starts, sizes)])
    col = slot - np.repeat(starts, sizes)

    lv0, le1, le2 = v0[slot], e1[slot], e2[slot]
    h = np.cross(le1, le2)
    w = np.zeros((len(slot), W_ROWS), np.float32)
    w[:, 0:3] = np.cross(le2, le1)
    w[:, 3:6] = -np.cross(le2, lv0)
    w[:, 6:9] = le2
    w[:, 9:12] = -np.cross(lv0, le1)
    w[:, 12:15] = -le1
    w[:, 15:18] = h
    w[:, 18] = -(lv0 * h).sum(-1)
    w[:, 19] = np.float32(vm.EPSILON) * np.linalg.norm(h, axis=-1)
    weights = np.zeros((n_leaves, TREELET, W_ROWS), np.float32)
    weights[:, :, 19] = np.float32(vm.EPSILON) * np.float32(BIG)
    weights[leaf_of, col] = w

    dev = torch.device("cpu") if device is None else device
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return TreeletTables(
        lbmin=t(f(bvh.bmin)[leaves].astype(np.float32)),
        lbmax=t(f(bvh.bmax)[leaves].astype(np.float32)),
        weights=t(weights), leaf_first=t(first[leaves].astype(np.int32)),
        tri_v0=bvh.tri_v0.to(dev), tri_e1=bvh.tri_e1.to(dev), tri_e2=bvh.tri_e2.to(dev),
        tri_id=bvh.tri_id.to(dev))


# Bit v of a 5-bit value moved to bit 6·v: the 6-D interleave as one gather.
_SPREAD = [sum(((v >> i) & 1) << (6 * i) for i in range(5)) for v in range(32)]
_spread_tables = {}


def _spread6(q):
    """Spread the 5 low bits of ``q`` (int64 in [0, 31]) 6 apart."""
    key = str(q.device)
    if key not in _spread_tables:
        _spread_tables[key] = torch.tensor(_SPREAD, dtype=torch.int64, device=q.device)
    return _spread_tables[key][q]


def morton_keys(start, seg, alive, lo, hi):
    """int32 sort key: 6-D Morton over (origin, direction), 5 bits an axis;
    dead lanes get ``1 << 30`` and sort last."""
    scale = 31.0 / torch.clamp(hi - lo, min=1e-6)
    qo = torch.clamp((start - lo) * scale, 0.0, 31.0).to(torch.int64)
    dn = seg / torch.clamp(torch.linalg.vector_norm(seg, dim=-1, keepdim=True), min=1e-30)
    qd = torch.clamp((dn + 1.0) * 15.999, 0.0, 31.0).to(torch.int64)
    # Direction axis a at bit a, origin axis a at bit a + 3, of each 6-bit digit.
    spread = _spread6(torch.cat([qd, qo], dim=1)) << torch.arange(6, device=start.device)
    key = spread.sum(dim=1)  # the six fields share no bit: sum == or
    if alive is not None:
        key = torch.where(alive, key, 1 << 30)
    return key.to(torch.int32)


def ray_features(start, seg, t_init=None):
    """Pad the rays to whole blocks and build their ``[n_pad, 16]`` features
    ``[d, o×d, o, 1, min(t_init, 1), 0…]``.  Pad rays have ``t0 = 0``: dead.
    Valid hits have t ≤ 1, so clamping the seeds to 1 loses nothing."""
    n = start.shape[0]
    dev = start.device
    n_pad = -(-n // BLOCK_RAYS) * BLOCK_RAYS
    t0 = (torch.full((n,), INVALID_PARAM, dtype=torch.float32, device=dev)
          if t_init is None else t_init.to(torch.float32))
    F = torch.zeros((n_pad, N_FEATURES), dtype=torch.float32, device=dev)
    F[:n, 0:3] = seg
    F[:n, 3:6] = vm.cross(start, seg)
    F[:n, 6:9] = start
    F[:, 9] = 1.0
    F[:n, 10] = torch.clamp(t0, max=1.0)
    return F


# ---------------------------------------------------------------------------
# Kernel 5: the cull


def _rcp(d):
    return 1.0 / torch.where(torch.abs(d) < 1e-30, torch.where(d >= 0, 1e-30, -1e-30), d)


def plain_cull(F, tables: TreeletTables):
    """Plain version of kernel 5: ``F [n_pad,16] → key [B, L]``, the
    minimum over each block's live rays of the exact slab entry t
    ``max(t_lo, 0)`` of every overlapping leaf, :data:`BIG` elsewhere."""
    n_pad = F.shape[0]
    L = tables.n_leaves
    o, r = F[:, 6:9], _rcp(F[:, 0:3])
    t0 = F[:, 10]
    tb1 = torch.clamp(t0, max=1.0)
    live = t0 > 0.0
    # Rays per slice: bound each [rays, L, 3] temporary to ~2^26 floats.
    step = max(BLOCK_RAYS, (1 << 26) // (3 * L) // BLOCK_RAYS * BLOCK_RAYS)
    keys = []
    for a in range(0, n_pad, step):
        sl = slice(a, min(a + step, n_pad))
        ta = (tables.lbmin[None] - o[sl, None]) * r[sl, None]  # [n,L,3]
        tb = (tables.lbmax[None] - o[sl, None]) * r[sl, None]
        lo, hi = torch.fmin(ta, tb), torch.fmax(ta, tb)
        t_lo = torch.fmax(torch.fmax(lo[..., 0], lo[..., 1]), lo[..., 2])
        t_hi = torch.fmin(torch.fmin(hi[..., 0], hi[..., 1]), hi[..., 2])
        ov = ((t_lo <= t_hi) & (t_hi >= 0.0) & (t_lo <= tb1[sl, None])
              & live[sl, None])
        ks = torch.where(ov, torch.fmax(t_lo, torch.zeros_like(t_lo)), BIG)
        keys.append(ks.reshape(-1, BLOCK_RAYS, L).amin(dim=1))
    return torch.cat(keys)


def launch_cull(F, tables: TreeletTables):
    """Launch kernel 5 on CUDA tensors; same contract as :func:`plain_cull`."""
    dev = F.device
    n_pad, L = F.shape[0], tables.n_leaves
    _build.check_cuda_tensor("F", F, torch.float32, (n_pad, N_FEATURES), dev)
    _build.check_cuda_tensor("lbmin", tables.lbmin, torch.float32, (L, 3), dev)
    _build.check_cuda_tensor("lbmax", tables.lbmax, torch.float32, (L, 3), dev)
    if n_pad % BLOCK_RAYS:
        raise ValueError(f"F has {n_pad} rows, not a multiple of {BLOCK_RAYS}")
    if F.data_ptr() % 16:
        raise ValueError("F must be 16-byte aligned: the kernel reads its rows as float4")
    n_blocks = n_pad // BLOCK_RAYS
    key = torch.empty((n_blocks, L), dtype=torch.float32, device=dev)
    _build.launch(TREELET_CULL, F.data_ptr(), tables.lbmin.data_ptr(),
                  tables.lbmax.data_ptr(), L, n_blocks, key.data_ptr(),
                  torch.cuda.current_stream(dev).cuda_stream)
    return key


def cull(F, tables: TreeletTables):
    """Kernel 5 on a CUDA ``F``, its plain version on a CPU one."""
    if F.device.type == "cuda":
        return launch_cull(F, tables)
    if F.device.type != "cpu":
        raise ValueError(f"unsupported device {F.device}")
    return plain_cull(F, tables)


def order_from_key(key):
    """``[B, L]`` entry-t keys (:data:`BIG` = culled) → survivor counts
    ``[B]`` int32, front-to-back leaf lists ``order [B, L]`` int32 and
    their floor-quantized entry t ``tlo [B, L]`` float32.

    One int32 value sort per row: the entry t (≤ 1) quantized into the high
    bits, the leaf id in the low bits.  Flooring only delays the sweep's
    exit, never triggers it early.  Entries past a row's count are pad keys
    (their order clamped to the last leaf, their tlo huge).
    """
    B, L = key.shape
    counts = (key < BIG).sum(dim=1, dtype=torch.int32)
    id_bits = max(1, (L - 1).bit_length())
    t_scale = float((1 << (30 - id_bits)) - 1)
    t_q = (torch.clamp(key, max=1.0) * t_scale).to(torch.int32)
    leaf = torch.arange(L, dtype=torch.int32, device=key.device)[None, :]
    packed = torch.where(key < BIG, (t_q << id_bits) | leaf, NO_HIT)
    packed = torch.sort(packed, dim=1).values
    order = torch.clamp(packed & ((1 << id_bits) - 1), max=L - 1)
    tlo = (packed >> id_bits).to(torch.float32) / t_scale
    return counts, order.contiguous(), tlo.contiguous()


# ---------------------------------------------------------------------------
# Kernel 6: the sweep


def _leaf_test(Fb, w, t_best):
    """Every ray of ``Fb [nb,R,16]`` against the 128 triangles of ``w
    [nb,128,20]``, the sign-folded Möller–Trumbore of the kernel, term for
    term: the packed key ``(bits(t) & ~127) | column`` of each ray's nearest
    valid triangle, :data:`NO_HIT` where none."""
    f = [Fb[:, :, c:c + 1] for c in range(9)]  # d0..2, c0..2, o0..2 as [nb,R,1]
    k = [w[:, None, :, c] for c in range(W_ROWS)]  # [nb,1,128]
    det = f[0] * k[0] + f[1] * k[1] + f[2] * k[2]
    u_num = (f[0] * k[3] + f[1] * k[4] + f[2] * k[5]
             + f[3] * k[6] + f[4] * k[7] + f[5] * k[8])
    v_num = (f[0] * k[9] + f[1] * k[10] + f[2] * k[11]
             + f[3] * k[12] + f[4] * k[13] + f[5] * k[14])
    t_num = f[6] * k[15] + f[7] * k[16] + f[8] * k[17] + k[18]
    ad = torch.abs(det)
    sm = torch.where(det < 0.0, -1.0, 1.0)
    un, vn, tn = u_num * sm, v_num * sm, t_num * sm
    min4 = torch.fmin(torch.fmin(un, vn), torch.fmin(ad - (un + vn), tn))
    ok = (min4 >= 0.0) & (tn < t_best[:, :, None] * ad) & (ad >= k[19])
    tc = tn / torch.where(ok, ad, 1.0)
    col = torch.arange(TREELET, dtype=torch.int32, device=Fb.device)
    key = torch.where(ok, (tc.view(torch.int32) & ~(TREELET - 1)) | col, NO_HIT)
    return key.amin(dim=-1)


def plain_sweep(counts, order, tlo, F, tables: TreeletTables):
    """Plain version of kernel 6: ``(t [n_pad] f32, best [n_pad] i32,
    visits [B] i32)``.

    Each block sweeps its leaves ``order[b, :counts[b]]`` in groups of
    :data:`GROUP`; a ray keeps the quantized t of its best triangle and ``best
    = leaf·128 + column`` (−1: none), comparing later triangles against
    that t with a strict ``<``.  After each group the block stops when the
    next leaf's ``tlo`` exceeds ``min(max over its rays of t, 1)``.
    ``visits`` counts the leaves each block swept.
    """
    n_pad = F.shape[0]
    B = n_pad // BLOCK_RAYS
    dev = F.device
    Fb = F.reshape(B, BLOCK_RAYS, N_FEATURES)
    t_best = Fb[:, :, 10].clone()
    best = torch.full((B, BLOCK_RAYS), -1, dtype=torch.int32, device=dev)
    visits = torch.zeros((B,), dtype=torch.int32, device=dev)
    counts = counts.long()
    L = order.shape[1]
    blocks = torch.nonzero(counts > 0)[:, 0]
    k = 0
    while blocks.numel():
        for j in range(GROUP):
            live = blocks[counts[blocks] > k + j]
            if not live.numel():
                break
            leaf = order[live, k + j].long()
            kmin = _leaf_test(Fb[live], tables.weights[leaf], t_best[live])
            hit = kmin < NO_HIT
            best[live] = torch.where(hit, (leaf * TREELET)[:, None].to(torch.int32)
                                     + (kmin & (TREELET - 1)), best[live])
            t_best[live] = torch.where(hit, (kmin & ~(TREELET - 1)).view(torch.float32),
                                       t_best[live])
            visits[live] += 1
        nk = k + GROUP
        t_blk = torch.clamp(t_best[blocks].amax(dim=1), max=1.0)
        tlo_next = tlo[blocks, min(nk, L - 1)]
        blocks = blocks[(nk < counts[blocks]) & ~(tlo_next > t_blk)]
        k = nk
    return t_best.reshape(-1), best.reshape(-1), visits


def block_order(counts):
    """The order in which kernel 6 takes its ray blocks: a permutation of
    ``range(B)`` (int64) with ``counts`` non-increasing along it, so the
    blocks with the longest leaf lists start first.  Outputs are written by
    block id, so the order leaves them unchanged."""
    return torch.argsort(counts, descending=True, stable=True)


def cull_shape(n_leaves: int):
    """Kernel 5's CTA as the built library launches it for ``n_leaves``
    leaves: ``(threads, leaves a thread)``."""
    shape = (ctypes.c_int * 2)()
    _build.library(TREELET_CULL.library).fspt_cull_shape(n_leaves, shape)
    return tuple(shape)


def sweep_shape():
    """Kernel 6's CTA as the built library launches it: ``(threads, rays a
    thread, threads a ray)``."""
    shape = (ctypes.c_int * 3)()
    _build.library(TREELET_SWEEP.library).fspt_sweep_shape(shape)
    return tuple(shape)


def launch_sweep(counts, order, tlo, F, tables: TreeletTables):
    """Launch kernel 6 on CUDA tensors, its blocks in :func:`block_order`;
    same contract as :func:`plain_sweep`."""
    dev = F.device
    n_pad, L = F.shape[0], tables.n_leaves
    n_blocks = n_pad // BLOCK_RAYS
    _build.check_cuda_tensor("F", F, torch.float32, (n_pad, N_FEATURES), dev)
    _build.check_cuda_tensor("counts", counts, torch.int32, (n_blocks,), dev)
    _build.check_cuda_tensor("order", order, torch.int32, (n_blocks, L), dev)
    _build.check_cuda_tensor("tlo", tlo, torch.float32, (n_blocks, L), dev)
    _build.check_cuda_tensor("weights", tables.weights, torch.float32,
                             (L, TREELET, W_ROWS), dev)
    if n_pad % BLOCK_RAYS:
        raise ValueError(f"F has {n_pad} rows, not a multiple of {BLOCK_RAYS}")
    t = torch.empty((n_pad,), dtype=torch.float32, device=dev)
    best = torch.empty((n_pad,), dtype=torch.int32, device=dev)
    visits = torch.empty((n_blocks,), dtype=torch.int32, device=dev)
    heavy_first = block_order(counts)
    _build.launch(TREELET_SWEEP, heavy_first.data_ptr(), counts.data_ptr(),
                  order.data_ptr(), tlo.data_ptr(), L, GROUP, F.data_ptr(),
                  tables.weights.data_ptr(), n_blocks, t.data_ptr(), best.data_ptr(),
                  visits.data_ptr(),
                  torch.cuda.current_stream(dev).cuda_stream)
    return t, best, visits


def sweep(counts, order, tlo, F, tables: TreeletTables):
    """Kernel 6 on a CUDA ``F``, its plain version on a CPU one."""
    if F.device.type == "cuda":
        return launch_sweep(counts, order, tlo, F, tables)
    if F.device.type != "cpu":
        raise ValueError(f"unsupported device {F.device}")
    return plain_sweep(counts, order, tlo, F, tables)


# ---------------------------------------------------------------------------
# The traverser and the mesh intersector


def post(tables: TreeletTables, start, seg, t_kern, best):
    """Exact recompute for each ray's winner: ``(t, tri_id, u, v)`` with the
    original triangle id (−1 and ``t_kern`` on a miss)."""
    hit = best >= 0
    b = torch.clamp(best, min=0).long()
    slot = tables.leaf_first.long()[b // TREELET] + b % TREELET
    v0, e1, e2 = tables.tri_v0[slot], tables.tri_e1[slot], tables.tri_e2[slot]
    pvec = vm.cross(seg, e2)
    det = vm.dot(e1, pvec)
    inv = 1.0 / torch.where(torch.abs(det) > 0, det, 1.0)
    tvec = start - v0
    u = vm.dot(tvec, pvec) * inv
    qvec = vm.cross(tvec, e1)
    v = vm.dot(seg, qvec) * inv
    t_re = vm.dot(e2, qvec) * inv
    return (torch.where(hit, t_re, t_kern),
            torch.where(hit, tables.tri_id[slot], -1),
            torch.where(hit, u, 0.0), torch.where(hit, v, 0.0))


def make_culled_traverser(bvh: FlatBVH, device=None, plain: bool = False):
    """``fn(start[N,3], seg[N,3], t_init[N]=None) → (t, tri_id, u, v)`` over
    the leaves of ``bvh`` (at most 128 triangles each).

    Lanes with ``t_init ≤ 0`` are dead: they take part in no cull and win
    no triangle.  The stages hang on the function: ``prepare`` (features,
    cull, sort of the keys), ``sweep``, ``raw`` (both, → ``(t, best)``) and
    ``post``.  ``plain=True`` runs the plain versions on any device (the
    kernel checks' reference path).
    """
    tables = treelet_tables(bvh, device=bvh.tri_v0.device if device is None else device)
    cull_fn = plain_cull if plain else cull
    sweep_fn = plain_sweep if plain else sweep

    def prepare(start, seg, t_init=None):
        F = ray_features(start, seg, t_init)
        counts, order, tlo = order_from_key(cull_fn(F, tables))
        return counts, order, tlo, F

    def run_sweep(counts, order, tlo, F):
        return sweep_fn(counts, order, tlo, F, tables)

    def raw(start, seg, t_init=None):
        """``(t_kern, best)`` with ``best = leaf·128 + column`` (−1 on a
        miss, where ``t_kern`` is the caller's own ``t_init``)."""
        n = start.shape[0]
        t, best, _ = run_sweep(*prepare(start, seg, t_init))
        t0 = (torch.full((n,), INVALID_PARAM, dtype=torch.float32, device=start.device)
              if t_init is None else t_init)
        best = best[:n]
        return torch.where(best >= 0, t[:n], t0), best

    def traverse(start, seg, t_init=None):
        t_kern, best = raw(start, seg, t_init)
        return post(tables, start, seg, t_kern, best)

    traverse.tables = tables
    traverse.prepare = prepare
    traverse.sweep = run_sweep
    traverse.raw = raw
    traverse.post = lambda start, seg, t_kern, best: post(tables, start, seg, t_kern, best)
    return traverse


def box_exit(start, seg, lo, hi):
    """Each ray's t (in units of ``seg``) just past its exit from the box
    ``[lo, hi]``, 0 where it misses the box: no triangle inside the box
    is hit farther along."""
    inv = _rcp(seg)
    ta = (lo - start) * inv
    tb = (hi - start) * inv
    tnear = torch.amax(torch.minimum(ta, tb), dim=-1)
    tfar = torch.amin(torch.maximum(ta, tb), dim=-1)
    return torch.where((tnear <= tfar) & (tfar > 0.0), tfar * 1.0001 + 1e-5, 0.0)


def make_mesh_intersector(scene_pack, plain: bool = False):
    """Full-scene intersector for BVH scenes, ``fn(start, seg[, alive]) →
    Hit`` (``accepts_alive``), or None when it does not apply.

    Kernel 1 (ops/cuda_trace.py) seeds each ray's t from the analytic
    primitives, clipped to the ray's exit from the mesh box (dead lanes get
    0); the rays are sorted by Morton key (stably); kernels 5 and 6 run on
    the sorted rays and only ``(t, best)`` are unsorted; :func:`post`
    recovers the winner and the TriShade gathers its shading attributes.
    ``plain=True`` takes the plain versions of kernels 1, 5 and 6 on any
    device.  ``fn.sweep_inputs(start, seg, alive)`` gives the sorted rays,
    their seeds and the permutation, as the sweep sees them; ``fn.box`` the
    mesh box ``(lo, hi)`` of their Morton keys.
    """
    from fspt_tpu_torch.ops.cuda_trace import make_cuda_intersector
    from fspt_tpu_torch.render.integrator import merge_triangle_hit

    if scene_pack.bvh is None:
        return None
    base_fn = make_cuda_intersector(scene_pack.geometry, plain=plain)
    if base_fn is None:
        return None
    # A treelet tree in original triangle order (the scene's fine BVH
    # serves the plain path), so tri_id gathers align.
    fine = scene_pack.bvh
    order = np.argsort(fine.tri_id.cpu().numpy())
    v0 = fine.tri_v0.cpu().numpy()[order]
    v1 = v0 + fine.tri_e1.cpu().numpy()[order]
    v2 = v0 + fine.tri_e2.cpu().numpy()[order]
    dev = scene_pack.device
    trav = make_culled_traverser(build_treelet_chunks(v0, v1, v2), device=dev, plain=plain)
    # Every triangle hit lies in the mesh box, so a ray's exit from it
    # bounds its deepest possible hit: rays that leave the mesh do no work.
    box_lo = torch.from_numpy(np.minimum(v0, np.minimum(v1, v2)).min(axis=0)).to(dev)
    box_hi = torch.from_numpy(np.maximum(v0, np.maximum(v1, v2)).max(axis=0)).to(dev)

    def sweep_inputs(start, seg, alive=None, base=None):
        if base is None:
            base = base_fn(start, seg)
        t_init = torch.minimum(base.t, box_exit(start, seg, box_lo, box_hi))
        if alive is not None:
            t_init = torch.where(alive, t_init, 0.0)
        perm = torch.argsort(morton_keys(start, seg, alive, box_lo, box_hi), stable=True)
        return start[perm], seg[perm], t_init[perm], perm

    def intersect(start, seg, alive=None):
        base = base_fn(start, seg)
        start_s, seg_s, t_init_s, perm = sweep_inputs(start, seg, alive, base)
        t_sorted, best_sorted = trav.raw(start_s, seg_s, t_init_s)
        t_kern = torch.empty_like(t_sorted)
        best = torch.empty_like(best_sorted)
        t_kern[perm] = t_sorted
        best[perm] = best_sorted
        t_tri, tri_id, u, v = trav.post(start, seg, t_kern, best)
        # Seeded with the analytic t, so any triangle hit is strictly closer.
        return merge_triangle_hit(scene_pack.tri_shade, base, start, seg, t_tri,
                                  tri_id, u, v, tri_hit_wins=tri_id >= 0)

    intersect.accepts_alive = True
    intersect.traverser = trav
    intersect.sweep_inputs = sweep_inputs
    intersect.box = (box_lo, box_hi)
    return intersect


# ---------------------------------------------------------------------------
# The walks' packed records (kernels 11 and 12)

#: Low bits of a packed node's last word that hold a leaf's triangle count
#: (0 on an internal node); the high bits hold its first triangle (kernel 11)
#: or its leaf ordinal (kernel 12).  csrc kCountBits.
COUNT_BITS = 8


def walk_nodes(bmin, bmax, count, miss, payload):
    """``[M, 8]`` float32 node records of the walks, from the same float
    values: per node ``(bmin, bits(miss))`` and ``(bmax, bits(payload <<
    COUNT_BITS | count))``; ``payload`` is taken on leaves only (0 on
    internal nodes).  Raises unless every miss link points forward in
    preorder (``i < miss[i] <= M``), which both walks rely on."""
    m = bmin.shape[0]
    miss64, count64 = miss.long(), count.long()
    pay = torch.where(count64 > 0, payload.long(), 0)
    if not bool(((miss64 > torch.arange(m, device=bmin.device)) & (miss64 <= m)).all()):
        raise ValueError("the walks need preorder miss links: i < miss[i] <= M on every node")
    if m and int(count64.max()) >= 1 << COUNT_BITS:
        raise ValueError(f"a leaf holds {int(count64.max())} triangles, more than a packed "
                         f"node record's {(1 << COUNT_BITS) - 1}")
    if m and (int(pay.min()) < 0 or int(pay.max()) >= 1 << (31 - COUNT_BITS)):
        raise ValueError("a leaf's first triangle or ordinal does not fit a packed node record")
    meta = ((pay << COUNT_BITS) | count64).to(torch.int32)
    return torch.cat([bmin.to(torch.float32), miss.to(torch.int32).view(torch.float32)[:, None],
                      bmax.to(torch.float32), meta.view(torch.float32)[:, None]],
                     dim=1).contiguous()


def walk_tris(bvh: FlatBVH):
    """``[T, 12]`` float32 triangle records of kernel 11, from the same float
    values: ``(v0, area2)``, ``(e1, bits(tri_id))``, ``(e2, 0)``."""
    zero = torch.zeros_like(bvh.tri_area2)[:, None]
    return torch.cat([bvh.tri_v0, bvh.tri_area2[:, None], bvh.tri_e1,
                      bvh.tri_id.to(torch.int32).view(torch.float32)[:, None], bvh.tri_e2,
                      zero], dim=1).contiguous()


# ---------------------------------------------------------------------------
# Kernel 11: the walk of a fine BVH


class BvhWalkTables(NamedTuple):
    """Kernel 11's records of a FlatBVH (:func:`walk_nodes` with each
    leaf's first triangle, :func:`walk_tris`), built once a tree."""

    nodes: torch.Tensor  # [M, 8] float32
    tris: torch.Tensor  # [T, 12] float32

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]


def bvh_walk_tables(bvh: FlatBVH) -> BvhWalkTables:
    return BvhWalkTables(nodes=walk_nodes(bvh.bmin, bvh.bmax, bvh.count, bvh.miss, bvh.first),
                         tris=walk_tris(bvh))


def launch_bvh_walk(tables: BvhWalkTables, start, seg, t_init):
    """Launch kernel 11 on CUDA tensors; same contract as
    :func:`ops.bvh.walk_bvh` on the tree whose records ``tables`` holds."""
    dev = start.device
    n, m, T = start.shape[0], tables.n_nodes, tables.tris.shape[0]
    for name, t, dtype, shape in (
            ("start", start, torch.float32, (n, 3)), ("seg", seg, torch.float32, (n, 3)),
            ("t_init", t_init, torch.float32, (n,)),
            ("nodes", tables.nodes, torch.float32, (m, 8)),
            ("tris", tables.tris, torch.float32, (T, 12))):
        _build.check_cuda_tensor(name, t, dtype, shape, dev)
    f32 = lambda: torch.empty((n,), dtype=torch.float32, device=dev)  # noqa: E731
    i32 = lambda: torch.empty((n,), dtype=torch.int32, device=dev)  # noqa: E731
    t, ids, u, v, visits, tested = f32(), i32(), f32(), f32(), i32(), i32()
    batch = torch.empty((1,), dtype=torch.int32, device=dev)  # the warps' ray counter
    _build.launch(BVH_WALK, start.data_ptr(), seg.data_ptr(), t_init.data_ptr(), n,
                  tables.nodes.data_ptr(), m, tables.tris.data_ptr(), t.data_ptr(),
                  ids.data_ptr(), u.data_ptr(), v.data_ptr(), visits.data_ptr(),
                  tested.data_ptr(), batch.data_ptr(),
                  torch.cuda.current_stream(dev).cuda_stream)
    return t, ids, u, v, visits, tested


def make_bvh_traverser(bvh: FlatBVH, max_leaf: int, device=None, plain: bool = False):
    """``fn(start[N,3], seg[N,3], t_init[N]=None) → (t, tri_id, u, v)``:
    the closest triangle hit of each segment in ``bvh`` (leaves of at most
    ``max_leaf`` triangles), tri_id −1 on a miss, where ``t`` is the seed
    (``INVALID_PARAM`` by default).  Kernel 11 on CUDA rays,
    :func:`ops.bvh.walk_bvh` on CPU ones or with ``plain=True``.
    ``fn.walk`` gives also the nodes and triangles each ray tested;
    ``fn.tables`` holds kernel 11's records of the tree."""
    if device is not None:
        bvh = FlatBVH(*(t.to(device) for t in bvh))
    if int(bvh.count.max()) > max_leaf:
        raise ValueError(f"a leaf of the tree holds {int(bvh.count.max())} triangles, "
                         f"more than max_leaf={max_leaf}")
    tables = bvh_walk_tables(bvh)

    def walk(start, seg, t_init=None):
        if t_init is None:
            t_init = torch.full((start.shape[0],), INVALID_PARAM, dtype=torch.float32,
                                device=start.device)
        if plain or start.device.type == "cpu":
            return walk_bvh(bvh, start, seg, t_init, max_leaf)
        if start.device.type != "cuda":
            raise ValueError(f"unsupported device {start.device}")
        return launch_bvh_walk(tables, start.contiguous(), seg.contiguous(),
                               t_init.to(torch.float32).contiguous())

    def traverse(start, seg, t_init=None):
        return walk(start, seg, t_init)[:4]

    traverse.walk = walk
    traverse.bvh = bvh
    traverse.tables = tables
    return traverse


# ---------------------------------------------------------------------------
# Kernel 12: the walk of a tree of 128-triangle leaves


class TreeletWalkTables(NamedTuple):
    """The node table of a tree with leaves of at most 128 triangles, each
    leaf's ordinal in :class:`TreeletTables` (node order; −1 on internal
    nodes), the leaf tables, and kernel 12's node records
    (:func:`walk_nodes` with each leaf's ordinal)."""

    bmin: torch.Tensor  # [M,3]
    bmax: torch.Tensor  # [M,3]
    count: torch.Tensor  # [M] int32
    leaf_of: torch.Tensor  # [M] int32
    miss: torch.Tensor  # [M] int32
    tables: TreeletTables
    nodes: torch.Tensor  # [M, 8] float32

    @property
    def n_nodes(self) -> int:
        return self.bmin.shape[0]


def treelet_walk_tables(bvh: FlatBVH, device=None) -> TreeletWalkTables:
    dev = bvh.tri_v0.device if device is None else device
    leaf = bvh.count > 0
    leaf_of = torch.where(leaf, torch.cumsum(leaf.to(torch.int32), 0) - 1, -1)
    return TreeletWalkTables(bmin=bvh.bmin.to(dev), bmax=bvh.bmax.to(dev),
                             count=bvh.count.to(dev), leaf_of=leaf_of.to(torch.int32).to(dev),
                             miss=bvh.miss.to(dev), tables=treelet_tables(bvh, device=dev),
                             nodes=walk_nodes(bvh.bmin, bvh.bmax, bvh.count, bvh.miss,
                                              leaf_of).to(dev))


#: Rays per batch of the plain walk's leaf tests (bounds its [rays, 128, 20]
#: weight gathers).
PLAIN_LEAF_BATCH = 8192


def plain_treelet_walk(F, wt: TreeletWalkTables):
    """Plain version of kernel 12: ``F [n_pad,16] → (t [n_pad] f32, best
    [n_pad] i32, visits [n_pad] i32, tested [n_pad] i32)``.

    Each ray walks the tree as :func:`ops.bvh.walk_bvh` does (rays with
    ``t0 ≤ 0`` are dead); at each leaf whose box it enters before its best
    t, :func:`_leaf_test` against the leaf's 128 triangles; it keeps the
    quantized t of the packed key and ``best = leaf·128 + column`` (−1:
    none).  ``visits`` counts the nodes each ray tested, ``tested`` the
    triangles of the leaves it swept (their real counts, not the pad
    columns of the 128-wide test).
    """
    n, dev, m = F.shape[0], F.device, wt.n_nodes
    o, d = F[:, 6:9], F[:, 0:3]
    t_best = F[:, 10].clone()
    best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    node = torch.where(t_best > 0.0, 0, m).to(torch.int64)
    visits = torch.zeros((n,), dtype=torch.int32, device=dev)
    tested = torch.zeros((n,), dtype=torch.int32, device=dev)
    count, leaf_of, miss = wt.count.long(), wt.leaf_of.long(), wt.miss.long()
    weights = wt.tables.weights
    while bool((node < m).any()):
        active = node < m
        nidx = torch.clamp(node, max=m - 1)
        box_hit, entry = _slab_entry(wt.bmin[nidx], wt.bmax[nidx], o, d)
        box_hit = box_hit & (entry <= t_best) & active
        is_leaf = count[nidx] > 0
        work = box_hit & is_leaf
        visits += active.to(torch.int32)
        tested += torch.where(work, count[nidx], 0).to(torch.int32)
        for lanes in torch.nonzero(work)[:, 0].split(PLAIN_LEAF_BATCH):
            leaf = leaf_of[nidx[lanes]]
            kmin = _leaf_test(F[lanes][:, None, :], weights[leaf], t_best[lanes][:, None])[:, 0]
            hit = kmin < NO_HIT
            best[lanes] = torch.where(hit, (leaf * TREELET).to(torch.int32)
                                      + (kmin & (TREELET - 1)), best[lanes])
            t_best[lanes] = torch.where(hit, (kmin & ~(TREELET - 1)).view(torch.float32),
                                        t_best[lanes])
        node = torch.where(active, torch.where(box_hit & ~is_leaf, nidx + 1, miss[nidx]), node)
    return t_best, best, visits, tested


def launch_treelet_walk(F, wt: TreeletWalkTables):
    """Launch kernel 12 on CUDA tensors; same contract as
    :func:`plain_treelet_walk`."""
    dev = F.device
    n_pad, m, L = F.shape[0], wt.n_nodes, wt.tables.n_leaves
    for name, t, dtype, shape in (
            ("F", F, torch.float32, (n_pad, N_FEATURES)),
            ("nodes", wt.nodes, torch.float32, (m, 8)),
            ("weights", wt.tables.weights, torch.float32, (L, TREELET, W_ROWS))):
        _build.check_cuda_tensor(name, t, dtype, shape, dev)
    if F.data_ptr() % 16:
        raise ValueError("F must be 16-byte aligned: the kernel reads its rows as float4")
    t = torch.empty((n_pad,), dtype=torch.float32, device=dev)
    best, visits, tested = (torch.empty((n_pad,), dtype=torch.int32, device=dev)
                            for _ in range(3))
    _build.launch(TREELET_WALK, F.data_ptr(), n_pad, wt.nodes.data_ptr(), m,
                  wt.tables.weights.data_ptr(), t.data_ptr(), best.data_ptr(),
                  visits.data_ptr(), tested.data_ptr(),
                  torch.cuda.current_stream(dev).cuda_stream)
    return t, best, visits, tested


def make_treelet_traverser(bvh: FlatBVH, device=None, plain: bool = False):
    """``fn(start[N,3], seg[N,3], t_init[N]=None) → (t, tri_id, u, v)`` over
    a tree with leaves of at most 128 triangles (``build_bvh(...,
    max_leaf=TREELET)``; internal nodes are walked, unlike
    :func:`make_culled_traverser`'s leaf list): kernel 12 on CUDA rays,
    :func:`plain_treelet_walk` on CPU ones or with ``plain=True``, then
    :func:`post` for the exact t, u, v and original id.  A miss returns the
    seed t.  ``fn.walk(start, seg, t_init)`` gives the raw ``(t, best,
    visits, tested)`` over the padded feature rows."""
    wt = treelet_walk_tables(bvh, device=device)

    def walk(start, seg, t_init=None):
        F = ray_features(start, seg, t_init)
        if plain or F.device.type == "cpu":
            return plain_treelet_walk(F, wt)
        if F.device.type != "cuda":
            raise ValueError(f"unsupported device {F.device}")
        return launch_treelet_walk(F, wt)

    def traverse(start, seg, t_init=None):
        n = start.shape[0]
        t, best, _, _ = walk(start, seg, t_init)
        t0 = (torch.full((n,), INVALID_PARAM, dtype=torch.float32, device=start.device)
              if t_init is None else t_init.to(torch.float32))
        best = best[:n]
        return post(wt.tables, start, seg, torch.where(best >= 0, t[:n], t0), best)

    traverse.walk = walk
    traverse.walk_tables = wt
    return traverse
