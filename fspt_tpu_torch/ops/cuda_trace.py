"""Closest-hit intersection over a packed primitive table: kernel 1.

Counterpart of fspt_tpu/ops/pallas_trace.py.  The CUDA kernel
``intersect_kernel`` (csrc/fspt_kernels.cu) replaces the Pallas kernel of
``pallas_trace.py:make_pallas_intersector`` (its body ``intersect_lanes``).

* What it computes: for each segment ``start + seg·t, t∈[0,1]``, the closest
  hit over every valid primitive (sphere, plane, disc, quad, cuboid faces,
  triangles), merged in the reference's order with a strict ``<`` so the
  first primitive wins ties; normal, material, winning kind and texcoords.
* What bounds it on the H100: at the flagship's 14 rows, bytes: per
  segment it reads 24 and writes 32, and evaluates every row (about 20-60
  float operations each); past a few dozen rows, those operations.
* What its design does about it: the TPU kernel baked each primitive into
  the instruction stream; here the scene is a table of 32-float rows
  (:class:`HostScene`) that each block copies into shared memory and walks
  one primitive kind at a time, every thread of a warp on the same row, so
  each row load is one broadcast and no compile is needed per scene.  Its
  grid (:func:`intersect_plan`) is at most eight waves of the blocks the card
  holds at once, each staging the table once and striding over the
  segments, two segments a thread sharing each row read; the walk keeps
  each segment's winning row alone, and the hit's normal, material and
  texcoords are read from that row after it.  No padding to tiles.

:func:`intersect_lanes` is the plain PyTorch version of the kernel, on the
same table rows and in the same order of operations.  The wrapper made by
:func:`make_cuda_intersector` uses it only for tensors on the CPU; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from fspt_tpu_torch.ops import _build
from fspt_tpu_torch.ops.intersect import (
    Hit,
    KIND_CUBOID,
    KIND_DISC,
    KIND_PLANE,
    KIND_QUAD,
    KIND_SPHERE,
    KIND_TRIANGLE,
)
from fspt_tpu_torch.scene.geometry import INVALID_PARAM
from fspt_tpu_torch.utils import vecmath as vm

# Above this many primitives the reference sends the scene to its BVH path.
MAX_SPECIALIZED_PRIMS = 512
PRIM_STRIDE = 32  # floats per table row (csrc kPrimStride)

# Float operations (add, mul, div, sqrt, compare, select) one segment spends
# on one table row before it knows whether the row is hit, counted from
# intersect_lanes in csrc/fspt_kernels.cuh.  Work done only on a hit (the
# hit point, normal, disc/quad/cuboid bounds) is left out, so the sum over
# rows is a lower bound on the kernel's work per segment.
OPS_PER_TEST = {KIND_SPHERE: 36, KIND_PLANE: 19, KIND_DISC: 19, KIND_QUAD: 19,
                KIND_CUBOID: 19, KIND_TRIANGLE: 55}

INTERSECT = _build.KernelCounter(
    "intersect", "fspt_kernels", "fspt_intersect",
    "fspt_tpu/ops/pallas_trace.py:421 make_pallas_intersector (body intersect_lanes :189)")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class HostScene:
    """The valid primitives of a GeometryPack as packed table rows.

    Row order is the reference's merge order: spheres, planes, discs, quads,
    cuboids (faces 0..5), triangles.  Row layouts (float32, 32 wide):

    * sphere: center(3), radius, 1/radius
    * plane: plane(4)
    * disc: plane(4), origin(3), radius
    * quad: plane(4), origin(3), tangent(3), bitangent(3), half_w, half_h
    * cuboid face i: plane i(4), then the four side planes j with
      ``j//2 != i//2`` in ascending j (4 each)
    * triangle: v0(3), e1(3), e2(3), EPS·area2, n0(3), n1−n0(3), n2−n0(3),
      t0(2), t1−t0(2), t2−t0(2)

    Derived constants (1/radius, EPS·area2, the vertex differences) are
    rounded once to float32 from float64, exactly as the reference's baked
    Python constants are.
    """

    def __init__(self, g):
        rows = []

        def add(kind, mat, values):
            row = np.zeros(PRIM_STRIDE, np.float32)
            row[:len(values)] = np.asarray(values, np.float64)
            rows.append((kind, int(mat), row))

        f = {name: _np(getattr(g, name)) for name in g._fields}
        for i in np.nonzero(f["sph_valid"])[0]:
            r = float(f["sph_radius"][i])
            add(KIND_SPHERE, f["sph_mat"][i], [*f["sph_center"][i], r, 1.0 / r])
        for i in np.nonzero(f["pln_valid"])[0]:
            add(KIND_PLANE, f["pln_mat"][i], f["pln_plane"][i])
        for i in np.nonzero(f["dsc_valid"])[0]:
            add(KIND_DISC, f["dsc_mat"][i], [*f["dsc_plane"][i], *f["dsc_origin"][i],
                                            f["dsc_radius"][i]])
        for i in np.nonzero(f["qud_valid"])[0]:
            add(KIND_QUAD, f["qud_mat"][i],
                [*f["qud_plane"][i], *f["qud_origin"][i], *f["qud_tangent"][i],
                 *f["qud_bitangent"][i], f["qud_half_w"][i], f["qud_half_h"][i]])
        for c in np.nonzero(f["cub_valid"])[0]:
            planes = f["cub_planes"][c]
            for i in range(6):
                sides = [v for j in range(6) if j // 2 != i // 2 for v in planes[j]]
                add(KIND_CUBOID, f["cub_mat"][c], [*planes[i], *sides])
        for i in np.nonzero(f["tri_valid"])[0]:
            d = lambda a, b: [float(x) - float(y) for x, y in zip(a, b)]
            n0, n1, n2 = f["tri_n0"][i], f["tri_n1"][i], f["tri_n2"][i]
            t0, t1, t2 = f["tri_t0"][i], f["tri_t1"][i], f["tri_t2"][i]
            add(KIND_TRIANGLE, f["tri_mat"][i],
                [*f["tri_v0"][i], *f["tri_e1"][i], *f["tri_e2"][i],
                 vm.EPSILON * float(f["tri_area2"][i]),
                 *n0, *d(n1, n0), *d(n2, n0), *t0, *d(t1, t0), *d(t2, t0)])
        self.rows = rows
        self._device_tables = {}

    @property
    def prim_count(self) -> int:
        return len(self.rows)

    def kind_counts(self) -> dict:
        """Rows per primitive kind (cuboids count six faces)."""
        counts = {}
        for kind, _, _ in self.rows:
            counts[kind] = counts.get(kind, 0) + 1
        return counts

    def segment_ops(self) -> int:
        """Float operations one segment needs against the whole table
        (a lower bound; see :data:`OPS_PER_TEST`)."""
        return sum(OPS_PER_TEST[kind] for kind, _, _ in self.rows)

    def tables(self, device):
        """``(prims [P,32] float32, meta [P,2] int32)`` on ``device`` (at
        least one row; the kernel reads only ``prim_count``)."""
        key = str(device)
        if key not in self._device_tables:
            n = max(1, self.prim_count)
            prims = np.zeros((n, PRIM_STRIDE), np.float32)
            meta = np.zeros((n, 2), np.int32)
            for p, (kind, mat, row) in enumerate(self.rows):
                prims[p] = row
                meta[p] = (kind, mat)
            if (np.diff(meta[:self.prim_count, 0]) < 0).any():
                # The path kernels walk the rows one kind at a time.
                raise ValueError("the primitive rows are not sorted by kind")
            self._device_tables[key] = (torch.from_numpy(prims).to(device),
                                        torch.from_numpy(meta).to(device))
        return self._device_tables[key]


def _atan2(y, x):
    """The reference's polynomial atan2 (pallas_trace.py:101-118)."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    mx = torch.maximum(ax, ay)
    mn = torch.minimum(ax, ay)
    z = mn / torch.where(mx > 0.0, mx, 1.0)
    z2 = z * z
    p = z * (0.9998660 + z2 * (-0.3302995 + z2 * (0.1801410
             + z2 * (-0.0851330 + z2 * 0.0208351))))
    r = torch.where(ay > ax, 0.5 * vm.PI - p, p)
    r = torch.where(x < 0.0, vm.PI - r, r)
    return torch.where(y < 0.0, -r, r)


class _GrazeDiv(torch.autograd.Function):
    """``ns / ts`` whose derivatives floor ``|ts|`` at ``floor``.

    The reference's ``_graze_div`` (pallas_trace.py:137-163): the plane-hit
    parameter is exact, but at glancing incidence its derivatives (∝ 1/ts)
    overflow float32; the backward clamps ``|ts|`` to ``floor`` (≈ 1e-3 of
    the segment length), so such lanes get a bounded derivative instead of
    NaN.  csrc/fspt_adjoint.cu ``winner_adj`` is its reverse-mode form."""

    @staticmethod
    def forward(ctx, ns, ts, floor):
        ctx.save_for_backward(ns, ts, floor)
        return ns / ts

    @staticmethod
    def backward(ctx, ct):
        ns, ts, floor = ctx.saved_tensors
        sgn = torch.where(ts < 0.0, -1.0, 1.0)
        ts_safe = sgn * torch.maximum(torch.abs(ts), floor)
        return ct / ts_safe, -ct * ns / (ts_safe * ts_safe), None


class _GrazeSqrt(torch.autograd.Function):
    """``sqrt(x)`` whose derivative floors the root at ``floor``: the
    reference's ``_graze_sqrt`` (pallas_trace.py:166-183), the sphere-tangent
    analog of :class:`_GrazeDiv`."""

    @staticmethod
    def forward(ctx, x, floor):
        r = torch.sqrt(x)
        ctx.save_for_backward(r, floor)
        return r

    @staticmethod
    def backward(ctx, ct):
        r, floor = ctx.saved_tensors
        return ct / (2.0 * torch.maximum(r, floor)), None


def intersect_lanes(scene: HostScene, sx, sy, sz, dx, dy, dz,
                    want_texcoords: bool = True):
    """Plain PyTorch version of kernel 1 over lane planes.

    Returns ``(t, nx, ny, nz, mat, kind, u, v)``; a miss has ``t = 2``,
    ``mat = 0`` and ``kind = -1``.  ``want_texcoords=False`` skips the
    texcoord math (the path body never reads it).

    Differentiable with respect to the lane planes: every division and root
    is in a safe-``where`` form, so a branch that is not selected cannot put
    NaN into the gradient, and plane hits and sphere roots carry the
    reference's derivative floors (:class:`_GrazeDiv`, :class:`_GrazeSqrt`).
    """
    eps = vm.EPSILON
    zero = torch.zeros_like(sx)
    t = torch.full_like(sx, INVALID_PARAM)
    nx, ny, nz, uu, vv = zero, zero, zero, zero, zero
    mat = torch.full(sx.shape, -1, dtype=torch.int32, device=sx.device)
    kind = torch.full(sx.shape, -1, dtype=torch.int32, device=sx.device)
    diff = torch.is_grad_enabled() and any(
        x.requires_grad for x in (sx, sy, sz, dx, dy, dz))
    if diff:
        seg_floor = (1e-3 * torch.sqrt(dx * dx + dy * dy + dz * dz) + 1e-20).detach()

    for k, m, row in scene.rows:
        r = [float(x) for x in row]
        tri_uv = None
        if k == KIND_SPHERE:
            c0, c1, c2, rad, inv_r = r[:5]
            ox, oy, oz = sx - c0, sy - c1, sz - c2
            a = dx * dx + dy * dy + dz * dz
            b = 2.0 * (ox * dx + oy * dy + oz * dz)
            oc2 = ox * ox + oy * oy + oz * oz
            cc = oc2 - rad * rad
            disc = b * b - 4.0 * a * cc
            root_of = torch.where(disc >= 0.0, disc, 1.0)
            if diff:
                sq = _GrazeSqrt.apply(root_of, (1e-3 * torch.abs(b) + 1e-12).detach())
            else:
                sq = torch.sqrt(root_of)
            inside = oc2 <= rad * rad
            # A zero-length segment (a refraction lost to total internal
            # reflection) gives 0/0 = NaN, as in the kernel; the guard only
            # keeps that NaN out of the gradient.
            pos_a = a > 0.0
            tc = torch.where(pos_a, torch.where(inside, -b + sq, -b - sq)
                             / torch.where(pos_a, 2.0 * a, 1.0), float("nan"))
            valid = (disc >= 0.0) & (tc >= 0.0) & (tc <= 1.0)
            tv = torch.where(valid, tc, 0.0)
            px, py, pz = sx + dx * tv, sy + dy * tv, sz + dz * tv
            hn = ((px - c0) * inv_r, (py - c1) * inv_r, (pz - c2) * inv_r)
        elif k == KIND_TRIANGLE:
            v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, eps_area = r[:10]
            pvx = dy * e2z - dz * e2y
            pvy = dz * e2x - dx * e2z
            pvz = dx * e2y - dy * e2x
            det = e1x * pvx + e1y * pvy + e1z * pvz
            np_ = torch.abs(det) >= eps_area
            inv = 1.0 / torch.where(np_, det, 1.0)
            tx, ty, tz = sx - v0x, sy - v0y, sz - v0z
            ub = (tx * pvx + ty * pvy + tz * pvz) * inv
            qvx = ty * e1z - tz * e1y
            qvy = tz * e1x - tx * e1z
            qvz = tx * e1y - ty * e1x
            vb = (dx * qvx + dy * qvy + dz * qvz) * inv
            tc = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
            valid = (np_ & (ub >= 0.0) & (vb >= 0.0) & (ub + vb <= 1.0)
                     & (tc >= 0.0) & (tc <= 1.0))
            hn = tuple(r[10 + c] + r[13 + c] * ub + r[16 + c] * vb for c in range(3))
            tri_uv = tuple(r[19 + c] + r[21 + c] * ub + r[23 + c] * vb for c in range(2))
        else:
            p0, p1, p2, pw = r[:4]
            ts = p0 * dx + p1 * dy + p2 * dz
            ns = -(p0 * sx + p1 * sy + p2 * sz + pw)
            np_ = torch.abs(ts) >= eps
            if diff:
                tc = _GrazeDiv.apply(ns, torch.where(np_, ts, 1.0), seg_floor)
            else:
                tc = ns / torch.where(np_, ts, 1.0)
            valid = np_ & (tc >= 0.0) & (tc <= 1.0)
            px, py, pz = sx + dx * tc, sy + dy * tc, sz + dz * tc
            if k == KIND_CUBOID:
                for j in range(4):
                    q0, q1, q2, qw = r[4 + 4 * j: 8 + 4 * j]
                    valid = valid & (q0 * px + q1 * py + q2 * pz + qw <= 0.0)
            elif k in (KIND_DISC, KIND_QUAD):
                ex, ey, ez = px - r[4], py - r[5], pz - r[6]
                if k == KIND_DISC:
                    valid = valid & ((ex * ex + ey * ey + ez * ez) <= r[7] * r[7])
                else:
                    td = r[7] * ex + r[8] * ey + r[9] * ez
                    bd = r[10] * ex + r[11] * ey + r[12] * ez
                    valid = valid & (torch.abs(bd) <= r[13]) & (torch.abs(td) <= r[14])
            hn = (torch.full_like(sx, p0), torch.full_like(sx, p1),
                  torch.full_like(sx, p2))

        better = valid & (tc < t)
        t = torch.where(better, tc, t)
        nx = torch.where(better, hn[0], nx)
        ny = torch.where(better, hn[1], ny)
        nz = torch.where(better, hn[2], nz)
        mat = torch.where(better, m, mat)
        kind = torch.where(better, k, kind)
        if tri_uv is not None:
            uu = torch.where(better, tri_uv[0], uu)
            vv = torch.where(better, tri_uv[1], vv)

    mat = torch.clamp(mat, min=0)
    if not want_texcoords:
        return t, nx, ny, nz, mat, kind, uu, vv

    # Texcoords by winner kind (sphere map / planar map / cuboid ×0.1 /
    # triangle barycentric already merged).
    px, py, pz = sx + dx * t, sy + dy * t, sz + dz * t
    su = _atan2(nx, nz) / (2.0 * vm.PI) + 0.5
    sv = 1.0 - (ny * 0.5 + 0.5)
    use_x = (nx > ny) & (nx > nz)
    use_y = (ny > nx) & (ny > nz) & ~use_x
    pu = torch.where(use_x, py, px)
    pv = torch.where(use_x, pz, torch.where(use_y, pz, py))
    scale = torch.where(kind == KIND_CUBOID, 0.1, 1.0)
    uu = torch.where(kind == KIND_SPHERE, su,
                     torch.where(kind == KIND_TRIANGLE, uu, pu * scale))
    vv = torch.where(kind == KIND_SPHERE, sv,
                     torch.where(kind == KIND_TRIANGLE, vv, pv * scale))
    return t, nx, ny, nz, mat, kind, uu, vv


def intersect_plan(n_prims: int, n: int) -> tuple[int, int]:
    """Kernel 1's launch over ``n`` segments and ``n_prims`` rows
    (csrc/fspt_kernels.cu fspt_intersect_plan, which the launcher follows):
    its grid, eight waves of the card's resident blocks (fewer where the
    segments fill fewer tiles), and the segments a block takes a stride.
    Loads the kernel library."""
    grid, tile = ctypes.c_int(), ctypes.c_int()
    err = _build.library("fspt_kernels").fspt_intersect_plan(
        n_prims, n, ctypes.byref(grid), ctypes.byref(tile))
    if err != 0:
        raise RuntimeError(f"intersect plan failed: CUDA error {err}")
    return grid.value, tile.value


def launch_intersect(scene: HostScene, start, seg):
    """Launch kernel 1 on CUDA tensors ``start``/``seg`` [N,3] float32.

    Returns ``(t [N], normal [N,3], mat [N], kind [N], uv [N,2])``.
    """
    dev = start.device
    n = start.shape[0]
    _build.check_cuda_tensor("start", start, torch.float32, (n, 3), dev)
    _build.check_cuda_tensor("seg", seg, torch.float32, (n, 3), dev)
    prims, meta = scene.tables(dev)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    normal = torch.empty((n, 3), dtype=torch.float32, device=dev)
    mat = torch.empty((n,), dtype=torch.int32, device=dev)
    kind = torch.empty((n,), dtype=torch.int32, device=dev)
    uv = torch.empty((n, 2), dtype=torch.float32, device=dev)
    _build.launch(INTERSECT, prims.data_ptr(), meta.data_ptr(), scene.prim_count,
                  start.data_ptr(), seg.data_ptr(), n, t.data_ptr(),
                  normal.data_ptr(), mat.data_ptr(), kind.data_ptr(), uv.data_ptr(),
                  torch.cuda.current_stream(dev).cuda_stream)
    return t, normal, mat, kind, uv


def plain_intersect(scene: HostScene, start, seg):
    """The plain version with kernel 1's output layout."""
    t, nx, ny, nz, mat, kind, uu, vv = intersect_lanes(
        scene, start[:, 0], start[:, 1], start[:, 2],
        seg[:, 0], seg[:, 1], seg[:, 2])
    return (t, torch.stack([nx, ny, nz], dim=-1), mat, kind,
            torch.stack([uu, vv], dim=-1))


def make_cuda_intersector(geometry, plain: bool = False):
    """``fn(start[N,3], seg[N,3]) → Hit`` over the scene's primitives, or
    None above :data:`MAX_SPECIALIZED_PRIMS` (as the reference).

    A CPU ``start`` takes the plain version; a CUDA one launches kernel 1
    (``plain=True``: the plain version on any device, for kernel checks).
    """
    scene = HostScene(geometry)
    if scene.prim_count > MAX_SPECIALIZED_PRIMS:
        return None

    def intersect(start, seg) -> Hit:
        if plain or start.device.type == "cpu":
            t, normal, mat, kind, uv = plain_intersect(scene, start, seg)
        elif start.device.type == "cuda":
            t, normal, mat, kind, uv = launch_intersect(
                scene, start.contiguous(), seg.contiguous())
        else:
            raise ValueError(f"unsupported device {start.device}")
        return Hit(t=t, point=start + seg * t[:, None], normal=normal,
                   texcoords=uv, mat=mat, prim_kind=kind, hit=t < INVALID_PARAM)

    intersect.host_scene = scene
    return intersect
