"""Plain reference of a triangle-mesh scene through a thin-lens camera.

The heightfield configuration (``benchmark/configs/heightfield_100k.json``)
adds two things to what :mod:`pathtrace` models: a thin-lens camera and a
mesh of triangles.  This module gives both and the path loop over them,
reusing :mod:`pathtrace`'s random streams, analytic closest hit, material
tables and shading; it imports nothing of the program under test and none
of JAX, and shares no tree or table layout with the program:

* the mesh is worked out here from its description, the heightfield formula
  of ``bench.py:134-146`` evaluated in NumPy float32 as ``bench.py`` does
  (:func:`heightfield`), each cell split into two triangles;
* the triangles are tested by brute force, every segment against every
  triangle, with no acceleration structure: Möller–Trumbore written as
  products of each segment's ``(d, o×d, o, 1)`` with per-triangle weights
  (Plücker form), run as matrix products over blocks of segments, then a
  masked minimum over the triangles.  The closest hit is the nearer of the
  mesh's and the analytic rows' (:func:`pathtrace.closest_hit`); a triangle
  wins only where it is strictly nearer;
* the thin lens of the reference engine (engine.cpp:221-244): the pinhole
  segment's crossing of the focal plane (normal −forward through origin +
  forward·focal depth), a lens offset ``right·cos(2π u2)·r + up·sin(2π
  u2)·r`` with ``r = sqrt(u3)·aperture``, on the camera stream's counters
  2 and 3 (the pinhole's jitter takes 0 and 1), and a segment of length
  ``z_far`` from the offset origin through the focal point; a segment
  parallel to the focal plane or not crossing it within its length keeps the
  pinhole's.

Departures from the published description, each also the program's: a
triangle's shading normal is its geometric normal (the mesh has no vertex
normals) flipped towards the segment's origin, as every hit's; a hit counts
where ``|det| ≥ 1e-5 · |e1 × e2|``; the material is the configuration's one
mesh material.  The description asks for float32: every float tensor is made
in ``dtype`` (the bfloat16 control runs the same code), the weights are
worked out in float64 and rounded once, and TF32 is off for the products.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import pathtrace as pt

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


# --- the mesh -----------------------------------------------------------------


def heightfield(desc: dict):
    """``(v0, v1, v2)`` float32 ``[T, 3]`` of a heightfield description:
    ``grid`` points a side from ``extent[0]`` to ``extent[1]`` in x and z,
    y = a1·sin(f1x·x)·cos(f1z·z) + a2·sin(f2x·x + p2)·sin(f2z·z) + offset,
    evaluated in float32 as ``bench.py:134-146`` does; two triangles a cell,
    ``(a, b, c)`` then ``(a, c, d)``."""
    grid = int(desc["grid"])
    lo, hi = desc["extent"]
    h = desc["height"]
    xs = np.linspace(lo, hi, grid, dtype=np.float32)
    X, Z = np.meshgrid(xs, xs, indexing="ij")
    Y = (h["a1"] * np.sin(X * h["f1x"]) * np.cos(Z * h["f1z"])
         + h["a2"] * np.sin(X * h["f2x"] + h["p2"]) * np.sin(Z * h["f2z"]) + h["offset"])
    P = np.stack([X, Y, Z], axis=-1)
    a = P[:-1, :-1].reshape(-1, 3)
    b = P[1:, :-1].reshape(-1, 3)
    c = P[1:, 1:].reshape(-1, 3)
    d = P[:-1, 1:].reshape(-1, 3)
    return np.concatenate([a, a]), np.concatenate([b, c]), np.concatenate([c, d])


class Mesh:
    """A triangle mesh's brute-force closest hit in ``dtype`` on ``device``.

    Per triangle, with ``e1 = v1 − v0``, ``e2 = v2 − v0``, ``n = e1 × e2``,
    a segment ``o + d·t`` gives ``det = −d·n``, ``u·det = e2·(o×d) +
    d·(v0×e2)``, ``v·det = −e1·(o×d) + d·(e1×v0)`` and ``t·det = o·n −
    v0·n``: four products of the segment's features with weight columns."""

    def __init__(self, v0, v1, v2, mat: int, dtype, device, block_elems: int = 1 << 26):
        v0, v1, v2 = (np.asarray(v, np.float64) for v in (v0, v1, v2))
        e1, e2 = v1 - v0, v2 - v0
        n = np.cross(e1, e2)
        area = np.linalg.norm(n, axis=-1)
        f = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)  # noqa: E731
        self.w_det = f(-n.T)                                               # [3, T]
        self.w_u = f(np.concatenate([np.cross(v0, e2).T, e2.T]))           # [6, T] (d, o×d)
        self.w_v = f(np.concatenate([np.cross(e1, v0).T, -e1.T]))          # [6, T]
        self.w_t = f(np.concatenate([n.T, -np.einsum("ij,ij->i", v0, n)[None]]))  # [4, T]
        self.eps_area = f(pt.EPSILON * area)
        self.normal = f(n / np.where(area > 0.0, area, 1.0)[:, None])
        self.mat = int(mat)
        self.count = len(area)
        self.block = max(1, block_elems // max(self.count, 1))

    def closest(self, start, seg):
        """``(t [n], tri [n])``: each segment's nearest triangle hit with t
        in [0, 1] (t = 2, tri = −1 where none)."""
        n = start.shape[0]
        t_best = torch.full((n,), pt.INVALID, dtype=start.dtype, device=start.device)
        tri = torch.full((n,), -1, dtype=torch.int64, device=start.device)
        for b0 in range(0, n, self.block):
            o, d = start[b0:b0 + self.block], seg[b0:b0 + self.block]
            c = torch.cross(o, d, dim=-1)
            dc = torch.cat([d, c], dim=-1)
            det = d @ self.w_det
            un = dc @ self.w_u
            vn = dc @ self.w_v
            tn = torch.cat([o, torch.ones_like(o[:, :1])], dim=-1) @ self.w_t
            # Fold det's sign into the numerators: the tests need no division.
            sign = torch.where(det < 0.0, -1.0, 1.0).to(det.dtype)
            ad = det.abs()
            un, vn, tn = un * sign, vn * sign, tn * sign
            ok = ((ad >= self.eps_area) & (un >= 0.0) & (vn >= 0.0) & (un + vn <= ad)
                  & (tn >= 0.0) & (tn <= ad))
            t = torch.where(ok, tn / torch.where(ok, ad, 1.0), math.inf)
            t_min, j = t.min(dim=1)
            hit = t_min <= 1.0
            t_best[b0:b0 + self.block] = torch.where(hit, t_min, t_best[b0:b0 + self.block])
            tri[b0:b0 + self.block] = torch.where(hit, j, -1)
        return t_best, tri


def mesh_from_config(config: dict, dtype, device, block_elems: int = 1 << 26) -> Mesh:
    """The configuration's ``reference.scene.mesh`` (a heightfield) as a
    :class:`Mesh` with its material row."""
    desc = config["reference"]["scene"]["mesh"]
    if desc["kind"] != "heightfield":
        raise ValueError(f"the reference has no mesh kind {desc['kind']!r}")
    names = list(config["reference"]["scene"]["materials"])
    return Mesh(*heightfield(desc), names.index(desc["material"]), dtype, device, block_elems)


# --- the camera ---------------------------------------------------------------


class ThinLensCamera(pt.PinholeCamera):
    """:class:`pathtrace.PinholeCamera` with the engine's thin lens
    (engine.cpp:221-244) where the aperture is above 0."""

    def __init__(self, cam: dict, width: int, height: int):
        super().__init__(dict(cam, aperture_size=0.0), width, height)
        self.aperture = float(cam.get("aperture_size", 0.0))
        o = np.asarray(cam["origin"], np.float64)
        fwd = np.asarray(cam["target"], np.float64) - o
        fwd /= np.linalg.norm(fwd)
        focus = o + fwd * float(cam.get("focal_depth", 80.0))
        self.focal_normal = -fwd
        self.focal_w = -float(np.dot(-fwd, focus))

    def rays(self, h0, lanes, spp, sample0, dtype):
        start, seg, prefix = super().rays(h0, lanes, spp, sample0, dtype)
        if self.aperture <= 0.0:
            return start, seg, prefix
        vec = lambda v: torch.tensor(v, dtype=dtype, device=lanes.device)  # noqa: E731
        fn = vec(self.focal_normal)
        ts = pt.dot(seg, fn)
        ns = -(pt.dot(start, fn) + self.focal_w)
        crosses = ts.abs() >= pt.EPSILON
        tf = ns / torch.where(crosses, ts, 1.0)
        valid = crosses & (tf >= 0.0) & (tf <= 1.0)
        focus = start + seg * tf[:, None]
        u2 = pt.uniform(prefix, pt.CTR_CAMERA + 2, dtype)
        u3 = pt.uniform(prefix, pt.CTR_CAMERA + 3, dtype)
        angle = u2 * (2.0 * pt.PI)
        r = torch.sqrt(u3) * self.aperture
        offset = (torch.cos(angle) * r)[:, None] * vec(self.right) \
            + (torch.sin(angle) * r)[:, None] * vec(self.up)
        lens_start = start + offset
        lens_seg = pt.normalize(focus - lens_start) * self.z_far
        return (torch.where(valid[:, None], lens_start, start),
                torch.where(valid[:, None], lens_seg, seg), prefix)


# --- the path ------------------------------------------------------------------


def closest_hit(tables, mesh: Mesh, start, seg, alive):
    """The nearer of the analytic rows' hit and the mesh's, for the live
    segments (a dead one keeps the analytic hit): ``(t, normal, mat)``, the
    normal not flipped yet."""
    t, normal, mat, _ = pt.closest_hit(tables, start, seg)
    live = torch.nonzero(alive)[:, 0]
    t_tri, tri = mesh.closest(start[live], seg[live])
    wins = (tri >= 0) & (t_tri < t[live])
    rows = live[wins]
    t[rows] = t_tri[wins]
    normal[rows] = mesh.normal[tri[wins]]
    mat[rows] = mesh.mat
    return t, normal, mat


def trace_lanes(tables, mesh: Mesh, cam: ThinLensCamera, spp: int, max_depth: int, seed: int,
                sample0: int, lanes):
    """Trace the frame lanes ``lanes`` (int64) of a frame whose first sample
    is ``sample0``, as :func:`pathtrace.trace_lanes` does with the mesh in
    the closest hit.  Returns ``(radiance [n,3], normal [n,3], depth [n],
    mat [n], segments [n])``."""
    dtype, dev = tables.diffuse.dtype, tables.diffuse.device
    n = lanes.shape[0]
    start, seg, prefix = cam.rays(pt.seed_prefix(seed), lanes, spp, sample0, dtype)
    L = torch.zeros((n, 3), dtype=dtype, device=dev)
    T = torch.ones((n, 3), dtype=dtype, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    segments = torch.zeros((n,), dtype=torch.int32, device=dev)
    aov_n = torch.zeros((n, 3), dtype=dtype, device=dev)
    aov_d = torch.zeros((n,), dtype=dtype, device=dev)
    aov_m = torch.full((n,), tables.sky, dtype=torch.int64, device=dev)
    p_light = torch.zeros((n,), dtype=torch.bool, device=dev)
    seg_len = cam.z_far - pt.RAY_OFFSET
    sky = tables.emissive[tables.sky] * 3.0
    for depth in range(max_depth):
        segments = segments + alive.to(torch.int32)
        t, hn, mat = closest_hit(tables, mesh, start, seg, alive)
        hit = t < pt.INVALID
        p = start + seg * t[:, None]
        hn = torch.where((pt.dot(hn, start - p) < 0.0)[:, None], -hn, hn)

        miss = alive & ~hit
        view_dir = pt.normalize(seg)
        L = torch.where(miss[:, None], L + T * sky, L)

        active = alive & hit
        fam = tables.family[mat]
        oh = tables.one_hot(mat)
        v = pt.normalize(p - start)
        base = pt.CTR_BOUNCE + depth * pt.BOUNCE_SLOTS
        u0, u1, u2, _ = (pt.uniform(prefix, base + k, dtype) for k in range(4))
        refl = v - 2.0 * pt.dot(hn, v)[:, None] * hn
        gz = 1.0 - 2.0 * u1
        gr = torch.sqrt(torch.clamp(1.0 - gz * gz, min=0.0))
        phi = (2.0 * pt.PI) * u2
        g = torch.stack([gr * torch.cos(phi), gr * torch.sin(phi), gz], -1)
        g = torch.where((pt.dot(g, hn) < 0.0)[:, None], -g, g)

        def lerped(amount):
            o = pt.normalize(g * amount[:, None] + refl * (1.0 - amount)[:, None])
            return torch.where((pt.dot(o, hn) < 0.0)[:, None], -o, o)

        prm = tables.gather(tables.param, oh)
        albedo = tables.gather(tables.diffuse, oh)
        ndl_d = pt.dot(g, hn)
        coef_d = albedo * torch.clamp(ndl_d, min=0.0)[:, None]
        dir_m = lerped(prm)
        ndl_m = pt.dot(dir_m, hn)
        coef_m = albedo * (prm * torch.clamp(ndl_m, min=0.0) + (1.0 - prm))[:, None]
        amount_c = torch.where(u0 < pt.CERAMIC_SPIKE_PROB, torch.zeros_like(prm), 1.0 - prm)
        dir_c = lerped(amount_c)
        nl_c = torch.clamp(pt.dot(dir_c, hn), min=0.0)
        hn_c = pt.dot(pt.normalize(dir_c - v), hn)
        spec = (hn_c * hn_c) ** (pt.CERAMIC_SPEC_POWER // 2)
        coef_c = spec[:, None] + albedo * (nl_c * (1.0 - spec))[:, None]

        is_ = lambda f: (fam == f)[:, None]  # noqa: E731
        direction = torch.where(is_(pt.DIFFUSE), g, torch.where(
            is_(pt.METAL), dir_m, torch.where(is_(pt.MIRROR), refl, dir_c)))
        coef = torch.where(is_(pt.DIFFUSE), coef_d, torch.where(
            is_(pt.METAL), coef_m, torch.where(is_(pt.MIRROR), albedo, coef_c)))
        will = torch.where(fam == pt.DIFFUSE, ndl_d > pt.DIFFUSE_CONTRIB_THRESHOLD,
                           torch.where(fam == pt.METAL, tables.metal_smooth[mat]
                                       | (ndl_m > pt.DIFFUSE_CONTRIB_THRESHOLD),
                                       fam != pt.LIGHT))
        light = active & (fam == pt.LIGHT)
        L = torch.where(light[:, None], L + T * tables.gather(tables.emissive, oh), L)
        T = torch.where((active & ~light)[:, None], T * coef, T)

        if depth == 0:
            p_light = light
            aov_n = torch.where(hit[:, None], hn, view_dir)
            aov_d = torch.where(hit, torch.sqrt(pt.dot(p - start, p - start)),
                                torch.full_like(aov_d, cam.z_far))
            aov_m = torch.where(hit, mat, aov_m)

        start = torch.where(active[:, None], p + direction * pt.RAY_OFFSET, start)
        seg = torch.where(active[:, None], direction * seg_len, seg)
        alive = active & will
    norm = torch.sqrt(torch.clamp(pt.dot(L, L), min=1e-20))
    clamp = p_light & (norm > pt.LIGHT_CLAMP)
    L = L * torch.where(clamp, pt.LIGHT_CLAMP / norm, torch.ones_like(norm))[:, None]
    return L, aov_n, aov_d, aov_m.to(torch.int32), segments


def band_lanes(rows, width: int, spp: int, device):
    """The frame lanes of image rows ``rows`` in row order (pixel-major,
    then sample)."""
    per_row = width * spp
    base = torch.as_tensor(list(rows), dtype=torch.int64, device=device)[:, None] * per_row
    return (base + torch.arange(per_row, dtype=torch.int64, device=device)).reshape(-1)


def reference_band(scene, mesh: Mesh, cam: ThinLensCamera, spp: int, max_depth: int, seed: int,
                   frame: int, rows, dtype, device):
    """The reference's outputs of the lanes of image rows ``rows`` of frame
    ``frame``, without gradients."""
    tables = pt.Tables(scene, dtype, device)
    if tables.textured:
        raise ValueError("the mesh reference models untextured scenes")
    with torch.no_grad():
        return trace_lanes(tables, mesh, cam, spp, max_depth, seed, frame * spp,
                           band_lanes(rows, cam.width, spp, device))
