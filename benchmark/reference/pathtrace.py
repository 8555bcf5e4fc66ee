"""Plain reference path tracer: the engine's semantics over lane tensors.

An independent implementation of what a camera-fused frame computes: the
counter-based random streams, the pinhole camera, the closest hit over
spheres, quads and rotated cuboids, the material families the benchmark's
scenes use (diffuse, light, metal, mirror, ceramic), textured rows and sky,
the primary-hit light clamp and the depth-0 AOVs.  It follows the recursive
per-pixel oracle of the reference engine (engine.cpp:59-250,
material.cpp), written as a loop over depths with a running throughput,
which is the same sum.  Plain PyTorch only: it imports nothing of the
program under test and none of JAX.

Every float tensor is made in ``dtype``, so the same code computed in
bfloat16 is the benchmark's lower-precision control.  Material values may
be tensors that require grad: torch autograd then gives the recovery
gradients, with the reference's derivative floors at grazing plane hits and
sphere tangents (the winner's ``ns/ts`` and ``sqrt(disc)``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

PI = 3.14159262  # the engine's constant (math/base.h)
EPSILON = 1.0e-5
INVALID = 2.0

DIFFUSE, LIGHT, METAL, MIRROR, GLASS, LIQUID, CERAMIC, GLOW, FOG = range(9)
DIFFUSE_CONTRIB_THRESHOLD = 0.001
DIFFUSE_ROUGHNESS_THRESHOLD = 0.95
CERAMIC_SPIKE_PROB = 0.1
CERAMIC_SPEC_POWER = 50
SUPPORTED_FAMILIES = (DIFFUSE, LIGHT, METAL, MIRROR, CERAMIC)

RAY_OFFSET = 0.03
LIGHT_CLAMP = 10.0
BOUNCE_SLOTS = 4

CTR_CAMERA = 0
CTR_BOUNCE = 16
_M32 = 0xFFFFFFFF


# --- counter-based random streams (PCG-RXS-M-XS over uint32) ---------------


def pcg(x):
    """One PCG-RXS-M-XS output permutation of uint32 values held in int64
    (a Python int or an int64 tensor)."""
    x = (x * 747796405 + 2891336453) & _M32
    word = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & _M32
    return (word >> 22) ^ word


def seed_prefix(seed: int) -> int:
    return pcg((int(seed) & _M32) ^ 0x9E3779B9)


def lane_prefix(h0: int, pixel, sample):
    return pcg((pcg((pixel + h0) & _M32) + sample) & _M32)


def uniform(prefix, ctr: int, dtype):
    """The float in [0, 1) of counter ``ctr``: the hash's top 24 bits."""
    bits = pcg((prefix + ctr) & _M32)
    return ((bits >> 8).to(torch.float64) * (1.0 / (1 << 24))).to(dtype)


# --- camera ------------------------------------------------------------------


class PinholeCamera:
    """A camera's frame (engine.cpp:184-197): basis from world up +Y, the
    projection rectangle at ``z_far``.  Apertures are not modelled."""

    def __init__(self, cam: dict, width: int, height: int):
        if float(cam.get("aperture_size", 0.0)) > 0.0:
            raise ValueError("the reference models pinhole cameras only")
        o = np.asarray(cam["origin"], np.float64)
        fwd = np.asarray(cam["target"], np.float64) - o
        fwd /= np.linalg.norm(fwd)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        up /= np.linalg.norm(up)
        self.z_far = float(cam.get("z_far", 10000.0))
        fovy = float(cam["fov_y"]) * PI / 180.0
        fovx = 2.0 * math.atan(math.tan(fovy * 0.5) * width / height)
        self.half_h = math.tan(fovy * 0.5) * self.z_far
        self.half_w = math.tan(fovx * 0.5) * self.z_far
        self.origin, self.right, self.up = o, right, up
        self.proj_origin = o + fwd * self.z_far
        self.width, self.height = width, height

    def rays(self, h0, lanes, spp, sample0, dtype):
        """Primary segments of the frame's lanes (pixel-major, then sample):
        ``(start [n,3], seg [n,3], prefix [n])``."""
        s = lanes % spp
        pxy = lanes // spp
        x = pxy % self.width
        y = pxy // self.width
        prefix = lane_prefix(h0, y * self.width + x, s + sample0)
        u0, u1 = uniform(prefix, CTR_CAMERA, dtype), uniform(prefix, CTR_CAMERA + 1, dtype)
        xd = self.half_w * (((x.to(dtype) + (u0 - 0.5)) * (1.0 / (self.width - 1))) * 2.0 - 1.0)
        yd = self.half_h * (((y.to(dtype) + (u1 - 0.5)) * (1.0 / (self.height - 1))) * 2.0 - 1.0)
        vec = lambda v: torch.tensor(v, dtype=dtype, device=lanes.device)  # noqa: E731
        stop = vec(self.proj_origin) + xd[:, None] * vec(self.right) + yd[:, None] * vec(self.up)
        start = vec(self.origin).expand_as(stop)
        return start, stop - start, prefix


# --- geometry ------------------------------------------------------------------


class _FloorDiv(torch.autograd.Function):
    """``ns / ts`` whose derivatives floor ``|ts|`` at ``floor``."""

    @staticmethod
    def forward(ctx, ns, ts, floor):
        ctx.save_for_backward(ns, ts, floor)
        return ns / ts

    @staticmethod
    def backward(ctx, ct):
        ns, ts, floor = ctx.saved_tensors
        safe = torch.where(ts < 0.0, -1.0, 1.0) * torch.maximum(ts.abs(), floor)
        return ct / safe, -ct * ns / (safe * safe), None


class _FloorSqrt(torch.autograd.Function):
    """``sqrt(x)`` whose derivative floors the root at ``floor``."""

    @staticmethod
    def forward(ctx, x, floor):
        r = torch.sqrt(x)
        ctx.save_for_backward(r, floor)
        return r

    @staticmethod
    def backward(ctx, ct):
        r, floor = ctx.saved_tensors
        return ct / (2.0 * torch.maximum(r, floor)), None


def dot(a, b):
    return (a * b).sum(-1)


def normalize(v):
    n2 = dot(v, v)
    pos = n2 > 0.0
    return v / torch.sqrt(torch.where(pos, n2, 1.0))[:, None] * pos[:, None]


def closest_hit(tables, start, seg):
    """The closest hit of each segment over the scene's rows, in the
    engine's merge order (spheres, quads, cuboid faces; strict ``<``
    between rows).  Returns ``(t [n], normal [n,3], mat [n], uv [n,2])``
    with ``t = 2`` on a miss; the normal is not flipped yet; uv is the
    winner's texture coordinates (sphere map, planar map, cuboid ×0.1),
    made only where the scene has textures."""
    dtype, dev = start.dtype, start.device
    n = start.shape[0]
    diff = torch.is_grad_enabled() and (start.requires_grad or seg.requires_grad)
    if diff:
        seg_floor = (1e-3 * torch.sqrt(dot(seg, seg)) + 1e-20).detach()
    t = torch.full((n,), INVALID, dtype=dtype, device=dev)
    normal = torch.zeros((n, 3), dtype=dtype, device=dev)
    mat = torch.zeros((n,), dtype=torch.int64, device=dev)
    kind = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for k, m, row in tables.rows:
        if k == "sphere":
            c, r = row["center"], row["radius"]
            oc = start - c
            a = dot(seg, seg)
            b = 2.0 * dot(oc, seg)
            oc2 = dot(oc, oc)
            disc = b * b - 4.0 * a * (oc2 - r * r)
            root_of = torch.where(disc >= 0.0, disc, 1.0)
            if diff:
                sq = _FloorSqrt.apply(root_of, (1e-3 * b.abs() + 1e-12).detach())
            else:
                sq = torch.sqrt(root_of)
            tc = torch.where(oc2 <= r * r, -b + sq, -b - sq) / (2.0 * a)
            valid = (disc >= 0.0) & (tc >= 0.0) & (tc <= 1.0)
            p = start + seg * torch.where(valid, tc, 0.0)[:, None]
            hn = normalize(p - c)
        else:
            pn, pw = row["normal"], row["w"]
            ts = dot(seg, pn)
            ns = -(dot(start, pn) + pw)
            ok = ts.abs() >= EPSILON
            if diff:
                tc = _FloorDiv.apply(ns, torch.where(ok, ts, 1.0), seg_floor)
            else:
                tc = ns / torch.where(ok, ts, 1.0)
            valid = ok & (tc >= 0.0) & (tc <= 1.0)
            p = start + seg * tc[:, None]
            if k == "quad":
                e = p - row["origin"]
                valid = (valid & (dot(e, row["bitangent"]).abs() <= row["half_w"])
                         & (dot(e, row["tangent"]).abs() <= row["half_h"]))
            elif k == "cuboid_face":
                for sn, sw in row["sides"]:
                    valid = valid & (dot(p, sn) + sw <= 0.0)
            hn = pn.expand_as(p)
        better = valid & (tc < t)
        t = torch.where(better, tc, t)
        normal = torch.where(better[:, None], hn, normal)
        mat = torch.where(better, m, mat)
        kind = torch.where(better, _KIND_CODE[k], kind)
    if not tables.textured:
        return t, normal, mat, None
    p = start + seg * t[:, None]
    nx, ny, nz = normal.unbind(-1)
    sphere_uv = sphere_map(normal)
    use_x = (nx > ny) & (nx > nz)
    use_y = (ny > nx) & (ny > nz) & ~use_x
    pu = torch.where(use_x, p[:, 1], p[:, 0])
    pv = torch.where(use_x | use_y, p[:, 2], p[:, 1])
    scale = torch.where(kind == _KIND_CODE["cuboid_face"], 0.1, 1.0).to(dtype)
    planar = torch.stack([pu * scale, pv * scale], -1)
    uv = torch.where((kind == _KIND_CODE["sphere"])[:, None], sphere_uv, planar)
    return t, normal, mat, uv


_KIND_CODE = {"sphere": 0, "quad": 3, "cuboid_face": 4}


def fast_atan2(y, x):
    """The engine's polynomial atan2 (the sky and sphere texture maps)."""
    ax, ay = x.abs(), y.abs()
    mx, mn = torch.maximum(ax, ay), torch.minimum(ax, ay)
    z = mn / torch.where(mx > 0.0, mx, 1.0)
    z2 = z * z
    p = z * (0.9998660 + z2 * (-0.3302995 + z2 * (0.1801410 + z2 * (-0.0851330
                                                                  + z2 * 0.0208351))))
    r = torch.where(ay > ax, 0.5 * PI - p, p)
    r = torch.where(x < 0.0, PI - r, r)
    return torch.where(y < 0.0, -r, r)


def sphere_map(v):
    """Texture coordinates of a unit direction (scene.cpp:157-162)."""
    u = fast_atan2(v[:, 0], v[:, 2]) / (2.0 * PI) + 0.5
    return torch.stack([u, 1.0 - (v[:, 1] * 0.5 + 0.5)], -1)


# --- materials and the path ---------------------------------------------------


class Tables:
    """The scene on a device in ``dtype``: its primitive rows' constants, its
    material rows and texels.

    ``values`` overrides the continuous material columns (``diffuse``,
    ``emissive``, ``param``) with tensors, which may require grad."""

    def __init__(self, scene, dtype, device, values=None):
        mats = scene.materials
        for m in mats:
            if m["family"] not in SUPPORTED_FAMILIES:
                raise ValueError(f"the reference has no material family {m['family']}")
        f = lambda rows: torch.tensor(np.asarray(rows, np.float64),  # noqa: E731
                                      dtype=dtype, device=device)
        i = lambda rows: torch.tensor(rows, dtype=torch.int64, device=device)  # noqa: E731
        cols = {"diffuse": f([m["diffuse"] for m in mats]),
                "emissive": f([m["emissive"] for m in mats]),
                "param": f([m["param"] for m in mats])}
        for name, v in (values or {}).items():
            cols[name] = v.to(dtype)
        self.diffuse, self.emissive, self.param = cols["diffuse"], cols["emissive"], cols["param"]
        self.count = len(mats)
        self.family = i([m["family"] for m in mats])
        # Whether each row's regime is fixed (metal at roughness ≤ 0.95
        # always continues), decided once from the scene's own values.
        self.metal_smooth = torch.tensor(
            [m["family"] == METAL and m["param"] <= DIFFUSE_ROUGHNESS_THRESHOLD for m in mats],
            device=device)
        self.sky = scene.sky
        self.textured = any(m["tex_id"] >= 0 for m in mats)
        self.tex_id = i([m["tex_id"] for m in mats])
        self.tex_scale = f([m["tex_scale"] for m in mats])
        texs = scene.textures or [np.zeros((1, 1, 3), np.float32)]
        self.texels = torch.cat([f(t.reshape(-1, 3)) for t in texs])
        sizes = [t.shape[:2] for t in texs]
        self.tex_h = i([h for h, _ in sizes])
        self.tex_w = i([w for _, w in sizes])
        self.tex_off = i(np.cumsum([0] + [h * w for h, w in sizes[:-1]]).tolist())
        self.rows = []
        for r in scene.rows:
            k = r["kind"]
            if k == "sphere":
                c = dict(center=f(r["center"]), radius=r["radius"])
            elif k in ("quad", "cuboid_face"):
                c = dict(normal=f(r["plane"][:3]), w=f(r["plane"][3]))
                if k == "quad":
                    c.update(origin=f(r["origin"]), tangent=f(r["tangent"]),
                             bitangent=f(r["bitangent"]), half_w=r["half_w"],
                             half_h=r["half_h"])
                elif k == "cuboid_face":
                    c["sides"] = [(f(sd[:3]), f(sd[3])) for sd in r["sides"]]
            else:
                raise ValueError(f"the reference has no primitive kind {k!r}")
            self.rows.append((k, r["mat"], c))

    def one_hot(self, rows):
        """``[n, M]`` one-hot rows: a gather by a product and a sum, whose
        gradient is a sum over the lanes (no atomics onto a few rows)."""
        return torch.nn.functional.one_hot(rows, self.count).to(self.diffuse.dtype)

    @staticmethod
    def gather(column, oh):
        """The rows of ``column`` ([M] or [M,3]) picked by one-hot ``oh``."""
        if column.dim() == 1:
            return (oh * column).sum(-1)
        return (oh[:, :, None] * column).sum(1)

    def texel(self, rows, uv, fallback):
        """Nearest texel of row ``rows`` at ``uv`` (material.cpp:107-127:
        ``int(u·scale·w + 0.5 − 1) mod w``), or ``fallback`` where the row
        has no texture."""
        if not self.textured:
            return fallback
        tid = self.tex_id[rows]
        safe = tid.clamp(min=0)
        w, h = self.tex_w[safe], self.tex_h[safe]
        sc = self.tex_scale[rows]
        xi = torch.remainder((uv[:, 0] * sc * w.to(uv.dtype) + 0.5 - 1.0).to(torch.int64), w)
        yi = torch.remainder((uv[:, 1] * sc * h.to(uv.dtype) + 0.5 - 1.0).to(torch.int64), h)
        tex = self.texels[self.tex_off[safe] + yi * w + xi]
        return torch.where((tid >= 0)[:, None], tex, fallback)


def trace_lanes(tables, cam: PinholeCamera, spp: int, max_depth: int, seed: int,
                sample0: int, lane0: int, n: int, want_aovs: bool = True):
    """Trace lanes ``lane0 .. lane0+n-1`` of a frame whose first sample is
    ``sample0``.  Returns ``(radiance [n,3], normal [n,3], depth [n], mat
    [n], segments [n])``."""
    dtype, dev = tables.diffuse.dtype, tables.diffuse.device
    lanes = lane0 + torch.arange(n, dtype=torch.int64, device=dev)
    start, seg, prefix = cam.rays(seed_prefix(seed), lanes, spp, sample0, dtype)
    L = torch.zeros((n, 3), dtype=dtype, device=dev)
    T = torch.ones((n, 3), dtype=dtype, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    segments = torch.zeros((n,), dtype=torch.int32, device=dev)
    aov_n = torch.zeros((n, 3), dtype=dtype, device=dev)
    aov_d = torch.zeros((n,), dtype=dtype, device=dev)
    aov_m = torch.full((n,), tables.sky, dtype=torch.int64, device=dev)
    p_light = torch.zeros((n,), dtype=torch.bool, device=dev)
    seg_len = cam.z_far - RAY_OFFSET
    sky_rows = torch.full((n,), tables.sky, dtype=torch.int64, device=dev)
    for depth in range(max_depth):
        segments = segments + alive.to(torch.int32)
        t, hn, mat, uv = closest_hit(tables, start, seg)
        hit = t < INVALID
        p = start + seg * t[:, None]
        hn = torch.where((dot(hn, start - p) < 0.0)[:, None], -hn, hn)

        # A miss sees the sky: its emission (or sphere-mapped texel) ×3.
        miss = alive & ~hit
        view_dir = normalize(seg)
        if tables.textured:
            sky = tables.texel(sky_rows, sphere_map(view_dir),
                               tables.emissive[tables.sky].expand(n, 3)) * 3.0
        else:
            sky = tables.emissive[tables.sky] * 3.0
        L = torch.where(miss[:, None], L + T * sky, L)

        active = alive & hit
        fam = tables.family[mat]
        oh = tables.one_hot(mat)
        v = normalize(p - start)
        base = CTR_BOUNCE + depth * BOUNCE_SLOTS
        u0, u1, u2, u3 = (uniform(prefix, base + k, dtype) for k in range(4))
        refl = v - 2.0 * dot(hn, v)[:, None] * hn
        gz = 1.0 - 2.0 * u1
        gr = torch.sqrt(torch.clamp(1.0 - gz * gz, min=0.0))
        phi = (2.0 * PI) * u2
        g = torch.stack([gr * torch.cos(phi), gr * torch.sin(phi), gz], -1)
        g = torch.where((dot(g, hn) < 0.0)[:, None], -g, g)

        def lerped(amount):
            o = normalize(g * amount[:, None] + refl * (1.0 - amount)[:, None])
            return torch.where((dot(o, hn) < 0.0)[:, None], -o, o)

        prm = tables.gather(tables.param, oh)
        diffuse = tables.gather(tables.diffuse, oh)
        albedo = tables.texel(mat, uv, diffuse)
        # Diffuse: the hemisphere sample, cosine-weighted.
        ndl_d = dot(g, hn)
        coef_d = albedo * torch.clamp(ndl_d, min=0.0)[:, None]
        # Metal: a lerp of the hemisphere sample and the reflection.
        dir_m = lerped(prm)
        ndl_m = dot(dir_m, hn)
        coef_m = albedo * (prm * torch.clamp(ndl_m, min=0.0) + (1.0 - prm))[:, None]
        # Ceramic: a mirror spike one time in ten, else a lerp; a Phong lobe.
        amount_c = torch.where(u0 < CERAMIC_SPIKE_PROB, torch.zeros_like(prm), 1.0 - prm)
        dir_c = lerped(amount_c)
        nl_c = torch.clamp(dot(dir_c, hn), min=0.0)
        hn_c = dot(normalize(dir_c - v), hn)
        spec = (hn_c * hn_c) ** (CERAMIC_SPEC_POWER // 2)
        coef_c = spec[:, None] + albedo * (nl_c * (1.0 - spec))[:, None]

        is_ = lambda f: (fam == f)[:, None]  # noqa: E731
        direction = torch.where(is_(DIFFUSE), g, torch.where(
            is_(METAL), dir_m, torch.where(is_(MIRROR), refl, dir_c)))
        coef = torch.where(is_(DIFFUSE), coef_d, torch.where(
            is_(METAL), coef_m, torch.where(is_(MIRROR), diffuse, coef_c)))
        will = torch.where(fam == DIFFUSE, ndl_d > DIFFUSE_CONTRIB_THRESHOLD,
                           torch.where(fam == METAL, tables.metal_smooth[mat]
                                       | (ndl_m > DIFFUSE_CONTRIB_THRESHOLD),
                                       fam != LIGHT))
        light = active & (fam == LIGHT)
        emit = tables.texel(mat, uv, tables.gather(tables.emissive, oh))
        L = torch.where(light[:, None], L + T * emit, L)
        T = torch.where((active & ~light)[:, None], T * coef, T)

        if depth == 0:
            p_light = light
            if want_aovs:
                aov_n = torch.where(hit[:, None], hn, view_dir)
                aov_d = torch.where(hit, torch.sqrt(dot(p - start, p - start)),
                                    torch.full_like(aov_d, cam.z_far))
                aov_m = torch.where(hit, mat, aov_m)

        start = torch.where(active[:, None], p + direction * RAY_OFFSET, start)
        seg = torch.where(active[:, None], direction * seg_len, seg)
        alive = active & will
    norm = torch.sqrt(torch.clamp(dot(L, L), min=1e-20))
    clamp = p_light & (norm > LIGHT_CLAMP)
    L = L * torch.where(clamp, LIGHT_CLAMP / norm, torch.ones_like(norm))[:, None]
    return L, aov_n, aov_d, aov_m.to(torch.int32), segments


def trace_frame(tables, cam, spp, max_depth, seed, sample0, block_lanes,
                want_aovs=True):
    """A whole frame, ``block_lanes`` lanes at a time, without gradients."""
    n = cam.width * cam.height * spp
    parts = []
    with torch.no_grad():
        for lane0 in range(0, n, block_lanes):
            parts.append(trace_lanes(tables, cam, spp, max_depth, seed, sample0,
                                     lane0, min(block_lanes, n - lane0), want_aovs))
    return tuple(torch.cat(p) for p in zip(*parts))
