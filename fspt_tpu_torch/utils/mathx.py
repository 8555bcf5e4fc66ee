"""The reference's remaining math-foundation modules as batched torch.

Port of fspt_tpu/utils/mathx.py: quaternions, bezier curves and paths,
interpolation, statistics, linear regression, polynomial solvers, byte
hashing and 4×4 matrix helpers (the scalar C++ of the reference's
math/{quaternion,interpolate,curve,statistics,regression,solver,hash,
matrix4}).  Every function works over arbitrary leading axes and is
differentiable by torch autograd.  Nothing in the renderer depends on it.

Tensors keep their device; array-likes become float32 tensors on
``device`` (the card unless ``device="cpu"``, config.resolve_device).

Deliberate deviations from the reference, as in the JAX package:

* ``slerp`` is the textbook great-arc interpolation.  The reference's
  formula (interpolate.h:60-117) divides by ``(1-frac)·ang`` in a way that
  is NaN at frac=1 and does not reduce to a rotation; it is unused in the
  reference tree.
* ``linear_squares`` solves the correct normal equations
  ``[[Σx²,Σx],[Σx,n]]``; the reference builds ``[[Σx²,Σx],[Σx,1]]``
  (regression.cpp:36), which only agrees when n==1.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fspt_tpu_torch.config import resolve_device
from fspt_tpu_torch.utils import vecmath as vm


def _f32(x, like=None, device=None):
    """``x`` as float32: a tensor keeps its device, anything else goes to
    ``like``'s device (a tensor) or ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(np.asarray(x, np.float32), device=like.device)
    return torch.as_tensor(np.asarray(x, np.float32), device=resolve_device(device))


def _first_tensor(*xs):
    return next((x for x in xs if isinstance(x, torch.Tensor)), None)


def _vec(values, like):
    return torch.tensor(values, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# Quaternions (reference math/quaternion.h; [..., 4] tensors ordered w,x,y,z)


def quat_from_axis_angle(axis, angle, device=None):
    """Unit quaternion rotating by ``angle`` about ``axis``
    (quaternion.h: from_axis_angle)."""
    axis = _f32(axis, _first_tensor(angle), device)
    v = vm.normalize(axis)
    angle = _f32(angle, v)
    s = torch.sin(angle * 0.5)
    c = torch.cos(angle * 0.5)
    return torch.stack([c, v[..., 0] * s, v[..., 1] * s, v[..., 2] * s], dim=-1)


def quat_to_axis_angle(q):
    """Inverse of :func:`quat_from_axis_angle` → ``(axis[...,3], angle)``
    (quaternion.h: to_axis_angle, returned there as <x,y,z,angle>)."""
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    angle = 2.0 * torch.arccos(w)
    s = torch.sqrt(torch.clamp(1.0 - w * w, min=1e-20))
    axis = q[..., 1:4] / s[..., None]
    # angle≈0 → the axis is arbitrary; pick +x like a normalized zero vector.
    tiny = s[..., None] < 1e-6
    return torch.where(tiny, _vec([1.0, 0.0, 0.0], q), axis), angle


def quat_mul(a, b):
    """Hamilton product (quaternion.h: operator*)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conjugate(q):
    return q * _vec([1.0, -1.0, -1.0, -1.0], q)


def quat_normalize(q):
    n2 = (q * q).sum(dim=-1, keepdim=True)
    return q / torch.sqrt(torch.clamp(n2, min=1e-20))


def quat_inverse(q):
    """Conjugate over squared norm (quaternion.h: inverse)."""
    n2 = (q * q).sum(dim=-1, keepdim=True)
    return quat_conjugate(q) / torch.clamp(n2, min=1e-20)


def quat_rotate(q, v):
    """Rotate vector(s) ``v`` by unit quaternion(s) ``q`` — q·(0,v)·q*."""
    p = torch.cat([torch.zeros(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device), v],
                  dim=-1)
    return quat_mul(quat_mul(q, p), quat_conjugate(q))[..., 1:4]


def quat_between(v_from, v_to, device=None):
    """Quaternion rotating ``v_from`` onto ``v_to``
    (quaternion.h:201-207 rotation(from,to): axis=cross, angle=angle)."""
    like = _first_tensor(v_from, v_to)
    f = vm.normalize(_f32(v_from, like, device))
    t = vm.normalize(_f32(v_to, f))
    axis = vm.cross(f, t)
    # Parallel vectors → zero cross; fall back to any perpendicular axis.
    deg = vm.length(axis) < 1e-8
    alt = vm.cross(f, torch.broadcast_to(_vec([1.0, 0.0, 0.0], f), f.shape))
    alt2 = vm.cross(f, torch.broadcast_to(_vec([0.0, 1.0, 0.0], f), f.shape))
    alt = torch.where((vm.length(alt) < 1e-8)[..., None], alt2, alt)
    axis = torch.where(deg[..., None], alt, axis)
    cosang = torch.clamp(vm.dot(f, t), -1.0, 1.0)
    return quat_from_axis_angle(axis, torch.arccos(cosang))


def quat_to_matrix3(q):
    """Row-major 3×3 rotation matrix (quaternion.cpp:26-41 to_matrix)."""
    w, x, y, z = q.unbind(-1)
    x2, y2, z2 = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    rows = [
        [1 - 2 * (y2 + z2), 2 * (xy - wz), 2 * (xz + wy)],
        [2 * (xy + wz), 1 - 2 * (x2 + z2), 2 * (yz - wx)],
        [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (x2 + y2)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _arc_weights(d, frac):
    """Great-arc weights ``(wa, wb)`` at cosine ``d``; straight where the
    arc is degenerate."""
    theta = torch.arccos(torch.clamp(d, -1.0, 1.0))
    sin_t = torch.sin(theta)
    straight = sin_t < 1e-6
    safe = torch.where(straight, 1.0, sin_t)
    wa = torch.where(straight, 1.0 - frac, torch.sin((1.0 - frac) * theta) / safe)
    wb = torch.where(straight, frac, torch.sin(frac * theta) / safe)
    return wa, wb


def quat_slerp(a, b, frac):
    """Spherical interpolation between unit quaternions (shortest arc)."""
    frac = _f32(frac, a)
    d = (a * b).sum(dim=-1)
    b = torch.where(d[..., None] < 0, -b, b)
    wa, wb = _arc_weights(torch.abs(d), frac)
    return quat_normalize(a * wa[..., None] + b * wb[..., None])


# ---------------------------------------------------------------------------
# Interpolation toolkit (reference math/interpolate.h)


def lerp(a, b, frac):
    """interpolate.h:43-57 — works for scalars and [...,K] alike."""
    return a + (b - a) * frac


def slerp(a, b, frac, device=None):
    """Great-arc interpolation of direction vectors (textbook form; see the
    module docstring for why interpolate.h:60-117 is not transliterated)."""
    a = _f32(a, _first_tensor(b, frac), device)
    b = _f32(b, a)
    frac = _f32(frac, a)
    la, lb = vm.length(a), vm.length(b)
    an, bn = vm.normalize(a), vm.normalize(b)
    wa, wb = _arc_weights(vm.dot(an, bn), frac)
    out = an * wa[..., None] + bn * wb[..., None]
    return vm.normalize(out) * lerp(la, lb, frac)[..., None]


def color_lerp(p0, c0, p1, c1, p2, c2, pos, device=None):
    """Barycentric color interpolation inside a triangle; black outside
    (interpolate.h:121-145).  All arguments broadcast over leading axes."""
    like = _first_tensor(p0, c0, p1, c1, p2, c2, pos)
    p0, c0, p1, c1, p2, c2, pos = (_f32(x, like, device) for x in (p0, c0, p1, c1, p2, c2, pos))
    e0, e1, ep = p1 - p0, p2 - p0, pos - p0
    d00, d01, d11 = vm.dot(e0, e0), vm.dot(e0, e1), vm.dot(e1, e1)
    d20, d21 = vm.dot(ep, e0), vm.dot(ep, e1)
    denom = d00 * d11 - d01 * d01
    safe = torch.where(torch.abs(denom) > 1e-20, denom, 1.0)
    u = (d11 * d20 - d01 * d21) / safe
    v = (d00 * d21 - d01 * d20) / safe
    inside = (u >= 0) & (v >= 0) & (u + v <= 1) & (torch.abs(denom) > 1e-20)
    color = c0 + (c1 - c0) * u[..., None] + (c2 - c0) * v[..., None]
    return torch.where(inside[..., None], color, 0.0)


def ease_in(a, b, frac):
    """Quadratic ease-in (interpolate.h:147-169)."""
    return (b - a) * (frac * frac) + a


def ease_over(a, b, frac, device=None):
    """Overshooting cosine ease (interpolate.h:171-199): travels past ``b``
    by 25% of a half period before settling."""
    trav = 1.25 * vm.PI
    sent = 1.0 / (1.0 - math.cos(trav))
    frac = _f32(frac, _first_tensor(a, b), device)
    return a + (b - a) * (sent * (1.0 - torch.cos(trav * frac)))


# ---------------------------------------------------------------------------
# Bezier curves and paths (reference math/curve.{h,cpp}): control points a
# [K,3] tensor (K ∈ {2,3,4}), ``t`` any shape — one evaluation gives the
# whole batch of samples.


def eval_bezier(control, t, device=None):
    """de Casteljau over ``control [K,3]`` at ``t [...]`` → ``[...,3]``.

    K=2/3/4 match evaluate_linear/quadratic/cubic_bezier (curve.cpp:5-52);
    t is clamped to [0,1] like curve::evaluate (curve.cpp:74-75).
    """
    control = _f32(control, _first_tensor(t), device)
    k = control.shape[0]
    if k < 2 or k > 4:
        raise ValueError("bezier curves take 2-4 control points (reference curve.h:41-44)")
    t = torch.clamp(_f32(t, control), 0.0, 1.0)[..., None]
    pts = [torch.broadcast_to(c, t.shape[:-1] + (3,)) for c in control]
    while len(pts) > 1:
        pts = [a * (1.0 - t) + b * t for a, b in zip(pts[:-1], pts[1:])]
    return pts[0]


def eval_path(curves, t, device=None):
    """Evaluate a multi-curve path at global ``t ∈ [0,1]`` (curve.h:94-110):
    ``curves`` is a list of [K,3] control arrays, and t splits into equal
    buckets, one a curve, exactly like path::evaluate."""
    n = len(curves)
    if n == 0:
        raise ValueError("empty path")
    t = torch.clamp(_f32(t, _first_tensor(*curves), device), 0.0, 1.0)
    scaled = torch.clamp(t * n, max=n - 1e-6)
    idx = scaled.to(torch.int64)
    local = scaled - idx.to(torch.float32)
    outs = torch.stack([eval_bezier(_f32(c, t), local) for c in curves], dim=0)
    pick = torch.broadcast_to(idx[None, ..., None], (1,) + outs.shape[1:])
    return torch.gather(outs, 0, pick)[0]


# ---------------------------------------------------------------------------
# Statistics (reference math/statistics.{h,cpp}; population normalization)


def mean(x, axis=0, device=None):
    return _f32(x, device=device).mean(dim=axis)


def variance(x, axis=0, device=None):
    """Population variance, ÷count (statistics.cpp compute_variance)."""
    x = _f32(x, device=device)
    m = x.mean(dim=axis, keepdim=True)
    return ((x - m) ** 2).mean(dim=axis)


def deviation(x, axis=0, device=None):
    return torch.sqrt(variance(x, axis=axis, device=device))


def covariance(a, b, axis=0, device=None):
    """Component-wise population covariance (statistics.cpp)."""
    a = _f32(a, _first_tensor(b), device)
    b = _f32(b, a)
    ma = a.mean(dim=axis, keepdim=True)
    mb = b.mean(dim=axis, keepdim=True)
    return ((a - ma) * (b - mb)).mean(dim=axis)


def linear_squares(points, device=None):
    """Least-squares line through 2-D ``points [N,2]`` → ``(start, end)``,
    the segment spanning [min x, max x] on the fitted line: the shape of
    regression.cpp:6-105's output (see the module docstring for the
    normal-equation fix)."""
    p = _f32(points, device=device)
    x, y = p[..., 0], p[..., 1]
    n = float(p.shape[-2])
    sx, sy = x.sum(dim=-1), y.sum(dim=-1)
    sxx, sxy = (x * x).sum(dim=-1), (x * y).sum(dim=-1)
    det = sxx * n - sx * sx
    safe = torch.where(torch.abs(det) > 1e-12, det, 1.0)
    m = (sxy * n - sx * sy) / safe
    b = (sxx * sy - sx * sxy) / safe
    x0, x1 = x.amin(dim=-1), x.amax(dim=-1)
    return torch.stack([x0, m * x0 + b], dim=-1), torch.stack([x1, m * x1 + b], dim=-1)


# ---------------------------------------------------------------------------
# Polynomial solvers (reference math/solver.h), branch-free and batched:
# roots come back as a fixed-width tensor + count, NaN-free for any input.


def solve_quadratic(a, b, c, device=None):
    """Real roots of at²+bt+c → ``(roots[...,2], count[...])``
    (solver.h:48-84; root order matches: (-b+√D)/2a first)."""
    like = _first_tensor(a, b, c)
    a, b, c = (_f32(x, like, device) for x in (a, b, c))
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    inv2a = 1.0 / torch.where(torch.abs(a) > 1e-30, 2.0 * a, 1.0)
    r0 = (-b + sq) * inv2a
    r1 = (-b - sq) * inv2a
    count = torch.where(disc > 0, 2, torch.where(disc == 0, 1, 0))
    roots = torch.stack([r0, torch.where(count == 2, r1, 0.0)], dim=-1)
    return torch.where(count[..., None] > 0, roots, 0.0), count


def solve_cubic(e, a, b, c, device=None):
    """Real roots of et³+at²+bt+c → ``(roots[...,3], count[...])``.

    Trigonometric/Cardano closed form following solver.h:146-216: one root
    when the discriminant d<0, three (with multiplicity) otherwise.
    """
    like = _first_tensor(e, a, b, c)
    e = _f32(e, like, device)
    a, b, c = (_f32(x, e) / e for x in (a, b, c))
    p = (-1.0 / 3.0) * a * a + b
    q = (2.0 / 27.0) * a * a * a - (1.0 / 3.0) * a * b + c
    d = -4.0 * p * p * p - 27.0 * q * q
    d_pr, p_pr, q_pr = -d / 108.0, p / 3.0, q / 2.0
    sq = torch.sqrt(torch.clamp(d_pr, min=0.0))

    def cbrt(v):
        return torch.sign(v) * torch.abs(v) ** (1.0 / 3.0)

    one = (cbrt(-q_pr + sq) + cbrt(-q_pr - sq)) - a / 3.0

    # d >= 0 → three real roots by the trig form (solver.h:182-215).
    pp = torch.clamp(-p_pr, min=1e-30)
    # pp³ underflows f32 for tiny pp (a triple root has p=q=0); the clamped
    # denominator keeps 0/0 out while amp≈0 still collapses all three trig
    # roots onto -a/3, the multiplicity-3 root.
    denom = torch.sqrt(torch.clamp(pp * pp * pp, min=1e-30))
    theta = torch.arccos(torch.clamp(-q_pr / denom, -1.0, 1.0)) / 3.0
    amp = 2.0 * torch.sqrt(pp)
    t0 = amp * torch.cos(theta) - a / 3.0
    t1 = amp * torch.cos(theta + 2.0 * vm.PI / 3.0) - a / 3.0
    t2 = amp * torch.cos(theta - 2.0 * vm.PI / 3.0) - a / 3.0
    three = d >= 0
    roots = torch.stack([torch.where(three, t0, one), torch.where(three, t1, 0.0),
                         torch.where(three, t2, 0.0)], dim=-1)
    return roots, torch.where(three, 3, 1)


# ---------------------------------------------------------------------------
# Byte hashing (reference math/hash.h:40-51) — a host-side scene/asset util.


def hash_bytes(data) -> int:
    """Modified-Bernstein hash, bit-exact with hash.h:40-51 (uint32 wrap)."""
    h = 5381
    for c in bytes(data):
        h = ((h << 5) + h + (h << 16) * c * c) & 0xFFFFFFFF
    return h


# ---------------------------------------------------------------------------
# 4×4 matrix helpers (reference math/matrix4.h): row-major [...,4,4] acting
# on column vectors (the reference stores column-major GL-style
# m[col*4+row] and multiplies M·v).


def mat4_identity(device=None):
    return torch.eye(4, dtype=torch.float32, device=resolve_device(device))


def mat4_translation(t, device=None):
    t = _f32(t, device=device)
    m = torch.eye(4, dtype=torch.float32, device=t.device)
    m[:3, 3] = t
    return m


def mat4_scale(s, device=None):
    s = _f32(s, device=device)
    return torch.diag(torch.cat([s, torch.ones(1, dtype=torch.float32, device=s.device)]))


def mat4_rotation(axis, angle, device=None):
    """Axis-angle rotation (matrix4.h rotation; the same Rodrigues terms as
    vecmath.rotate)."""
    r3 = quat_to_matrix3(quat_from_axis_angle(axis, angle, device=device))
    m = torch.eye(4, dtype=torch.float32, device=r3.device)
    m[:3, :3] = r3
    return m


def mat4_perspective(fov_y, aspect, z_near, z_far, device=None):
    """D3D-style projection with fovx=fovy·aspect (matrix4.h:422-438)."""
    fov_x = fov_y * aspect
    clip = z_far / (z_far - z_near)
    m = torch.zeros((4, 4), dtype=torch.float32, device=resolve_device(device))
    m[0, 0] = 1.0 / np.tan(fov_x * 0.5)
    m[1, 1] = 1.0 / np.tan(fov_y * 0.5)
    m[2, 2] = clip
    m[2, 3] = -clip * z_near
    m[3, 2] = 1.0
    return m


def mat4_look_at(origin, target, up=(0.0, 1.0, 0.0), device=None):
    """Camera-to-world orientation at ``origin`` facing ``target``
    (matrix4.h:455-466: right = up×view, up' = view×right)."""
    origin = _f32(origin, _first_tensor(target, up), device)
    view = vm.normalize(_f32(target, origin) - origin)
    right = vm.normalize(vm.cross(_f32(up, origin), view))
    new_up = vm.normalize(vm.cross(view, right))
    m = torch.eye(4, dtype=torch.float32, device=origin.device)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, new_up, view, origin
    return m


def mat4_inverse(m):
    return torch.linalg.inv(m)


def transform_points(m, pts):
    """Apply ``m [4,4]`` to ``pts [...,3]`` with w-divide."""
    pts = _f32(pts, m)
    homo = torch.cat([pts, torch.ones(pts.shape[:-1] + (1,), dtype=torch.float32,
                                      device=pts.device)], dim=-1)
    out = homo @ m.T
    return out[..., :3] / out[..., 3:4]


def transform_dirs(m, dirs):
    """Apply the linear part of ``m`` to direction vectors."""
    return _f32(dirs, m) @ m[:3, :3].T
