"""Batched 3-vector math over torch tensors.

Port of fspt_tpu/utils/vecmath.py (reference math/vector3.h, plane.h,
normal.h): the ``[..., 3]`` helpers and the component-planar (``_p``)
variants the slice uses, term for term so both packages round alike.
"""

from __future__ import annotations

import torch

PI = 3.14159262  # reference math/base.h:80
EPSILON = 1.0e-5  # reference math/base.h:83


def dot(a, b):
    return (a * b).sum(dim=-1)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def length(v):
    return torch.sqrt(dot(v, v))


def normalize(v):
    """Normalize; zero vectors map to zero (guards the reference's 0/0)."""
    n2 = dot(v, v)
    pos = n2 > 0.0
    inv = torch.where(pos, torch.reciprocal(torch.sqrt(torch.where(pos, n2, 1.0))), 0.0)
    return v * inv[..., None]


def make_plane(normal, point):
    """Plane (a,b,c,d) through ``point`` with ``normal``; plane.h:68-102."""
    d = -dot(normal, point)
    return torch.cat([normal, d[..., None]], dim=-1)


def rotate(v, angle, axis):
    """Rodrigues rotation of ``v`` [..., 3] by ``angle`` (radians) about the
    unit ``axis`` [..., 3]; reference vector3.h:315-333, term for term
    (:func:`rotate_p`'s arithmetic)."""
    angle = torch.as_tensor(angle, dtype=v.dtype, device=v.device)
    out = rotate_p(v[..., 0], v[..., 1], v[..., 2], angle,
                   axis[..., 0], axis[..., 1], axis[..., 2])
    return torch.stack(out, dim=-1)


def sphere_map_texcoords(normal):
    """Spherical environment texcoords; reference intersect.cpp:779-784."""
    u = torch.atan2(normal[..., 0], normal[..., 2]) / (2.0 * PI) + 0.5
    v = normal[..., 1] * 0.5 + 0.5
    return torch.stack([u, 1.0 - v], dim=-1)


def planar_map_texcoords(point, normal):
    """Dominant-axis planar projection; reference intersect.cpp:769-777
    (signed components compared with strict ``>``, as the reference)."""
    n0, n1, n2 = normal[..., 0], normal[..., 1], normal[..., 2]
    p0, p1, p2 = point[..., 0], point[..., 1], point[..., 2]
    use_x = (n0 > n1) & (n0 > n2)
    use_y = (n1 > n0) & (n1 > n2) & ~use_x
    u = torch.where(use_x, p1, p0)
    v = torch.where(use_x, p2, torch.where(use_y, p2, p1))
    return torch.stack([u, v], dim=-1)


# --- component-planar variants ---------------------------------------------


def dot_p(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def normalize_p(vx, vy, vz):
    """Planar :func:`normalize`: zero vectors map to zero."""
    n2 = vx * vx + vy * vy + vz * vz
    pos = n2 > 0.0
    inv = torch.where(pos, torch.reciprocal(torch.sqrt(torch.where(pos, n2, 1.0))), 0.0)
    return vx * inv, vy * inv, vz * inv


def reflect_p(vx, vy, vz, nx, ny, nz):
    d2 = 2.0 * (nx * vx + ny * vy + nz * vz)
    return vx - nx * d2, vy - ny * d2, vz - nz * d2


def refract_p(vx, vy, vz, nx, ny, nz, index):
    """Planar refraction (vector3.h:205-214); TIR → zero vector."""
    n_dot_v = -(vx * nx + vy * ny + vz * nz)
    sin2 = (index * index) * (1.0 - n_dot_v * n_dot_v)
    k = index * n_dot_v - torch.sqrt(torch.clamp(1.0 - sin2, min=1e-12))
    rx, ry, rz = vx * index + nx * k, vy * index + ny * k, vz * index + nz * k
    ox, oy, oz = normalize_p(rx, ry, rz)
    tir = sin2 >= 1.0
    return (torch.where(tir, 0.0, ox), torch.where(tir, 0.0, oy),
            torch.where(tir, 0.0, oz))


def rotate_p(vx, vy, vz, angle, ax, ay, az):
    """Planar Rodrigues rotation (vector3.h:315-333)."""
    c = torch.cos(angle)
    s = torch.sin(angle)
    ic = 1.0 - c
    ox = (c + ic * ax * ax) * vx + (ic * ax * ay - az * s) * vy + (ic * ax * az + ay * s) * vz
    oy = (ic * ax * ay + az * s) * vx + (c + ic * ay * ay) * vy + (ic * ay * az - ax * s) * vz
    oz = (ic * ax * az - ay * s) * vx + (ic * ay * az + ax * s) * vy + (c + ic * az * az) * vz
    return ox, oy, oz


def uniform_sphere_dir_p(u1, u2):
    """Uniform direction on the unit sphere (area-preserving map)."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = (2.0 * PI) * u2
    return r * torch.cos(phi), r * torch.sin(phi), z


def sphere_map_texcoords_p(nx, ny, nz):
    u = torch.atan2(nx, nz) / (2.0 * PI) + 0.5
    v = ny * 0.5 + 0.5
    return u, 1.0 - v
