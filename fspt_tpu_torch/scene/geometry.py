"""Flat scene geometry as torch tensors.

Port of fspt_tpu/scene/geometry.py: typed primitive struct-of-arrays
(reference object.h:84-152) built on the host with NumPy, exactly as the
reference builds them (same constructors, same padding rows), then moved to
the device as tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Invalid-collision sentinel; reference math/trace.cpp:18-21.
INVALID_PARAM = 2.0


class GeometryPack(NamedTuple):
    """All scene primitives as padded tensors (each type ≥1 row)."""

    sph_center: torch.Tensor  # [S,3]
    sph_radius: torch.Tensor  # [S]
    sph_mat: torch.Tensor  # [S] int32
    sph_valid: torch.Tensor  # [S] bool

    pln_plane: torch.Tensor  # [P,4]
    pln_mat: torch.Tensor
    pln_valid: torch.Tensor

    dsc_plane: torch.Tensor  # [D,4]
    dsc_origin: torch.Tensor  # [D,3]
    dsc_radius: torch.Tensor  # [D]
    dsc_mat: torch.Tensor
    dsc_valid: torch.Tensor

    qud_plane: torch.Tensor  # [Q,4]
    qud_origin: torch.Tensor  # [Q,3]
    qud_tangent: torch.Tensor  # [Q,3] (unnormalized, reference semantics)
    qud_bitangent: torch.Tensor  # [Q,3]
    qud_half_w: torch.Tensor  # [Q]
    qud_half_h: torch.Tensor  # [Q]
    qud_mat: torch.Tensor
    qud_valid: torch.Tensor

    cub_planes: torch.Tensor  # [C,6,4]
    cub_mat: torch.Tensor
    cub_valid: torch.Tensor

    tri_v0: torch.Tensor  # [T,3]
    tri_e1: torch.Tensor  # [T,3] v1-v0
    tri_e2: torch.Tensor  # [T,3] v2-v0
    tri_ng: torch.Tensor  # [T,3] unit geometric normal
    tri_area2: torch.Tensor  # [T] |e1×e2| for the parallel-ray epsilon
    tri_n0: torch.Tensor  # [T,3] shading normals
    tri_n1: torch.Tensor
    tri_n2: torch.Tensor
    tri_t0: torch.Tensor  # [T,2] vertex texcoords
    tri_t1: torch.Tensor
    tri_t2: torch.Tensor
    tri_mat: torch.Tensor  # [T] int32
    tri_valid: torch.Tensor  # [T] bool


# ---------------------------------------------------------------------------
# Host-side (NumPy) constructors, identical to the reference's


def _normalize(v):
    n = np.linalg.norm(v)
    return v / n if n > 0 else v * 0.0


def make_plane(normal, point):
    normal = np.asarray(normal, np.float32)
    point = np.asarray(point, np.float32)
    return np.concatenate([normal, [-float(np.dot(normal, point))]]).astype(np.float32)


def plane_from_points(a, b, c):
    """calculate_plane over three CCW points (reference math/plane.h)."""
    a, b, c = (np.asarray(p, np.float32) for p in (a, b, c))
    n = _normalize(np.cross(b - a, c - a))
    return make_plane(n, a)


def quad_from_normal(origin, normal, width, height):
    """QuadObject(origin, normal, w, h); reference object.cpp:167-189."""
    origin = np.asarray(origin, np.float32)
    normalized = _normalize(np.asarray(normal, np.float32))
    up = np.array([0.0, 1.0, 0.0], np.float32)
    bitangent = np.cross(normalized, up)  # NOT normalized (reference quirk)
    tangent = np.cross(normalized, bitangent)
    return dict(
        plane=make_plane(normalized, origin),
        origin=origin,
        tangent=tangent.astype(np.float32),
        bitangent=bitangent.astype(np.float32),
        half_w=np.float32(width * 0.5),
        half_h=np.float32(height * 0.5),
    )


def quad_from_uv(position, u, v):
    """QuadObject(position, u, v); reference object.cpp:191-211."""
    position = np.asarray(position, np.float32)
    u = np.asarray(u, np.float32)
    v = np.asarray(v, np.float32)
    normal = _normalize(np.cross(u, v))
    origin = position + u * 0.5 + v * 0.5
    return dict(
        plane=make_plane(normal, position),
        origin=origin.astype(np.float32),
        tangent=_normalize(v).astype(np.float32),
        bitangent=_normalize(u).astype(np.float32),
        half_w=np.float32(np.linalg.norm(u) * 0.5),
        half_h=np.float32(np.linalg.norm(v) * 0.5),
    )


def _cube_vertices(vmin, vmax):
    """Vertex ordering of cube::operator=(bounds); volume.cpp:262-280."""
    (x0, y0, z0), (x1, y1, z1) = vmin, vmax
    return np.array(
        [
            [x0, y0, z0], [x1, y0, z0], [x1, y0, z1], [x0, y0, z1],
            [x0, y1, z0], [x1, y1, z0], [x1, y1, z1], [x0, y1, z1],
        ],
        np.float32,
    )


def _cube_planes(v):
    """Face planes of a (possibly rotated) cube; volume.cpp:234-247."""
    return np.stack(
        [
            plane_from_points(v[0], v[1], v[2]),  # bottom
            plane_from_points(v[6], v[5], v[4]),  # top
            plane_from_points(v[5], v[6], v[2]),  # right
            plane_from_points(v[7], v[4], v[0]),  # left
            plane_from_points(v[4], v[5], v[1]),  # front
            plane_from_points(v[6], v[7], v[3]),  # back
        ]
    )


def _rotate_about_axis(points, angle, axis):
    axis = _normalize(np.asarray(axis, np.float32))
    c, s = np.cos(angle), np.sin(angle)
    ic = 1.0 - c
    ax, ay, az = axis
    rot = np.array(
        [
            [c + ic * ax * ax, ic * ax * ay - az * s, ic * ax * az + ay * s],
            [ic * ax * ay + az * s, c + ic * ay * ay, ic * ay * az - ax * s],
            [ic * ax * az - ay * s, ic * ay * az + ax * s, c + ic * az * az],
        ],
        np.float32,
    )
    return points @ rot.T


def cuboid_planes(origin, width, height, depth, rot_axis=None, rot_angle=0.0):
    """CuboidObject + optional Rotate; object.cpp:115-124, volume.cpp:434-445."""
    origin = np.asarray(origin, np.float32)
    half = np.array([width, height, depth], np.float32) * 0.5
    verts = _cube_vertices(origin - half, origin + half)
    if rot_axis is not None and rot_angle:
        center = verts.mean(axis=0)
        verts = _rotate_about_axis(verts - center, rot_angle, rot_axis) + center
    return _cube_planes(verts)


# ---------------------------------------------------------------------------
# Packing


def _pad_rows(rows, pad_row):
    rows = list(rows)
    n = max(1, len(rows))
    valid = np.zeros(n, bool)
    valid[: len(rows)] = True
    while len(rows) < n:
        rows.append(pad_row)
    return np.asarray(rows, np.float32), valid


def pack_geometry(spheres, planes, discs, quads, cuboids, triangles,
                  device) -> GeometryPack:
    """Pack host-side primitive dicts into the SoA pack on ``device``.

    ``triangles`` is a dict of arrays (v0, v1, v2, n0..n2, t0..t2, mat) or
    None.  Padding rows and dtypes (float32, int32 materials, bool masks)
    are the reference's.
    """
    sph, sph_valid = _pad_rows(
        [list(s["center"]) + [s["radius"], s["mat"]] for s in spheres],
        [0, 0, 0, -1, 0],
    )
    pln, pln_valid = _pad_rows(
        [list(p["plane"]) + [p["mat"]] for p in planes], [0, 1, 0, 1e9, 0]
    )
    dsc, dsc_valid = _pad_rows(
        [list(d["plane"]) + list(d["origin"]) + [d["radius"], d["mat"]] for d in discs],
        [0, 1, 0, 1e9, 0, 0, 0, -1, 0],
    )
    qud, qud_valid = _pad_rows(
        [
            list(q["plane"]) + list(q["origin"]) + list(q["tangent"])
            + list(q["bitangent"]) + [q["half_w"], q["half_h"], q["mat"]]
            for q in quads
        ],
        [0, 1, 0, 1e9] + [0] * 9 + [-1, -1, 0],
    )
    if cuboids:
        cub_planes = np.stack([c["planes"] for c in cuboids]).astype(np.float32)
        cub_mat = np.array([c["mat"] for c in cuboids], np.int32)
        cub_valid = np.ones(len(cuboids), bool)
    else:
        cub_planes = np.zeros((1, 6, 4), np.float32)
        cub_planes[:, :, 3] = 1e9
        cub_mat = np.zeros(1, np.int32)
        cub_valid = np.zeros(1, bool)

    if triangles is not None and len(triangles["v0"]):
        v0 = np.asarray(triangles["v0"], np.float32)
        v1 = np.asarray(triangles["v1"], np.float32)
        v2 = np.asarray(triangles["v2"], np.float32)
        e1, e2 = v1 - v0, v2 - v0
        cr = np.cross(e1, e2)
        area2 = np.linalg.norm(cr, axis=-1)
        ng = cr / np.where(area2 > 0, area2, 1.0)[:, None]
        n0 = np.asarray(triangles.get("n0", ng), np.float32)
        n1 = np.asarray(triangles.get("n1", ng), np.float32)
        n2 = np.asarray(triangles.get("n2", ng), np.float32)
        t0 = np.asarray(triangles.get("t0", np.zeros((len(v0), 2))), np.float32)
        t1 = np.asarray(triangles.get("t1", np.zeros((len(v0), 2))), np.float32)
        t2 = np.asarray(triangles.get("t2", np.zeros((len(v0), 2))), np.float32)
        tri_mat = np.asarray(triangles["mat"], np.int32)
        tri_valid = np.ones(len(v0), bool)
    else:
        v0 = np.zeros((1, 3), np.float32)
        e1 = np.array([[1.0, 0, 0]], np.float32)
        e2 = np.array([[0, 1.0, 0]], np.float32)
        ng = np.array([[0, 0, 1.0]], np.float32)
        area2 = np.ones(1, np.float32)
        n0 = n1 = n2 = ng
        t0 = t1 = t2 = np.zeros((1, 2), np.float32)
        tri_mat = np.zeros(1, np.int32)
        tri_valid = np.zeros(1, bool)

    def mats(items):
        return (np.array([x["mat"] for x in items], np.int32) if items
                else np.zeros(1, np.int32))

    f32 = lambda x: np.asarray(x, np.float32)
    fields = dict(
        sph_center=f32(sph[:, :3]), sph_radius=f32(sph[:, 3]),
        sph_mat=mats(spheres), sph_valid=sph_valid,
        pln_plane=f32(pln[:, :4]), pln_mat=mats(planes), pln_valid=pln_valid,
        dsc_plane=f32(dsc[:, :4]), dsc_origin=f32(dsc[:, 4:7]),
        dsc_radius=f32(dsc[:, 7]), dsc_mat=mats(discs), dsc_valid=dsc_valid,
        qud_plane=f32(qud[:, :4]), qud_origin=f32(qud[:, 4:7]),
        qud_tangent=f32(qud[:, 7:10]), qud_bitangent=f32(qud[:, 10:13]),
        qud_half_w=f32(qud[:, 13]), qud_half_h=f32(qud[:, 14]),
        qud_mat=mats(quads), qud_valid=qud_valid,
        cub_planes=cub_planes, cub_mat=cub_mat, cub_valid=cub_valid,
        tri_v0=f32(v0), tri_e1=f32(e1), tri_e2=f32(e2), tri_ng=f32(ng),
        tri_area2=f32(area2), tri_n0=n0, tri_n1=n1, tri_n2=n2,
        tri_t0=t0, tri_t1=t1, tri_t2=t2, tri_mat=tri_mat, tri_valid=tri_valid,
    )
    return GeometryPack(**{name: torch.from_numpy(np.array(fields[name])).to(device)
                           for name in GeometryPack._fields})
