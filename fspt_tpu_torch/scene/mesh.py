"""Wavefront OBJ loading → triangle SoA.

The port's copy of fspt_tpu/scene/mesh.py.  :func:`load_mesh` parses with
the native library (utils/native.py, built from csrc/fspt_native.cpp);
:func:`parse_obj` is the Python parser with the same output, which the
tests hold the native one against.  It replaces the vendored
tinyobjloader + MeshObject construction (reference mesh.cpp:167-272):

* polygon faces are fan-triangulated (tinyobj's ``triangulate=true``),
* winding is flipped CW→CCW exactly like mesh.cpp:250-260 (indices 2,1,0),
* vertex normals are normalized, optionally inverted (mesh.cpp:225-237),
* the TRS transform is ``T·R·S`` applied to vertices (mesh.cpp:188-221).
  Note: the reference only populates its vertex array when a transform is
  present — untransformed meshes silently fail to render (mesh.cpp:211-221).
  We fix that rather than reproduce it.
"""

from __future__ import annotations

import numpy as np


def _rotation_matrix(axis, angle):
    axis = np.asarray(axis, np.float64)
    n = np.linalg.norm(axis)
    if n == 0 or angle == 0:
        return np.eye(3)
    axis = axis / n
    c, s = np.cos(angle), np.sin(angle)
    ic = 1.0 - c
    x, y, z = axis
    return np.array(
        [
            [c + ic * x * x, ic * x * y - z * s, ic * x * z + y * s],
            [ic * x * y + z * s, c + ic * y * y, ic * y * z - x * s],
            [ic * x * z - y * s, ic * y * z + x * s, c + ic * z * z],
        ]
    )


def parse_obj(path: str):
    """Parse v/vn/vt/f records; returns dict of vertices/normals/texcoords/faces.

    Faces are triples of (v_idx, vt_idx, vn_idx), fan-triangulated, with
    OBJ's 1-based and negative indices resolved.
    """
    verts, norms, uvs = [], [], []
    faces = []  # each: 3 triples of (vi, ti, ni); -1 = absent
    with open(path, "r", errors="replace") as f:
        for line in f:
            if not line or line[0] == "#":
                continue
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif tag == "vn":
                norms.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif tag == "vt":
                uvs.append([float(parts[1]), float(parts[2]) if len(parts) > 2 else 0.0])
            elif tag == "f":
                corner = []
                for spec in parts[1:]:
                    comps = spec.split("/")
                    vi = int(comps[0])
                    ti = int(comps[1]) if len(comps) > 1 and comps[1] else 0
                    ni = int(comps[2]) if len(comps) > 2 and comps[2] else 0
                    # resolve 1-based / negative indices
                    vi = vi - 1 if vi > 0 else len(verts) + vi
                    ti = ti - 1 if ti > 0 else (len(uvs) + ti if ti else -1)
                    ni = ni - 1 if ni > 0 else (len(norms) + ni if ni else -1)
                    corner.append((vi, ti, ni))
                for k in range(1, len(corner) - 1):  # fan triangulation
                    faces.append([corner[0], corner[k], corner[k + 1]])
    return dict(
        vertices=np.asarray(verts, np.float32).reshape(-1, 3),
        normals=np.asarray(norms, np.float32).reshape(-1, 3),
        texcoords=np.asarray(uvs, np.float32).reshape(-1, 2),
        faces=np.asarray(faces, np.int64).reshape(-1, 3, 3),
    )


def load_mesh(path: str, invert_normals: bool = False, translation=(0, 0, 0),
              scale=(1, 1, 1), rotation=(0, 0, 0, 0)):
    """OBJ → triangle-soup dict for SceneBuilder.add_triangles.

    ``rotation`` is (axis_x, axis_y, axis_z, angle) per the scene grammar
    (scene.cpp:476-477).  Transform order is T·R·S (mesh.cpp:188-217).
    """
    from fspt_tpu_torch.utils import native

    obj = native.parse_obj(path)
    verts = obj["vertices"].astype(np.float64)
    norms = obj["normals"].astype(np.float64)
    uvs = obj["texcoords"]
    faces = obj["faces"]

    sc = np.asarray(scale, np.float64)
    if not np.any(sc):  # scene files may omit scale → (0,0,0) means identity
        sc = np.ones(3)
    rot = _rotation_matrix(rotation[:3], rotation[3])
    verts = (verts * sc) @ rot.T + np.asarray(translation, np.float64)
    if len(norms):
        norms = norms @ rot.T
        ln = np.linalg.norm(norms, axis=-1, keepdims=True)
        norms = norms / np.where(ln > 0, ln, 1.0)
        if invert_normals:
            norms = -norms

    # CW→CCW winding flip (mesh.cpp:250-260): reverse corner order.
    faces = faces[:, ::-1, :]

    vi = faces[:, :, 0]
    v0, v1, v2 = verts[vi[:, 0]], verts[vi[:, 1]], verts[vi[:, 2]]

    out = dict(
        v0=v0.astype(np.float32), v1=v1.astype(np.float32), v2=v2.astype(np.float32)
    )
    ni = faces[:, :, 2]
    if len(norms) and (ni >= 0).all():
        out["n0"] = norms[ni[:, 0]].astype(np.float32)
        out["n1"] = norms[ni[:, 1]].astype(np.float32)
        out["n2"] = norms[ni[:, 2]].astype(np.float32)
    ti = faces[:, :, 1]
    if len(uvs) and (ti >= 0).all():
        out["t0"] = uvs[ti[:, 0]].astype(np.float32)
        out["t1"] = uvs[ti[:, 1]].astype(np.float32)
        out["t2"] = uvs[ti[:, 2]].astype(np.float32)
    return out
