"""Host-side scene construction → device tensors.

Port of fspt_tpu/scene/builder.py (reference scene.h:94-185,
scene.cpp:164-214): the builder accumulates primitives and materials on the
host and ``compile()`` packs them into flat tensors on the device.  Scenes
with ``bvh_threshold`` (64) or more triangles get a flattened BVH
(ops/bvh.py) and per-triangle shading attributes (:class:`TriShade`) in
place of the brute-force triangle rows.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from fspt_tpu_torch import materials as mat_mod
from fspt_tpu_torch.camera import Camera
from fspt_tpu_torch.config import resolve_device
from fspt_tpu_torch.materials import MaterialSpec, MaterialTable, TexturePack
from fspt_tpu_torch.scene import geometry as geom
from fspt_tpu_torch.utils import profiling


class TriShade(NamedTuple):
    """Per-triangle shading attributes, indexed by original triangle id
    (the BVH returns original ids, so these gathers stay stable)."""

    n0: torch.Tensor  # [T,3]
    n1: torch.Tensor
    n2: torch.Tensor
    t0: torch.Tensor  # [T,2]
    t1: torch.Tensor
    t2: torch.Tensor
    mat: torch.Tensor  # [T] int32


class ScenePack(NamedTuple):
    """Everything the device needs to render: the compiled scene.

    ``bvh``/``tri_shade`` are set for triangle-heavy scenes: the triangles
    then live in the flattened BVH (ops/bvh.FlatBVH) instead of the
    brute-force rows of ``geometry``.
    """

    geometry: geom.GeometryPack
    materials: MaterialTable
    textures: TexturePack
    sky_mat: torch.Tensor  # int32 scalar row index of the sky material
    bvh: object = None  # Optional[ops.bvh.FlatBVH]
    tri_shade: object = None  # Optional[TriShade]

    @property
    def device(self) -> torch.device:
        return self.materials.mtype.device


class SceneBuilder:
    """Accumulates primitives/materials host-side; ``compile()`` packs them."""

    def __init__(self):
        self._materials: List[MaterialSpec] = []
        self._spheres = []
        self._planes = []
        self._discs = []
        self._quads = []
        self._cuboids = []
        self._tri_chunks = []
        self._textures = []  # list of np.ndarray [H,W,3] float32
        self.cameras: List[Camera] = []
        # Default sky: black LightMaterial (scene.cpp:142-144).
        self._sky_mat: Optional[int] = None

    # -- materials ---------------------------------------------------------

    def add_material(self, spec: MaterialSpec) -> int:
        self._materials.append(spec)
        return len(self._materials) - 1

    def add_texture(self, image: np.ndarray) -> int:
        """Register an [H,W,3] float32 linear-RGB texture; returns its id."""
        self._textures.append(np.asarray(image, np.float32))
        return len(self._textures) - 1

    def set_sky(self, mat: int):
        self._sky_mat = mat

    # -- primitives (Scene::AddXxxObject, scene.cpp:164-214) ---------------

    def add_sphere(self, center, radius, mat: int):
        self._spheres.append(dict(center=list(map(float, center)), radius=float(radius), mat=mat))

    def add_plane(self, normal, point, mat: int):
        self._planes.append(dict(plane=geom.make_plane(normal, point), mat=mat))

    def add_disc(self, origin, normal, radius, mat: int):
        n = np.asarray(normal, np.float32)
        n = n / max(np.linalg.norm(n), 1e-30)
        self._discs.append(
            dict(plane=geom.make_plane(n, origin), origin=np.asarray(origin, np.float32),
                 radius=float(radius), mat=mat)
        )

    def add_quad(self, origin, normal, width, height, mat: int):
        q = geom.quad_from_normal(origin, normal, width, height)
        q["mat"] = mat
        self._quads.append(q)

    def add_quad_uv(self, position, u, v, mat: int):
        q = geom.quad_from_uv(position, u, v)
        q["mat"] = mat
        self._quads.append(q)

    def add_cuboid(self, origin, width, height, depth, mat: int,
                   rot_axis=None, rot_angle=0.0):
        planes = geom.cuboid_planes(origin, width, height, depth, rot_axis, rot_angle)
        self._cuboids.append(dict(planes=planes, mat=mat))

    def add_triangles(self, v0, v1, v2, mat: int, n0=None, n1=None, n2=None,
                      t0=None, t1=None, t2=None):
        """Add a raw triangle soup chunk (mesh loading builds on this)."""
        n = len(v0)
        chunk = dict(
            v0=np.asarray(v0, np.float32),
            v1=np.asarray(v1, np.float32),
            v2=np.asarray(v2, np.float32),
            mat=np.full(n, mat, np.int32) if np.isscalar(mat) else np.asarray(mat, np.int32),
        )
        for key, val in (("n0", n0), ("n1", n1), ("n2", n2),
                         ("t0", t0), ("t1", t1), ("t2", t2)):
            if val is not None:
                chunk[key] = np.asarray(val, np.float32)
        self._tri_chunks.append(chunk)

    def add_camera(self, camera: Camera):
        self.cameras.append(camera)

    # -- compile -----------------------------------------------------------

    def _pack_textures(self, device) -> TexturePack:
        """The textures as one pack on ``device``, inside the
        ``fspt.textures.pack`` span (a concatenation on the host and one
        copy: 1.61 GB for the benchmark's textured scene)."""
        if not self._textures:
            return TexturePack.empty(device)
        with profiling.span("fspt.textures.pack"):
            offsets, widths, heights, flats = [], [], [], []
            off = 0
            for img in self._textures:
                h, w = img.shape[:2]
                offsets.append(off)
                widths.append(w)
                heights.append(h)
                flats.append(img.reshape(-1, 3))
                off += h * w
            i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=device)
            return TexturePack(
                texels=torch.from_numpy(np.concatenate(flats, axis=0)).to(device),
                offset=i32(offsets), width=i32(widths), height=i32(heights),
            )

    def _merge_triangles(self):
        if not self._tri_chunks:
            return None
        merged = {}
        for k in ["v0", "v1", "v2", "mat"]:
            merged[k] = np.concatenate([c[k] for c in self._tri_chunks], axis=0)
        for k in ["n0", "n1", "n2", "t0", "t1", "t2"]:
            if any(k in c for c in self._tri_chunks):
                parts = []
                for c in self._tri_chunks:
                    if k in c:
                        parts.append(c[k])
                    elif k.startswith("n"):
                        # default to the per-face geometric normal
                        cr = np.cross(c["v1"] - c["v0"], c["v2"] - c["v0"])
                        ln = np.linalg.norm(cr, axis=-1, keepdims=True)
                        parts.append(cr / np.where(ln > 0, ln, 1.0))
                    else:
                        parts.append(np.zeros((len(c["v0"]), 2), np.float32))
                merged[k] = np.concatenate(parts, axis=0)
        return merged

    def compile(self, bvh_threshold: int = 64, device=None) -> ScenePack:
        """Pack the scene onto ``device`` (``cuda`` unless told otherwise);
        ``bvh_threshold`` or more triangles get a BVH."""
        dev = resolve_device(device)
        materials = list(self._materials)
        if self._sky_mat is None:
            # Implicit black sky light (scene.cpp:142-144).
            materials.append(MaterialSpec(mat_mod.LIGHT, emissive=(0.0, 0.0, 0.0)))
            sky_idx = len(materials) - 1
        else:
            sky_idx = self._sky_mat
        table = mat_mod.pack_materials(materials, dev)

        tris = self._merge_triangles()
        bvh = tri_shade = None
        if tris is not None and len(tris["v0"]) >= bvh_threshold:
            from fspt_tpu_torch.ops.bvh import build_bvh

            v0, v1, v2 = (np.asarray(tris[k], np.float32) for k in ("v0", "v1", "v2"))
            bvh = build_bvh(v0, v1, v2, device=dev)
            cr = np.cross(v1 - v0, v2 - v0)
            ln = np.linalg.norm(cr, axis=-1, keepdims=True)
            ng = (cr / np.where(ln > 0, ln, 1.0)).astype(np.float32)
            zeros = np.zeros((len(v0), 2), np.float32)
            f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
            tri_shade = TriShade(
                n0=f32(tris.get("n0", ng)), n1=f32(tris.get("n1", ng)),
                n2=f32(tris.get("n2", ng)), t0=f32(tris.get("t0", zeros)),
                t1=f32(tris.get("t1", zeros)), t2=f32(tris.get("t2", zeros)),
                mat=torch.from_numpy(np.asarray(tris["mat"], np.int32)).to(dev))
            tris = None  # keep the brute-force rows empty

        pack = geom.pack_geometry(
            self._spheres, self._planes, self._discs, self._quads,
            self._cuboids, tris, dev,
        )
        return ScenePack(
            geometry=pack,
            materials=table,
            textures=self._pack_textures(dev),
            sky_mat=torch.tensor(sky_idx, dtype=torch.int32, device=dev),
            bvh=bvh,
            tri_shade=tri_shade,
        )
