"""Host-side scene construction → device tensors.

Port of fspt_tpu/scene/builder.py (reference scene.h:94-185,
scene.cpp:164-214): the builder accumulates primitives and materials on the
host and ``compile()`` packs them into flat tensors on the device.  Scenes
with 64 or more triangles, which the reference hands to its BVH, are refused
until the port's mesh slice lands.
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


class ScenePack(NamedTuple):
    """Everything the device needs to render: the compiled scene.

    ``bvh``/``tri_shade`` keep the reference's layout; they stay None until
    the mesh slice brings BVH scenes to the port.
    """

    geometry: geom.GeometryPack
    materials: MaterialTable
    textures: TexturePack
    sky_mat: torch.Tensor  # int32 scalar row index of the sky material
    bvh: object = None
    tri_shade: object = None

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
        if not self._textures:
            return TexturePack.empty(device)
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
        """Pack the scene onto ``device`` (``cuda`` unless told otherwise).

        Raises NotImplementedError where the reference would build a BVH:
        ``bvh_threshold`` or more triangles.
        """
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
        if tris is not None and len(tris["v0"]) >= bvh_threshold:
            raise NotImplementedError(
                f"{len(tris['v0'])} triangles need a BVH: BVH scenes come "
                "with the mesh slice of the port")

        pack = geom.pack_geometry(
            self._spheres, self._planes, self._discs, self._quads,
            self._cuboids, tris, dev,
        )
        return ScenePack(
            geometry=pack,
            materials=table,
            textures=self._pack_textures(dev),
            sky_mat=torch.tensor(sky_idx, dtype=torch.int32, device=dev),
        )
