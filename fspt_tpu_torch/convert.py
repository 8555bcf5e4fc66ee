"""Carry render state from the JAX package into the port.

The path tracer's counterpart of carrying weights across: a reference
``ScenePack``, ``Camera`` or ``Framebuffer`` whose leaves are NumPy arrays
(or anything ``numpy.asarray`` takes) becomes the port's tensors on
``device``.  Fields are read by name, so the reference's NamedTuples pass
as they are; nothing of the JAX package is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from fspt_tpu_torch.camera import Camera
from fspt_tpu_torch.config import resolve_device
from fspt_tpu_torch.materials import MaterialTable, TexturePack
from fspt_tpu_torch.ops.bvh import FlatBVH
from fspt_tpu_torch.render.framebuffer import Framebuffer
from fspt_tpu_torch.scene.builder import ScenePack, TriShade
from fspt_tpu_torch.scene.geometry import GeometryPack


def _tensors(cls, tree, dev):
    return cls(**{name: torch.from_numpy(np.array(getattr(tree, name))).to(dev)
                  for name in cls._fields})


def scene_from_numpy(tree, device=None) -> ScenePack:
    """A reference ScenePack (NumPy leaves) → the port's ScenePack, its
    BVH and triangle shading attributes included."""
    dev = resolve_device(device)
    bvh = getattr(tree, "bvh", None)
    return ScenePack(
        geometry=_tensors(GeometryPack, tree.geometry, dev),
        materials=_tensors(MaterialTable, tree.materials, dev),
        textures=_tensors(TexturePack, tree.textures, dev),
        sky_mat=torch.tensor(int(np.asarray(tree.sky_mat)), dtype=torch.int32, device=dev),
        bvh=None if bvh is None else _tensors(FlatBVH, bvh, dev),
        tri_shade=None if bvh is None else _tensors(TriShade, tree.tri_shade, dev),
    )


def camera_from_numpy(tree, device=None) -> Camera:
    """A reference Camera (NumPy leaves) → the port's Camera."""
    dev = resolve_device(device)
    return Camera(**{name: torch.from_numpy(
        np.array(getattr(tree, name), np.float32)).to(dev) for name in Camera._fields})


def framebuffer_from_numpy(tree, device=None) -> Framebuffer:
    """A reference Framebuffer (NumPy leaves) → the port's Framebuffer."""
    return _tensors(Framebuffer, tree, resolve_device(device))


def params_from_numpy(params, device=None) -> dict:
    """Recovery parameters ``{field: array}`` (material columns such as
    ``diffuse``/``emissive``, or ``texels``) → float32 tensors on
    ``device``, the form the port's recovery steps take."""
    dev = resolve_device(device)
    return {name: torch.from_numpy(np.array(value, np.float32)).to(dev)
            for name, value in params.items()}
