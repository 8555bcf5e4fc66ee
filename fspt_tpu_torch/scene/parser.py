"""``.scene`` text format parser (the port's copy of fspt_tpu/scene/parser.py).

Grammar- and semantics-compatible with the reference's loader
(reference scene.cpp:251-535): ``#`` comment lines, ``{}`` blocks introduced
by ``material <name>`` / ``sphere`` / ``camera`` / ``sky`` / ``quad`` /
``cuboid`` / ``mesh`` keywords (substring match, scene.cpp:511-526), keyed
fields scanned anywhere in a block line.  The material factory rules are
reproduced exactly (scene.cpp:283-303):

    emission ≠ 0      → LIGHT(emission)
    roughness ≠ 0     → CERAMIC(color, roughness)
    metallic == 1     → MIRROR(color)
    metallic ≠ 0      → METAL(color, metallic)
    brdf == 1         → LIQUID(color, index, reflectivity)
    brdf == 2         → GLASS(color, index, reflectivity, frostiness)
    otherwise         → DIFFUSE(color)
"""

from __future__ import annotations

import os
import re

import numpy as np

from fspt_tpu_torch import materials as M
from fspt_tpu_torch.camera import Camera
from fspt_tpu_torch.materials import MaterialSpec
from fspt_tpu_torch.scene.builder import SceneBuilder
from fspt_tpu_torch.scene.mesh import load_mesh
from fspt_tpu_torch.utils.image import load_texture

_FLOAT = r"[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?"


def _scan(line, key, n=1, conv=float):
    """sscanf-style ' key v...' match anywhere in the line."""
    pat = r"\b" + re.escape(key) + r"\s+" + r"\s+".join([f"({_FLOAT})"] * n)
    m = re.search(pat, line)
    if not m:
        return None
    vals = [conv(g) for g in m.groups()]
    return vals[0] if n == 1 else vals

def _scan_str(line, key):
    m = re.search(r"\b" + re.escape(key) + r"\s+(\S+)", line)
    return m.group(1) if m else None


def _block(lines_iter):
    """Collect lines until one containing '}' (scene.cpp:268)."""
    block = []
    for line in lines_iter:
        if "}" in line:
            break
        block.append(line)
    return block


def load_scene(path: str, builder: SceneBuilder | None = None,
               device=None) -> SceneBuilder:
    """Parse a .scene file into a SceneBuilder (call .compile() after).

    Cameras are created on ``device`` (``cuda`` unless told otherwise).
    """
    b = builder or SceneBuilder()
    base_dir = os.path.dirname(os.path.abspath(path))
    materials: dict[str, int] = {}
    textures: dict[str, int] = {}

    with open(path, "r", errors="replace") as f:
        lines = iter(f.read().splitlines())

    def resolve_asset(name):
        cand = os.path.join(base_dir, name)
        return cand if os.path.exists(cand) else name

    def texture_id(name, scale):
        if name in textures:
            return textures[name]
        tid = b.add_texture(load_texture(resolve_asset(name)))
        textures[name] = tid
        return tid

    for line in lines:
        if line[:1] == "#":
            continue
        mat_name = None
        m = re.search(r"\bmaterial\s+(\S+)", line)
        if m:
            mat_name = m.group(1)
            block = _block(lines)
            color = np.zeros(3)
            emission = np.zeros(3)
            metallic = 0.0
            roughness = 0.0
            index = 1.0
            tex_scale = 1.0
            brdf = 0
            frost = 0.0
            reflectivity = 0.1
            tex_name = None
            for bl in block:
                v = _scan(bl, "color", 3)
                if v is not None:
                    color = np.asarray(v)
                v = _scan(bl, "emission", 3)
                if v is not None:
                    emission = np.asarray(v)
                v = _scan(bl, "metallic")
                if v is not None:
                    metallic = v
                v = _scan(bl, "roughness")
                if v is not None:
                    roughness = v
                v = _scan(bl, "index")
                if v is not None:
                    index = v
                v = _scan(bl, "texture_scale")
                if v is not None:
                    tex_scale = v
                v = _scan(bl, "brdf", conv=lambda s: int(float(s)))
                if v is not None:
                    brdf = v
                v = _scan(bl, "frostiness")
                if v is not None:
                    frost = v
                v = _scan(bl, "reflectivity")
                if v is not None:
                    reflectivity = v
                s = _scan_str(bl, "texture")
                if s is not None and not bl.strip().startswith("texture_scale"):
                    tex_name = s

            # Factory (scene.cpp:283-303).
            if emission.any():
                spec = MaterialSpec(M.LIGHT, emissive=tuple(emission))
            elif roughness:
                spec = MaterialSpec(M.CERAMIC, diffuse=tuple(color), param=roughness)
            elif metallic:
                if metallic == 1.0:
                    spec = MaterialSpec(M.MIRROR, diffuse=tuple(color))
                else:
                    spec = MaterialSpec(M.METAL, diffuse=tuple(color), param=metallic)
            elif brdf == 1:
                spec = MaterialSpec(M.LIQUID, diffuse=tuple(color), ior=index,
                                    reflectivity=reflectivity)
            elif brdf == 2:
                spec = MaterialSpec(M.GLASS, diffuse=tuple(color), ior=index,
                                    reflectivity=reflectivity, frost=frost)
            else:
                spec = MaterialSpec(M.DIFFUSE, diffuse=tuple(color))

            if tex_name and tex_name != "None":
                spec.tex_id = texture_id(tex_name, tex_scale)
                spec.tex_scale = tex_scale
            materials[mat_name] = b.add_material(spec)
            continue

        if "sphere" in line:
            block = _block(lines)
            pos, radius, mat = np.zeros(3), 0.0, None
            for bl in block:
                v = _scan(bl, "position", 3)
                if v is not None:
                    pos = np.asarray(v)
                v = _scan(bl, "radius")
                if v is not None:
                    radius = v
                s = _scan_str(bl, "material")
                if s is not None:
                    mat = s
            b.add_sphere(pos, radius, materials.get(mat, 0))
        elif "camera" in line:
            block = _block(lines)
            cam = dict(position=(0.0, 0.0, -200.0), target=(0.0, 0.0, 0.0),
                       fov=45.0, aperture=1.5, focal_depth=80.0)
            for bl in block:
                v = _scan(bl, "position", 3)
                if v is not None:
                    cam["position"] = v
                v = _scan(bl, "target", 3)
                if v is not None:
                    cam["target"] = v
                for key in ("fov", "aperture", "focal_depth"):
                    v = _scan(bl, key)
                    if v is not None:
                        cam[key] = v
            b.add_camera(Camera.create(
                origin=cam["position"], target=cam["target"], fov_y=cam["fov"],
                aperture_size=cam["aperture"], focal_depth=cam["focal_depth"],
                device=device,
            ))
        elif "sky" in line:
            block = _block(lines)
            for bl in block:
                s = _scan_str(bl, "material")
                if s is not None and s in materials:
                    b.set_sky(materials[s])
        elif "quad" in line:
            block = _block(lines)
            pos, normal, width, height, mat = np.zeros(3), np.zeros(3), 0.0, 0.0, None
            uvec = vvec = None
            for bl in block:
                v = _scan(bl, "position", 3)
                if v is not None:
                    pos = np.asarray(v)
                v = _scan(bl, "normal", 3)
                if v is not None:
                    normal = np.asarray(v)
                v = _scan(bl, "u", 3)
                if v is not None:
                    uvec = np.asarray(v)
                v = _scan(bl, "v", 3)
                if v is not None:
                    vvec = np.asarray(v)
                v = _scan(bl, "width")
                if v is not None:
                    width = v
                v = _scan(bl, "height")
                if v is not None:
                    height = v
                s = _scan_str(bl, "material")
                if s is not None:
                    mat = s
            if uvec is not None and vvec is not None:
                # Grammar extension: edge-vector quads (the reference's
                # second QuadObject ctor, object.cpp:191-211, which its
                # parser never exposed).  Avoids the degenerate tangent
                # frame of axis-aligned normals (object.cpp:176-177).
                b.add_quad_uv(pos, uvec, vvec, materials.get(mat, 0))
            else:
                b.add_quad(pos, normal, width, height, materials.get(mat, 0))
        elif "cuboid" in line:
            block = _block(lines)
            pos, w, h, d, rot, mat = np.zeros(3), 0.0, 0.0, 0.0, np.zeros(4), None
            for bl in block:
                v = _scan(bl, "position", 3)
                if v is not None:
                    pos = np.asarray(v)
                v = _scan(bl, "width")
                if v is not None:
                    w = v
                v = _scan(bl, "height")
                if v is not None:
                    h = v
                v = _scan(bl, "depth")
                if v is not None:
                    d = v
                v = _scan(bl, "rotation", 4)
                if v is not None:
                    rot = np.asarray(v)
                s = _scan_str(bl, "material")
                if s is not None:
                    mat = s
            rot_axis = rot[:3] if rot[3] else None
            b.add_cuboid(pos, w, h, d, materials.get(mat, 0),
                         rot_axis=rot_axis, rot_angle=float(rot[3]))
        elif "mesh" in line:
            block = _block(lines)
            fname, mat = None, None
            trans, scale, rot = np.zeros(3), np.ones(3), np.zeros(4)
            for bl in block:
                s = _scan_str(bl, "file")
                if s is not None:
                    fname = s
                s = _scan_str(bl, "material")
                if s is not None:
                    mat = s
                v = _scan(bl, "translation", 3)
                if v is not None:
                    trans = np.asarray(v)
                v = _scan(bl, "scale", 3)
                if v is not None:
                    scale = np.asarray(v)
                v = _scan(bl, "rotation", 4)
                if v is not None:
                    rot = np.asarray(v)
            if fname:
                tris = load_mesh(resolve_asset(fname), invert_normals=False,
                                 translation=trans, scale=scale, rotation=rot)
                b.add_triangles(mat=materials.get(mat, 0), **tris)

    return b
