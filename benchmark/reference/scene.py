"""The reference's own scene tables, worked out from the configuration.

A scene description is plain data: named materials, an optional sky, a
camera and a list of primitives in the ``.scene`` grammar's words (quads by
position and edge vectors, spheres, cuboids with an optional rotation).
:func:`parse_scene_file` reads that grammar's subset from a ``.scene`` file;
:func:`build` turns a description into the rows :mod:`pathtrace` walks, with
the engine's constructions (QuadObject from edge vectors, a cuboid's six face
planes from its rotated corners) computed here in float64.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from . import pathtrace as pt


def _unit(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


def _plane(normal, point):
    n = np.asarray(normal, np.float64)
    return [*n, -float(np.dot(n, point))]


def _quad(position, u, v):
    """QuadObject(position, u, v) (object.cpp:191-211)."""
    p, u, v = (np.asarray(x, np.float64) for x in (position, u, v))
    return dict(kind="quad", plane=_plane(_unit(np.cross(u, v)), p),
                origin=list(p + 0.5 * u + 0.5 * v), tangent=list(_unit(v)),
                bitangent=list(_unit(u)), half_w=0.5 * float(np.linalg.norm(u)),
                half_h=0.5 * float(np.linalg.norm(v)))


def _cuboid_faces(origin, size, axis=None, angle=0.0):
    """CuboidObject's six face planes (volume.cpp:234-280, 434-445): corners
    of the box, rotated about its centre, then a plane through three
    counter-clockwise corners of each face; each face keeps the four planes
    of the faces not opposite it as its bounds."""
    o = np.asarray(origin, np.float64)
    lo, hi = o - 0.5 * np.asarray(size, np.float64), o + 0.5 * np.asarray(size, np.float64)
    (x0, y0, z0), (x1, y1, z1) = lo, hi
    c = np.array([[x0, y0, z0], [x1, y0, z0], [x1, y0, z1], [x0, y0, z1],
                  [x0, y1, z0], [x1, y1, z0], [x1, y1, z1], [x0, y1, z1]])
    if axis is not None and angle:
        ax, ay, az = _unit(axis)
        co, si = np.cos(angle), np.sin(angle)
        ic = 1.0 - co
        rot = np.array([[co + ic * ax * ax, ic * ax * ay - az * si, ic * ax * az + ay * si],
                        [ic * ax * ay + az * si, co + ic * ay * ay, ic * ay * az - ax * si],
                        [ic * ax * az - ay * si, ic * ay * az + ax * si, co + ic * az * az]])
        centre = c.mean(axis=0)
        c = (c - centre) @ rot.T + centre
    order = [(0, 1, 2), (6, 5, 4), (5, 6, 2), (7, 4, 0), (4, 5, 1), (6, 7, 3)]
    planes = [_plane(_unit(np.cross(c[b] - c[a], c[d] - c[a])), c[a]) for a, b, d in order]
    return [dict(kind="cuboid_face", plane=planes[i],
                 sides=[planes[j] for j in range(6) if j // 2 != i // 2])
            for i in range(6)]


def _family(m: dict) -> tuple:
    """The engine's material factory (scene.cpp:283-303): family and its
    scalar parameter."""
    if any(m.get("emission", (0, 0, 0))):
        return pt.LIGHT, 0.0
    if m.get("roughness", 0.0):
        return pt.CERAMIC, float(m["roughness"])
    metallic = m.get("metallic", 0.0)
    if metallic == 1.0:
        return pt.MIRROR, 0.0
    if metallic:
        return pt.METAL, float(metallic)
    if m.get("brdf", 0):
        raise ValueError("the reference has no glass or liquid materials")
    return pt.DIFFUSE, 0.0


def build(desc: dict, texels: dict | None = None):
    """Scene rows, materials, textures, sky row and camera from a
    description.  ``texels`` maps a material's ``texture`` name to its
    ``[H,W,3]`` float32 texels."""
    names = list(desc["materials"])
    textures, tex_index = [], {}
    materials = []
    for name in names:
        m = desc["materials"][name]
        family, param = _family(m)
        tex_id = -1
        if m.get("texture"):
            key = m["texture"]
            if key not in tex_index:
                tex_index[key] = len(textures)
                textures.append(np.asarray(texels[key], np.float32))
            tex_id = tex_index[key]
        materials.append(dict(family=family, param=param, tex_id=tex_id,
                              tex_scale=float(m.get("texture_scale", 1.0)),
                              diffuse=list(m.get("color", (0.0, 0.0, 0.0))),
                              emissive=list(m.get("emission", (0.0, 0.0, 0.0)))))
    sky = desc.get("sky")
    if sky is None:
        # The implicit black sky light is one more row.
        materials.append(dict(family=pt.LIGHT, param=0.0, tex_id=-1, tex_scale=1.0,
                              diffuse=[0.0, 0.0, 0.0], emissive=[0.0, 0.0, 0.0]))
        sky_row = len(materials) - 1
    else:
        sky_row = names.index(sky)
    by_kind = {"sphere": [], "quad": [], "cuboid": []}
    for prim in desc["primitives"]:
        kind = prim["kind"]
        if kind not in by_kind:
            raise ValueError(f"the reference has no primitive kind {kind!r}")
        mat = names.index(prim["material"])
        if kind == "sphere":
            rows = [dict(kind="sphere", center=list(map(float, prim["position"])),
                         radius=float(prim["radius"]))]
        elif kind == "quad":
            rows = [_quad(prim["position"], prim["u"], prim["v"])]
        else:
            rot = prim.get("rotation")
            rows = _cuboid_faces(prim["position"], (prim["width"], prim["height"],
                                                    prim["depth"]),
                                 None if rot is None else rot[:3],
                                 0.0 if rot is None else rot[3])
        for r in rows:
            r["mat"] = mat
        by_kind[kind].append(rows)
    # The engine's merge order: spheres, planes, discs, quads, cuboids.
    rows = [r for kind in ("sphere", "quad", "cuboid") for rs in by_kind[kind] for r in rs]
    cam = dict(desc["camera"])
    return SimpleNamespace(rows=rows, materials=materials, textures=textures, sky=sky_row,
                           camera=cam)


_VECTORS = {"color": 3, "emission": 3, "position": 3, "target": 3, "u": 3, "v": 3,
            "rotation": 4}
_SCALARS = ("metallic", "roughness", "texture_scale", "brdf", "radius", "width", "height",
            "depth", "fov", "aperture", "focal_depth")


def parse_scene_file(text: str) -> dict:
    """A description from ``.scene`` text (scene.cpp:251-535), for the
    blocks the benchmark's scenes use: ``material``, ``sky``, ``camera``,
    ``quad`` (position and edge vectors), ``sphere`` and ``cuboid``."""
    desc = {"materials": {}, "sky": None, "camera": None, "primitives": []}
    lines = iter(text.splitlines())
    for line in lines:
        words = line.split()
        if not words or words[0].startswith("#"):
            continue
        head = words[0]
        body = {}
        for inner in lines:
            if inner.strip() == "}":
                break
            w = inner.split()
            if not w or w[0] == "{":
                continue
            key = w[0]
            if key in _VECTORS:
                body[key] = [float(x) for x in w[1:1 + _VECTORS[key]]]
            elif key in _SCALARS:
                body[key] = float(w[1])
            elif key in ("material", "texture"):
                body[key] = w[1]
            else:
                raise ValueError(f"unknown key {key!r} in a {head} block")
        if head == "material":
            desc["materials"][words[1]] = body
        elif head == "sky":
            desc["sky"] = body["material"]
        elif head == "camera":
            desc["camera"] = dict(origin=body["position"], target=body["target"],
                                  fov_y=body.get("fov", 45.0),
                                  aperture_size=body.get("aperture", 1.5),
                                  focal_depth=body.get("focal_depth", 80.0))
        elif head in ("quad", "sphere", "cuboid"):
            desc["primitives"].append(dict(kind=head, **body))
        else:
            raise ValueError(f"the reference reads no {head!r} block")
    if desc["camera"] is None:
        raise ValueError("the scene has no camera")
    return desc


def from_config(config: dict, root) -> SimpleNamespace:
    """The reference scene of a benchmark configuration: its inline
    ``reference.scene`` description, or ``reference.scene_file`` (relative to
    the checkout) with ``reference.textures`` added, each texture's texels
    read from its decoded ``.npy`` file."""
    ref = config["reference"]
    if "scene" in ref:
        desc = ref["scene"]
    else:
        desc = parse_scene_file((root / ref["scene_file"]).read_text())
    texels = {}
    for mat, tex in ref.get("textures", {}).items():
        desc["materials"][mat].update(texture=tex["texels"], texture_scale=tex["scale"])
        texels[tex["texels"]] = np.load(root / tex["texels"])
    return build(desc, texels)

