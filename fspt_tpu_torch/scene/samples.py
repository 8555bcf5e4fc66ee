"""Sample scenes shared by the port's checks and the parity tests.

Each function fills a builder with one scene.  It takes the builder and the
materials module as arguments, so the same scene can be built by this
package and, in the tests, by the reference package, whose builder API is
the same.  Cameras are added by the caller.

* :func:`flagship` — the Cornell headline scene of the reference's
  ``__graft_entry__._flagship_builder`` (walls, area light, mirror and metal
  spheres, rotated white cuboid).
* :func:`all_primitives` — every primitive kind: sphere, infinite plane,
  disc, quads, rotated cuboid and a few triangles (below the BVH threshold).
* :func:`all_families` — all nine material families in one closed box.
* :func:`textured` — the flagship with a seeded checker texture on two walls
  and a textured sky.
* :func:`textured_flagship` — the flagship with a map of its own on each of
  its six diffuse rows and a textured sky, the maps given by the caller
  (the benchmark's are 4096² and 8192×4096, 1.61 GB).
* ``all_families_textured`` — :func:`all_families` with textured walls, sky,
  lamp, mirror, ceramic and glow rows.
* :func:`write_textured_cornell` — a textured copy of a ``.scene`` file of
  the Cornell box (its red and green walls and its sky textured).
* :func:`heightfield` — the reference's mesh bench scene
  (``bench.py:build_mesh_scene``): a ``2·(grid−1)²``-triangle heightfield
  (99,458 at ``grid=224``), a floor quad, an area light and a sky; its
  camera, with depth of field, is :data:`HEIGHTFIELD_CAMERA`.
* :func:`write_heightfield_scene` — the same scene as a ``.scene`` file and
  an OBJ mesh, for the CLI.

Textures are checkers whose two colours come from a seeded NumPy generator,
so both packages build the same texels; :func:`textured_flagship` takes its
texels from the caller.
"""

from __future__ import annotations

import numpy as np

CAMERA_ORIGIN = (0.0, 0.0, -145.0)


def checker(rng, n=8, cell=2, scale=1.0):
    """An ``[n,n,3]`` checker of two colours drawn from ``rng``."""
    colors = rng.uniform(0.1, 0.9, (2, 3)) * scale
    yy, xx = np.indices((n, n))
    odd = ((xx // cell + yy // cell) % 2)[..., None] == 1
    return np.where(odd, colors[0], colors[1]).astype(np.float32)


def _cornell_walls(b, M, s=50.0, light=(15.0, 15.0, 15.0), wall_tex=None,
                   lamp_tex=-1):
    """The five walls and the area light.  With ``wall_tex``, the back and
    left walls take that texture; ``lamp_tex`` textures the lamp's
    emission."""
    white = b.add_material(M.MaterialSpec(M.DIFFUSE, diffuse=(0.73, 0.73, 0.73)))
    red = b.add_material(M.MaterialSpec(M.DIFFUSE, diffuse=(0.65, 0.05, 0.05)))
    green = b.add_material(M.MaterialSpec(M.DIFFUSE, diffuse=(0.12, 0.45, 0.15)))
    lamp = b.add_material(M.MaterialSpec(M.LIGHT, emissive=light, tex_id=lamp_tex))
    back, left = white, red
    if wall_tex is not None:
        back = b.add_material(M.MaterialSpec(M.DIFFUSE, diffuse=(0.73, 0.73, 0.73),
                                             tex_id=wall_tex, tex_scale=0.02))
        left = b.add_material(M.MaterialSpec(M.DIFFUSE, diffuse=(0.65, 0.05, 0.05),
                                             tex_id=wall_tex, tex_scale=0.05))
    b.add_quad_uv((-s, -s, -s), (2 * s, 0, 0), (0, 0, 2 * s), white)  # floor
    b.add_quad_uv((-s, s, -s), (0, 0, 2 * s), (2 * s, 0, 0), white)  # ceiling
    b.add_quad_uv((-s, -s, s), (2 * s, 0, 0), (0, 2 * s, 0), back)  # back
    b.add_quad_uv((-s, -s, -s), (0, 2 * s, 0), (0, 0, 2 * s), left)  # left
    b.add_quad_uv((s, -s, -s), (0, 0, 2 * s), (0, 2 * s, 0), green)  # right
    b.add_quad_uv((-15.0, s - 0.5, -15.0), (30.0, 0, 0), (0, 0, 30.0), lamp)
    return white, red, green, lamp


def _textured_sky(b, M, rng):
    tex = b.add_texture(checker(rng, n=16, cell=4, scale=0.3))
    b.set_sky(b.add_material(M.MaterialSpec(M.LIGHT, emissive=(0.05, 0.07, 0.10),
                                            tex_id=tex)))


def flagship(b, M, wall_tex=None):
    white, _, _, _ = _cornell_walls(b, M, wall_tex=wall_tex)
    mirror = b.add_material(M.MaterialSpec(M.MIRROR, diffuse=(0.9, 0.9, 0.9)))
    metal = b.add_material(M.MaterialSpec(M.METAL, diffuse=(0.8, 0.6, 0.2), param=0.3))
    b.add_sphere((-22, -35, 8), 15.0, mirror)
    b.add_sphere((22, -38, -6), 12.0, metal)
    b.add_cuboid((0, -42, 18), 16, 16, 16, white, rot_axis=(0, 1, 0), rot_angle=0.5)


#: :func:`textured_flagship`'s maps, in the order it adds them: the floor,
#: the ceiling, the back, left and right walls, the cuboid, then the sky.
TEXTURED_FLAGSHIP_MAPS = ("floor", "ceiling", "back", "left", "right", "cuboid", "sky")
#: Its rows' ``tex_scale``: one map spans a 100-unit wall once (the planar
#: map is in world units) and a 16-unit cuboid face once (its map is ×0.1).
TEXTURED_FLAGSHIP_SCALES = {"wall": 0.01, "cuboid": 0.625}


def textured_flagship(b, M, textures):
    """The flagship (its geometry, lamp, mirror and metal spheres) with a
    map on each diffuse row and on the sky: ``textures`` maps each name of
    :data:`TEXTURED_FLAGSHIP_MAPS` to an ``[H,W,3]`` float32 image.  The
    diffuse rows keep the flagship's colours, which their maps replace;
    the sky is a light row whose sphere-mapped map (×3) replaces its
    emission."""
    tex = {name: b.add_texture(textures[name]) for name in TEXTURED_FLAGSHIP_MAPS}
    wall, cube = TEXTURED_FLAGSHIP_SCALES["wall"], TEXTURED_FLAGSHIP_SCALES["cuboid"]

    def diffuse(name, color, scale):
        return b.add_material(M.MaterialSpec(M.DIFFUSE, diffuse=color, tex_id=tex[name],
                                             tex_scale=scale))

    white, red, green = (0.73, 0.73, 0.73), (0.65, 0.05, 0.05), (0.12, 0.45, 0.15)
    rows = [diffuse(name, color, wall) for name, color in
            (("floor", white), ("ceiling", white), ("back", white), ("left", red),
             ("right", green))]
    lamp = b.add_material(M.MaterialSpec(M.LIGHT, emissive=(15.0, 15.0, 15.0)))
    s = 50.0
    b.add_quad_uv((-s, -s, -s), (2 * s, 0, 0), (0, 0, 2 * s), rows[0])  # floor
    b.add_quad_uv((-s, s, -s), (0, 0, 2 * s), (2 * s, 0, 0), rows[1])  # ceiling
    b.add_quad_uv((-s, -s, s), (2 * s, 0, 0), (0, 2 * s, 0), rows[2])  # back
    b.add_quad_uv((-s, -s, -s), (0, 2 * s, 0), (0, 0, 2 * s), rows[3])  # left
    b.add_quad_uv((s, -s, -s), (0, 0, 2 * s), (0, 2 * s, 0), rows[4])  # right
    b.add_quad_uv((-15.0, s - 0.5, -15.0), (30.0, 0, 0), (0, 0, 30.0), lamp)
    mirror = b.add_material(M.MaterialSpec(M.MIRROR, diffuse=(0.9, 0.9, 0.9)))
    metal = b.add_material(M.MaterialSpec(M.METAL, diffuse=(0.8, 0.6, 0.2), param=0.3))
    b.add_sphere((-22, -35, 8), 15.0, mirror)
    b.add_sphere((22, -38, -6), 12.0, metal)
    b.add_cuboid((0, -42, 18), 16, 16, 16, diffuse("cuboid", white, cube),
                 rot_axis=(0, 1, 0), rot_angle=0.5)
    b.set_sky(b.add_material(M.MaterialSpec(M.LIGHT, emissive=(1.0, 1.0, 1.0),
                                            tex_id=tex["sky"])))


def _octahedron(center, r):
    c = np.asarray(center, np.float32)
    px, nx = c + (r, 0, 0), c - (r, 0, 0)
    py, ny = c + (0, r, 0), c - (0, r, 0)
    pz, nz = c + (0, 0, r), c - (0, 0, r)
    faces = [(px, py, pz), (py, nx, pz), (nx, ny, pz), (ny, px, pz),
             (py, px, nz), (nx, py, nz), (ny, nx, nz), (px, ny, nz)]
    v0, v1, v2 = (np.array([f[k] for f in faces], np.float32) for k in range(3))
    return v0, v1, v2


def all_primitives(b, M):
    white, red, green, _ = _cornell_walls(b, M)
    sky = b.add_material(M.MaterialSpec(M.LIGHT, emissive=(0.05, 0.07, 0.10)))
    b.set_sky(sky)
    blue = b.add_material(M.MaterialSpec(M.DIFFUSE, diffuse=(0.2, 0.3, 0.8)))
    mirror = b.add_material(M.MaterialSpec(M.MIRROR, diffuse=(0.9, 0.9, 0.9)))
    b.add_sphere((-25.0, -32.0, 10.0), 14.0, mirror)
    b.add_plane((0.0, 1.0, 0.0), (0.0, -45.0, 0.0), blue)
    b.add_disc((20.0, -15.0, 35.0), (0.3, 0.2, -1.0), 10.0, red)
    b.add_cuboid((18.0, -36.0, -8.0), 14.0, 18.0, 14.0, green,
                  rot_axis=(0, 1, 0), rot_angle=0.4)
    v0, v1, v2 = _octahedron((0.0, 15.0, 15.0), 12.0)
    n = len(v0)
    t0 = np.tile(np.float32([[0.0, 0.0]]), (n, 1))
    t1 = np.tile(np.float32([[1.0, 0.0]]), (n, 1))
    t2 = np.tile(np.float32([[0.0, 1.0]]), (n, 1))
    b.add_triangles(v0, v1, v2, white, t0=t0, t1=t1, t2=t2)
    # A quad of two triangles with per-vertex normals.
    q = np.float32([[-40, 20, 30], [-20, 20, 30], [-20, 40, 30], [-40, 40, 30]])
    nrm = np.float32([[0, 0, -1]] * 2)
    b.add_triangles(q[[0, 0]], q[[1, 2]], q[[2, 3]], blue, n0=nrm,
                    n1=np.float32([[0.1, 0, -1], [0, 0.1, -1]]), n2=nrm)


def textured(b, M, seed=7):
    rng = np.random.default_rng(seed)
    flagship(b, M, wall_tex=b.add_texture(checker(rng)))
    _textured_sky(b, M, rng)


def all_families(b, M, textured=False, seed=11):
    """All nine families; ``textured`` adds textures to the walls, the sky,
    the lamp (textured emission), the mirror, the ceramic and the glow."""
    rng = np.random.default_rng(seed)
    tex = lamp_tex = None
    if textured:
        tex = b.add_texture(checker(rng))
        lamp_tex = b.add_texture(checker(rng, scale=15.0))
    _cornell_walls(b, M, wall_tex=tex, lamp_tex=-1 if lamp_tex is None else lamp_tex)
    if textured:
        _textured_sky(b, M, rng)
    else:
        b.set_sky(b.add_material(M.MaterialSpec(M.LIGHT, emissive=(0.05, 0.07, 0.10))))
    tex_kw = dict(tex_id=tex, tex_scale=0.1) if textured else {}
    mirror = b.add_material(M.MaterialSpec(M.MIRROR, diffuse=(0.9, 0.9, 0.9), **tex_kw))
    glass = b.add_material(M.MaterialSpec(M.GLASS, diffuse=(0.95, 0.95, 0.95),
                                          ior=0.75, reflectivity=0.1, frost=0.2))
    clear = b.add_material(M.MaterialSpec(M.GLASS, diffuse=(0.9, 0.95, 0.9),
                                          ior=1.5, reflectivity=0.05, frost=0.0))
    liquid = b.add_material(M.MaterialSpec(M.LIQUID, diffuse=(0.8, 0.9, 1.0),
                                           ior=0.8, reflectivity=0.2))
    metal = b.add_material(M.MaterialSpec(M.METAL, diffuse=(0.8, 0.6, 0.2), param=0.3))
    ceramic = b.add_material(M.MaterialSpec(M.CERAMIC, diffuse=(0.2, 0.4, 0.8), param=0.7,
                                            **tex_kw))
    glow = b.add_material(M.MaterialSpec(M.GLOW, diffuse=(0.7, 0.7, 0.2), param=0.6,
                                         glow=(2.0, 1.0, 0.5), **tex_kw))
    fog = b.add_material(M.MaterialSpec(M.FOG, diffuse=(0.6, 0.6, 0.65), frost=500.0))
    b.add_sphere((-28.0, -36.0, 15.0), 12.0, mirror)
    b.add_sphere((0.0, -38.0, -5.0), 11.0, glass)
    b.add_sphere((-10.0, 10.0, 25.0), 9.0, clear)
    b.add_sphere((28.0, -38.0, 20.0), 11.0, liquid)
    b.add_sphere((25.0, 5.0, 10.0), 9.0, metal)
    b.add_sphere((-25.0, 15.0, -10.0), 8.0, glow)
    b.add_cuboid((5.0, -40.0, 28.0), 14.0, 20.0, 14.0, ceramic,
                 rot_axis=(0, 1, 0), rot_angle=0.6)
    b.add_sphere((5.0, 0.0, 0.0), 40.0, fog)


def many_materials(b, M, rows=64, seed=13):
    """The Cornell walls, a dim sky and ``rows`` material rows in all: each
    row past the walls' and the sky's lights a small sphere of its own
    (diffuse, metal, or an emitter, in turn), on a grid in front of the
    back wall.  A wide table for kernel 8's plan (64 rows)."""
    rng = np.random.default_rng(seed)
    _cornell_walls(b, M)
    b.set_sky(b.add_material(M.MaterialSpec(M.LIGHT, emissive=(0.05, 0.07, 0.10))))
    extra = rows - 5
    side = int(np.ceil(np.sqrt(extra)))
    for j in range(extra):
        color = tuple(float(c) for c in rng.uniform(0.2, 0.9, 3))
        kind = j % 3
        if kind == 0:
            spec = M.MaterialSpec(M.DIFFUSE, diffuse=color)
        elif kind == 1:
            spec = M.MaterialSpec(M.METAL, diffuse=color, param=0.4)
        else:
            spec = M.MaterialSpec(M.LIGHT, emissive=tuple(2.0 * c for c in color))
        x = -40.0 + 80.0 * (j % side + 0.5) / side
        y = -40.0 + 80.0 * (j // side + 0.5) / side
        b.add_sphere((x, y, 30.0), 0.35 * 80.0 / side, b.add_material(spec))


def flagship_rows(b, M, rows=512):
    """The flagship (14 primitive rows) and small metal spheres on a grid in
    front of the back wall, ``rows`` primitive rows in all: the widest
    table the analytic kernels take at 512 (MAX_SPECIALIZED_PRIMS, 69.6 KB
    of staged rows)."""
    flagship(b, M)
    metal = b.add_material(M.MaterialSpec(M.METAL, diffuse=(0.8, 0.7, 0.6), param=0.3))
    extra = rows - 14
    side = int(np.ceil(np.sqrt(extra)))
    for j in range(extra):
        x = -45.0 + 90.0 * (j % side + 0.5) / side
        y = -45.0 + 90.0 * (j // side + 0.5) / side
        b.add_sphere((x, y, 30.0), 0.3 * 90.0 / side, metal)


HEIGHTFIELD_CAMERA = dict(origin=(0.0, 25.0, -110.0), target=(0.0, -15.0, 0.0),
                          aperture_size=1.5, focal_depth=95.0)


def _heightfield_mesh(grid):
    """Grid points ``P [grid, grid, 3]`` and the two triangles of every
    cell as ``(v0, v1, v2)`` index arrays into ``P.reshape(-1, 3)``."""
    xs = np.linspace(-45, 45, grid, dtype=np.float32)
    X, Z = np.meshgrid(xs, xs, indexing="ij")
    Y = (6.0 * np.sin(X * 0.18) * np.cos(Z * 0.15)
         + 3.0 * np.sin(X * 0.51 + 1.0) * np.sin(Z * 0.43) - 20.0)
    P = np.stack([X, Y, Z], axis=-1)
    idx = np.arange(grid * grid).reshape(grid, grid)
    a, bq = idx[:-1, :-1].reshape(-1), idx[1:, :-1].reshape(-1)
    c, d = idx[1:, 1:].reshape(-1), idx[:-1, 1:].reshape(-1)
    return P, (np.concatenate([a, a]), np.concatenate([bq, c]), np.concatenate([c, d]))


def heightfield(b, M, grid=224):
    """The mesh bench scene of ``bench.py:115-152`` (camera by the caller)."""
    white = b.add_material(M.MaterialSpec(M.DIFFUSE, diffuse=(0.7, 0.7, 0.7)))
    terra = b.add_material(M.MaterialSpec(M.DIFFUSE, diffuse=(0.55, 0.45, 0.35)))
    light = b.add_material(M.MaterialSpec(M.LIGHT, emissive=(12.0, 12.0, 12.0)))
    b.set_sky(b.add_material(M.MaterialSpec(M.LIGHT, emissive=(0.3, 0.4, 0.6))))
    s = 60.0
    b.add_quad_uv((-s, -30.0, -s), (2 * s, 0, 0), (0, 0, 2 * s), white)  # floor
    b.add_quad_uv((-20, 55.0, -20), (40, 0, 0), (0, 0, 40), light)  # light
    P, (i0, i1, i2) = _heightfield_mesh(grid)
    flat = P.reshape(-1, 3)
    b.add_triangles(flat[i0], flat[i1], flat[i2], terra)


def write_heightfield_scene(dst_dir, grid=224):
    """Write :func:`heightfield` as ``heightfield.obj`` and
    ``heightfield.scene`` (floor, light, sky and camera as the sample) into
    ``dst_dir``; returns the ``.scene`` path.

    Faces are written clockwise: the OBJ loader's CW→CCW flip
    (scene/mesh.py) turns ``f v2 v1 v0`` back into ``(v0, v1, v2)``, so the
    parsed triangles equal the sample's.  Coordinates are written in the
    shortest form that reads back to the same float32.
    """
    import os

    os.makedirs(dst_dir, exist_ok=True)
    P, (i0, i1, i2) = _heightfield_mesh(grid)
    fmt = lambda x: np.format_float_positional(x, unique=True, trim="0")
    lines = [f"# heightfield, grid {grid}: {len(i0)} triangles"]
    lines += [f"v {fmt(x)} {fmt(y)} {fmt(z)}" for x, y, z in P.reshape(-1, 3)]
    lines += [f"f {c + 1} {b + 1} {a + 1}" for a, b, c in zip(i0, i1, i2)]
    obj = os.path.join(dst_dir, "heightfield.obj")
    with open(obj, "w") as f:
        f.write("\n".join(lines) + "\n")
    cam = HEIGHTFIELD_CAMERA
    v3 = lambda v: " ".join(str(float(x)) for x in v)
    scene = f"""# The mesh bench scene: a heightfield in a lit box (fspt_tpu_torch samples)

material white
{{
 color 0.7 0.7 0.7
}}

material terra
{{
 color 0.55 0.45 0.35
}}

material lamp
{{
 emission 12.0 12.0 12.0
}}

material ambient
{{
 emission 0.3 0.4 0.6
}}

sky
{{
 material ambient
}}

camera
{{
 position {v3(cam["origin"])}
 target {v3(cam["target"])}
 fov 45.0
 aperture {cam["aperture_size"]}
 focal_depth {cam["focal_depth"]}
}}

# floor
quad
{{
 material white
 position -60.0 -30.0 -60.0
 u 120.0 0.0 0.0
 v 0.0 0.0 120.0
}}

# area light
quad
{{
 material lamp
 position -20.0 55.0 -20.0
 u 40.0 0.0 0.0
 v 0.0 0.0 40.0
}}

mesh
{{
 file heightfield.obj
 material terra
}}
"""
    path = os.path.join(dst_dir, "heightfield.scene")
    with open(path, "w") as f:
        f.write(scene)
    return path


SCENES = {"flagship": flagship, "all_primitives": all_primitives,
          "all_families": all_families, "textured": textured,
          "all_families_textured": lambda b, M: all_families(b, M, textured=True),
          "many_materials": many_materials, "flagship_rows": flagship_rows,
          "heightfield": heightfield, "textured_flagship": textured_flagship}
CAMERAS = {"heightfield": HEIGHTFIELD_CAMERA}


def build(name: str, device=None, aperture=0.0, focal_depth=80.0, **scene_kw):
    """The named scene in this package's builder with its camera created on
    ``device``: the standard one (origin (0, 0, -145) looking at the origin,
    ``aperture``, ``focal_depth``) unless the scene has its own
    (:data:`CAMERAS`).  ``scene_kw`` go to the scene function (``grid``,
    ``textures``)."""
    from fspt_tpu_torch import materials as M
    from fspt_tpu_torch.camera import Camera
    from fspt_tpu_torch.scene.builder import SceneBuilder

    b = SceneBuilder()
    SCENES[name](b, M, **scene_kw)
    cam = CAMERAS.get(name, dict(origin=CAMERA_ORIGIN, aperture_size=aperture,
                                 focal_depth=focal_depth))
    b.add_camera(Camera.create(**cam, device=device))
    return b


def write_textured_cornell(src, dst, wall_texture, sky_texture, wall_scale=0.02):
    """Copy the ``.scene`` file ``src`` (scenes/cornell.scene) to ``dst``
    with ``wall_texture`` on its red and green walls and ``sky_texture`` on
    its sky material (``ambient``); texture paths are written absolute."""
    import os

    extra = {"red": (wall_texture, wall_scale), "green": (wall_texture, wall_scale),
             "ambient": (sky_texture, 1.0)}
    out, current = [], None
    with open(src) as f:
        for line in f.read().splitlines():
            words = line.split()
            if len(words) == 2 and words[0] == "material":
                current = words[1]
            elif line.strip() == "}" and current in extra:
                path, scale = extra.pop(current)
                out += [f" texture {os.path.abspath(path)}", f" texture_scale {scale}"]
                current = None
            out.append(line)
    if extra:
        raise ValueError(f"{src} has no material block for {sorted(extra)}")
    with open(dst, "w") as f:
        f.write("\n".join(out) + "\n")
    return dst
