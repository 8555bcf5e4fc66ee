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
* ``all_families_textured`` — :func:`all_families` with textured walls, sky,
  lamp, mirror, ceramic and glow rows.
* :func:`write_textured_cornell` — a textured copy of a ``.scene`` file of
  the Cornell box (its red and green walls and its sky textured).

Textures are checkers whose two colours come from a seeded NumPy generator,
so both packages build the same texels.
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


SCENES = {"flagship": flagship, "all_primitives": all_primitives,
          "all_families": all_families, "textured": textured,
          "all_families_textured": lambda b, M: all_families(b, M, textured=True)}


def build(name: str, device=None, aperture=0.0, focal_depth=80.0):
    """The named scene in this package's builder, with the standard camera
    (origin (0, 0, -145) looking at the origin) created on ``device``."""
    from fspt_tpu_torch import materials as M
    from fspt_tpu_torch.camera import Camera
    from fspt_tpu_torch.scene.builder import SceneBuilder

    b = SceneBuilder()
    SCENES[name](b, M)
    b.add_camera(Camera.create(origin=CAMERA_ORIGIN, aperture_size=aperture,
                               focal_depth=focal_depth, device=device))
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
