"""Batched material system over torch tensors.

Port of fspt_tpu/materials.py: the reference's nine-class material hierarchy
(material.h:88-328) as a parameter table plus pure functions over the whole
wavefront.  Every ``Material::Sample`` is affine in the indirect radiance,
``Sample(L) = coef * L + bias``, so the integrator folds it as
``radiance += T * bias; T *= coef``.  See the reference module for the
per-type semantics (material.cpp line by line).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fspt_tpu_torch.utils import vecmath as vm

# Material type ids (scene-factory order, reference scene.cpp:283-303).
DIFFUSE, LIGHT, METAL, MIRROR, GLASS, LIQUID, CERAMIC, GLOW, FOG = range(9)

# Thresholds from material.cpp:12-13.
DIFFUSE_CONTRIB_THRESHOLD = 0.001
DIFFUSE_ROUGHNESS_THRESHOLD = 0.95
# Ceramic mirror-spike probability (material.cpp:265) and specular power (280).
CERAMIC_SPIKE_PROB = 0.1
CERAMIC_SPEC_POWER = 50


class MaterialTable(NamedTuple):
    """Struct-of-arrays material parameters, one row per material."""

    mtype: torch.Tensor  # [M] int32
    diffuse: torch.Tensor  # [M,3] albedo / tint
    emissive: torch.Tensor  # [M,3] light emission
    glow: torch.Tensor  # [M,3] additive glow (GLOW)
    param: torch.Tensor  # [M] roughness (METAL) / shininess (CERAMIC, GLOW)
    ior: torch.Tensor  # [M] refraction ratio (GLASS, LIQUID)
    reflectivity: torch.Tensor  # [M] reflect probability (GLASS, LIQUID)
    frost: torch.Tensor  # [M] frostiness (GLASS); density*1000 (FOG)
    tex_id: torch.Tensor  # [M] int32 texture index, -1 = none
    tex_scale: torch.Tensor  # [M] texture tiling scale

    @property
    def count(self):
        return self.mtype.shape[0]


class TexturePack(NamedTuple):
    """All diffuse textures flattened into one texel buffer:
    ``texels[offset[t] + y*width[t] + x]``."""

    texels: torch.Tensor  # [K,3] float32 linear RGB
    offset: torch.Tensor  # [T] int32
    width: torch.Tensor  # [T] int32
    height: torch.Tensor  # [T] int32

    @classmethod
    def empty(cls, device) -> "TexturePack":
        return cls(
            texels=torch.zeros((1, 3), dtype=torch.float32, device=device),
            offset=torch.zeros((1,), dtype=torch.int32, device=device),
            width=torch.ones((1,), dtype=torch.int32, device=device),
            height=torch.ones((1,), dtype=torch.int32, device=device),
        )


class ShadeResultP(NamedTuple):
    """Component-planar shading result: every vector is three [N] planes."""

    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor  # direction
    cx: torch.Tensor
    cy: torch.Tensor
    cz: torch.Tensor  # coef (rgb)
    bx: torch.Tensor
    by: torch.Tensor
    bz: torch.Tensor  # bias (rgb)
    will_indirect: torch.Tensor  # [N] bool
    is_light: torch.Tensor  # [N] bool
    is_fog: torch.Tensor  # [N] bool
    fdx: torch.Tensor
    fdy: torch.Tensor
    fdz: torch.Tensor  # fog diffuse (rgb)
    fog_density: torch.Tensor  # [N]


class ShadeResult(NamedTuple):
    direction: torch.Tensor  # [N,3] sampled bounce direction
    coef: torch.Tensor  # [N,3] multiplier on indirect radiance
    bias: torch.Tensor  # [N,3] emitted radiance
    will_indirect: torch.Tensor  # [N] bool
    is_light: torch.Tensor  # [N] bool
    is_fog: torch.Tensor  # [N] bool
    fog_diffuse: torch.Tensor  # [N,3]
    fog_density: torch.Tensor  # [N]


def sample_texture_p(tex: TexturePack, tex_id, tex_scale, tu, tv,
                     fbx, fby, fbz):
    """Planar tiled nearest-neighbour texture fetch (material.cpp:107-127):
    ``x = int(u·scale·w + 0.5 − 1) mod w`` with a floored mod."""
    safe_id = torch.clamp(tex_id, min=0).long()
    w = tex.width[safe_id]
    h = tex.height[safe_id]
    xf = tu * tex_scale * w.to(torch.float32) + 0.5 - 1.0
    yf = tv * tex_scale * h.to(torch.float32) + 0.5 - 1.0
    xi = torch.remainder(xf.to(torch.int32), w)
    yi = torch.remainder(yf.to(torch.int32), h)
    idx = torch.clamp(tex.offset[safe_id] + yi * w + xi,
                      0, tex.texels.shape[0] - 1).long()
    has = tex_id >= 0
    return (torch.where(has, tex.texels[:, 0][idx], fbx),
            torch.where(has, tex.texels[:, 1][idx], fby),
            torch.where(has, tex.texels[:, 2][idx], fbz))


def sample_sky_p(table: MaterialTable, tex: TexturePack, sky_mat, vx, vy, vz):
    """Planar sky radiance for a miss; reference scene.cpp:157-162 (×3).
    ``(vx, vy, vz)`` must be normalized (engine.cpp:92-93)."""
    tu, tv = vm.sphere_map_texcoords_p(vx, vy, vz)
    sky = int(sky_mat)
    em = table.emissive[sky]
    r, g, b = sample_texture_p(
        tex, table.tex_id[sky].expand(vx.shape),
        table.tex_scale[sky], tu, tv,
        em[0].expand(vx.shape), em[1].expand(vx.shape), em[2].expand(vx.shape))
    return r * 3.0, g * 3.0, b * 3.0


def sample_sky(table: MaterialTable, tex: TexturePack, sky_mat, view_dir):
    r, g, b = sample_sky_p(table, tex, sky_mat, view_dir[..., 0],
                           view_dir[..., 1], view_dir[..., 2])
    return torch.stack([r, g, b], dim=-1)


def _lerped_reflection_p(hx, hy, hz, rx, ry, rz, amount, nx, ny, nz):
    """normal_sphere::random_reflection (reference math/normal.cpp:36-62)."""
    inv = 1.0 - amount
    ox, oy, oz = vm.normalize_p(hx * amount + rx * inv,
                                hy * amount + ry * inv,
                                hz * amount + rz * inv)
    flip = vm.dot_p(ox, oy, oz, nx, ny, nz) < 0.0
    return (torch.where(flip, -ox, ox), torch.where(flip, -oy, oy),
            torch.where(flip, -oz, oz))


def _random_refraction_p(vx, vy, vz, nx, ny, nz, hx, hy, hz,
                         solid_angle, index, u_aux):
    """normal_sphere::random_refraction (reference math/normal.cpp:64-105)."""
    straight = torch.abs(index - 1.0) < vm.EPSILON
    fx, fy, fz = vm.refract_p(vx, vy, vz, nx, ny, nz, index)
    fx = torch.where(straight, vx, fx)
    fy = torch.where(straight, vy, fy)
    fz = torch.where(straight, vz, fz)
    fx, fy, fz = vm.normalize_p(fx, fy, fz)

    delta = (u_aux * 2.0 - 1.0) * (solid_angle * 0.5)
    ox, oy, oz = vm.rotate_p(fx, fy, fz, delta, hx, hy, hz)

    full_diffuse = torch.abs(solid_angle - vm.PI) < vm.EPSILON
    no_spread = torch.abs(solid_angle) < vm.EPSILON
    ox = torch.where(no_spread, fx, ox)
    oy = torch.where(no_spread, fy, oy)
    oz = torch.where(no_spread, fz, oz)
    return (torch.where(full_diffuse, hx, ox), torch.where(full_diffuse, hy, oy),
            torch.where(full_diffuse, hz, oz))


def shade_planar(table: MaterialTable, tex: TexturePack, mat_idx, view,
                 normal, texcoords, uniforms) -> ShadeResultP:
    """Sample one bounce direction and the affine radiance transfer.

    ``mat_idx`` [N] material rows; ``view`` the normalized view planes
    (engine.cpp:114); ``normal`` the planes after the internal flip
    (scene.cpp:238-247); ``texcoords`` (tu, tv); ``uniforms`` the per-bounce
    draws (choice, dir_a, dir_b, aux).  Rows are gathered with the index
    clamped into the table, as the reference's XLA gathers clamp.
    """
    vx, vy, vz = view
    nx, ny, nz = normal
    tu, tv = texcoords
    u_choice, u_a, u_b, u_aux = uniforms

    idx = torch.clamp(mat_idx.long(), 0, table.count - 1)
    mtype = table.mtype[idx]
    dfx, dfy, dfz = (table.diffuse[:, k][idx] for k in range(3))
    emx, emy, emz = (table.emissive[:, k][idx] for k in range(3))
    glx, gly, glz = (table.glow[:, k][idx] for k in range(3))
    param = table.param[idx]
    ior = table.ior[idx]
    reflectivity = table.reflectivity[idx]
    frost = table.frost[idx]
    tex_id = table.tex_id[idx]
    tex_scale = table.tex_scale[idx]

    def is_(t):
        return mtype == t

    # --- bounce direction -------------------------------------------------
    rfx, rfy, rfz = vm.reflect_p(vx, vy, vz, nx, ny, nz)
    spx, spy, spz = vm.uniform_sphere_dir_p(u_a, u_b)
    hflip = vm.dot_p(spx, spy, spz, nx, ny, nz) < 0.0
    hx = torch.where(hflip, -spx, spx)
    hy = torch.where(hflip, -spy, spy)
    hz = torch.where(hflip, -spz, spz)

    zero = torch.zeros_like(vx)
    lobe = torch.where(is_(DIFFUSE), 1.0, zero)
    lobe = torch.where(is_(METAL), param, lobe)
    ceramic_lobe = torch.where(u_choice < CERAMIC_SPIKE_PROB, 0.0, 1.0 - param)
    lobe = torch.where(is_(CERAMIC) | is_(GLOW), ceramic_lobe, lobe)
    glass_reflecting = u_choice < reflectivity
    lobe = torch.where(is_(GLASS), frost, lobe)
    lpx, lpy, lpz = _lerped_reflection_p(hx, hy, hz, rfx, rfy, rfz, lobe,
                                         nx, ny, nz)

    gfx, gfy, gfz = _random_refraction_p(vx, vy, vz, nx, ny, nz, hx, hy, hz,
                                         vm.PI * frost, ior, u_aux)
    gdx = torch.where(glass_reflecting, lpx, gfx)
    gdy = torch.where(glass_reflecting, lpy, gfy)
    gdz = torch.where(glass_reflecting, lpz, gfz)

    lqx, lqy, lqz = vm.refract_p(vx, vy, vz, nx, ny, nz, ior)
    ldx = torch.where(glass_reflecting, rfx, lqx)
    ldy = torch.where(glass_reflecting, rfy, lqy)
    ldz = torch.where(glass_reflecting, rfz, lqz)

    mirror, glass, liquid, fog = is_(MIRROR), is_(GLASS), is_(LIQUID), is_(FOG)
    dx = torch.where(mirror, rfx, lpx)
    dy = torch.where(mirror, rfy, lpy)
    dz = torch.where(mirror, rfz, lpz)
    dx = torch.where(glass, gdx, dx)
    dy = torch.where(glass, gdy, dy)
    dz = torch.where(glass, gdz, dz)
    dx = torch.where(liquid, ldx, dx)
    dy = torch.where(liquid, ldy, dy)
    dz = torch.where(liquid, ldz, dz)
    dx = torch.where(fog, vx, dx)
    dy = torch.where(fog, vy, dy)
    dz = torch.where(fog, vz, dz)
    light = is_(LIGHT)
    dx = torch.where(light, 0.0, dx)
    dy = torch.where(light, 0.0, dy)
    dz = torch.where(light, 0.0, dz)

    # --- continuation predicate (WillUseIndirectLight) --------------------
    n_dot_l = vm.dot_p(nx, ny, nz, dx, dy, dz)
    will = ~light
    will = torch.where(is_(DIFFUSE), n_dot_l > DIFFUSE_CONTRIB_THRESHOLD, will)
    metal_will = (param <= DIFFUSE_ROUGHNESS_THRESHOLD) | (
        n_dot_l > DIFFUSE_CONTRIB_THRESHOLD)
    will = torch.where(is_(METAL), metal_will, will)

    # --- affine radiance transfer: Sample(L) = coef·L + bias --------------
    txx, txy, txz = sample_texture_p(tex, tex_id, tex_scale, tu, tv,
                                     dfx, dfy, dfz)
    ndl = torch.clamp(n_dot_l, min=0.0)

    hvx, hvy, hvz = vm.normalize_p(-vx + dx, -vy + dy, -vz + dz)
    hn = vm.dot_p(hvx, hvy, hvz, nx, ny, nz)
    # pow(h·n, 50) with an even exponent is positive for negative bases in
    # C++ (material.cpp:280); (hn²)^25 reproduces that.
    spec = torch.pow(hn * hn, CERAMIC_SPEC_POWER // 2)

    is_metal = is_(METAL)
    is_spec_tint = mirror | glass | liquid
    is_ceramic = is_(CERAMIC) | is_(GLOW)
    metal_mix = param * ndl + (1.0 - param)

    def _coef(tx, df):
        c = tx * ndl  # DIFFUSE
        c = torch.where(light, 0.0, c)
        c = torch.where(is_metal, tx * metal_mix, c)
        c = torch.where(is_spec_tint, df, c)
        c = torch.where(is_ceramic, spec + tx * ndl * (1.0 - spec), c)
        return torch.where(fog, 1.0, c)

    cx, cy, cz = _coef(txx, dfx), _coef(txy, dfy), _coef(txz, dfz)

    lbx, lby, lbz = sample_texture_p(tex, tex_id, tex_scale, tu, tv,
                                     emx, emy, emz)
    is_glow = is_(GLOW)

    def _bias(lb, gl):
        return torch.where(is_glow, gl, torch.where(light, lb, 0.0))

    bx, by, bz = _bias(lbx, glx), _bias(lby, gly), _bias(lbz, glz)

    return ShadeResultP(
        dx=dx, dy=dy, dz=dz, cx=cx, cy=cy, cz=cz, bx=bx, by=by, bz=bz,
        will_indirect=will, is_light=light, is_fog=fog,
        fdx=dfx, fdy=dfy, fdz=dfz, fog_density=frost,
    )


def shade(table: MaterialTable, tex: TexturePack, mat_idx, view, normal,
          texcoords, uniforms) -> ShadeResult:
    """[N,3]-interface wrapper over :func:`shade_planar`."""
    p = shade_planar(
        table, tex, mat_idx,
        (view[..., 0], view[..., 1], view[..., 2]),
        (normal[..., 0], normal[..., 1], normal[..., 2]),
        (texcoords[..., 0], texcoords[..., 1]),
        (uniforms[..., 0], uniforms[..., 1], uniforms[..., 2],
         uniforms[..., 3]),
    )
    st = lambda x, y, z: torch.stack([x, y, z], dim=-1)
    return ShadeResult(
        direction=st(p.dx, p.dy, p.dz),
        coef=st(p.cx, p.cy, p.cz),
        bias=st(p.bx, p.by, p.bz),
        will_indirect=p.will_indirect,
        is_light=p.is_light,
        is_fog=p.is_fog,
        fog_diffuse=st(p.fdx, p.fdy, p.fdz),
        fog_density=p.fog_density,
    )


# ---------------------------------------------------------------------------
# Host-side table construction


class MaterialSpec:
    """Host-side material description, built by the scene layer."""

    __slots__ = (
        "mtype", "diffuse", "emissive", "glow", "param", "ior",
        "reflectivity", "frost", "tex_id", "tex_scale",
    )

    def __init__(self, mtype, diffuse=(0, 0, 0), emissive=(0, 0, 0), glow=(0, 0, 0),
                 param=0.0, ior=1.0, reflectivity=0.1, frost=0.0,
                 tex_id=-1, tex_scale=1.0):
        self.mtype = mtype
        self.diffuse = diffuse
        self.emissive = emissive
        self.glow = glow
        self.param = param
        self.ior = ior
        self.reflectivity = reflectivity
        self.frost = frost
        self.tex_id = tex_id
        self.tex_scale = tex_scale


def pack_materials(specs, device) -> MaterialTable:
    """Pack host-side specs into the table on ``device`` (≥1 row)."""
    if not specs:
        specs = [MaterialSpec(LIGHT)]
    f32 = np.float32
    fields = dict(
        mtype=np.asarray([s.mtype for s in specs], np.int32),
        diffuse=np.asarray([s.diffuse for s in specs], f32),
        emissive=np.asarray([s.emissive for s in specs], f32),
        glow=np.asarray([s.glow for s in specs], f32),
        param=np.asarray([s.param for s in specs], f32),
        ior=np.asarray([s.ior for s in specs], f32),
        reflectivity=np.asarray([s.reflectivity for s in specs], f32),
        frost=np.asarray([s.frost for s in specs], f32),
        tex_id=np.asarray([s.tex_id for s in specs], np.int32),
        tex_scale=np.asarray([s.tex_scale for s in specs], f32),
    )
    return MaterialTable(**{name: torch.from_numpy(fields[name]).to(device)
                            for name in MaterialTable._fields})
