"""Path-tracing megakernels: kernels 2 (camera-fused), 3 (rays in) and 4
(texture-deferred camera-fused).

Counterpart of fspt_tpu/ops/pallas_path.py.  The CUDA kernels
(csrc/fspt_kernels.cu, csrc/fspt_deferred.cu) trace the whole path of a
lane in one thread — intersect, backface flip, fog, sky, the nine material
families, the light clamp — so per-lane state lives in registers for every
bounce and device memory sees only the outputs (and, for kernel 3, the
rays):

* ``camera_path_kernel`` replaces ``pallas_path.py:make_camera_path_tracer``
  (kernel body ``:1371``): it also makes each lane's primary ray from the
  lane index (pixel/sample ids, PCG jitter, thin-lens DoF).
* ``ray_path_kernel`` replaces ``pallas_path.py:make_path_tracer``
  (``build_path_kernel`` ``:770``): the same body with rays read from memory.
* ``deferred_camera_kernel`` replaces
  ``pallas_path.py:_make_deferred_camera_tracer`` (kernel ``:996``) and the
  XLA fold after it (``fold_deferred_radiance``, ``:867``): the same body in
  texture-deferred mode, for textured scenes.  Each depth's affine transfer
  is folded in the kernel as it is made, its texel fetched from the texture
  pack there; the reference emits slot planes and folds them outside only
  because a TPU kernel has no per-lane gather.
* ``mesh_camera_path_kernel`` (kernel 13) is kernel 2 on an untextured BVH
  scene, which the reference renders only through its ray queue
  (render/queue.py): after the staged primitive rows, each thread walks the
  scene's BVH for its segment in kernel 11's packed records
  (csrc/fspt_mesh.cuh), so the frame is one launch on the card.

What bounds kernels 2-4 on the H100: arithmetic.  A 1024²×4 spp Cornell
frame writes 36 bytes per lane but traces ~5 segments per lane, each testing
every primitive.  What the design does about the arithmetic: the TPU
version baked geometry and materials into the instruction stream and
evaluated every material row under a mask; here both are tables read as
warp broadcasts (the primitive rows from a block's copy in shared memory,
walked one kind at a time), and a lane switches on its hit
material's family (the reference's masks are disjoint, so this is the same
function), skipping dead lanes' work after they count.  Branch regimes the
reference fixed at trace time (glass ``|ior−1| < EPS``, frost at π or 0,
metal ``roughness ≤ 0.95``) are derived per material row on the host in
float64, exactly as the reference decides them, and passed as flags; the
texture regime of a row (``tex_id ≥ 0``) is a column of the same table.

:func:`build_fused_raygen` and :func:`build_path_core` are the plain
PyTorch versions of the kernels (with :func:`plain_mesh_intersect` for
kernel 13): the tracers use them only for a scene on the CPU; for a scene
on the card they launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from fspt_tpu_torch import materials as M
from fspt_tpu_torch.ops import _build, rng
from fspt_tpu_torch.ops.cuda_trace import (
    KIND_TRIANGLE,
    HostScene,
    MAX_SPECIALIZED_PRIMS,
    _atan2,
    _np,
    intersect_lanes,
)
from fspt_tpu_torch.render.integrator import TraceOutput
from fspt_tpu_torch.scene.geometry import INVALID_PARAM
from fspt_tpu_torch.utils import profiling
from fspt_tpu_torch.utils import vecmath as vm

MAT_STRIDE = 16  # floats per material row (csrc kMatStride)
META_STRIDE = 3  # ints per material meta row: family, flags, tex_id (csrc kMetaStride)
FLAG_GLASS_STRAIGHT = 1
FLAG_FROST_FULL = 2
FLAG_FROST_NONE = 4
FLAG_METAL_SMOOTH = 8

#: Float slot fields of the texture-deferred mode, in plane order.
DEFERRED_TEX_FIELDS = ("s", "k0", "k1", "k2", "se", "ke0", "ke1", "ke2", "u", "v")

CAMERA_PATH = _build.KernelCounter(
    "camera_path", "fspt_kernels", "fspt_camera_path",
    "fspt_tpu/ops/pallas_path.py:1405 make_camera_path_tracer (body :1371)")
RAY_PATH = _build.KernelCounter(
    "ray_path", "fspt_kernels", "fspt_ray_path",
    "fspt_tpu/ops/pallas_path.py:845 make_path_tracer (build_path_kernel :770)")
DEFERRED_PATH = _build.KernelCounter(
    "deferred_path", "fspt_deferred", "fspt_deferred_camera_path",
    "fspt_tpu/ops/pallas_path.py:1046 _make_deferred_camera_tracer (body :996)")
MESH_CAMERA_PATH = _build.KernelCounter(
    "mesh_camera_path", "fspt_kernels", "fspt_mesh_camera_path",
    "none: fspt_tpu renders BVH scenes through its ray queue (render/queue.py)")
#: Kernel 13's counting build's totals a launch (csrc/fspt_mesh.cuh
#: kMeshTotals): node steps and triangle tests (``walk``), then leaf phases,
#: leaves tested in them and warp walks (``phases``).
MESH_TOTALS = 5


def _one_minus(x):
    """``1 - x`` rounded once to float32, as the kernels round ``1.0f - x``:
    NumPy's ``1.0 - f32`` for a Python float, a float32 tensor subtraction
    for a tensor."""
    if isinstance(x, torch.Tensor):
        return 1.0 - x
    return float(np.float32(1.0) - np.float32(x))


def _half_spread(frost):
    """The frost rotation's half angle ``(π·frost)·0.5``, rounded in float32
    after each product, as the kernels compute ``(kPi * frost) * 0.5f``."""
    if isinstance(frost, torch.Tensor):
        return (frost * float(np.float32(vm.PI))) * 0.5
    return float(np.float32(np.float32(vm.PI) * np.float32(frost)) * np.float32(0.5))


def _lanes(like, v):
    """A lane plane holding ``v`` (a Python float or a 0-d tensor)."""
    return v.expand(like.shape) if isinstance(v, torch.Tensor) else torch.full_like(like, v)


def n_slots(cfg) -> int:
    """Slots a deferred trace emits: one per depth, plus the fast-render
    white terminal."""
    return cfg.effective_depth + (1 if cfg.fast_render else 0)


class HostMaterials:
    """The material table on the host, plus its packed kernel form.

    Kernel row (float32, 16 wide): diffuse(3), emissive(3), glow(3), param,
    ior, reflectivity, frost.  Meta (int32): family, regime flags, tex_id.
    """

    def __init__(self, table):
        self.mtype = _np(table.mtype)
        self.diffuse = _np(table.diffuse)
        self.emissive = _np(table.emissive)
        self.glow = _np(table.glow)
        self.param = _np(table.param)
        self.ior = _np(table.ior)
        self.reflectivity = _np(table.reflectivity)
        self.frost = _np(table.frost)
        self.tex_id = _np(table.tex_id)
        self.tex_scale = _np(table.tex_scale)
        self._device_tables = {}

    @property
    def count(self):
        return len(self.mtype)

    @property
    def any_textured(self):
        return bool((self.tex_id >= 0).any())

    def bias_column(self) -> np.ndarray:
        """Per row, the table column a bias event reads (defer_all mode,
        pallas_path.py:922-926): 0 emissive (lights, sky), 1 glow (Glow),
        2 diffuse (Fog)."""
        mt = self.mtype
        return np.where(mt == M.GLOW, 1, np.where(mt == M.FOG, 2, 0))

    def flags(self, row: int) -> int:
        """The row's static branch regimes, decided in float64 as
        pallas_path.py:487 and :534-546 decide them."""
        f = 0
        if abs(float(self.ior[row]) - 1.0) < vm.EPSILON:
            f |= FLAG_GLASS_STRAIGHT
        sa_s = vm.PI * float(self.frost[row])
        if abs(sa_s - vm.PI) < vm.EPSILON:
            f |= FLAG_FROST_FULL
        elif abs(sa_s) < vm.EPSILON:
            f |= FLAG_FROST_NONE
        if float(self.param[row]) <= M.DIFFUSE_ROUGHNESS_THRESHOLD:
            f |= FLAG_METAL_SMOOTH
        return f

    def tables(self, device):
        """``(mats [M,16] float32, meta [M,3] int32)`` on ``device``."""
        key = str(device)
        if key not in self._device_tables:
            n = self.count
            rows = np.zeros((n, MAT_STRIDE), np.float32)
            rows[:, 0:3] = self.diffuse
            rows[:, 3:6] = self.emissive
            rows[:, 6:9] = self.glow
            rows[:, 9] = self.param
            rows[:, 10] = self.ior
            rows[:, 11] = self.reflectivity
            rows[:, 12] = self.frost
            meta = np.array([(int(self.mtype[r]), self.flags(r), int(self.tex_id[r]))
                             for r in range(n)], np.int32).reshape(n, META_STRIDE)
            self._device_tables[key] = (torch.from_numpy(rows).to(device),
                                        torch.from_numpy(meta).to(device))
        return self._device_tables[key]


class HostCamera:
    """Camera constants of the fused raygen, computed in NumPy exactly as
    pallas_path.py:1076-1106 (reference engine.cpp:184-197)."""

    def __init__(self, camera, width: int, height: int):
        o = np.asarray(_np(camera.origin), np.float32)
        tgt = np.asarray(_np(camera.target), np.float32)
        self.origin = o
        self.z_far = float(_np(camera.z_far))
        self.aperture = float(_np(camera.aperture_size))
        self.focal_depth = float(_np(camera.focal_depth))
        fwd = tgt - o
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(np.array([0.0, 1.0, 0.0], np.float32), fwd)
        right = right / np.linalg.norm(right)
        up = np.cross(fwd, right)
        up = up / np.linalg.norm(up)
        self.forward, self.right, self.up = fwd, right, up
        fovy = float(_np(camera.fov_y)) * vm.PI / 180.0
        aspect = width / height
        fovx = 2.0 * np.arctan(np.tan(fovy * 0.5) * aspect)
        self.half_h = float(np.tan(fovy * 0.5) * self.z_far)
        self.half_w = float(np.tan(fovx * 0.5) * self.z_far)
        self.proj_origin = o + fwd * self.z_far
        # Focal plane (engine.cpp:195-197): normal -forward through
        # origin + forward*focal_depth.
        n = -fwd
        p = o + fwd * self.focal_depth
        self.focal_plane = np.concatenate([n, [-float(np.dot(n, p))]])


# --- plain PyTorch versions of the kernels ---------------------------------


def _norm3(x, y, z):
    n2 = x * x + y * y + z * z
    pos = n2 > 0.0
    inv = torch.where(pos, torch.rsqrt(torch.where(pos, n2, 1.0)), 0.0)
    return x * inv, y * inv, z * inv


def _pow25(x):
    """x**25 by repeated squaring, as the kernel computes it."""
    x2 = x * x
    x4 = x2 * x2
    x8 = x4 * x4
    x16 = x8 * x8
    return x16 * x8 * x


def _rotate(vx, vy, vz, angle, ax, ay, az):
    c = torch.cos(angle)
    s = torch.sin(angle)
    ic = 1.0 - c
    ox = (c + ic * ax * ax) * vx + (ic * ax * ay - az * s) * vy + (ic * ax * az + ay * s) * vz
    oy = (ic * ax * ay + az * s) * vx + (c + ic * ay * ay) * vy + (ic * ay * az - ax * s) * vz
    oz = (ic * ax * az - ay * s) * vx + (ic * ay * az + ax * s) * vy + (c + ic * az * az) * vz
    return ox, oy, oz


def _refract(vx, vy, vz, nx, ny, nz, index: float):
    """vector3::refract (vector3.h:205-214): TIR → zero, else normalized."""
    ndv = -(vx * nx + vy * ny + vz * nz)
    sin2 = (index * index) * (1.0 - ndv * ndv)
    k = index * ndv - torch.sqrt(torch.where(sin2 < 1.0, 1.0 - sin2, 1.0))
    rx, ry, rz = _norm3(vx * index + nx * k, vy * index + ny * k, vz * index + nz * k)
    tir = sin2 >= 1.0
    return (torch.where(tir, 0.0, rx), torch.where(tir, 0.0, ry),
            torch.where(tir, 0.0, rz))


def build_fused_raygen(cam: HostCamera, cfg):
    """Plain version of the kernel-2 raygen (pallas_path.py:1109, reference
    engine.cpp:205-244).

    Returns ``raygen(h0, sample0, lane0, n, device) → (sx, sy, sz, dx, dy,
    dz, pix, smp)`` for lanes ``lane0 .. lane0+n-1`` of the frame, lane
    order pixel-major then sample.
    """
    width, spp = cfg.width, cfg.spp
    inv_wm1 = 1.0 / (cfg.width - 1)
    inv_hm1 = 1.0 / (cfg.height - 1)
    o = [float(x) for x in cam.origin]
    po = [float(x) for x in cam.proj_origin]
    rt = [float(x) for x in cam.right]
    up = [float(x) for x in cam.up]
    fp = [float(x) for x in cam.focal_plane]

    def raygen(h0, sample0, lane0, n, device):
        flat = int(lane0) + torch.arange(n, dtype=torch.int64, device=device)
        s = torch.remainder(flat, spp)
        pxy = torch.div(flat, spp, rounding_mode="floor")
        x = torch.remainder(pxy, width)
        y = torch.div(pxy, width, rounding_mode="floor")
        pix = (y * width + x).to(torch.int32)
        smp = (s + int(sample0)).to(torch.int32)
        hs = rng.sample_hash(h0, pix, smp)
        u0 = rng.counter_uniform(hs, 0)
        u1 = rng.counter_uniform(hs, 1)
        xf = x.to(torch.float32) + (u0 - 0.5)
        yf = y.to(torch.float32) + (u1 - 0.5)
        x_dist = cam.half_w * ((xf * inv_wm1) * 2.0 - 1.0)
        y_dist = cam.half_h * ((yf * inv_hm1) * 2.0 - 1.0)
        stop = [po[k] + rt[k] * x_dist + up[k] * y_dist for k in range(3)]
        sx, sy, sz = (torch.full_like(x_dist, o[k]) for k in range(3))
        dx, dy, dz = stop[0] - sx, stop[1] - sy, stop[2] - sz

        if cam.aperture > 0.0:
            # Thin-lens DoF (engine.cpp:221-244).
            u2 = rng.counter_uniform(hs, 2)
            u3 = rng.counter_uniform(hs, 3)
            ts = fp[0] * dx + fp[1] * dy + fp[2] * dz
            ns = -(fp[0] * sx + fp[1] * sy + fp[2] * sz + fp[3])
            not_par = torch.abs(ts) >= vm.EPSILON
            tf = ns / torch.where(not_par, ts, 1.0)
            valid = not_par & (tf >= 0.0) & (tf <= 1.0)
            fx, fy, fz = sx + dx * tf, sy + dy * tf, sz + dz * tf
            angle = u2 * (2.0 * vm.PI)
            mag = torch.sqrt(u3) * cam.aperture
            offc = torch.cos(angle) * mag
            offs = torch.sin(angle) * mag
            nsx = sx + (rt[0] * offc + up[0] * offs)
            nsy = sy + (rt[1] * offc + up[1] * offs)
            nsz = sz + (rt[2] * offc + up[2] * offs)
            ndx, ndy, ndz = _norm3(fx - nsx, fy - nsy, fz - nsz)
            zf = cam.z_far
            sx = torch.where(valid, nsx, sx)
            sy = torch.where(valid, nsy, sy)
            sz = torch.where(valid, nsz, sz)
            dx = torch.where(valid, ndx * zf, dx)
            dy = torch.where(valid, ndy * zf, dy)
            dz = torch.where(valid, ndz * zf, dz)

        return sx, sy, sz, dx, dy, dz, pix, smp

    return raygen


#: Packed camera parameters of the traced raygen: origin (3), target (3),
#: fov_y (degrees), aperture, focal_depth (pallas_path.py:1190-1192).
CAMERA_PARAM_COUNT = 9


def camera_pvec(camera):
    """A Camera's 9-vector for the traced raygen (float32, on its device)."""
    f = lambda x: torch.as_tensor(x, dtype=torch.float32).reshape(-1)  # noqa: E731
    return torch.cat([f(camera.origin), f(camera.target), f(camera.fov_y),
                      f(camera.aperture_size), f(camera.focal_depth)])


def camera_from_pvec(camera, pvec):
    """``camera`` with the 9-vector's values."""
    return camera._replace(origin=pvec[0:3], target=pvec[3:6], fov_y=pvec[6],
                           aperture_size=pvec[7], focal_depth=pvec[8])


class _KeepFinite(torch.autograd.Function):
    """Identity whose backward zeroes non-finite cotangents
    (pallas_path.py:1210-1230): the traced raygen reduces every lane's ray
    cotangent into 9 camera scalars, so one degenerate lane (a normalize at
    a grazing or invalid lens sample) must not poison them with NaN.  The
    reverse-mode kernel 8 zeroes a non-finite primary-segment cotangent the
    same way before the camera's adjoint, and the adjoint kernels zero a
    lane's non-finite gradient entries (csrc/fspt_adjoint.cu)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return torch.where(torch.isfinite(ct), ct, 0.0)


def build_traced_raygen(cam: HostCamera, cfg):
    """Primary rays from 9 camera tensors (pallas_path.py:1233-1334).

    The mirror of :func:`build_fused_raygen` whose basis, projection extents
    and focal plane are recomputed in float32 from the :data:`CAMERA_PARAM_COUNT`
    values, so autograd (or the kernels' tangents) carries camera-pose
    gradients.  ``cam`` supplies only ``z_far`` and whether the thin-lens
    code exists (``cam.aperture > 0``).  Its rays are not kernel 2's bit for
    bit: kernel 2 takes the basis from NumPy (:class:`HostCamera`).

    Returns ``raygen(cv, h0, sample0, lane0, n, device) → (sx, sy, sz, dx,
    dy, dz, pix, smp)``; ``cv`` is a sequence of 9 0-d float32 tensors.
    """
    width, spp = cfg.width, cfg.spp
    inv_wm1 = 1.0 / (cfg.width - 1)
    inv_hm1 = 1.0 / (cfg.height - 1)
    aspect = cfg.width / cfg.height
    zf = cam.z_far
    half_deg = 0.5 * (float(vm.PI) / 180.0)

    def raygen(cv, h0, sample0, lane0, n, device):
        ox, oy, oz, tx, ty, tz, fov_deg, aperture, focal = cv
        # Basis (engine.cpp:187-189, world up +Y): right = (fz, 0, -fx)/n.
        fx, fy, fz = tx - ox, ty - oy, tz - oz
        fin = torch.rsqrt(fx * fx + fy * fy + fz * fz)
        fx, fy, fz = fx * fin, fy * fin, fz * fin
        rin = torch.rsqrt(torch.clamp(fx * fx + fz * fz, min=1e-20))
        rx, ry, rz = fz * rin, torch.zeros_like(fz), -fx * rin
        ux = fy * rz - fz * ry
        uy = fz * rx - fx * rz
        uz = fx * ry - fy * rx
        # tan(fovx/2) = tan(fovy/2)·aspect exactly.
        th = torch.tan(fov_deg * half_deg)
        half_h = th * zf
        half_w = th * aspect * zf
        pox, poy, poz = ox + fx * zf, oy + fy * zf, oz + fz * zf

        flat = int(lane0) + torch.arange(n, dtype=torch.int64, device=device)
        s = torch.remainder(flat, spp)
        pxy = torch.div(flat, spp, rounding_mode="floor")
        x = torch.remainder(pxy, width)
        y = torch.div(pxy, width, rounding_mode="floor")
        pix = (y * width + x).to(torch.int32)
        smp = (s + int(sample0)).to(torch.int32)
        hs = rng.sample_hash(h0, pix, smp)
        u0 = rng.counter_uniform(hs, 0)
        u1 = rng.counter_uniform(hs, 1)
        xf = x.to(torch.float32) + (u0 - 0.5)
        yf = y.to(torch.float32) + (u1 - 0.5)
        x_dist = half_w * ((xf * inv_wm1) * 2.0 - 1.0)
        y_dist = half_h * ((yf * inv_hm1) * 2.0 - 1.0)
        stopx = pox + rx * x_dist + ux * y_dist
        stopy = poy + ry * x_dist + uy * y_dist
        stopz = poz + rz * x_dist + uz * y_dist
        one = torch.ones((n,), dtype=torch.float32, device=device)
        sx, sy, sz = ox * one, oy * one, oz * one
        dx, dy, dz = stopx - sx, stopy - sy, stopz - sz

        if cam.aperture > 0.0:
            # Thin-lens DoF (engine.cpp:221-244); the focal plane has normal
            # -forward through origin + forward·focal.
            u2 = rng.counter_uniform(hs, 2)
            u3 = rng.counter_uniform(hs, 3)
            qx, qy, qz = ox + fx * focal, oy + fy * focal, oz + fz * focal
            fpw = qx * fx + qy * fy + qz * fz
            ts = -(fx * dx + fy * dy + fz * dz)
            ns = -(-(fx * sx + fy * sy + fz * sz) + fpw)
            not_par = torch.abs(ts) >= vm.EPSILON
            tf = ns / torch.where(not_par, ts, 1.0)
            valid = not_par & (tf >= 0.0) & (tf <= 1.0)
            fxp, fyp, fzp = sx + dx * tf, sy + dy * tf, sz + dz * tf
            angle = u2 * (2.0 * vm.PI)
            mag = torch.sqrt(u3) * aperture
            offc = torch.cos(angle) * mag
            offs = torch.sin(angle) * mag
            nsx = sx + (rx * offc + ux * offs)
            nsy = sy + (ry * offc + uy * offs)
            nsz = sz + (rz * offc + uz * offs)
            ndx, ndy, ndz = _norm3(fxp - nsx, fyp - nsy, fzp - nsz)
            sx = torch.where(valid, nsx, sx)
            sy = torch.where(valid, nsy, sy)
            sz = torch.where(valid, nsz, sz)
            dx = torch.where(valid, ndx * zf, dx)
            dy = torch.where(valid, ndy * zf, dy)
            dz = torch.where(valid, ndz * zf, dz)

        keep = _KeepFinite.apply
        return keep(sx), keep(sy), keep(sz), keep(dx), keep(dy), keep(dz), pix, smp

    return raygen


def _sphere_uv(dx, dy, dz):
    """Sphere-map texcoords of a view direction (scene.cpp:157-162,
    intersect.cpp:779-784), with the reference's polynomial atan2."""
    mvx, mvy, mvz = _norm3(dx, dy, dz)
    return _atan2(mvx, mvz) / (2.0 * vm.PI) + 0.5, 1.0 - (mvy * 0.5 + 0.5)


def build_path_core(scene: HostScene, mats: HostMaterials, cfg, sky_idx: int,
                    z_far_default: float, deferred_tex: bool = False,
                    defer_all: bool = False, want_aovs: bool = True, tmats=None,
                    intersect=None, return_stepper: bool = False):
    """Plain version of the kernel path body (pallas_path.py:190).

    ``core(h0, sx, sy, sz, dx, dy, dz, pix, smp)`` over lane tensors; ``h0``
    is :func:`rng.seed_hash` of the seed.  Modes, as the reference's:

    * direct (default): returns ``(Lx, Ly, Lz, aov_nx, aov_ny, aov_nz,
      aov_depth, aov_mat, segcnt)`` (kernels 2-3).
    * ``deferred_tex``: the path is traced exactly, but each depth emits the
      affine structure of its radiance transfer instead of folding it:
      ``coef = tex·s + k`` and ``bias = tex·se + ke``, where ``tex`` is the
      texel of the slot's material row, or 1 (kernel 4).  Returns
      ``(slots, p_light, aov_nx, aov_ny, aov_nz, aov_depth, aov_mat,
      segcnt)``; ``slots`` is a list of per-depth dicts with float planes
      :data:`DEFERRED_TEX_FIELDS` and the int32 plane ``mat``.
    * ``defer_all`` (implies ``deferred_tex``): every radiometric table value
      is deferred: ``coef_c = value_c(mat)·s + k`` and ``bias_c =
      value_c(mat_e)·se``, with ``k`` channel-independent.  Slots have float
      planes ``s, k, se, u, v`` and int32 planes ``mat, mat_e`` (kernel 7).

    Both deferred modes append the fast-render white terminal as an extra
    slot, so they return :func:`n_slots` slots.  ``want_aovs=False`` skips
    the AOVs (the gradient kernels never read them); their planes then hold
    the defaults.

    ``tmats`` (direct mode) supplies the continuous material values: a
    MaterialTable of tensors, which may require grad (kernels 9-10 and 8's
    whole chain read these cells at run time).  ``None`` reads the NumPy
    snapshot ``mats`` as Python floats.  Branch structure (families, the
    regime flags, texture rows) always comes from ``mats``, as in the
    reference (pallas_path.py:215-218).  ``intersect(sx, sy, sz, dx, dy,
    dz, alive) → (t, nx, ny, nz, mat, kind, u, v)`` overrides the closest
    hit (default: :func:`ops.cuda_trace.intersect_lanes` on ``scene``);
    ``alive`` is the lanes' liveness, for an intersector that skips a dead
    lane's closest hit as a kernel does.

    ``return_stepper=True`` returns the same body as ``(init, step,
    finalize)`` (pallas_path.py:276-299, :710-768): ``init(h0, sx..dz, pix,
    smp) → state`` (a dict of lane planes), ``step(depth, state) → (state,
    slot or None)`` traces one bounce, ``finalize(state, slots) →
    outputs``; ``core`` is exactly ``finalize`` of the loop of ``step``
    over the depths.  The remat construction checkpoints ``step``.
    """
    if defer_all:
        deferred_tex = True
    if tmats is not None and deferred_tex:
        raise ValueError("tmats feeds the direct mode only")
    if intersect is None:
        def intersect(sx, sy, sz, dx, dy, dz, alive):
            return intersect_lanes(scene, sx, sy, sz, dx, dy, dz,
                                   want_texcoords=deferred_tex)
    depth_count = cfg.effective_depth
    ray_offset = cfg.ray_offset
    if tmats is None:
        sky_e = [float(x) for x in mats.emissive[sky_idx] * np.float32(3.0)]

        def value(field, row, c=None):
            v = getattr(mats, field)[row]
            return float(v if c is None else v[c])
    else:
        sky_e = [tmats.emissive[sky_idx][c] * 3.0 for c in range(3)]

        def value(field, row, c=None):
            v = getattr(tmats, field)[row]
            return v if c is None else v[c]
    sky_textured = deferred_tex and int(mats.tex_id[sky_idx]) >= 0
    seg_scale = z_far_default - ray_offset

    def init(h0, sx, sy, sz, dx, dy, dz, pix, smp):
        dev = sx.device
        zero = torch.zeros_like(sx)
        one = torch.ones_like(sx)
        false = torch.zeros(sx.shape, dtype=torch.bool, device=dev)
        return dict(
            sx=sx, sy=sy, sz=sz, dx=dx, dy=dy, dz=dz,
            Lx=zero, Ly=zero, Lz=zero, Tx=one, Ty=one, Tz=one,
            alive=~false, segcnt=torch.zeros(sx.shape, dtype=torch.int32, device=dev),
            f_active=false, f_fx=zero, f_fy=zero, f_fz=zero, f_dx=zero, f_dy=zero,
            f_dz=zero, f_dens=zero, f_u=zero,
            f_row=torch.full(sx.shape, -1, dtype=torch.int32, device=dev),
            aov_nx=zero, aov_ny=zero, aov_nz=zero, aov_d=zero,
            aov_m=torch.full(sx.shape, sky_idx, dtype=torch.int32, device=dev),
            p_light=false, hs=rng.sample_hash(h0, pix, smp))

    def step(depth, st):
        sx, sy, sz, dx, dy, dz = (st[k] for k in ("sx", "sy", "sz", "dx", "dy", "dz"))
        Lx, Ly, Lz, Tx, Ty, Tz = (st[k] for k in ("Lx", "Ly", "Lz", "Tx", "Ty", "Tz"))
        alive, f_active = st["alive"], st["f_active"]
        f_fx, f_fy, f_fz = st["f_fx"], st["f_fy"], st["f_fz"]
        f_dx, f_dy, f_dz = st["f_dx"], st["f_dy"], st["f_dz"]
        f_dens, f_u, f_row = st["f_dens"], st["f_u"], st["f_row"]
        aov_nx, aov_ny, aov_nz = st["aov_nx"], st["aov_ny"], st["aov_nz"]
        aov_d, aov_m, p_light, hs = st["aov_d"], st["aov_m"], st["p_light"], st["hs"]
        dev = sx.device
        zero = torch.zeros_like(sx)
        one = torch.ones_like(sx)
        false = torch.zeros(sx.shape, dtype=torch.bool, device=dev)
        minus1 = torch.full(sx.shape, -1, dtype=torch.int32, device=dev)

        segcnt = st["segcnt"] + alive.to(torch.int32)
        # Slot defaults: k = 1 keeps an inactive lane's throughput.
        sl_s, sl_se, sl_u, sl_v = zero, zero, zero, zero
        sl_k = [one, one, one]
        sl_ke = [zero, zero, zero]
        sl_mat = sl_mat_e = minus1

        t, hnx, hny, hnz, hmat, _, huu, hvv = intersect(sx, sy, sz, dx, dy, dz, alive)
        hit = t < INVALID_PARAM
        px, py, pz = sx + dx * t, sy + dy * t, sz + dz * t

        # Backface flip (scene.cpp:238-247).
        flip = hnx * (sx - px) + hny * (sy - py) + hnz * (sz - pz) < 0.0
        hnx = torch.where(flip, -hnx, hnx)
        hny = torch.where(flip, -hny, hny)
        hnz = torch.where(flip, -hnz, hnz)

        if depth >= 1:
            # Depth-0 fog resolution one bounce later (material.cpp:330-337).
            ddx = torch.where(hit, px, sx + dx) - f_fx
            ddy = torch.where(hit, py, sy + dy) - f_fy
            ddz = torch.where(hit, pz, sz + dz) - f_fz
            dist2 = ddx * ddx + ddy * ddy + ddz * ddz
            thresh = torch.clamp(dist2 * f_dens * 0.00005, 0.0, 1.0)
            absorbed = f_active & (f_u < thresh) & alive
            if defer_all:
                # Bias event on the fog row's (diffuse) column.
                sl_se = torch.where(absorbed, 1.0, sl_se)
                sl_mat_e = torch.where(absorbed, f_row, sl_mat_e)
            elif deferred_tex:
                sl_ke = [torch.where(absorbed, f, k) for f, k in
                         zip((f_dx, f_dy, f_dz), sl_ke)]
            else:
                Lx = torch.where(absorbed, Lx + Tx * f_dx, Lx)
                Ly = torch.where(absorbed, Ly + Ty * f_dy, Ly)
                Lz = torch.where(absorbed, Lz + Tz * f_dz, Lz)
            alive = alive & ~absorbed
            f_active = false

        # Miss → sky (engine.cpp:92-101).
        miss = alive & ~hit
        if deferred_tex and (defer_all or sky_textured):
            # Bias event: sky emission ×3, or its sphere-mapped texel.
            sl_se = torch.where(miss, 3.0, sl_se)
            if defer_all:
                sl_mat_e = torch.where(miss, sky_idx, sl_mat_e)
            else:
                sl_mat = torch.where(miss, sky_idx, sl_mat)
            if sky_textured:
                sku, skv = _sphere_uv(dx, dy, dz)
                sl_u = torch.where(miss, sku, sl_u)
                sl_v = torch.where(miss, skv, sl_v)
        elif deferred_tex:
            sl_ke = [torch.where(miss, e, k) for e, k in zip(sky_e, sl_ke)]
        else:
            Lx = torch.where(miss, Lx + Tx * sky_e[0], Lx)
            Ly = torch.where(miss, Ly + Ty * sky_e[1], Ly)
            Lz = torch.where(miss, Lz + Tz * sky_e[2], Lz)

        active = alive & hit
        vx, vy, vz = _norm3(px - sx, py - sy, pz - sz)
        base = rng.CTR_BOUNCE + depth * cfg.bounce_slots
        u0, u1, u2, u3 = (rng.counter_uniform(hs, base + k) for k in range(4))

        ndv = hnx * vx + hny * vy + hnz * vz
        rx, ry, rz = vx - 2.0 * ndv * hnx, vy - 2.0 * ndv * hny, vz - 2.0 * ndv * hnz
        gz = 1.0 - 2.0 * u1
        gr = torch.sqrt(torch.clamp(1.0 - gz * gz, min=0.0))
        phi = (2.0 * vm.PI) * u2
        gx, gy = gr * torch.cos(phi), gr * torch.sin(phi)
        gflip = gx * hnx + gy * hny + gz * hnz < 0.0
        gx = torch.where(gflip, -gx, gx)
        gy = torch.where(gflip, -gy, gy)
        gz = torch.where(gflip, -gz, gz)

        def lerped(amount):
            inv = _one_minus(amount)
            ox, oy, oz = _norm3(gx * amount + rx * inv, gy * amount + ry * inv,
                                gz * amount + rz * inv)
            neg = ox * hnx + oy * hny + oz * hnz < 0.0
            return (torch.where(neg, -ox, ox), torch.where(neg, -oy, oy),
                    torch.where(neg, -oz, oz))

        bx = by = bz = cx = cy = cz = ex = ey = ez = zero
        will = is_light = is_fog = false
        fog_dens = fog_cx = fog_cy = fog_cz = zero

        for row in range(mats.count):
            msk = active & (hmat == row)
            mtype = int(mats.mtype[row])
            flags = mats.flags(row)
            # Deferred coefficient (s, k0, k1, k2) of a textured row, or of
            # every row in defer_all; None keeps the full coefficient in k.
            tex_row = deferred_tex and int(mats.tex_id[row]) >= 0
            defer_coef = tex_row or defer_all
            dsk = None
            d0, d1, d2 = (value("diffuse", row, c) for c in range(3))
            if mtype == M.LIGHT:
                if defer_all:
                    sl_se = torch.where(msk, 1.0, sl_se)
                    sl_mat_e = torch.where(msk, row, sl_mat_e)
                elif tex_row:
                    # Textured emission: bias = texel (material.cpp:38-44).
                    sl_se = torch.where(msk, 1.0, sl_se)
                else:
                    em = [value("emissive", row, c) for c in range(3)]
                    ex = torch.where(msk, em[0], ex)
                    ey = torch.where(msk, em[1], ey)
                    ez = torch.where(msk, em[2], ez)
                is_light = is_light | msk
                continue
            w = None
            if mtype == M.DIFFUSE:
                ox, oy, oz = gx, gy, gz
                ndl = ox * hnx + oy * hny + oz * hnz
                w = ndl > M.DIFFUSE_CONTRIB_THRESHOLD
                nl = torch.clamp(ndl, min=0.0)
                ccx, ccy, ccz = d0 * nl, d1 * nl, d2 * nl
                if defer_coef:
                    dsk = (nl, zero, zero, zero)
            elif mtype == M.METAL:
                rough = value("param", row)
                ox, oy, oz = lerped(rough)
                ndl = ox * hnx + oy * hny + oz * hnz
                w = (ndl > M.DIFFUSE_CONTRIB_THRESHOLD) | bool(flags & FLAG_METAL_SMOOTH)
                f = rough * torch.clamp(ndl, min=0.0) + _one_minus(rough)
                ccx, ccy, ccz = d0 * f, d1 * f, d2 * f
                if defer_coef:
                    dsk = (f, zero, zero, zero)
            elif mtype == M.MIRROR:
                ox, oy, oz = rx, ry, rz
                ccx, ccy, ccz = (_lanes(sx, d) for d in (d0, d1, d2))
                if defer_all:
                    dsk = (one, zero, zero, zero)
            elif mtype in (M.CERAMIC, M.GLOW):
                amount = torch.where(u0 < M.CERAMIC_SPIKE_PROB, 0.0,
                                     _one_minus(value("param", row)))
                ox, oy, oz = lerped(amount)
                nl = torch.clamp(ox * hnx + oy * hny + oz * hnz, min=0.0)
                hx, hy, hz = _norm3(ox - vx, oy - vy, oz - vz)
                hn = hx * hnx + hy * hny + hz * hnz
                spec = _pow25(hn * hn)
                ccx = spec + d0 * nl * (1.0 - spec)
                ccy = spec + d1 * nl * (1.0 - spec)
                ccz = spec + d2 * nl * (1.0 - spec)
                if defer_coef:
                    # The mirror spike is a constant: it lands in k.
                    dsk = (nl * (1.0 - spec), spec, spec, spec)
                if mtype == M.GLOW:
                    if defer_all:
                        sl_se = torch.where(msk, 1.0, sl_se)
                        sl_mat_e = torch.where(msk, row, sl_mat_e)
                    else:
                        gl = [value("glow", row, c) for c in range(3)]
                        ex = torch.where(msk, gl[0], ex)
                        ey = torch.where(msk, gl[1], ey)
                        ez = torch.where(msk, gl[2], ez)
            elif mtype == M.GLASS:
                refl = value("reflectivity", row)
                frost = value("frost", row)
                lrx, lry, lrz = lerped(frost)
                # random_refraction (normal.cpp:64-105).
                if flags & FLAG_GLASS_STRAIGHT:
                    fx0, fy0, fz0 = _norm3(vx, vy, vz)
                else:
                    fx0, fy0, fz0 = _refract(vx, vy, vz, hnx, hny, hnz,
                                             value("ior", row))
                if flags & FLAG_FROST_FULL:
                    qx, qy, qz = gx, gy, gz
                elif flags & FLAG_FROST_NONE:
                    qx, qy, qz = fx0, fy0, fz0
                else:
                    delta = (u3 * 2.0 - 1.0) * _half_spread(frost)
                    qx, qy, qz = _rotate(fx0, fy0, fz0, delta, gx, gy, gz)
                take_r = u0 < refl
                ox = torch.where(take_r, lrx, qx)
                oy = torch.where(take_r, lry, qy)
                oz = torch.where(take_r, lrz, qz)
                ccx, ccy, ccz = (_lanes(sx, d) for d in (d0, d1, d2))
                if defer_all:
                    dsk = (one, zero, zero, zero)
            elif mtype == M.LIQUID:
                qx, qy, qz = _refract(vx, vy, vz, hnx, hny, hnz, value("ior", row))
                take_r = u0 < value("reflectivity", row)
                ox = torch.where(take_r, rx, qx)
                oy = torch.where(take_r, ry, qy)
                oz = torch.where(take_r, rz, qz)
                ccx, ccy, ccz = (_lanes(sx, d) for d in (d0, d1, d2))
                if defer_all:
                    dsk = (one, zero, zero, zero)
            elif mtype == M.FOG:
                ox, oy, oz = vx, vy, vz
                ccx = ccy = ccz = one
                is_fog = is_fog | msk
                fog_dens = torch.where(msk, value("frost", row), fog_dens)
                fog_cx = torch.where(msk, d0, fog_cx)
                fog_cy = torch.where(msk, d1, fog_cy)
                fog_cz = torch.where(msk, d2, fog_cz)
            else:
                raise ValueError(f"unknown material type {mtype}")

            bx = torch.where(msk, ox, bx)
            by = torch.where(msk, oy, by)
            bz = torch.where(msk, oz, bz)
            if not deferred_tex:
                cx = torch.where(msk, ccx, cx)
                cy = torch.where(msk, ccy, cy)
                cz = torch.where(msk, ccz, cz)
            elif dsk is None:
                sl_k = [torch.where(msk, c, k) for c, k in zip((ccx, ccy, ccz), sl_k)]
            else:
                sl_s = torch.where(msk, dsk[0], sl_s)
                sl_k = [torch.where(msk, c, k) for c, k in zip(dsk[1:], sl_k)]
            will = will | (msk if w is None else msk & w)

        if depth == 0:
            if want_aovs:
                anx = torch.where(hit, hnx, dx)
                any_ = torch.where(hit, hny, dy)
                anz = torch.where(hit, hnz, dz)
                nx0, ny0, nz0 = _norm3(anx, any_, anz)
                aov_nx = torch.where(hit, anx, nx0)
                aov_ny = torch.where(hit, any_, ny0)
                aov_nz = torch.where(hit, anz, nz0)
                dpx, dpy, dpz = px - sx, py - sy, pz - sz
                aov_d = torch.where(hit, torch.sqrt(dpx * dpx + dpy * dpy + dpz * dpz),
                                    z_far_default)
                aov_m = torch.where(hit, hmat, sky_idx).to(torch.int32)
            p_light = hit & is_light
            mark = active & is_fog
            f_active = mark
            f_fx = torch.where(mark, px, f_fx)
            f_fy = torch.where(mark, py, f_fy)
            f_fz = torch.where(mark, pz, f_fz)
            f_dx = torch.where(mark, fog_cx, f_dx)
            f_dy = torch.where(mark, fog_cy, f_dy)
            f_dz = torch.where(mark, fog_cz, f_dz)
            f_dens = torch.where(mark, fog_dens, f_dens)
            f_u = torch.where(mark, u3, f_u)
            f_row = torch.where(mark, hmat, f_row)

        slot = None
        if deferred_tex:
            sl_mat = torch.where(active, hmat, sl_mat)
            sl_u = torch.where(active, huu, sl_u)
            sl_v = torch.where(active, hvv, sl_v)
        if defer_all:
            slot = dict(s=sl_s, k=sl_k[0], se=sl_se, u=sl_u, v=sl_v, mat=sl_mat,
                        mat_e=sl_mat_e)
        elif deferred_tex:
            # Untextured emission (lights, glow): the active lanes are
            # disjoint from the fog and sky events above.
            sl_ke = [torch.where(active, e, k) for e, k in zip((ex, ey, ez), sl_ke)]
            slot = dict(s=sl_s, k0=sl_k[0], k1=sl_k[1], k2=sl_k[2], se=sl_se,
                        ke0=sl_ke[0], ke1=sl_ke[1], ke2=sl_ke[2], u=sl_u, v=sl_v,
                        mat=sl_mat)
        else:
            Lx = torch.where(active, Lx + Tx * ex, Lx)
            Ly = torch.where(active, Ly + Ty * ey, Ly)
            Lz = torch.where(active, Lz + Tz * ez, Lz)
            Tx = torch.where(active, Tx * cx, Tx)
            Ty = torch.where(active, Ty * cy, Ty)
            Tz = torch.where(active, Tz * cz, Tz)
        sx = torch.where(active, px + bx * ray_offset, sx)
        sy = torch.where(active, py + by * ray_offset, sy)
        sz = torch.where(active, pz + bz * ray_offset, sz)
        dx = torch.where(active, bx * seg_scale, dx)
        dy = torch.where(active, by * seg_scale, dy)
        dz = torch.where(active, bz * seg_scale, dz)
        alive = active & will
        return dict(sx=sx, sy=sy, sz=sz, dx=dx, dy=dy, dz=dz, Lx=Lx, Ly=Ly, Lz=Lz,
                    Tx=Tx, Ty=Ty, Tz=Tz, alive=alive, segcnt=segcnt, f_active=f_active,
                    f_fx=f_fx, f_fy=f_fy, f_fz=f_fz, f_dx=f_dx, f_dy=f_dy, f_dz=f_dz,
                    f_dens=f_dens, f_u=f_u, f_row=f_row, aov_nx=aov_nx, aov_ny=aov_ny,
                    aov_nz=aov_nz, aov_d=aov_d, aov_m=aov_m, p_light=p_light,
                    hs=hs), slot

    def finalize(st, slots):
        alive, p_light, segcnt = st["alive"], st["p_light"], st["segcnt"]
        Lx, Ly, Lz, Tx, Ty, Tz = (st[k] for k in ("Lx", "Ly", "Lz", "Tx", "Ty", "Tz"))
        aovs = (st["aov_nx"], st["aov_ny"], st["aov_nz"], st["aov_d"], st["aov_m"])
        slots = list(slots)
        if cfg.fast_render:
            # White terminal (engine.cpp:67-70); an extra slot when deferred.
            zero = torch.zeros_like(Lx)
            one = torch.ones_like(Lx)
            minus1 = torch.full(Lx.shape, -1, dtype=torch.int32, device=Lx.device)
            wht = torch.where(alive, 1.0, 0.0)
            if defer_all:
                slots.append(dict(s=zero, k=one, se=wht, u=zero, v=zero,
                                  mat=minus1, mat_e=minus1))
            elif deferred_tex:
                slots.append(dict(s=zero, k0=one, k1=one, k2=one, se=zero,
                                  ke0=wht, ke1=wht, ke2=wht, u=zero, v=zero,
                                  mat=minus1))
            else:
                Lx = torch.where(alive, Lx + Tx, Lx)
                Ly = torch.where(alive, Ly + Ty, Ly)
                Lz = torch.where(alive, Lz + Tz, Lz)

        if deferred_tex:
            return (slots, p_light, *aovs, segcnt)
        # Depth-0 light tone clamp (engine.cpp:148-151).
        return (*_light_clamp(cfg, Lx, Ly, Lz, p_light), *aovs, segcnt)

    if return_stepper:
        return init, step, finalize

    def core(h0, sx, sy, sz, dx, dy, dz, pix, smp):
        st = init(h0, sx, sy, sz, dx, dy, dz, pix, smp)
        slots = []
        for depth in range(depth_count):
            st, slot = step(depth, st)
            if slot is not None:
                slots.append(slot)
        return finalize(st, slots)

    return core


def _light_clamp(cfg, Lx, Ly, Lz, p_light):
    """Depth-0 light tone clamp (engine.cpp:148-151)."""
    norm = torch.sqrt(torch.clamp(Lx * Lx + Ly * Ly + Lz * Lz, min=1e-20))
    s = torch.where(p_light & (norm > cfg.light_clamp), cfg.light_clamp / norm, 1.0)
    return Lx * s, Ly * s, Lz * s


def _row_gather(table, rows, valid):
    """``table[rows]`` as three planes, 0 where ``valid`` is false.  The
    index is clamped before the gather, so no negative or out-of-range row
    reaches ``index_select``; its autograd is an ``index_add``."""
    safe = torch.where(valid, rows, 0).long()
    picked = torch.index_select(table, 0, safe.reshape(-1)).reshape(*rows.shape, -1)
    return tuple(torch.where(valid, picked[..., c], 0.0) for c in range(picked.shape[-1]))


def fold_deferred_radiance(table, tex, cfg, s, k0, k1, k2, se, ke0, ke1, ke2,
                           u, v, mat, p_light):
    """Fold of the texture-deferred slots (pallas_path.py:867).

    Slot fields are ``[S, N]`` planes.  Per slot, the texel ``t =
    texture(tex_id[mat], uv)`` (1 where the row has no texture, and where
    ``s``/``se`` are zero anyway) folds ``L += T·(t·se + ke); T *= (t·s +
    k)``; then the depth-0 light tone clamp (engine.cpp:148-151).
    Differentiable with respect to ``tex.texels``.
    """
    n = s.shape[1]
    one = torch.ones((n,), dtype=torch.float32, device=s.device)
    Tx = Ty = Tz = one
    Lx = Ly = Lz = torch.zeros((n,), dtype=torch.float32, device=s.device)
    last = table.count - 1
    for d in range(s.shape[0]):
        m = mat[d]
        safe = torch.clamp(m, 0, last).long()
        tid = torch.where(m >= 0, table.tex_id[safe], -1)
        t0, t1, t2 = M.sample_texture_p(tex, tid, table.tex_scale[safe], u[d], v[d],
                                        one, one, one)
        Lx = Lx + Tx * (t0 * se[d] + ke0[d])
        Ly = Ly + Ty * (t1 * se[d] + ke1[d])
        Lz = Lz + Tz * (t2 * se[d] + ke2[d])
        Tx = Tx * (t0 * s[d] + k0[d])
        Ty = Ty * (t1 * s[d] + k1[d])
        Tz = Tz * (t2 * s[d] + k2[d])
    return _light_clamp(cfg, Lx, Ly, Lz, p_light)


def bias_table(bias, diffuse, emissive, glow):
    """The ``[M,3]`` values a bias event reads per row: emissive (lights,
    sky), glow (Glow) or diffuse (Fog), as pallas_path.py:922-926 picks
    them, by ``bias``, the ``[M,1]`` bias column on the values' device
    (:attr:`PathBody.bias`)."""
    return torch.where(bias == 1, glow, torch.where(bias == 2, diffuse, emissive))


def fold_deferred_params(mats: HostMaterials, bias, cfg, diffuse, emissive, glow, tex,
                         s, k, se, mat_c, mat_e, u, v, p_light):
    """Fold of the ``defer_all`` slots (pallas_path.py:905); ``bias`` is
    the table's ``[M,1]`` bias column on the planes' device
    (:attr:`PathBody.bias`).

    Slot fields are ``[S, N]`` planes.  Per depth, the coefficient value
    ``tc = texture(mat_c) | diffuse[mat_c]`` (0 where ``mat_c < 0``) and the
    bias value ``te = texture(mat_e) | bias_table[mat_e]`` (1 where
    ``mat_e < 0``: the fast-render white slot) fold ``L += T·(te·se); T *=
    (tc·s + k)``; then the depth-0 light tone clamp.  Differentiable with
    respect to ``diffuse``, ``emissive``, ``glow`` and ``tex.texels``.

    The reference selects rows with a static lattice of ``where``s, because
    a TPU gather's transpose is a serialized scatter; here rows are an
    indexed gather (:func:`_row_gather`), whose transpose is an
    ``index_add``.  A row outside the table reads 0, as there.
    """
    count = mats.count
    e_tab = bias_table(bias, diffuse, emissive, glow)
    dev = s.device
    any_tex = mats.any_textured
    if any_tex:
        tid_tab = torch.from_numpy(mats.tex_id).to(dev)
        tsc_tab = torch.from_numpy(mats.tex_scale.astype(np.float32)).to(dev)

    def values(table, mid, u_d, v_d):
        valid = (mid >= 0) & (mid < count)
        out = _row_gather(table, mid, valid)
        if any_tex:
            safe = torch.where(valid, mid, 0).long()
            tid = torch.where(valid, tid_tab[safe], -1)
            out = M.sample_texture_p(tex, tid, tsc_tab[safe], u_d, v_d, *out)
        return out

    n = s.shape[1]
    one = torch.ones((n,), dtype=torch.float32, device=dev)
    Tx = Ty = Tz = one
    Lx = Ly = Lz = torch.zeros((n,), dtype=torch.float32, device=dev)
    for d in range(s.shape[0]):
        tc0, tc1, tc2 = values(diffuse, mat_c[d], u[d], v[d])
        te0, te1, te2 = values(e_tab, mat_e[d], u[d], v[d])
        has_e = mat_e[d] >= 0
        te0 = torch.where(has_e, te0, 1.0)
        te1 = torch.where(has_e, te1, 1.0)
        te2 = torch.where(has_e, te2, 1.0)
        Lx = Lx + Tx * (te0 * se[d])
        Ly = Ly + Ty * (te1 * se[d])
        Lz = Lz + Tz * (te2 * se[d])
        Tx = Tx * (tc0 * s[d] + k[d])
        Ty = Ty * (tc1 * s[d] + k[d])
        Tz = Tz * (tc2 * s[d] + k[d])
    return _light_clamp(cfg, Lx, Ly, Lz, p_light)


# --- kernel wrappers -------------------------------------------------------


def _floats(values):
    return (ctypes.c_float * len(values))(*map(float, values))


def _path_outputs(n, dev):
    return (torch.empty((n, 3), dtype=torch.float32, device=dev),
            torch.empty((n, 3), dtype=torch.float32, device=dev),
            torch.empty((n,), dtype=torch.float32, device=dev),
            torch.empty((n,), dtype=torch.int32, device=dev),
            torch.empty((n,), dtype=torch.int32, device=dev))


def _trace_output(radiance, normal, depth, mat, segcnt) -> TraceOutput:
    return TraceOutput(radiance=radiance, aov_normal=normal, aov_depth=depth,
                       aov_mat=mat, segments=segcnt.sum())


def planes_to_output(outs) -> TraceOutput:
    """The plain core's planes as a TraceOutput."""
    lx, ly, lz, anx, any_, anz, ad, am, segc = outs
    return _trace_output(torch.stack([lx, ly, lz], dim=-1),
                         torch.stack([anx, any_, anz], dim=-1), ad, am, segc)


def stack_slots(slots, names):
    """Per-depth slot dicts → one ``[len(names), S, N]`` tensor."""
    return torch.stack([torch.stack([sl[nm] for sl in slots]) for nm in names])


class DeferredPlanes(NamedTuple):
    """The plain version of kernel 4 before its fold: ``fields [10, S, N]``
    float32 in :data:`DEFERRED_TEX_FIELDS` order, ``mat [S, N]`` int32, and
    the lane planes."""

    fields: torch.Tensor
    mat: torch.Tensor
    p_light: torch.Tensor  # [N] bool
    normal: torch.Tensor  # [N,3]
    depth: torch.Tensor  # [N]
    aov_mat: torch.Tensor  # [N] int32
    segcnt: torch.Tensor  # [N] int32


class PathBody:
    """The host side of the path body that kernels 2-4, 7-10 and 13 share,
    made once per tracer or gradient function.

    The scene, checked once: ``scene`` (HostScene), ``mats``
    (HostMaterials), ``sky_idx``, ``cam`` (HostCamera; None for kernel 3,
    whose rays come in, which gives ``z_far`` instead) and ``dev`` (the
    scene's device, cpu or cuda).  ``bias`` is the ``[M,1]`` column of
    :meth:`HostMaterials.bias_column` on ``dev``, which kernel 8 affine's
    wrapper and kernel 7's fold read: copied to the card here, once, since
    a copy from host memory in a call would wait for the card.  The facts
    a factory picks its kernel by: ``bvh`` (the scene has a BVH: kernel
    13's), ``textured`` (a material row has a texture) and ``fits`` (at
    most MAX_SPECIALIZED_PRIMS primitive rows; past it the reference takes
    its general path).

    The card side: the launch head every path-body launcher takes first —
    the four table pointers, PathParams and, with a camera, CamParams —
    made once a device (:meth:`head`), and :meth:`launch`.  The plain side,
    which the tests hold the kernels against: ``raygen``
    (:func:`build_fused_raygen`, with a camera) and :meth:`core`
    (:func:`build_path_core` over the scene).
    """

    def __init__(self, scene_pack, camera, cfg, z_far: float | None = None):
        dev = scene_pack.device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {dev}")
        self.dev, self.cfg = dev, cfg
        self.scene = HostScene(scene_pack.geometry)
        self.mats = mats = HostMaterials(scene_pack.materials)
        self.bias = torch.from_numpy(mats.bias_column()).to(dev)[:, None]
        self.sky_idx = int(scene_pack.sky_mat)
        self.bvh = scene_pack.bvh is not None
        self.textured = mats.any_textured
        self.fits = self.scene.prim_count <= MAX_SPECIALIZED_PRIMS
        self.cam = cam = None if camera is None else HostCamera(camera, cfg.width, cfg.height)
        self.z_far = float(z_far) if cam is None else cam.z_far
        self.raygen = None if cam is None else build_fused_raygen(cam, cfg)
        self.params = (_build.PathParams(
            ray_offset=cfg.ray_offset,
            seg_scale=float(np.float32(self.z_far - cfg.ray_offset)),
            z_far=self.z_far,
            light_clamp=cfg.light_clamp,
            sky_e=_floats(mats.emissive[self.sky_idx] * np.float32(3.0)),
            depth=cfg.effective_depth,
            bounce_slots=cfg.bounce_slots,
            sky_idx=self.sky_idx,
            fast_render=int(cfg.fast_render),
            n_prims=self.scene.prim_count,
            n_mats=mats.count,
        ),)
        if cam is not None:
            self.params += (_build.CamParams(
                origin=_floats(cam.origin), proj_origin=_floats(cam.proj_origin),
                right=_floats(cam.right), up=_floats(cam.up),
                focal_plane=_floats(cam.focal_plane),
                half_w=cam.half_w, half_h=cam.half_h,
                inv_wm1=1.0 / (cfg.width - 1), inv_hm1=1.0 / (cfg.height - 1),
                aperture=cam.aperture, z_far=cam.z_far,
                width=cfg.width, spp=cfg.spp, dof=int(cam.aperture > 0.0),
            ),)
        self._heads = {}

    def head(self, dev=None) -> tuple:
        """The launch head on ``dev`` (the scene's device by default), made
        on first use: the pointers of the tables, whose tensors ``scene``
        and ``mats`` keep for the body's life (hold the body while a launch
        reads them), then ``params``."""
        dev = self.dev if dev is None else dev
        if dev not in self._heads:
            tables = (*self.scene.tables(dev), *self.mats.tables(dev))
            self._heads[dev] = (*(t.data_ptr() for t in tables), *self.params)
        return self._heads[dev]

    def launch(self, counter: _build.KernelCounter, *tail, dev=None) -> None:
        """Launch ``counter``'s kernel with the head, ``tail`` and the current
        stream of ``dev`` (the scene's device by default)."""
        dev = self.dev if dev is None else dev
        _build.launch(counter, *self.head(dev), *tail,
                      torch.cuda.current_stream(dev).cuda_stream)

    def frame(self, counter, seed, sample0, lane0, n, pre=(), post=()) -> TraceOutput:
        """One launch of a camera-fused kernel (2, 4 or 13) over the frame
        lanes ``lane0 .. lane0+n-1``, into new output planes: ``pre`` are
        the launcher's arguments between the head and the seed's hash,
        ``post`` those after the outputs."""
        outs = _path_outputs(n, self.dev)
        self.launch(counter, *pre, rng.seed_hash(seed), int(sample0), int(lane0), n,
                    *(o.data_ptr() for o in outs), *post)
        return _trace_output(*outs)

    def core(self, **modes):
        """:func:`build_path_core` over the scene in ``modes``."""
        return build_path_core(self.scene, self.mats, self.cfg, self.sky_idx, self.z_far,
                               **modes)


def _frame_tracer(body: PathBody, kernel, plain, card):
    """``trace(seed, sample0, lane0=0, n_lanes=None) → TraceOutput`` over
    the frame lanes ``lane0 .. lane0+n_lanes-1`` (the whole H×W×spp frame by
    default), inside the ``fspt.trace`` span: ``plain(seed, sample0, lane0,
    n)`` for a scene on the CPU, else ``card(...)``.  ``trace.kernel`` is
    the KernelCounter of the kernel it stands for."""
    cfg = body.cfg
    run = plain if body.dev.type == "cpu" else card

    def trace(seed, sample0, lane0=0, n_lanes=None):
        with profiling.span("fspt.trace"):
            n = n_lanes if n_lanes is not None else cfg.height * cfg.width * cfg.spp
            return run(seed, sample0, lane0, n)

    trace.kernel = kernel
    return trace


def make_camera_path_tracer(scene_pack, camera, cfg):
    """The camera-fused path tracer for a fixed camera: kernel 2, kernel 4
    for a textured scene (pallas_path.py:1362-1365), or kernel 13 for an
    untextured BVH scene (:func:`_make_mesh_camera_tracer`).

    Returns ``trace(seed, sample0, lane0=0, n_lanes=None) → TraceOutput``
    over lanes ``lane0 .. lane0+n_lanes-1`` of the H×W×spp frame, or None
    for a textured BVH scene or one over 512 primitive rows.  A scene on the
    CPU runs the plain version; a scene on the card launches the kernel.
    ``trace.kernel`` is the kernel's KernelCounter.
    """
    body = PathBody(scene_pack, camera, cfg)
    if not body.fits:
        return None
    if body.bvh:
        return _make_mesh_camera_tracer(scene_pack, body)
    if body.textured:
        return _make_deferred_camera_tracer(scene_pack, body)
    core = body.core()

    def plain(seed, sample0, lane0, n):
        h0 = rng.seed_hash(seed)
        return planes_to_output(core(h0, *body.raygen(h0, sample0, lane0, n, body.dev)))

    def card(seed, sample0, lane0, n):
        return body.frame(CAMERA_PATH, seed, sample0, lane0, n)

    return _frame_tracer(body, CAMERA_PATH, plain, card)


def _make_deferred_camera_tracer(scene_pack, body: PathBody):
    """Texture-deferred camera-fused tracer (kernel 4).

    On the card ``trace`` is one launch: the kernel traces the exact path,
    fetches each depth's texel and folds it in (the order of
    :func:`fold_deferred_radiance`), then applies the light clamp.  It
    gives no texel gradient: texels that require grad are refused, since
    texel recovery goes through ``cuda_grad.make_affine_grad_image_fn``
    (kernel 7).  ``trace.plain_planes(seed, sample0, lane0, n) →
    DeferredPlanes`` (the per-depth slot planes) and ``trace.fold`` (planes
    → ``TraceOutput``) are the plain version, run on any device; on the CPU
    ``trace`` is ``fold(plain_planes(...))``.
    """
    cfg, dev = body.cfg, body.dev
    core = body.core(deferred_tex=True)
    tex_scale = torch.from_numpy(body.mats.tex_scale.astype(np.float32)).to(dev)

    def plain_planes(seed, sample0, lane0, n) -> DeferredPlanes:
        h0 = rng.seed_hash(seed)
        slots, p_light, anx, any_, anz, ad, am, segc = core(
            h0, *body.raygen(h0, sample0, lane0, n, dev))
        return DeferredPlanes(
            fields=stack_slots(slots, DEFERRED_TEX_FIELDS),
            mat=torch.stack([sl["mat"] for sl in slots]), p_light=p_light,
            normal=torch.stack([anx, any_, anz], dim=-1), depth=ad, aov_mat=am,
            segcnt=segc)

    def fold(p: DeferredPlanes) -> TraceOutput:
        Lx, Ly, Lz = fold_deferred_radiance(scene_pack.materials, scene_pack.textures,
                                            cfg, *p.fields, p.mat, p.p_light)
        return _trace_output(torch.stack([Lx, Ly, Lz], dim=-1), p.normal, p.depth,
                             p.aov_mat, p.segcnt)

    def tex_pack() -> _build.TexPack:
        tex = scene_pack.textures
        if tex.texels.requires_grad:
            raise ValueError(
                "kernel 4 folds the texels inside the kernel and gives them no gradient; "
                "recover texels through cuda_grad.make_affine_grad_image_fn (kernel 7)")
        k, t = tex.texels.shape[0], tex.offset.shape[0]
        _build.check_cuda_tensor("texels", tex.texels, torch.float32, (k, 3), dev)
        for name in ("offset", "width", "height"):
            _build.check_cuda_tensor(name, getattr(tex, name), torch.int32, (t,), dev)
        return _build.TexPack(texels=tex.texels.data_ptr(), offset=tex.offset.data_ptr(),
                              width=tex.width.data_ptr(), height=tex.height.data_ptr(),
                              scale=tex_scale.data_ptr(), n_texels=k)

    def card(seed, sample0, lane0, n):
        return body.frame(DEFERRED_PATH, seed, sample0, lane0, n, pre=(tex_pack(),))

    trace = _frame_tracer(body, DEFERRED_PATH, lambda *a: fold(plain_planes(*a)), card)
    trace.plain_planes = plain_planes
    trace.fold = fold
    return trace


def mesh_shade(tri_shade) -> torch.Tensor:
    """Kernel 13's ``[T, 12]`` float32 shade records of a TriShade, by
    original triangle id: ``(n0, bits(mat))``, ``(n1 − n0, 0)``, ``(n2 − n0,
    0)``, the differences rounded as :func:`render.integrator.
    merge_triangle_hit` rounds them."""
    zero = torch.zeros_like(tri_shade.n0[:, :1])
    mat = tri_shade.mat.to(torch.int32).view(torch.float32)[:, None]
    return torch.cat([tri_shade.n0, mat, tri_shade.n1 - tri_shade.n0, zero,
                      tri_shade.n2 - tri_shade.n0, zero], dim=1).contiguous()


def plain_mesh_intersect(scene: HostScene, bvh, shade, totals):
    """The plain version of kernel 13's closest hit, for
    :func:`build_path_core`'s ``intersect``: the rows
    (:func:`ops.cuda_trace.intersect_lanes`), then :func:`ops.bvh.walk_bvh`
    over ``bvh`` seeded with their t (0 on a dead lane, which walks
    nothing), the triangle winner's normal and material from ``shade``
    (:func:`mesh_shade`).  Adds the live lanes' node steps and triangle
    tests to ``totals`` (``[2]`` int64), as the kernel counts them."""
    from fspt_tpu_torch.ops.bvh import walk_bvh

    n0, d1, d2 = shade[:, 0:3], shade[:, 4:7], shade[:, 8:11]
    tri_mat = shade[:, 3].contiguous().view(torch.int32)

    def intersect(sx, sy, sz, dx, dy, dz, alive):
        t, nx, ny, nz, mat, kind, u, v = intersect_lanes(scene, sx, sy, sz, dx, dy, dz,
                                                         want_texcoords=False)
        start = torch.stack([sx, sy, sz], dim=-1)
        seg = torch.stack([dx, dy, dz], dim=-1)
        tt, tid, bu, bv, visits, tested = walk_bvh(bvh, start, seg, torch.where(alive, t, 0.0))
        totals[0] += visits.sum()
        totals[1] += tested.sum()
        win = tid >= 0
        idx = torch.clamp(tid, min=0).long()
        n = [n0[idx, c] + d1[idx, c] * bu + d2[idx, c] * bv for c in range(3)]
        return (torch.where(win, tt, t), torch.where(win, n[0], nx),
                torch.where(win, n[1], ny), torch.where(win, n[2], nz),
                torch.where(win, tri_mat[idx], mat), torch.where(win, KIND_TRIANGLE, kind),
                u, v)

    return intersect


def _make_mesh_camera_tracer(scene_pack, body: PathBody):
    """Kernel 13: the camera-fused tracer of an untextured BVH scene, or
    None for a textured one (kernel 4 is the textured form, and walks no
    tree) or ``edge_eps`` (the edge reparameterization rides the queue).

    The tree is the scene's own BVH (``scene_pack.bvh``) in kernel 11's
    packed records (:func:`ops.cuda_bvh.bvh_walk_tables`), built once here;
    the shade records come from its TriShade.  On the card ``trace`` is one
    launch of the build that counts nothing, and its output's ``walk`` is
    None.  ``trace.counted`` (same arguments) launches the build that counts
    the walk: its output's ``walk`` holds the BVH node steps and triangle
    tests of the segments (``[2]`` int64 on the card, read with the
    segments), its ``phases`` the walk's warp-wide leaf phases, the leaves
    tested in them and the warp walks (``[3]`` int64), and its frame is
    6-7 % longer on an H100 (PERF.md §6).  ``trace.plain(seed, sample0,
    lane0, n)`` is the plain version on any device, :func:`build_path_core` over
    :func:`plain_mesh_intersect`, always with the walk's totals and never
    with ``phases`` (a plain walk has no warps); on the CPU ``trace`` and
    ``trace.counted`` run it, and ``trace`` drops the totals.
    """
    from fspt_tpu_torch.ops import cuda_bvh

    if body.textured or body.cfg.edge_eps != 0.0:
        return None
    dev = body.dev
    tables = cuda_bvh.bvh_walk_tables(scene_pack.bvh)
    shade = mesh_shade(scene_pack.tri_shade)

    def plain(seed, sample0, lane0, n) -> TraceOutput:
        h0 = rng.seed_hash(seed)
        totals = torch.zeros((2,), dtype=torch.int64, device=dev)
        core = body.core(intersect=plain_mesh_intersect(body.scene, scene_pack.bvh, shade,
                                                        totals))
        out = planes_to_output(core(h0, *body.raygen(h0, sample0, lane0, n, dev)))
        return out._replace(walk=totals)

    def card(count):
        def run(seed, sample0, lane0, n):
            totals = torch.empty((MESH_TOTALS,), dtype=torch.int64, device=dev) if count else None
            out = body.frame(MESH_CAMERA_PATH, seed, sample0, lane0, n,
                             pre=(tables.nodes.data_ptr(), tables.n_nodes,
                                  tables.tris.data_ptr(), shade.data_ptr()),
                             post=(None if totals is None else totals.data_ptr(),))
            return out if totals is None else out._replace(walk=totals[:2], phases=totals[2:])

        return run

    trace = _frame_tracer(body, MESH_CAMERA_PATH, lambda *a: plain(*a)._replace(walk=None),
                          card(False))
    trace.counted = _frame_tracer(body, MESH_CAMERA_PATH, plain, card(True))
    trace.plain = plain
    trace.tables = tables
    return trace


def make_path_tracer(scene_pack, cfg, z_far: float = 10000.0):
    """The rays-in path tracer (kernel 3).

    Returns ``trace(start[N,3], seg[N,3], pixel_idx[N], sample_idx[N], seed)
    → TraceOutput``, or None for a textured or BVH scene or one over 512
    primitives (as the reference).  CPU rays run the plain version; CUDA
    rays launch the kernel.
    """
    body = PathBody(scene_pack, None, cfg, z_far=z_far)
    if body.bvh or not body.fits or body.textured:
        return None
    core = body.core()

    def trace(start, seg, pixel_idx, sample_idx, seed):
        dev = start.device
        h0 = rng.seed_hash(seed)
        if dev.type == "cpu":
            return planes_to_output(core(h0, start[:, 0], start[:, 1], start[:, 2],
                                      seg[:, 0], seg[:, 1], seg[:, 2],
                                      pixel_idx, sample_idx))
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        n = start.shape[0]
        _build.check_cuda_tensor("start", start, torch.float32, (n, 3), dev)
        _build.check_cuda_tensor("seg", seg, torch.float32, (n, 3), dev)
        _build.check_cuda_tensor("pixel_idx", pixel_idx, torch.int32, (n,), dev)
        _build.check_cuda_tensor("sample_idx", sample_idx, torch.int32, (n,), dev)
        outs = _path_outputs(n, dev)
        body.launch(RAY_PATH, start.data_ptr(), seg.data_ptr(), pixel_idx.data_ptr(),
                    sample_idx.data_ptr(), h0, n, *(o.data_ptr() for o in outs), dev=dev)
        return _trace_output(*outs)

    return trace
