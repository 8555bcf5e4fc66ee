"""Camera model and primary-ray generation.

Port of fspt_tpu/camera.py (reference engine.cpp:184-244, camera.cpp:6-24):
one vectorized pass producing the ``[N, 3]`` segment-parameterized ray SoA
(``start + seg * t``, ``t ∈ [0, 1]``) for a band of the H×W×spp wavefront,
lanes ordered pixel-major then sample.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fspt_tpu_torch.config import resolve_device
from fspt_tpu_torch.ops import rng
from fspt_tpu_torch.utils import vecmath as vm


class Camera(NamedTuple):
    """Camera parameters as 0-d / [3] float32 tensors; defaults per
    reference camera.cpp:6-24."""

    origin: torch.Tensor  # [3]
    target: torch.Tensor  # [3]
    fov_y: torch.Tensor  # degrees
    aperture_size: torch.Tensor
    focal_depth: torch.Tensor
    z_near: torch.Tensor
    z_far: torch.Tensor

    @classmethod
    def create(
        cls,
        origin=(0.0, 0.0, -200.0),
        target=(0.0, 0.0, 0.0),
        fov_y=45.0,
        aperture_size=1.5,
        focal_depth=80.0,
        z_near=1.0,
        z_far=10000.0,
        device=None,
    ) -> "Camera":
        dev = resolve_device(device)
        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
        return cls(
            origin=f32(origin),
            target=f32(target),
            fov_y=f32(fov_y),
            aperture_size=f32(aperture_size),
            focal_depth=f32(focal_depth),
            z_near=f32(z_near),
            z_far=f32(z_far),
        )


def camera_basis(camera: Camera):
    """Forward/right/up basis; reference engine.cpp:187-189 (world up = +Y)."""
    forward = vm.normalize(camera.target - camera.origin)
    up_world = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32,
                            device=forward.device)
    right = vm.normalize(vm.cross(up_world, forward))
    up = vm.normalize(vm.cross(forward, right))
    return forward, right, up


def generate_rays(camera: Camera, width: int, height: int, spp: int, seed,
                  sample0, y0=0, rows=None):
    """Build the primary-ray wavefront of ``rows`` scanlines from ``y0``.

    Returns ``(start[N,3], seg[N,3], pixel_idx[N], sample_idx[N])`` with
    ``N = rows*width*spp``; ``pixel_idx`` stays global so RNG streams do
    not depend on banding.
    """
    if rows is None:
        rows = height
    lanes = torch.arange(rows * width * spp, dtype=torch.int32,
                         device=camera.origin.device)
    return rays_for_lanes(camera, width, height, spp, seed, sample0, lanes,
                          y0=y0)


def rays_for_lanes(camera: Camera, width: int, height: int, spp: int, seed,
                   sample0, lanes, y0=0):
    """Primary rays for band-local lane indices
    (lane = (row·width + x)·spp + s); the full iota reproduces
    :func:`generate_rays`.  Semantics per reference engine.cpp:205-244:
    ±0.5 px jitter, pinhole projection through a far-plane-sized image plane,
    thin-lens depth of field when ``aperture_size > 0``."""
    forward, right, up = camera_basis(camera)

    fovy = camera.fov_y * (vm.PI / 180.0)
    aspect = torch.tensor(width, dtype=torch.float32) / torch.tensor(
        height, dtype=torch.float32)
    fovx = 2.0 * torch.atan(torch.tan(fovy * 0.5) * aspect.to(fovy.device))
    half_proj_h = torch.tan(fovy * 0.5) * camera.z_far
    half_proj_w = torch.tan(fovx * 0.5) * camera.z_far
    proj_origin = camera.origin + forward * camera.z_far

    lanes = lanes.to(torch.int32)
    ys = torch.div(lanes, width * spp, rounding_mode="floor") + int(y0)
    xs = torch.remainder(torch.div(lanes, spp, rounding_mode="floor"), width)
    ss = torch.remainder(lanes, spp)
    pixel_idx = (ys * width + xs).to(torch.int32)
    sample_idx = (ss + int(sample0)).to(torch.int32)
    i = xs.to(torch.float32)
    j = ys.to(torch.float32)

    u = rng.camera_uniforms(seed, pixel_idx, sample_idx)  # [N,4]
    aa_x = u[:, 0] - 0.5
    aa_y = u[:, 1] - 0.5

    x_dist = half_proj_w * (((i + aa_x) / (width - 1)) * 2.0 - 1.0)
    y_dist = half_proj_h * (((j + aa_y) / (height - 1)) * 2.0 - 1.0)
    stop = (proj_origin[None, :] + right[None, :] * x_dist[:, None]
            + up[None, :] * y_dist[:, None])

    start = camera.origin.expand(stop.shape)
    seg = stop - start

    # Thin-lens DoF (engine.cpp:221-244): the focal plane faces the camera
    # (normal -forward) through origin + forward*focal_depth.
    focal_plane = vm.make_plane(-forward, camera.origin + forward * camera.focal_depth)
    ts = vm.dot(focal_plane[:3].expand(seg.shape), seg)
    ns = -(vm.dot(focal_plane[:3].expand(start.shape), start) + focal_plane[3])
    small = torch.abs(ts) < vm.EPSILON
    t_focal = ns / torch.where(small, 1.0, ts)
    focal_valid = ~small & (t_focal >= 0.0) & (t_focal <= 1.0)
    focal_point = start + seg * t_focal[:, None]

    angle = u[:, 2] * (2.0 * vm.PI)
    mag = torch.sqrt(u[:, 3]) * camera.aperture_size
    offset = (right[None, :] * (torch.cos(angle) * mag)[:, None]
              + up[None, :] * (torch.sin(angle) * mag)[:, None])
    dof_start = start + offset
    dof_seg = vm.normalize(focal_point - dof_start) * camera.z_far

    use_dof = (camera.aperture_size > 0.0) & focal_valid
    start = torch.where(use_dof[:, None], dof_start, start)
    seg = torch.where(use_dof[:, None], dof_seg, seg)

    return start, seg, pixel_idx, sample_idx


def probe_ray(camera: Camera, width: int, height: int, x, y):
    """Un-jittered center ray of pixel (x, y), ``(origin, stop − origin)``
    on the camera's device; reference engine.cpp:298-321.  The distance
    probe of click-to-focus (``interactive.trace_range``) traces it."""
    forward, right, up = camera_basis(camera)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=forward.device)
    fovy = camera.fov_y * (vm.PI / 180.0)
    aspect = f32(float(width)) / f32(float(height))
    fovx = 2.0 * torch.atan(torch.tan(fovy * 0.5) * aspect)
    half_proj_h = torch.tan(fovy * 0.5) * camera.z_far
    half_proj_w = torch.tan(fovx * 0.5) * camera.z_far
    proj_origin = camera.origin + forward * camera.z_far
    x_dist = half_proj_w * ((f32(float(x)) / (width - 1)) * 2.0 - 1.0)
    y_dist = half_proj_h * ((f32(float(y)) / (height - 1)) * 2.0 - 1.0)
    stop = proj_origin + right * x_dist + up * y_dist
    return camera.origin, stop - camera.origin
