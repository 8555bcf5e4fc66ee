"""Progressive accumulation framebuffer + AOVs + tonemap.

Port of fspt_tpu/render/framebuffer.py (reference frame.h:49-92,
frame.cpp): each wavefront folds into the running mean with a Chan et al.
parallel Welford combine; the AOVs (normal, depth, material id) keep the
last sample of each pixel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fspt_tpu_torch.config import resolve_device
from fspt_tpu_torch.utils import profiling


class Framebuffer(NamedTuple):
    mean: torch.Tensor  # [H,W,3] running radiance mean
    m2: torch.Tensor  # [H,W,3] running sum of squared deviations (Welford)
    count: torch.Tensor  # [H,W] float32 samples accumulated
    normal: torch.Tensor  # [H,W,3] last-sample normal AOV
    depth: torch.Tensor  # [H,W] last-sample depth AOV
    mat: torch.Tensor  # [H,W] int32 last-sample material id AOV


def create(height: int, width: int, device=None) -> Framebuffer:
    dev = resolve_device(device)
    f32 = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    return Framebuffer(
        mean=f32(height, width, 3),
        m2=f32(height, width, 3),
        count=f32(height, width),
        normal=f32(height, width, 3),
        depth=f32(height, width),
        mat=torch.zeros((height, width), dtype=torch.int32, device=dev),
    )


def accumulate(fb: Framebuffer, radiance, aov_normal, aov_depth, aov_mat,
               height: int, width: int, spp: int) -> Framebuffer:
    """Fold an [H*W*spp,3] wavefront into the running mean + variance.

    new mean = (mean·n + Σ samples)/(n + spp), as ``spp`` sequential
    running-mean updates (frame.cpp:53-61); m2 by the parallel Welford
    combine.  Returns a new Framebuffer; the input is not modified.
    """
    with profiling.span("fspt.accumulate"):
        rad = radiance.reshape(height, width, spp, 3)
        n_old = fb.count[..., None]
        n_new = n_old + spp
        batch_mean = rad.mean(dim=2)
        batch_m2 = ((rad - batch_mean[:, :, None, :]) ** 2).sum(dim=2)
        delta = batch_mean - fb.mean
        mean = (fb.mean * n_old + rad.sum(dim=2)) / n_new
        m2 = fb.m2 + batch_m2 + (delta * delta) * (n_old * spp) / n_new
        return Framebuffer(
            mean=mean,
            m2=m2,
            count=fb.count + spp,
            normal=aov_normal.reshape(height, width, spp, 3)[:, :, -1],
            depth=aov_depth.reshape(height, width, spp)[:, :, -1],
            mat=aov_mat.reshape(height, width, spp)[:, :, -1].to(torch.int32),
        )


def variance_of_mean(fb: Framebuffer):
    """Per-pixel estimator variance of the accumulated mean, [H,W,3]."""
    n = torch.clamp(fb.count, min=1.0)[..., None]
    sample_var = fb.m2 / torch.clamp(n - 1.0, min=1.0)
    return sample_var / n


def to_display(image, gamma_correct: bool = True):
    """HDR mean → uint8 display; reference frame.cpp:63-75 (gamma 1/2.2)."""
    x = torch.clamp(image, 0.0, 1.0)
    if gamma_correct:
        x = torch.pow(x, 1.0 / 2.2)
    return torch.floor(255.0 * x + 0.5).to(torch.uint8)
