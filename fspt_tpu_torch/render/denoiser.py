"""AOV-guided, variance-adaptive denoiser.

Port of fspt_tpu/render/denoiser.py: edge-aware à-trous wavelet filtering
(Dammertz et al. 2010 / SVGF-style weights) guided by the framebuffer's
normal / depth / material-id AOVs, with the luminance edge-stopping term
scaled by the per-pixel estimator variance (render/framebuffer.py).  The
reference computes it in XLA, so here it is plain torch on the
framebuffer's device; the shifted views are gathers of clamped indices.
"""

from __future__ import annotations

import torch

from fspt_tpu_torch.render.framebuffer import Framebuffer, variance_of_mean

# 5-tap B3-spline à-trous kernel; the 5×5 tap weights are float32 products,
# as the reference's float() of ``_KERNEL_1D[i] * _KERNEL_1D[j]``.
_KERNEL_1D = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
_TAPS = (_KERNEL_1D[:, None] * _KERNEL_1D[None, :]).tolist()
_OFFSETS = (-2, -1, 0, 1, 2)
_LUMA = (0.2126, 0.7152, 0.0722)


def _shift2d(x, dy, dx):
    """``out[i, j] = x[i − dy, j − dx]`` with edge clamping (no
    wraparound), over the first two dimensions."""
    if dy:
        rows = torch.arange(x.shape[0], device=x.device) - dy
        x = x.index_select(0, rows.clamp_(0, x.shape[0] - 1))
    if dx:
        cols = torch.arange(x.shape[1], device=x.device) - dx
        x = x.index_select(1, cols.clamp_(0, x.shape[1] - 1))
    return x


def _luminance(rgb):
    w = torch.tensor(_LUMA, dtype=torch.float32, device=rgb.device)
    return rgb @ w


def _gaussian3(x):
    """3×3 binomial prefilter (stabilizes the noisy variance estimate)."""
    out = 0.25 * _shift2d(x, -1, 0) + 0.5 * x + 0.25 * _shift2d(x, 1, 0)
    return 0.25 * _shift2d(out, 0, -1) + 0.5 * out + 0.25 * _shift2d(out, 0, 1)


def atrous_pass(color, normal, depth, mat, sigma_dev, stride: int,
                sigma_n: float = 64.0, sigma_z: float = 1.0):
    """One edge-aware à-trous iteration with dilation ``stride``.

    SVGF-style luminance edge-stop ``exp(-|l_p − l_q| / σ_pq)`` with the
    symmetric pair deviation ``σ_pq = sqrt(σ_p² + σ_q²)``; normal weight
    ``max(n·n_q, 0)^σ_n``, depth weight ``exp(-|z − z_q| / (σ_z(|z| + 1)))``,
    material weight 1 where the ids are equal, else 0.
    """
    lum = _luminance(color)
    wsum = torch.zeros(color.shape[:2], dtype=color.dtype, device=color.device)
    acc = torch.zeros_like(color)
    for i, oy in enumerate(_OFFSETS):
        for j, ox in enumerate(_OFFSETS):
            h = _TAPS[i][j]
            dy, dx = oy * stride, ox * stride
            c_q = _shift2d(color, dy, dx)
            n_q = _shift2d(normal, dy, dx)
            z_q = _shift2d(depth, dy, dx)
            m_q = _shift2d(mat, dy, dx)
            l_q = _luminance(c_q)

            w_n = torch.clamp((normal * n_q).sum(dim=-1), min=0.0) ** sigma_n
            w_z = torch.exp(-torch.abs(depth - z_q) / (sigma_z * (torch.abs(depth) + 1.0)))
            w_m = (mat == m_q).to(color.dtype)
            sd_q = _shift2d(sigma_dev, dy, dx)
            sigma_pq = torch.sqrt(sigma_dev * sigma_dev + sd_q * sd_q)
            w_l = torch.exp(-torch.abs(lum - l_q) / sigma_pq)
            w = h * w_n * w_z * w_m * w_l
            wsum = wsum + w
            acc = acc + c_q * w[..., None]
    return acc / torch.clamp(wsum, min=1e-8)[..., None]


def denoise(fb: Framebuffer, iterations: int = 3, variance_boost: float = 4.0):
    """Denoise the accumulated mean using the AOV buffers; ``[H, W, 3]`` on
    the framebuffer's device.

    The sampled variance underestimates uncertainty at low counts (a pixel
    whose few samples were all zero reports Var=0 and would refuse all
    smoothing), so σ gets a floor proportional to the local mean brightness
    over √count.
    """
    var = _gaussian3(_luminance(variance_of_mean(fb)))
    local_lum = _gaussian3(_luminance(fb.mean))
    count = torch.clamp(fb.count, min=1.0)
    var_floor = (local_lum * local_lum + 1e-4) / count
    sigma_dev = variance_boost * torch.sqrt(torch.clamp(var, min=0.0) + var_floor) + 1e-3
    color = fb.mean
    for it in range(iterations):
        color = atrous_pass(color, fb.normal, fb.depth, fb.mat, sigma_dev, stride=1 << it)
    return color
