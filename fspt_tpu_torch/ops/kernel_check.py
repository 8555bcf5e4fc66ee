"""Hold each CUDA kernel against its plain PyTorch version on the card.

Both run on the same CUDA tensors; the kernels' launch counts rise, the
plain versions' do not.  The GPU-marked tests and ``chip_smoke.py`` call
these functions; each returns a report and raises ``AssertionError`` when
a bar is missed.

Bars (path tracers): radiance within rtol 1e-4 / atol 1e-5 on ≥ 99.9 % of
values, material AOV equal on ≥ 99.9 % of lanes, total segments within
0.1 %.  The two sides round every operation alike (the kernels build with
``-fmad=false``), but the card's ``sinf``/``cosf`` and torch's may still
differ in the last bit, and a lane whose branch (``u0 < reflectivity``, a
near-tie hit) flips follows another path: hence fractions, not equality.
Intersect: t, normal and texcoords within rtol 1e-5 / atol 1e-6, material
and kind equal, each on ≥ 99.9 % of lanes.  The ``lane0`` band split of the
camera-fused kernel must reproduce the full frame bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from fspt_tpu_torch.camera import generate_rays
from fspt_tpu_torch.ops import cuda_path, cuda_trace, rng
from fspt_tpu_torch.scene.geometry import INVALID_PARAM

FRACTION = 0.999


def random_segments(n: int, seed: int, device, box: float = 48.0):
    """``n`` seeded random segments starting inside the Cornell box, with
    uniform directions and lengths in [20, 200]."""
    r = np.random.default_rng(seed)
    start = r.uniform(-box, box, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    seg = (d * r.uniform(20.0, 200.0, (n, 1))).astype(np.float32)
    return (torch.from_numpy(start).to(device), torch.from_numpy(seg).to(device))


def _frac_close(a, b, rtol, atol):
    return torch.isclose(a, b, rtol=rtol, atol=atol).float().mean().item()


def _frac_equal(a, b):
    return (a == b).float().mean().item()


def _max_abs(a, b):
    return (a - b).abs().max().item() if a.numel() else 0.0


def check_intersect(geometry, start, seg) -> dict:
    """Kernel 1 against :func:`cuda_trace.plain_intersect` on CUDA rays."""
    scene = cuda_trace.HostScene(geometry)
    k = cuda_trace.launch_intersect(scene, start, seg)
    p = cuda_trace.plain_intersect(scene, start, seg)
    torch.cuda.synchronize()
    hit = p[0] < INVALID_PARAM
    rep = dict(
        lanes=start.shape[0],
        hit_fraction=hit.float().mean().item(),
        t_close=_frac_close(k[0], p[0], 1e-5, 1e-6),
        normal_close=_frac_close(k[1], p[1], 1e-5, 1e-6),
        uv_close=_frac_close(k[4], p[4], 1e-5, 1e-6),
        mat_equal=_frac_equal(k[2], p[2]),
        kind_equal=_frac_equal(k[3], p[3]),
        max_abs_err=max(_max_abs(k[0], p[0]), _max_abs(k[1], p[1])),
    )
    for key in ("t_close", "normal_close", "uv_close", "mat_equal", "kind_equal"):
        assert rep[key] >= FRACTION, (key, rep)
    return rep


def compare_paths(k, p) -> dict:
    """Hold a kernel's TraceOutput ``k`` against the plain version's ``p``."""
    seg_k, seg_p = int(k.segments), int(p.segments)
    rep = dict(
        lanes=k.radiance.shape[0],
        radiance_close=_frac_close(k.radiance, p.radiance, 1e-4, 1e-5),
        aov_mat_equal=_frac_equal(k.aov_mat, p.aov_mat),
        segments=seg_k,
        plain_segments=seg_p,
        segments_rel_diff=abs(seg_k - seg_p) / max(seg_p, 1),
        max_abs_err=_max_abs(k.radiance, p.radiance),
        radiance_mean=k.radiance.mean().item(),
    )
    assert rep["radiance_close"] >= FRACTION, rep
    assert rep["aov_mat_equal"] >= FRACTION, rep
    assert rep["segments_rel_diff"] <= 1e-3, rep
    assert np.isfinite(rep["radiance_mean"]), rep
    return rep


def check_path_tracer(scene_pack, camera, cfg, seed: int, sample0: int = 0) -> dict:
    """Kernel 3 against :func:`cuda_path.build_path_core` on rays from
    :func:`generate_rays`, both on the card."""
    tracer = cuda_path.make_path_tracer(scene_pack, cfg, z_far=float(camera.z_far))
    start, seg, pix, smp = generate_rays(camera, cfg.width, cfg.height, cfg.spp,
                                         seed, sample0)
    k = tracer(start, seg, pix, smp, seed)
    scene = cuda_trace.HostScene(scene_pack.geometry)
    mats = cuda_path.HostMaterials(scene_pack.materials)
    core = cuda_path.build_path_core(scene, mats, cfg, int(scene_pack.sky_mat),
                                     float(camera.z_far))
    p = cuda_path.planes_to_output(core(
        rng.seed_hash(seed), start[:, 0], start[:, 1], start[:, 2],
        seg[:, 0], seg[:, 1], seg[:, 2], pix, smp))
    torch.cuda.synchronize()
    return compare_paths(k, p)


def check_camera_tracer(scene_pack, camera, cfg, seed: int, sample0: int = 0) -> dict:
    """Kernel 2 against :func:`cuda_path.build_fused_raygen` +
    :func:`cuda_path.build_path_core` on the card, and the ``lane0`` band
    split against the full frame (bit-exact)."""
    tracer = cuda_path.make_camera_path_tracer(scene_pack, camera, cfg)
    k = tracer(seed, sample0)
    n = cfg.height * cfg.width * cfg.spp
    half = n // 2 + 37  # an uneven split: ragged tails in both halves
    lower = tracer(seed, sample0, lane0=0, n_lanes=half)
    upper = tracer(seed, sample0, lane0=half, n_lanes=n - half)

    scene = cuda_trace.HostScene(scene_pack.geometry)
    mats = cuda_path.HostMaterials(scene_pack.materials)
    cam = cuda_path.HostCamera(camera, cfg.width, cfg.height)
    raygen = cuda_path.build_fused_raygen(cam, cfg)
    core = cuda_path.build_path_core(scene, mats, cfg, int(scene_pack.sky_mat), cam.z_far)
    h0 = rng.seed_hash(seed)
    p = cuda_path.planes_to_output(core(h0, *raygen(h0, sample0, 0, n, scene_pack.device)))
    torch.cuda.synchronize()

    rep = compare_paths(k, p)
    band = torch.cat([lower.radiance, upper.radiance])
    rep["band_split_exact"] = bool(torch.equal(band, k.radiance)) and (
        int(lower.segments) + int(upper.segments) == int(k.segments))
    assert rep["band_split_exact"], rep
    return rep
