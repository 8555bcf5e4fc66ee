"""Plain reference of a render frame and its accumulation, and the numbers
that judge the program's frames against it.

A checked frame is judged on what the timed path produced for it: the path
kernel's radiance, AOVs and segment count, and the framebuffer after the
frame's accumulation.  The reference traces the frame itself
(:mod:`pathtrace`) and accumulates it onto the program's framebuffer as it
was before the frame: the framebuffer is the program's running state, so
the reference follows it one frame at a time; frame 0 starts from an empty
framebuffer the reference makes itself.
"""

from __future__ import annotations

import torch

from . import pathtrace as pt

#: A lane agrees where every radiance channel is within ATOL + RTOL·|ref|.
#: Rounding differs between the two sides (operation order, float64 scene
#: constants here), so a lane whose path meets a branch within rounding of
#: its threshold (a texel edge, a near-tie hit, the diffuse cut-off) may
#: take another path: those lanes are what the lane share counts.
RTOL = 1e-3
ATOL = 1e-4
#: AOV agreement: the material id exactly, the normal per component, the
#: depth relative.
NORMAL_TOL = 1e-4
DEPTH_RTOL = 1e-5

#: Each number's limit, set between the largest reading of sound runs
#: (lower) and the smallest reading of the bfloat16 control (upper), with
#: more room above the lower; the readings are in PERF.md.
LIMITS = {
    "lane_mismatch": 5e-3,         # lower 9.7e-5, upper 6.6e-2
    "radiance_mean_gap": 1e-2,     # lower 2.3e-5, upper 0.387
    "aov_mismatch": 5e-2,          # lower 2.9e-4, upper 0.998
    "segments_gap": 2e-3,          # lower 1.6e-6, upper 0.446
    "framebuffer_mismatch": 5e-2,  # lower 6.2e-4, upper 0.998
    "count_gap": 0.0,              # exact: every pixel counts every frame's samples
    "missing_frames": 0.0,         # every checked frame has to come
}


def reference_frame(scene, cam, spp, max_depth, seed, frame, block_lanes, dtype, device):
    """The reference's outputs of frame ``frame``: radiance, normal, depth,
    material and segments per lane."""
    tables = pt.Tables(scene, dtype, device)
    return pt.trace_frame(tables, cam, spp, max_depth, seed, frame * spp, block_lanes)


def empty_framebuffer(height, width, device) -> dict:
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)  # noqa: E731
    return dict(mean=z(height, width, 3), m2=z(height, width, 3), count=z(height, width),
                normal=z(height, width, 3), depth=z(height, width),
                mat=torch.zeros((height, width), dtype=torch.int32, device=device))


def accumulate(fb: dict, radiance, normal, depth, mat, height, width, spp) -> dict:
    """Fold a frame's ``spp`` samples per pixel into the running mean
    (frame.cpp:53-61) and sum of squared deviations (Chan et al.'s
    combine); the AOVs keep each pixel's last sample.  In float64."""
    rad = radiance.double().reshape(height, width, spp, 3)
    n_old = fb["count"].double()[..., None]
    n_new = n_old + spp
    batch_mean = rad.mean(dim=2)
    batch_m2 = ((rad - batch_mean[:, :, None]) ** 2).sum(dim=2)
    delta = batch_mean - fb["mean"].double()
    return dict(
        mean=(fb["mean"].double() * n_old + rad.sum(dim=2)) / n_new,
        m2=fb["m2"].double() + batch_m2 + delta * delta * (n_old * spp) / n_new,
        count=fb["count"].double() + spp,
        normal=normal.double().reshape(height, width, spp, 3)[:, :, -1],
        depth=depth.double().reshape(height, width, spp)[:, :, -1],
        mat=mat.reshape(height, width, spp)[:, :, -1].to(torch.int32))


def _off(prog, ref, rtol, atol):
    return (prog.double() - ref.double()).abs() > atol + rtol * ref.double().abs()


def judge_frame(prog: dict, ref: tuple, height, width, spp) -> dict:
    """The numbers of one checked frame.  ``prog`` holds the program's
    ``radiance, normal, depth, mat, segments`` and framebuffers ``before``
    and ``after``; ``ref`` is :func:`reference_frame`'s outputs."""
    L, n, d, m, s = ref
    lane_off = _off(prog["radiance"], L, RTOL, ATOL).any(-1)
    aov_off = ((prog["mat"].to(torch.int64) != m.to(torch.int64))
               | _off(prog["normal"], n, 0.0, NORMAL_TOL).any(-1)
               | _off(prog["depth"], d, DEPTH_RTOL, 0.0))
    ref_sum = float(L.double().sum())
    seg_ref = int(s.sum())
    want = accumulate(prog["before"], L, n, d, m, height, width, spp)
    got = prog["after"]
    px_off = (_off(got["mean"], want["mean"], RTOL, ATOL).any(-1)
              | _off(got["m2"], want["m2"], RTOL, ATOL).any(-1)
              | (got["count"].double() != want["count"])
              | _off(got["normal"], want["normal"], 0.0, NORMAL_TOL).any(-1)
              | _off(got["depth"], want["depth"], DEPTH_RTOL, 0.0)
              | (got["mat"] != want["mat"]))
    return {
        "lane_mismatch": float(lane_off.double().mean()),
        "radiance_mean_gap": abs(float(prog["radiance"].double().sum()) - ref_sum)
        / max(abs(ref_sum), 1e-30),
        "aov_mismatch": float(aov_off.double().mean()),
        "segments_gap": abs(int(prog["segments"]) - seg_ref) / max(seg_ref, 1),
        "framebuffer_mismatch": float(px_off.double().mean()),
    }
