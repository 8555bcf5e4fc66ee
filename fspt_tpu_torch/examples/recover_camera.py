"""Differentiable camera-pose recovery through the fused loss kernel.

Recover the camera origin from a target render by gradient descent, the
pose analog of material recovery.  The camera 9-vector
(ops/cuda_path.camera_pvec: origin, target, fov_y, aperture, focal_depth)
rides kernel 8's whole chain (ops/cuda_grad.make_fused_loss_grad_fn,
``fields=("camera",)``): each lane's primary ray comes from the traced
raygen, and the kernel carries the pose derivatives through rays, hits and
shading, so one launch per call gives the loss and the pose gradient.

Coarse to fine rides a resolution pyramid instead of image-space pooling
(the kernel's lane-level loss cannot pool, but rendering at 1/8 width is the
pooled objective): the low-resolution stage restores a usable basin, the
full-resolution stage polishes.  Each stage renders its own target at its
own resolution (kernel 2, the true camera).

    python -m fspt_tpu_torch.examples.recover_camera [--iters 1000] \\
        [--out build/examples/recover_cam] [--device cuda]

On the CPU (plain versions of the kernels) only at a tiny size, e.g.
``--device cpu --width 16 --height 16 --iters 4 --coarse-spp 4 --fine-spp 2
--target-frames 2 --grad-frames 1``.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

from fspt_tpu_torch import materials as M
from fspt_tpu_torch.camera import Camera
from fspt_tpu_torch.config import RenderConfig, resolve_device
from fspt_tpu_torch.materials import MaterialSpec
from fspt_tpu_torch.ops.cuda_grad import make_fused_loss_grad_fn
from fspt_tpu_torch.ops.cuda_path import camera_pvec, make_camera_path_tracer
from fspt_tpu_torch.render import framebuffer as fb_mod
from fspt_tpu_torch.scene.builder import SceneBuilder
from fspt_tpu_torch.utils.image import write_image

DEFAULT_OUT = os.path.join(os.path.dirname(__file__), "..", "..", "build", "examples",
                           "recover_cam")
#: The perturbed start of the origin (|error| 16.9 world units).
START_ORIGIN = (6.0, -5.0, -160.0)


def build_scene(device):
    b = SceneBuilder()
    white = b.add_material(MaterialSpec(M.DIFFUSE, diffuse=(0.73, 0.73, 0.73)))
    red = b.add_material(MaterialSpec(M.DIFFUSE, diffuse=(0.65, 0.05, 0.05)))
    green = b.add_material(MaterialSpec(M.DIFFUSE, diffuse=(0.12, 0.45, 0.15)))
    light = b.add_material(MaterialSpec(M.LIGHT, emissive=(15.0, 15.0, 15.0)))
    s = 50.0
    b.add_quad_uv((-s, -s, -s), (2 * s, 0, 0), (0, 0, 2 * s), white)
    b.add_quad_uv((-s, s, -s), (0, 0, 2 * s), (2 * s, 0, 0), white)
    b.add_quad_uv((-s, -s, s), (2 * s, 0, 0), (0, 2 * s, 0), white)
    b.add_quad_uv((-s, -s, -s), (0, 2 * s, 0), (0, 0, 2 * s), red)
    b.add_quad_uv((s, -s, -s), (0, 0, 2 * s), (0, 2 * s, 0), green)
    b.add_quad_uv((-15, s - 0.5, -15), (30, 0, 0), (0, 0, 30), light)
    b.add_sphere((0, -35, 10), 15.0, white)
    b.add_camera(Camera.create(origin=(0.0, 0.0, -145.0), aperture_size=0.0,
                               device=device))
    return b


def render_mean(scene, camera, cfg, frames, seed, frame0=0):
    """The mean radiance image ``[H,W,3]`` of ``frames`` frames (kernel 2)."""
    tracer = make_camera_path_tracer(scene, camera, cfg)
    fb = fb_mod.create(cfg.height, cfg.width, device=scene.device)
    for f in range(frames):
        out = tracer(seed, (frame0 + f) * cfg.spp)
        fb = fb_mod.accumulate(fb, out.radiance, out.aov_normal, out.aov_depth,
                               out.aov_mat, cfg.height, cfg.width, cfg.spp)
    return fb.mean


def parse_args(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=1000)
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--height", type=int, default=128)
    p.add_argument("--coarse-spp", type=int, default=256,
                   help="spp of the 1/8-size coarse stage (the lane-level loss "
                        "trades patch pooling for sample count)")
    p.add_argument("--fine-spp", type=int, default=16)
    p.add_argument("--target-frames", type=int, default=48,
                   help="frames averaged into the full-size target (its residual "
                        "noise shifts the product-loss optimum)")
    p.add_argument("--lr-coarse", type=float, default=0.4)
    p.add_argument("--lr-fine", type=float, default=0.05)
    p.add_argument("--grad-frames", type=int, default=8,
                   help="fused-kernel calls averaged per optimizer step: without "
                        "patch pooling, Adam's normalized steps random-walk the "
                        "weak lateral coordinates on fewer")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return p.parse_args(argv)


def run(argv=None) -> dict:
    """Run the recovery; returns the origin error and the full-size loss
    (on fixed frames) at the start and at the end."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    builder = build_scene(device)
    scene = builder.compile(device=device)
    true_cam = builder.cameras[0]
    base_spp, depth = 2, 3

    # Only the origin rows of the 9-vector optimize: the mask freezes
    # target, field of view and lens.
    cvec0 = camera_pvec(true_cam).to(device)
    start = cvec0.clone()
    start[0:3] = torch.tensor(START_ORIGIN, dtype=torch.float32, device=device)
    mask = torch.zeros(9, device=device)
    mask[0:3] = 1.0

    def stage(k, spp):
        scfg = RenderConfig(width=max(2, args.width // k), height=max(2, args.height // k),
                            spp=spp, max_depth=depth)
        fused = make_fused_loss_grad_fn(scene, true_cam, scfg, fields=("camera",))
        assert fused is not None
        frames = max(1, args.target_frames // max(1, spp // base_spp))
        return fused, render_mean(scene, true_cam, scfg, frames, seed=3), scfg

    # Factor-2 ladder: each stage converges to sub-pixel at its own
    # resolution, about one pixel at the next stage's, inside its basin.
    ladder = [(8, args.coarse_spp, args.lr_coarse),
              (4, max(args.fine_spp, args.coarse_spp // 2), 0.3),
              (2, max(args.fine_spp, args.coarse_spp // 8), 0.2),
              (1, args.fine_spp, args.lr_fine)]
    bounds = [int(args.iters * f) for f in (0.35, 0.55, 0.8)]
    stages = [stage(k, spp) for k, spp, _ in ladder]
    K = args.grad_frames

    def loss_and_grad(cvec, s, f0):
        fused, tgt, scfg = stages[s]
        loss, gacc = 0.0, torch.zeros(9, device=device)
        for j in range(K):
            l_j, g_j, _segs = fused({"camera": cvec}, tgt, 7, f0 + j, 0, scfg.height)
            loss = loss + float(l_j) / K
            gacc = gacc + g_j["camera"] / K
        return loss, gacc

    def eval_loss(cvec):
        """The full-size stage's loss on frames no step uses."""
        return loss_and_grad(cvec, len(stages) - 1, 10 ** 6)[0]

    def origin_err(cvec):
        return float(torch.linalg.norm(cvec[0:3] - true_cam.origin))

    leaf = start.clone()
    result = {"loss_start": eval_loss(leaf), "origin_err_start": origin_err(leaf)}
    t0 = time.time()
    opt, cur = None, -1
    for it in range(args.iters):
        s = sum(it >= b for b in bounds)
        if s != cur:
            # Fresh Adam moments per stage: the loss re-scales across
            # resolutions, and a stale second moment freezes the step size.
            opt = torch.optim.Adam([leaf], lr=ladder[s][2])
            cur = s
        loss, g = loss_and_grad(leaf.detach(), s, it * 2 * K + 1)
        leaf.grad = g * mask
        opt.step()
        if it % 20 == 0 or it == args.iters - 1:
            print(f"iter {it:4d}  stage {s}  loss {loss:+.5f}  |origin err| "
                  f"{origin_err(leaf.detach()):6.2f}  ({time.time() - t0:.1f}s)", flush=True)
    cvec = leaf.detach()
    result.update(loss_end=eval_loss(cvec), origin_err_end=origin_err(cvec),
                  seconds=time.time() - t0)
    err = (cvec[0:3] - true_cam.origin).cpu().numpy()
    print(f"final origin error {result['origin_err_end']:.2f} world units (started "
          f"{result['origin_err_start']:.2f}): lateral (x,y) {np.linalg.norm(err[:2]):.2f}, "
          f"view-axis z {err[2]:+.2f}; full-size loss {result['loss_start']:.6g} -> "
          f"{result['loss_end']:.6g}; {args.iters} iterations in {result['seconds']:.1f}s "
          f"on {device}")

    fine_cfg = stages[-1][2]
    cam = true_cam._replace(origin=cvec[0:3].clone())
    os.makedirs(args.out, exist_ok=True)
    for name, c in (("target", true_cam), ("recovered", cam)):
        img = fb_mod.to_display(render_mean(scene, c, fine_cfg, frames=6, seed=11, frame0=40))
        write_image(os.path.join(args.out, f"{name}.png"), img.cpu().numpy()[::-1])
    print(f"wrote {args.out}/target.png and recovered.png")
    return result


def main(argv=None):
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
