"""Differentiable material recovery (BASELINE.md config 4) on the port.

Renders a target Cornell image with the true material table through the
port's camera-fused tracer, perturbs every albedo and the light emission,
then recovers them with Adam through ``make_fused_recovery_step``: at the
default pool of 8 it takes the affine slot planes (kernel 7) and torch
autograd of their fold.

    python -m fspt_tpu_torch.examples.recover_albedo [--iters 150] \\
        [--out build/examples/recover] [--device cuda]
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
from fspt_tpu_torch.ops.cuda_path import make_camera_path_tracer
from fspt_tpu_torch.parallel.train import _apply_params, make_fused_recovery_step
from fspt_tpu_torch.render import framebuffer as fb_mod
from fspt_tpu_torch.scene.builder import SceneBuilder
from fspt_tpu_torch.utils.image import write_image

DEFAULT_OUT = os.path.join(os.path.dirname(__file__), "..", "..", "build", "examples",
                           "recover")


def build_scene(device):
    b = SceneBuilder()
    white = b.add_material(MaterialSpec(M.DIFFUSE, diffuse=(0.73, 0.73, 0.73)))
    red = b.add_material(MaterialSpec(M.DIFFUSE, diffuse=(0.65, 0.05, 0.05)))
    green = b.add_material(MaterialSpec(M.DIFFUSE, diffuse=(0.12, 0.45, 0.15)))
    light = b.add_material(MaterialSpec(M.LIGHT, emissive=(15.0, 15.0, 15.0)))
    s = 50.0
    b.add_quad_uv((-s, -s, -s), (2 * s, 0, 0), (0, 0, 2 * s), white)
    b.add_quad_uv((-s, s, -s), (0, 0, 2 * s), (2 * s, 0, 0), white)
    b.add_quad_uv((-s, -s, s), (2 * s, 0, 0), (0, 2 * s, 0), red)
    b.add_quad_uv((-s, -s, -s), (0, 2 * s, 0), (0, 0, 2 * s), red)
    b.add_quad_uv((s, -s, -s), (0, 0, 2 * s), (0, 2 * s, 0), green)
    b.add_quad_uv((-15, s - 0.5, -15), (30, 0, 0), (0, 0, 30), light)
    b.add_sphere((0, -35, 10), 15.0, white)
    b.add_camera(Camera.create(origin=(0, 0, -145), aperture_size=0.0, device=device))
    return b


def render_mean(scene, camera, cfg, frames, seed):
    """The mean radiance image of ``frames`` accumulated frames."""
    tracer = make_camera_path_tracer(scene, camera, cfg)
    fb = fb_mod.create(cfg.height, cfg.width, device=scene.device)
    for f in range(frames):
        out = tracer(seed, f * cfg.spp)
        fb = fb_mod.accumulate(fb, out.radiance, out.aov_normal, out.aov_depth,
                               out.aov_mat, cfg.height, cfg.width, cfg.spp)
    return fb.mean


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=150)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    builder = build_scene(device)
    scene = builder.compile(device=device)
    camera = builder.cameras[0]
    cfg = RenderConfig(width=args.width, height=args.height, spp=4, max_depth=3)

    # Target: a well-converged image with the true parameters.
    target = render_mean(scene, camera, cfg, frames=16, seed=5)

    true_diffuse = scene.materials.diffuse.cpu().numpy()
    true_emissive = scene.materials.emissive.cpu().numpy()
    rng = np.random.RandomState(0)
    params = {
        "diffuse": torch.from_numpy(np.clip(
            true_diffuse * rng.uniform(0.3, 1.7, true_diffuse.shape), 0, 1)
            .astype(np.float32)).to(device),
        "emissive": torch.from_numpy(true_emissive * np.float32(0.4)).to(device),
    }
    print("initial albedo error:",
          float(np.abs(params["diffuse"].cpu().numpy() - true_diffuse).max()))

    # Adam handles the albedo (~0.7) vs emission (~15) scale mismatch.
    step = make_fused_recovery_step(None, scene, camera, cfg,
                                    fields=("diffuse", "emissive"),
                                    optimizer=lambda ps: torch.optim.Adam(ps, lr=args.lr))
    state = step.init(params)
    t0 = time.time()
    for it in range(args.iters):
        params, state, loss = step(params, state, scene, camera, target, 5, it)
        if it % 25 == 0 or it == args.iters - 1:
            print(f"iter {it:4d}  loss {float(loss):.6f}")
    print(f"{args.iters} recovery iters in {time.time() - t0:.1f}s on {device}")

    # Success metric (BASELINE config 4): the *image* matches.  Parameter
    # errors are diagnostics only (albedo×emission products are what the
    # image constrains).
    rec = render_mean(_apply_params(scene, params), camera, cfg, frames=16, seed=5)
    rec_img = fb_mod.to_display(rec).cpu().numpy()
    tgt_img = fb_mod.to_display(target).cpu().numpy()
    img_err = np.abs(rec_img.astype(np.float32) - tgt_img.astype(np.float32)).mean()
    print(f"display-space image error: {img_err:.2f}/255 "
          f"({img_err / max(tgt_img.mean(), 1e-9):.1%} of mean brightness)")
    err_d = np.abs(params["diffuse"].cpu().numpy() - true_diffuse)
    err_e = np.abs(params["emissive"].cpu().numpy() - true_emissive)
    print("param diagnostics (gauge-ambiguous): albedo max-err", float(err_d.max()),
          "emission max-err", float(err_e.max()))

    os.makedirs(args.out, exist_ok=True)
    write_image(os.path.join(args.out, "target.png"), tgt_img[::-1])
    write_image(os.path.join(args.out, "recovered.png"), rec_img[::-1])
    print(f"wrote {args.out}/target.png and recovered.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
