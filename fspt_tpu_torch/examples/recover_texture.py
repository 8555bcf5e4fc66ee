"""Differentiable TEXTURE recovery through the affine-deferred fold, on the
port.

Optimizes the texel buffer of a textured scene so the render matches a
target.  Kernel 7 writes the slot planes, which do not depend on the texels;
the gradient is torch autograd of the fold (ops/cuda_grad.
make_affine_grad_image_fn), and Adam moves the texels.

    python -m fspt_tpu_torch.examples.recover_texture [--iters 400] \\
        [--out build/examples/recover_tex] [--device cuda]
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
from fspt_tpu_torch.ops.cuda_grad import make_affine_grad_image_fn
from fspt_tpu_torch.scene.builder import SceneBuilder
from fspt_tpu_torch.utils.image import write_image

DEFAULT_OUT = os.path.join(os.path.dirname(__file__), "..", "..", "build", "examples",
                           "recover_tex")


def build_scene(device):
    """A checker-textured floor + sphere under an area light.

    Quad texcoords are world-scale planar mappings (reference
    intersect.cpp:769-784), so tex_scale=0.02 gives a 50-unit texture
    period: 2 repeats across the 100-unit floor.
    """
    b = SceneBuilder()
    yy, xx = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    checker = np.where(((xx // 2 + yy // 2) % 2)[..., None],
                       np.array([0.85, 0.55, 0.25]),
                       np.array([0.2, 0.35, 0.7])).astype(np.float32)
    tid = b.add_texture(checker)
    ground = b.add_material(MaterialSpec(M.DIFFUSE, diffuse=(1, 1, 1), tex_id=tid,
                                         tex_scale=0.02))
    white = b.add_material(MaterialSpec(M.DIFFUSE, diffuse=(0.7, 0.7, 0.7)))
    light = b.add_material(MaterialSpec(M.LIGHT, emissive=(13.0, 13.0, 13.0)))
    sky = b.add_material(MaterialSpec(M.LIGHT, emissive=(0.15, 0.2, 0.3)))
    b.set_sky(sky)
    b.add_quad_uv((-50, -12, -50), (100, 0, 0), (0, 0, 100), ground)
    b.add_quad_uv((-15, 40, -15), (30, 0, 0), (0, 0, 30), light)
    b.add_sphere((0, 2, 5), 10.0, white)
    b.add_camera(Camera.create(origin=(0, 25, -75), target=(0, -5, 0),
                               aperture_size=0.0, device=device))
    return b


def to_u8(img):
    return (np.clip(img.detach().cpu().numpy(), 0, 1) ** (1 / 2.2) * 255).astype(np.uint8)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=400)
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--width", type=int, default=192)
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    builder = build_scene(device)
    scene = builder.compile(device=device)
    camera = builder.cameras[0]
    cfg = RenderConfig(width=args.width, height=args.height, spp=4, max_depth=3)
    gi = make_affine_grad_image_fn(scene, camera, cfg)
    assert gi is not None, "scene must be kernel-specializable"

    true_texels = scene.textures.texels

    @torch.no_grad()
    def render(texels, seed, f0, frames=6):
        img = 0.0
        for f in range(frames):
            frame, _ = gi({"texels": texels}, seed, f0 + f, 0, cfg.height)
            img = img + frame
        return img / frames

    target = render(true_texels, 3, 0)

    # Start from a flat gray texture.
    params = torch.full_like(true_texels, 0.5).requires_grad_()
    opt = torch.optim.Adam([params], lr=0.1)

    def loss_fn(texels, f0):
        a, _ = gi({"texels": texels}, 7, f0, 0, cfg.height)
        b, _ = gi({"texels": texels}, 7, f0 + 10007, 0, cfg.height)
        return ((a - target) * (b - target)).mean()

    t0 = time.time()
    for it in range(args.iters):
        opt.zero_grad()
        loss = loss_fn(params, it * 3 + 1)
        loss.backward()
        opt.step()
        with torch.no_grad():
            params.clamp_(0.0, 1.0)
        if it % 25 == 0 or it == args.iters - 1:
            err = float((params.detach() - true_texels).abs().mean())
            print(f"iter {it:4d}  loss {float(loss.detach()):+.5f}  "
                  f"mean |texel err| {err:.4f}  ({time.time() - t0:.1f}s)", flush=True)

    err = float((params.detach() - true_texels).abs().mean())
    final = render(params, 11, 60)
    truth = render(true_texels, 11, 60)
    disp = float((final.clamp(0, 1) ** (1 / 2.2) - truth.clamp(0, 1) ** (1 / 2.2))
                 .abs().mean() * 255)
    print(f"final display error {disp:.2f}/255 (identical-sample renders); "
          f"mean |texel err| {err:.4f} incl. never-visible texels (started 0.244)")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    write_image(f"{args.out}_render.png", to_u8(final)[::-1])
    write_image(f"{args.out}_target.png", to_u8(target)[::-1])
    print(f"wrote {args.out}_render.png / _target.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
