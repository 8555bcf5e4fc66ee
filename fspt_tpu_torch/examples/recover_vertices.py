"""Differentiable geometry recovery (BASELINE.md config 5) on the port.

Renders a target image of an emissive triangle, perturbs its vertices, then
recovers them with Adam through ``make_vertex_recovery_step``: torch autograd
of the wavefront renderer with the brute-force intersector.  A constant
emitter has no interior gradient, so the whole signal is the visibility
boundary term of the edge-reparameterized integrator (``edge_eps > 0``).

    python -m fspt_tpu_torch.examples.recover_vertices [--iters 300] \\
        [--out build/examples/recover_v] [--device cuda]
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
from fspt_tpu_torch.parallel.train import (apply_vertices, make_vertex_recovery_step,
                                           render_image_rows)
from fspt_tpu_torch.render import framebuffer as fb_mod
from fspt_tpu_torch.scene.builder import SceneBuilder
from fspt_tpu_torch.utils.image import write_image

DEFAULT_OUT = os.path.join(os.path.dirname(__file__), "..", "..", "build", "examples",
                           "recover_v")


def build_scene(device):
    b = SceneBuilder()
    tri = b.add_material(MaterialSpec(M.LIGHT, emissive=(4.0, 4.0, 4.0)))
    sky = b.add_material(MaterialSpec(M.LIGHT, emissive=(0.1, 0.1, 0.1)))
    b.set_sky(sky)
    b.add_triangles(np.array([[-20.0, -15.0, 30.0]], np.float32),
                    np.array([[20.0, -15.0, 30.0]], np.float32),
                    np.array([[0.0, 15.0, 30.0]], np.float32), tri)
    b.add_camera(Camera.create(origin=(0, 0, -60), aperture_size=0.0, device=device))
    return b


def verts_of(scene) -> dict:
    g = scene.geometry
    return {"v0": g.tri_v0, "v1": g.tri_v0 + g.tri_e1, "v2": g.tri_v0 + g.tri_e2}


def mean_image(scene, camera, cfg, params, frames, seed):
    """The mean radiance image of ``frames`` frames of the scene with
    ``params`` as its vertices."""
    s = apply_vertices(scene, params)
    with torch.no_grad():
        return sum(render_image_rows(s, camera, cfg, seed, f, 0, cfg.height)
                   for f in range(frames)) / frames


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    builder = build_scene(device)
    scene = builder.compile(device=device)
    camera = builder.cameras[0]
    cfg = RenderConfig(width=args.width, height=args.height, spp=4, max_depth=2,
                       edge_eps=2.0)

    true_params = verts_of(scene)
    target = mean_image(scene, camera, cfg, true_params, frames=16, seed=5)

    # Perturb: shrink about the centroid and translate.
    c = (true_params["v0"] + true_params["v1"] + true_params["v2"]) / 3.0
    shift = torch.tensor([6.0, -4.0, 0.0], device=device)
    params = {k: c + (v - c) * 0.7 + shift for k, v in true_params.items()}

    def vert_err(p):
        return max(float((p[k] - true_params[k]).abs().max()) for k in p)

    err0 = vert_err(params)
    print(f"initial vertex error: {err0:.2f} world units")
    step = make_vertex_recovery_step(None, cfg,
                                     optimizer=lambda ps: torch.optim.Adam(ps, lr=args.lr))
    state = step.init(params)
    t0 = time.time()
    for it in range(args.iters):
        params, state, loss = step(params, state, scene, camera, target, 5, it)
        if it % 50 == 0 or it == args.iters - 1:
            print(f"iter {it:4d}  loss {float(loss):.6f}  vert-err {vert_err(params):.3f}")
    err1 = vert_err(params)
    print(f"{args.iters} iters in {time.time() - t0:.1f}s on {device}; vertex error "
          f"{err0:.2f} -> {err1:.3f} world units")

    # Success metric (BASELINE config 5): the projected silhouette matches.
    # Vertex coordinates are gauge-ambiguous (a farther, larger emitter
    # projects to the same image), so their error is a diagnostic.
    tgt_img = fb_mod.to_display(mean_image(scene, camera, cfg, true_params, 8, 5))
    rec_img = fb_mod.to_display(mean_image(scene, camera, cfg, params, 8, 5))
    tgt_img, rec_img = tgt_img.cpu().numpy(), rec_img.cpu().numpy()
    img_err = np.abs(rec_img.astype(np.float32) - tgt_img.astype(np.float32)).mean()
    print(f"display-space image error: {img_err:.2f}/255")
    os.makedirs(args.out, exist_ok=True)
    write_image(os.path.join(args.out, "target.png"), tgt_img[::-1])
    write_image(os.path.join(args.out, "recovered.png"), rec_img[::-1])
    print(f"wrote {args.out}/target.png and recovered.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
