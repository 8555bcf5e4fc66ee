"""BVH-scale differentiable geometry recovery (BASELINE.md config 5 at the
config-3 scene scale) on the port.

Builds a triangle heightfield large enough for the BVH path, moves every
vertex up by a global offset, then recovers the surface with Adam through
``make_bvh_vertex_recovery_step``: the fast mesh intersector (kernels 1, 5
and 6) records each segment's winner without gradients, and a replay of one
Möller–Trumbore per segment (ops/diff_intersect.py) differentiates t,
normal and uv in the vertex tensors.

    python -m fspt_tpu_torch.examples.recover_vertices_bvh [--grid 224] \\
        [--iters 100] [--device cuda]

``--grid 224`` ≈ 100 k triangles; the default 24 (1,058 triangles) keeps a
run short.  ``--spp`` and ``--depth`` size the render (2 and 2: the
reference's example); on the card the run ends with its peak device memory.  The run fails (exit 1) unless the mean vertex y-error falls
below 0.6× its start; ``--no-check`` skips that (runs too short to
converge, as the CPU tests make).
"""

import argparse
import sys
import time

import numpy as np
import torch

from fspt_tpu_torch import materials as M
from fspt_tpu_torch.camera import Camera
from fspt_tpu_torch.config import RenderConfig, resolve_device
from fspt_tpu_torch.materials import MaterialSpec
from fspt_tpu_torch.ops.diff_intersect import make_diff_mesh_intersector, tris_from_scene
from fspt_tpu_torch.parallel.train import make_bvh_vertex_recovery_step, render_image_rows
from fspt_tpu_torch.scene.builder import SceneBuilder


def build_scene(grid, device):
    """Heightfield in a lit box (the family of the mesh bench scene)."""
    b = SceneBuilder()
    terra = b.add_material(MaterialSpec(M.DIFFUSE, diffuse=(0.55, 0.45, 0.35)))
    light = b.add_material(MaterialSpec(M.LIGHT, emissive=(12.0, 12.0, 12.0)))
    sky = b.add_material(MaterialSpec(M.LIGHT, emissive=(0.3, 0.4, 0.6)))
    b.set_sky(sky)
    b.add_quad_uv((-20, 55.0, -20), (40, 0, 0), (0, 0, 40), light)
    xs = np.linspace(-45, 45, grid, dtype=np.float32)
    X, Z = np.meshgrid(xs, xs, indexing="ij")
    Y = (6.0 * np.sin(X * 0.18) * np.cos(Z * 0.15)
         + 3.0 * np.sin(X * 0.51 + 1.0) * np.sin(Z * 0.43) - 20.0)
    P = np.stack([X, Y, Z], axis=-1)
    a = P[:-1, :-1].reshape(-1, 3)
    bq = P[1:, :-1].reshape(-1, 3)
    c = P[1:, 1:].reshape(-1, 3)
    d = P[:-1, 1:].reshape(-1, 3)
    b.add_triangles(np.concatenate([a, a]), np.concatenate([bq, c]), np.concatenate([c, d]),
                    terra)
    print(f"scene: {2 * len(a)} triangles")
    b.add_camera(Camera.create(origin=(0.0, 25.0, -110.0), target=(0.0, -15.0, 0.0),
                               aperture_size=0.0, device=device))
    return b


def parse_args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=24, help="heightfield grid; 224 ≈ 100k triangles")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--spp", type=int, default=2, help="samples per pixel of each buffer")
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--check", action=argparse.BooleanOptionalAction, default=True,
                    help="fail unless the y-error falls below 0.6x its start")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return ap.parse_args(argv)


def run(argv=None) -> dict:
    """Run the recovery; returns the mean vertex y-error at the start and
    the end, and the seconds the steps took."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    builder = build_scene(args.grid, device)
    scene = builder.compile(device=device)
    if scene.bvh is None:
        raise SystemExit("scene too small to cross the BVH threshold")
    cam = builder.cameras[0]
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_depth=args.depth, edge_eps=0.05)

    baked = tris_from_scene(scene)
    true_params = {k: baked[k] for k in ("v0", "v1", "v2")}
    # Target: a few frames of the unmoved scene through the replay
    # intersector the loss uses.
    diff = make_diff_mesh_intersector(scene)
    with torch.no_grad():
        target = sum(render_image_rows(scene, cam, cfg, 11, f, 0, cfg.height,
                                       intersector=diff) for f in range(4)) / 4.0

    # Perturb: a global y-offset, small enough that the recorded winners of
    # the baked tree stay about right.
    shift = torch.tensor([0.0, 0.5, 0.0], device=device)
    params = {k: v + shift for k, v in true_params.items()}
    step = make_bvh_vertex_recovery_step(
        None, cfg, scene, optimizer=lambda ps: torch.optim.Adam(ps, lr=args.lr), pool=1)
    state = step.init(params)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    def mean_dy(p):
        return float((p["v0"][:, 1] - true_params["v0"][:, 1]).mean())

    e0 = mean_dy(params)
    print(f"initial mean vertex y-error: {e0:.3f} world units")
    t0 = time.time()
    for it in range(args.iters):
        params, state, loss = step(params, state, scene, cam, target, 11, it)
        if it % 10 == 0 or it == args.iters - 1:
            print(f"iter {it:4d}  loss {float(loss):.6f}  mean-dy {mean_dy(params):+.4f}")
    dt = time.time() - t0
    e1 = mean_dy(params)
    print(f"{args.iters} iters in {dt:.1f}s on {device} ({dt / max(args.iters, 1):.3f} "
          f"s/fwd+bwd step); mean vertex y-error {e0:.3f} -> {e1:.4f}")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    if peak is not None:
        print(f"peak device memory of the steps: {peak / 2**30:.2f} GiB")
    return dict(err_start=e0, err_end=e1, seconds=dt, check=args.check, peak_bytes=peak)


def main(argv=None):
    res = run(argv)
    e0, e1 = res["err_start"], res["err_end"]
    if res["check"] and not 0.0 <= e1 < 0.6 * e0:
        print(f"recovery insufficient: {e0} -> {e1}", file=sys.stderr)
        return 1
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
