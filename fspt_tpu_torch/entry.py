"""Entry points of the port: a one-device render step and a multi-rank dry run.

``entry()`` returns the forward render step on the flagship workload (the
Cornell-box-class ``scene/samples.flagship``, the torch integrator) with
example arguments.  ``dryrun_multichip(n)`` runs, on a mesh of the first
``n`` ranks of the torch.distributed world, one of each sharded step:
the band render, the recovery step, vertex recovery, the camera-fused
kernel's band step, fused recovery, the mesh-intersector step and the
queued mesh step, at tiny shapes.  Both run on the card unless
``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from fspt_tpu_torch.config import RenderConfig, resolve_device


def _flagship(dev):
    from fspt_tpu_torch.scene import samples

    return samples.build("flagship", device=dev)


def entry(device=None):
    """``(fn, example_args)``: ``fn(scene, camera, fb, seed, frame_idx) →
    (fb, segments)``, one progressive frame of the flagship at 64×64, 2
    spp, depth 4, and the arguments of its first frame."""
    from fspt_tpu_torch.render import framebuffer, integrator

    dev = resolve_device(device)
    builder = _flagship(dev)
    scene = builder.compile(device=dev)
    camera = builder.cameras[0]
    cfg = RenderConfig(width=64, height=64, spp=2, max_depth=4)
    fb = framebuffer.create(cfg.height, cfg.width, device=dev)

    def fn(scene, camera, fb, seed, frame_idx):
        return integrator.render_step(scene, camera, cfg, fb, seed, frame_idx)

    return fn, (scene, camera, fb, 7, 0)


def _heightfield_triangles():
    """The dry run's 12×12 heightfield under the flagship's floor level."""
    xs = np.linspace(-20, 20, 12, dtype=np.float32)
    X, Z = np.meshgrid(xs, xs, indexing="ij")
    Y = 2.0 * np.sin(X * 0.3) * np.cos(Z * 0.25) - 40.0
    P = np.stack([X, Y, Z], axis=-1)
    a, bq = P[:-1, :-1].reshape(-1, 3), P[1:, :-1].reshape(-1, 3)
    c, d = P[1:, 1:].reshape(-1, 3), P[:-1, 1:].reshape(-1, 3)
    return np.concatenate([a, a]), np.concatenate([bq, c]), np.concatenate([c, d])


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One of each sharded step on a mesh of the first ``n_devices`` ranks
    (collective: every rank of the world calls it; ranks past
    ``n_devices`` only join the mesh).  Returns the segment counts and
    losses on the mesh's ranks (an empty dict elsewhere)."""
    from fspt_tpu_torch.ops.cuda_bvh import make_mesh_intersector
    from fspt_tpu_torch.parallel import (make_fused_recovery_step, make_mesh,
                                         make_recovery_step, make_sharded_megakernel_step,
                                         make_sharded_render_step, make_vertex_recovery_step,
                                         sharded_framebuffer)

    dev = resolve_device(device)
    mesh = make_mesh(n_devices, device=dev)
    if not mesh.member:
        return {}
    dev = mesh.device
    builder = _flagship(dev)
    scene = builder.compile(device=dev)
    camera = builder.cameras[0]
    height = max(8, n_devices)
    while height % n_devices:
        height += 1
    cfg = RenderConfig(width=8, height=height, spp=1, max_depth=2)
    out = {}

    # Forward: band-sharded framebuffer, one band a rank.
    fb = sharded_framebuffer(mesh, cfg.height, cfg.width)
    fb, segments = make_sharded_render_step(mesh, cfg)(scene, camera, fb, 7, 0)
    out["render_segments"] = int(segments)
    assert out["render_segments"] > 0

    # Train: data-parallel rays, gradients averaged over the ranks.
    target = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32, device=dev)
    step = make_recovery_step(mesh, cfg, param_names=("diffuse",), lr=0.1)
    _, loss = step({"diffuse": scene.materials.diffuse}, scene, camera, target, 7, 0)
    out["recovery_loss"] = float(loss)
    assert np.isfinite(out["recovery_loss"])

    # Geometry train: edge-reparameterized vertex gradients, sharded rays.
    b2 = _flagship(dev)
    b2.add_triangles(np.array([[-20.0, -15.0, 30.0]], np.float32),
                     np.array([[20.0, -15.0, 30.0]], np.float32),
                     np.array([[0.0, 15.0, 30.0]], np.float32), 0)
    scene2 = b2.compile(device=dev)
    g = scene2.geometry
    vparams = {"v0": g.tri_v0, "v1": g.tri_v0 + g.tri_e1, "v2": g.tri_v0 + g.tri_e2}
    cfg_e = RenderConfig(width=8, height=height, spp=1, max_depth=2, edge_eps=2.0)
    _, vloss = make_vertex_recovery_step(mesh, cfg_e, lr=0.05)(vparams, scene2, camera,
                                                                target, 7, 0)
    out["vertex_loss"] = float(vloss)
    assert np.isfinite(out["vertex_loss"])

    # The fast kernels under the mesh: the camera-fused band step, fused
    # recovery, and the mesh intersector, unrolled and queued.
    mk_step = make_sharded_megakernel_step(mesh, scene, camera, cfg)
    assert mk_step is not None
    _, mk_segs = mk_step(sharded_framebuffer(mesh, cfg.height, cfg.width), 7, 0)
    out["megakernel_segments"] = int(mk_segs)
    assert out["megakernel_segments"] > 0

    fstep = make_fused_recovery_step(mesh, scene, camera, cfg, fields=("diffuse",), lr=0.1,
                                     pool=1)
    _, floss = fstep({"diffuse": scene.materials.diffuse}, scene, camera, target, 7, 0)
    out["fused_loss"] = float(floss)
    assert np.isfinite(out["fused_loss"])

    b3 = _flagship(dev)
    b3.add_triangles(*_heightfield_triangles(), 0)
    scene3 = b3.compile(device=dev)
    assert scene3.bvh is not None
    inter = make_mesh_intersector(scene3)
    _, bvh_segs = make_sharded_render_step(mesh, cfg, intersector=inter)(
        scene3, camera, sharded_framebuffer(mesh, cfg.height, cfg.width), 7, 0)
    out["bvh_segments"] = int(bvh_segs)
    assert out["bvh_segments"] > 0

    # The queued wavefront under the mesh: one ray queue a band.
    _, q_segs = make_sharded_render_step(mesh, cfg, intersector=inter, queue=32)(
        scene3, camera, sharded_framebuffer(mesh, cfg.height, cfg.width), 7, 0)
    out["queued_segments"] = int(q_segs)
    assert out["queued_segments"] == out["bvh_segments"]
    return out


def main(argv=None) -> int:
    """``python -m fspt_tpu_torch.entry [--device cpu]``: the dry run on a
    mesh of every rank of the world ``multihost.initialize()`` brings up
    (``torchrun``'s, or a world of 1); the primary rank prints its numbers."""
    import argparse
    import json

    import torch.distributed as dist

    from fspt_tpu_torch.parallel import multihost

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    multihost.initialize(device=args.device)
    n = dist.get_world_size()
    out = dryrun_multichip(n, device=args.device)
    if multihost.is_primary():
        print(json.dumps({"devices": n, **out}))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
