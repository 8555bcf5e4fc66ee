"""Command-line renderer of the port.

Port of fspt_tpu/cli.py with the same flags and output, plus ``--device``
(``cuda`` by default): parse a ``.scene`` file, run N accumulation frames on
the fastest path (camera-fused CUDA megakernel, its texture-deferred form
for a textured scene, its mesh form, kernel 13, for an untextured BVH
scene; for a BVH scene under ``--first-hit-cache``, or a textured one, the
queued wavefront with the treelet kernels, with the flag its warm-start
form; else the CUDA intersect kernel under the torch integrator, else
torch), report Mrays/sec per frame (engine.cpp:283-293; on kernel 13's
first frame also the BVH node steps and triangle tests a segment) and
write the tonemapped image (with ``--denoise`` through the AOV-guided
denoiser, render/denoiser.py) and optional AOVs.  A checkpoint records
whether the first-hit cache made it, and a render under the other
estimator refuses to resume from it.

    python -m fspt_tpu_torch.cli --file scenes/cornell.scene --width 1024 \
        --height 1024 --frames 4 --spp 4 --output out.png
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

def build_argparser():
    p = argparse.ArgumentParser(description="fspt_tpu_torch path tracer")
    p.add_argument("--file", required=True, help="input .scene file")
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--frames", type=int, default=16, help="accumulation frames")
    p.add_argument("--spp", type=int, default=1, help="samples/pixel per frame")
    p.add_argument("--depth", type=int, default=8, help="max path depth")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--camera", type=int, default=0, help="camera index")
    p.add_argument("--output", default="render.png")
    p.add_argument("--aov-prefix", default=None,
                   help="write <prefix>_normal.png/_depth.npy/_mat.npy")
    p.add_argument("--fast", action="store_true", help="fast-render preview mode")
    p.add_argument("--no-gamma", action="store_true")
    p.add_argument("--denoise", action="store_true",
                   help="AOV-guided denoise before writing")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint path; resumes if it exists, saves each frame")
    p.add_argument("--checkpoint-every", type=int, default=8)
    p.add_argument("--first-hit-cache", action="store_true",
                   help="warm-start first-hit cache on the BVH path (reference "
                        "ImagePlaneCache analog): depth 0 resolves outside the "
                        "queue while the camera is still; frozen camera jitter")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default: cuda)")
    return p


def main(argv=None):
    parser = build_argparser()
    args = parser.parse_args(argv)

    import torch

    from fspt_tpu_torch.camera import Camera
    from fspt_tpu_torch.config import RenderConfig, resolve_device
    from fspt_tpu_torch.ops import cuda_path
    from fspt_tpu_torch.render import framebuffer as fb_mod
    from fspt_tpu_torch.render.dispatch import make_cached_scene_step, make_scene_step
    from fspt_tpu_torch.scene.parser import load_scene
    from fspt_tpu_torch.utils import checkpoint as ckpt
    from fspt_tpu_torch.utils.image import write_image

    device = resolve_device(args.device)
    builder = load_scene(args.file, device=device)
    scene = builder.compile(device=device)
    print(f"Scene file {args.file} loaded successfully.")  # scene.cpp:532
    if not builder.cameras:
        builder.add_camera(Camera.create(device=device))
    camera = builder.cameras[min(args.camera, len(builder.cameras) - 1)]

    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_depth=args.depth, fast_render=args.fast,
                       gamma_correct=not args.no_gamma)

    # The first-hit cache is the queue's estimator: a checkpoint made with
    # it keeps meaning what it meant.
    cached_bvh = args.first_hit_cache and scene.bvh is not None
    tracer = None if cached_bvh else cuda_path.make_camera_path_tracer(scene, camera, cfg)
    cstep = None
    walk = None
    if tracer is not None:
        # A textured scene takes the texture-deferred kernel, which fetches
        # and folds the texels itself; a BVH scene the mesh kernel.
        kind = {cuda_path.CAMERA_PATH: "camera-fused",
                cuda_path.DEFERRED_PATH: "texture-deferred camera-fused",
                cuda_path.MESH_CAMERA_PATH: "mesh camera-fused"}[tracer.kernel]
        print(f"render path: {kind} cuda megakernel" if device.type == "cuda"
              else f"render path: {kind} plain torch")

        # Kernel 13's first frame (which also loads the kernel) takes its
        # counting build, so that line gives the walk's work a segment; the
        # others the build that counts nothing (the counts cost 6-7 %).
        count_next = tracer.kernel is cuda_path.MESH_CAMERA_PATH

        def step(fb, frame_idx):
            nonlocal walk, count_next
            trace = tracer.counted if count_next else tracer
            count_next = False
            out = trace(args.seed, frame_idx * cfg.spp)
            fb = fb_mod.accumulate(fb, out.radiance, out.aov_normal,
                                   out.aov_depth, out.aov_mat,
                                   cfg.height, cfg.width, cfg.spp)
            walk = out.walk
            return fb, out.segments
    else:
        # A BVH scene under --first-hit-cache, or one kernel 13 refuses
        # (textured), takes the queued wavefront; with the flag its
        # warm-start form, whose pose bundle is built once below (the
        # camera is static for the whole run).
        if args.first_hit_cache:
            cname, cstep, cache_fn = make_cached_scene_step(scene, cfg)
        if cstep is not None:
            print(f"render path: {cname}")

            def step(fb, frame_idx):
                return cstep(scene, camera, fb, args.seed, frame_idx, pose)
        else:
            name, scene_step = make_scene_step(scene, cfg)
            print(f"render path: {name}")

            def step(fb, frame_idx):
                return scene_step(scene, camera, fb, args.seed, frame_idx)

    mode = {"first_hit_cache": cstep is not None}
    fb = fb_mod.create(cfg.height, cfg.width, device=device)
    frame0 = 0
    if args.checkpoint:
        restored = ckpt.load(args.checkpoint, device=device, with_extra=True)
        if restored is not None:
            fb, frame0, extra = restored
            why = ckpt.estimator_mismatch(extra, mode["first_hit_cache"])
            if why:
                parser.error(f"cannot resume from {args.checkpoint}: {why}")
            print(f"resumed from {args.checkpoint} at frame {frame0}")
    if cstep is not None:
        pose = cache_fn(scene, camera, args.seed)

    for frame in range(frame0, args.frames):
        t0 = time.time()
        fb, segments = step(fb, frame)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.time() - t0
        # Frame timing printf parity (engine.cpp:291-292).
        line = (f"Frame {frame} render time: {dt:.2f} sec. "
                f"Mrays/sec: {int(segments) / (1e6 * dt):.2f}")
        if walk is not None:
            nodes, tris = walk.tolist()
            per = max(int(segments), 1)
            line += f" BVH nodes/segment: {nodes / per:.2f} triangles/segment: {tris / per:.2f}"
        print(line)
        if args.checkpoint and (frame + 1) % args.checkpoint_every == 0:
            ckpt.save(args.checkpoint, fb, frame + 1, extra=mode)

    image = fb.mean
    if args.denoise:
        from fspt_tpu_torch.render.denoiser import denoise

        image = denoise(fb)
    display = fb_mod.to_display(image, cfg.gamma_correct).cpu().numpy()
    # Row 0 is the bottom scanline (camera up = +Y); flip for image files.
    write_image(args.output, display[::-1])
    print(f"wrote {args.output}")

    if args.aov_prefix:
        normal_u8 = fb_mod.to_display(fb.normal * 0.5 + 0.5,
                                      gamma_correct=False).cpu().numpy()
        write_image(f"{args.aov_prefix}_normal.png", normal_u8[::-1])
        np.save(f"{args.aov_prefix}_depth.npy", fb.depth.cpu().numpy())
        np.save(f"{args.aov_prefix}_mat.npy", fb.mat.cpu().numpy())
        print(f"wrote {args.aov_prefix}_normal.png/_depth.npy/_mat.npy")

    if args.checkpoint:
        ckpt.save(args.checkpoint, fb, args.frames, extra=mode)
    return 0


if __name__ == "__main__":
    sys.exit(main())
