#!/usr/bin/env python3
"""The control of ``correct`` and the faults it must catch: runs of a cell
with its timed path replaced or broken underneath, each of which must come
out not correct.

    python3 benchmark/control.py --workload <name> --fault control --seeds 11 12 13

``control``: the plain reference computed in bfloat16, put in the
program's place.  For a render cell it replaces the path tracer the render loop
takes (``ops.cuda_path.make_camera_path_tracer``); for a recovery cell the
loss and gradient under the program's own recovery step
(``parallel.train.make_recovery_step`` with ``loss_and_grad_fn``), Adam and
the constraints staying the program's.

The faults, planted in the program's calls: ``state_unchanged`` (the
accumulation, or the recovery step, returns its state as it came),
``half_the_batch`` (half of each pixel's samples, or half of the frame's
rows, left out and the mean taken over the rest) and ``answer_altered``
(the frame's radiance or the adjoint's image altered where they are made,
or the fused loss's albedo gradient turned about, its norm kept).  One chip: no exchange between chips
to leave out.

The rest of each run is the benchmark's own (benchmark/run.py
``run_cell``): the same set-up, window and check at the cell's size.  Each
seed prints one JSON line with the numbers compared and whether the run came
out correct.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def reference_in_place(workload: str, dtype, root: Path = ROOT):
    """Swap the program's timed path for the reference in ``dtype``."""
    import torch

    from benchmark.harness import cell as cells
    from benchmark.reference import pathtrace as pt
    from benchmark.reference import recover as ref_recover
    from benchmark.reference import scene as ref_scene

    c = cells.resolve(workload, root)
    scene = ref_scene.from_config(c.config, root)
    driver = c.traffic["driver"]
    if driver == "render":
        from fspt_tpu_torch.ops import cuda_path

        module, name = cuda_path, "make_camera_path_tracer"

        def replacement(scene_pack, camera, cfg):
            tables = pt.Tables(scene, dtype, scene_pack.device)
            cam = pt.PinholeCamera(scene.camera, cfg.width, cfg.height)

            def trace(seed, sample0, lane0=0, n_lanes=None):
                L, n, d, m, s = pt.trace_frame(tables, cam, cfg.spp, cfg.max_depth, seed,
                                               sample0, c.traffic["check_block_lanes"])
                return SimpleNamespace(radiance=L.float(), aov_normal=n.float(),
                                       aov_depth=d.float(), aov_mat=m, segments=s.sum())

            return trace
    elif driver == "recover":
        from fspt_tpu_torch.parallel import train

        module, name = train, "make_fused_recovery_step"
        block = c.traffic["check_block_rows"]

        def replacement(mesh, scene_pack, camera, cfg, fields, lr=0.5, optimizer=None,
                        constraints=None, pool=8, loss_fn=None):
            cam = pt.PinholeCamera(scene.camera, cfg.width, cfg.height)

            def loss_and_grad(params, target, seed, frame_idx, y0, rows):
                loss, grads, segs = ref_recover.loss_and_grads(
                    scene, cam, cfg.spp, cfg.max_depth, pool, seed, frame_idx,
                    target.to(dtype), {k: params[k] for k in fields}, block, dtype)
                return (torch.tensor(loss, device=target.device),
                        {k: g.float() for k, g in grads.items()}, segs)

            return train.make_recovery_step(mesh, cfg, param_names=fields, lr=lr,
                                            optimizer=optimizer, constraints=constraints,
                                            pool=pool, loss_and_grad_fn=loss_and_grad)
    else:
        raise ValueError(f"no control for driver {driver!r}")
    with _swapped(module, name, replacement):
        yield


@contextlib.contextmanager
def _swapped(module, name, replacement):
    original = getattr(module, name)
    setattr(module, name, replacement)
    try:
        yield
    finally:
        setattr(module, name, original)


FAULTS = ("state_unchanged", "half_the_batch", "answer_altered")


def planted(workload: str, fault: str, root: Path = ROOT):
    """A context in which the program's call behind ``workload`` has
    ``fault`` (one of :data:`FAULTS`)."""
    from benchmark.harness import cell as cells

    driver = cells.resolve(workload, root).traffic["driver"]
    if driver == "render":
        return _render_fault(fault)
    pool = cells.resolve(workload, root).traffic["pool"]
    return _recover_fault(fault, pool)


def _render_fault(fault):
    from fspt_tpu_torch.ops import cuda_path
    from fspt_tpu_torch.render import framebuffer

    if fault == "state_unchanged":
        return _swapped(framebuffer, "accumulate", lambda fb, *a, **k: fb)
    if fault == "half_the_batch":
        accumulate = framebuffer.accumulate

        def half(fb, radiance, normal, depth, mat, height, width, spp):
            r = radiance.reshape(height * width, spp, 3).clone()
            r[:, spp // 2:] = r[:, :spp // 2]
            return accumulate(fb, r.reshape(-1, 3), normal, depth, mat, height, width, spp)

        return _swapped(framebuffer, "accumulate", half)
    make = cuda_path.make_camera_path_tracer

    def altered(*args, **kwargs):
        trace = make(*args, **kwargs)

        def traced(*a, **k):
            out = trace(*a, **k)
            return out._replace(radiance=out.radiance * 1.01)

        return traced

    return _swapped(cuda_path, "make_camera_path_tracer", altered)


def _recover_fault(fault, pool):
    from fspt_tpu_torch.ops import cuda_grad
    from fspt_tpu_torch.parallel import train

    if fault == "state_unchanged":
        make = train.make_fused_recovery_step

        def unchanged(*args, **kwargs):
            step = make(*args, **kwargs)

            def broken(params, state, *a):
                _, state, loss = step(params, state, *a)
                return params, state, loss

            broken.init = step.init
            return broken

        return _swapped(train, "make_fused_recovery_step", unchanged)
    if fault == "half_the_batch":
        def half(mesh, scene, camera, cfg, fields, lr=0.5, optimizer=None, constraints=None,
                 pool=8, loss_fn=None):
            if pool == 1:
                fused = cuda_grad.make_fused_loss_grad_fn(scene, camera, cfg, fields=fields)
                return train.make_recovery_step(
                    mesh, cfg, param_names=fields, lr=lr, optimizer=optimizer,
                    constraints=constraints, pool=1,
                    loss_and_grad_fn=lambda p, t, s, f, y0, rows: fused(
                        p, t[:rows // 2], s, f, y0, rows // 2))
            img_fn = cuda_grad.make_grad_image_fn(scene, camera, cfg, fields=fields)

            def render_fn(p, _scene, _camera, seed, frame, y0, rows):
                return img_fn(p, seed, frame, y0, rows // 2)[0]

            def half_loss(a, b, target):
                h = a.shape[0]
                return (train._pool(a - target[:h], pool)
                        * train._pool(b - target[:h], pool)).mean()

            return train.make_recovery_step(mesh, cfg, param_names=fields, lr=lr,
                                            optimizer=optimizer, constraints=constraints,
                                            pool=pool, render_fn=render_fn, loss_fn=half_loss)

        return _swapped(train, "make_fused_recovery_step", half)
    if pool == 1:
        make = cuda_grad.make_fused_loss_grad_fn

        def altered(*args, **kwargs):
            fn = make(*args, **kwargs)

            def scaled(*a):
                loss, grads, segs = fn(*a)
                return loss, dict(grads, diffuse=-grads["diffuse"]), segs

            return scaled

        return _swapped(cuda_grad, "make_fused_loss_grad_fn", altered)
    make = cuda_grad.make_grad_image_fn

    def altered_image(*args, **kwargs):
        fn = make(*args, **kwargs)

        def scaled(*a):
            img, segs = fn(*a)
            return img * 1.01, segs

        return scaled

    return _swapped(cuda_grad, "make_grad_image_fn", altered_image)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", choices=("control",) + FAULTS, default="control")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--check-within", type=int, nargs=2, default=None,
                   help="draw the checked frames from this range (a render control's "
                        "frames take the reference's time each)")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import run

    run.cache_environment(ROOT)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    overrides = {"check_within": args.check_within} if args.check_within else None
    for seed in args.seeds:
        if args.fault == "control":
            context = reference_in_place(args.workload, torch.bfloat16)
        else:
            context = planted(args.workload, args.fault)
        with context:
            result, numbers = run.run_cell(args.workload, seed, args.seconds, False,
                                           torch.device("cuda", 0),
                                           traffic_overrides=overrides)
        print(json.dumps({"workload": args.workload, "fault": args.fault, "seed": seed,
                          "correct": result["correct"],
                          "numbers": {n: v for n, v, _ in numbers}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
