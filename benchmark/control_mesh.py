#!/usr/bin/env python3
"""The control and the faults of a ``render_mesh`` cell (``control.py``
dispatches on the ``render`` and ``recover`` drivers only).

    python3 benchmark/control_mesh.py --workload heightfield-render --fault control --seeds 11 12 13

``control``: the plain mesh reference (``reference/mesh.py``) computed in
bfloat16, put in the place of the path tracer the render loop takes
(``ops.cuda_path.make_camera_path_tracer``).  Its frames take the
reference's time (brute force over every triangle, the whole frame), so a
control run warms up one frame (the render driver's set-up needs one) and
checks frame 0 alone.  The faults are ``control.py``'s render faults, planted in the
same calls (``state_unchanged``, ``half_the_batch``, ``answer_altered``).
Each seed prints one JSON line with the numbers compared and whether the
run came out correct.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import control  # noqa: E402

FAULTS = control.FAULTS
#: A control run's traffic: one warm-up frame, frame 0 alone checked.
CONTROL_TRAFFIC = {"warmup_frames": 1, "check_frames": 0}


@contextlib.contextmanager
def reference_in_place(workload: str, dtype, root: Path = ROOT):
    """Swap the program's camera tracer for the mesh reference in ``dtype``."""
    import torch

    from benchmark.harness import cell as cells
    from benchmark.reference import mesh as ref_mesh
    from benchmark.reference import pathtrace as pt
    from benchmark.reference import scene as ref_scene
    from fspt_tpu_torch.ops import cuda_path

    c = cells.resolve(workload, root)
    scene = ref_scene.from_config(c.config, root)
    block = c.traffic["check_block_elems"]

    def replacement(scene_pack, camera, cfg):
        dev = scene_pack.device
        tables = pt.Tables(scene, dtype, dev)
        mesh = ref_mesh.mesh_from_config(c.config, dtype, dev, block)
        cam = ref_mesh.ThinLensCamera(scene.camera, cfg.width, cfg.height)
        per_call = max(1, block // max(mesh.count, 1)) * 64

        def trace(seed, sample0, lane0=0, n_lanes=None):
            n = cfg.height * cfg.width * cfg.spp if n_lanes is None else n_lanes
            parts = []
            with torch.no_grad():
                for l0 in range(lane0, lane0 + n, per_call):
                    lanes = torch.arange(l0, min(l0 + per_call, lane0 + n), device=dev)
                    parts.append(ref_mesh.trace_lanes(tables, mesh, cam, cfg.spp,
                                                      cfg.max_depth, seed, sample0, lanes))
            L, nrm, d, m, s = (torch.cat(p) for p in zip(*parts))
            return SimpleNamespace(radiance=L.float(), aov_normal=nrm.float(),
                                   aov_depth=d.float(), aov_mat=m, segments=s.sum(), walk=None)

        return trace

    with control._swapped(cuda_path, "make_camera_path_tracer", replacement):
        yield


def planted(workload: str, fault: str, root: Path = ROOT):
    """A context in which the mesh cell ``workload``'s render calls have
    ``fault`` (one of :data:`FAULTS`)."""
    from benchmark.harness import cell as cells

    driver = cells.resolve(workload, root).traffic["driver"]
    if driver != "render_mesh":
        raise ValueError(f"{workload} runs driver {driver!r}: use control.py")
    return control._render_fault(fault)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", choices=("control",) + FAULTS, default="control")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    import torch

    from benchmark import run

    run.cache_environment(ROOT)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        if args.fault == "control":
            context, overrides = reference_in_place(args.workload, torch.bfloat16), \
                CONTROL_TRAFFIC
        else:
            context, overrides = planted(args.workload, args.fault), None
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
