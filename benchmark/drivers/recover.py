"""Driver ``recover``: recovery steps back to back, as a user's loop runs them.

Set-up builds the configuration's scene through the program, renders the
target from ``target_frames`` frames at the scene's own values (the camera
tracer and ``render.framebuffer.accumulate``), draws the start values from
the seed, builds the step with ``parallel.train.make_fused_recovery_step``
(one device, Adam) and drives it through its first ``setup_steps`` steps:
they are its warm-up, and the steps the reference follows.  Step ``i`` uses
frame index ``i``; the window goes on from there with the same step, its
optimizer and its values.  Each step ends when its loss is read on the host.

End to end: ``recover_step_ms``, the window's seconds over the steps it
completed (the manifest keeps it apart per cell, as
``recover_step_ms.<suffix>``).
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.harness import program, workcount
from benchmark.harness import timing
from benchmark.reference import pathtrace as pt
from benchmark.reference import recover as ref_recover
from benchmark.reference import scene as ref_scene

#: Each number's limit, set between the largest reading of sound runs
#: (lower) and the smallest reading of the control or of a fault that reads
#: ten times the lower (upper; a state left unchanged reads 1), with more
#: room above the lower; the readings are in PERF.md.
LIMITS = {
    "loss_gap": 1e-2,         # lower 9.0e-4, upper 2.4e-2
    "first_grad_gap": 3e-3,   # lower 5.2e-4, upper 9.1e-3
    "first_grad_diff": 4e-3,  # lower 5.6e-4, upper 1.2e-2
    "change_gap": 1.5e-2,     # lower 3.5e-3, upper 4.3e-2
}


def start_values(traffic, seed, scene) -> dict:
    """The start of the recovery, drawn from the seed: each field's true
    column times a factor, per the traffic's ``start`` rules
    (``times_uniform: [lo, hi]`` per element, or ``times: c``), clamped to
    ``clamp`` where given.  NumPy float32 arrays."""
    rng = np.random.default_rng(seed)
    column = {"diffuse": [m["diffuse"] for m in scene.materials],
              "emissive": [m["emissive"] for m in scene.materials],
              "param": [m["param"] for m in scene.materials]}
    out = {}
    for field in traffic["fields"]:
        rule = traffic["start"][field]
        true = np.asarray(column[field], np.float32)
        if "times_uniform" in rule:
            lo, hi = rule["times_uniform"]
            v = true * rng.uniform(lo, hi, true.shape).astype(np.float32)
        else:
            v = true * np.float32(rule["times"])
        if "clamp" in rule:
            v = np.clip(v, *rule["clamp"])
        out[field] = v.astype(np.float32)
    return out


class Session:
    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.width, self.height = t["width"], t["height"]
        self.spp, self.depth = t["spp"], t["max_depth"]
        self.seed = ctx.seed
        self.step_seed = ctx.seed + t["step_seed_offset"]
        self.span = timing.spans(ctx.trace)

    def setup(self):
        import torch

        from fspt_tpu_torch.config import RenderConfig
        from fspt_tpu_torch.ops import cuda_path
        from fspt_tpu_torch.parallel import train
        from fspt_tpu_torch.render import framebuffer

        ctx, t, dev = self.ctx, self.ctx.traffic, self.ctx.device
        t0 = time.perf_counter()
        scene, camera = program.program_scene(ctx.root, ctx.config, dev)
        cfg = RenderConfig(width=self.width, height=self.height, spp=self.spp,
                           max_depth=self.depth)
        tracer = cuda_path.make_camera_path_tracer(scene, camera, cfg)
        fb = framebuffer.create(self.height, self.width, device=dev)
        for f in range(t["target_frames"]):
            out = tracer(self.seed, f * self.spp)
            fb = framebuffer.accumulate(fb, out.radiance, out.aov_normal, out.aov_depth,
                                        out.aov_mat, self.height, self.width, self.spp)
        self.target = fb.mean
        del tracer, fb, out
        t1 = time.perf_counter()
        self.start = start_values(t, self.seed, ref_scene.from_config(ctx.config, ctx.root))
        lr = t["lr"]
        constraints = {k: tuple(v) for k, v in t["constraints"].items()}
        self.step = train.make_fused_recovery_step(
            None, scene, camera, cfg, fields=tuple(t["fields"]), pool=t["pool"],
            constraints=constraints, optimizer=lambda ps: torch.optim.Adam(ps, lr=lr))
        self.scene, self.camera = scene, camera
        self.params = {k: torch.from_numpy(v).to(dev) for k, v in self.start.items()}
        self.state = self.step.init(self.params)
        t2 = time.perf_counter()
        self.losses, self.after = [], []
        self.i = 0
        for _ in range(t["setup_steps"]):
            self._step()
            self.losses.append(float(self.loss))
            if self.i == 1:
                beta1 = self.state.optimizer.defaults["betas"][0]
                opt_state = self.state.optimizer.state
                self.first_grad = {k: opt_state[leaf]["exp_avg"].detach().clone() / (1 - beta1)
                                   for k, leaf in self.state.leaves.items()}
            self.after.append({k: v.detach().clone() for k, v in self.params.items()})
        self.steps = 0
        timing.synchronize(dev)
        self.setup_phases = {"scene and target": t1 - t0, "step built": t2 - t1,
                             "set-up steps": time.perf_counter() - t2}

    def _step(self):
        self.params, self.state, self.loss = self.step(self.params, self.state, self.scene,
                                                       self.camera, self.target,
                                                       self.step_seed, self.i)
        self.i += 1

    def iteration(self, k: int):
        with self.span("bench.step"):
            self._step()
        with self.span("bench.loss_read"):
            float(self.loss)
        self.steps += 1

    def end_to_end(self, window_s: float) -> dict:
        return {"recover_step_ms": (window_s * 1e3 / self.steps, "ms")}

    @property
    def attempted(self) -> int:
        return self.steps

    def release(self):
        self.step = self.state = self.params = self.scene = self.target = None

    def check(self) -> list:
        """Follow the set-up steps with the reference and judge them:
        ``[(name, value, limit)]``."""
        import torch

        ctx, t, dev = self.ctx, self.ctx.traffic, self.ctx.device
        scene = ref_scene.from_config(ctx.config, ctx.root)
        cam = pt.PinholeCamera(scene.camera, self.width, self.height)
        block = t["check_block_rows"]
        target = ref_recover.target_image(scene, cam, self.spp, self.depth, self.seed,
                                          t["target_frames"], block, torch.float32, dev)
        start = {k: torch.from_numpy(v).to(dev) for k, v in self.start.items()}
        ref = ref_recover.follow(scene, cam, t, self.step_seed, start, target,
                                 len(self.after), block, torch.float32)
        self.segments_per_step = ref["segments"]
        self.scene_rows = scene.rows
        loss_gap = max(abs(p - r) / max(abs(r), 1e-30)
                       for p, r in zip(self.losses, ref["losses"]))
        grad_gap = max(ref_recover.leaf_gaps(self.first_grad, ref["first_grad"]).values())
        grad_diff = max(ref_recover.leaf_diffs(self.first_grad, ref["first_grad"]).values())
        keep = ref_recover.moving_leaves(ref["first_grad"])
        prog_change = {k: self.after[-1][k] - start[k] for k in start}
        ref_change = {k: ref["values"][k] - start[k] for k in start}
        change_gap = max(ref_recover.leaf_gaps(prog_change, ref_change, keep).values())
        numbers = {"loss_gap": loss_gap, "first_grad_gap": grad_gap,
                   "first_grad_diff": grad_diff, "change_gap": change_gap}
        self.failed = int(any(v > LIMITS[k] for k, v in numbers.items()))
        return [(k, numbers[k], LIMITS[k]) for k in LIMITS]

    def work(self, first: int, count: int):
        """``(ops, bytes)`` of ``count`` window steps: both buffers'
        segments a step as the reference counted them on the steps it
        followed (the program reports none), against the scene's rows."""
        ops, nbytes = workcount.recover_step_work(self.segments_per_step,
                                                  self.width * self.height,
                                                  self.scene_rows, self.ctx.traffic["fields"])
        return ops * count, nbytes * count
