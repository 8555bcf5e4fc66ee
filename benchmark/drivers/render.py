"""Driver ``render``: progressive frames back to back, as the CLI runs them.

Set-up builds the configuration's scene through the program, takes the
tracer the CLI takes for it (``ops.cuda_path.make_camera_path_tracer``: the
camera-fused kernel, or its texture-deferred form) and warms both it and
``render.framebuffer.accumulate`` up on a scratch framebuffer.  Frame ``k``
of the window traces samples ``k·spp ..`` at the run's seed, folds them into
the framebuffer, synchronizes and reads the frame's segment count, as the
CLI's loop does (cli.py:82-96, 128-136).

End to end: ``segments_per_s``, every segment of the window over its
seconds.  Frame 0 and ``check_frames`` more drawn from the seed in
``check_within`` keep copies of what they produced (outputs, framebuffer
before and after), which the reference judges once the window has closed.
The range starts after the traced frames, so that no copy runs among them.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.harness import program, timing, workcount
from benchmark.reference import pathtrace as pt
from benchmark.reference import render as ref_render
from benchmark.reference import scene as ref_scene

def _fb_copy(fb) -> dict:
    return {k: getattr(fb, k).clone() for k in ("mean", "m2", "count", "normal", "depth", "mat")}


class Session:
    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.width, self.height = t["width"], t["height"]
        self.spp, self.depth = t["spp"], t["max_depth"]
        self.seed = ctx.seed
        self.span = timing.spans(ctx.trace)

    def setup(self):
        from fspt_tpu_torch.config import RenderConfig
        from fspt_tpu_torch.ops import cuda_path
        from fspt_tpu_torch.render import framebuffer

        ctx, dev = self.ctx, self.ctx.device
        t0 = time.perf_counter()
        self.fbm = framebuffer
        scene, camera = program.program_scene(ctx.root, ctx.config, dev)
        cfg = RenderConfig(width=self.width, height=self.height, spp=self.spp,
                           max_depth=self.depth)
        self.tracer = cuda_path.make_camera_path_tracer(scene, camera, cfg)
        if self.tracer is None:
            raise RuntimeError("the configuration's scene takes no camera-fused tracer")
        t1 = time.perf_counter()
        fb = framebuffer.create(self.height, self.width, device=dev)
        for k in range(ctx.traffic["warmup_frames"]):
            out = self.tracer(self.seed, k * self.spp)
            fb = self._accumulate(fb, out)
            int(out.segments)
        del fb, out
        self.fb = framebuffer.create(self.height, self.width, device=dev)
        rng = np.random.default_rng(self.seed)
        lo, hi = ctx.traffic["check_within"]
        self.checked = {0, *(int(k) for k in rng.choice(np.arange(lo, hi), replace=False,
                                                        size=ctx.traffic["check_frames"]))}
        self.snaps = {}
        self.frame_segments = []
        timing.synchronize(dev)
        self.setup_phases = {"scene and tracer": t1 - t0,
                             "warm-up frames": time.perf_counter() - t1}

    def _accumulate(self, fb, out):
        return self.fbm.accumulate(fb, out.radiance, out.aov_normal, out.aov_depth,
                                   out.aov_mat, self.height, self.width, self.spp)

    def iteration(self, k: int):
        checked = k in self.checked
        before = _fb_copy(self.fb) if checked else None
        with self.span("bench.tracer"):
            out = self.tracer(self.seed, k * self.spp)
        with self.span("bench.accumulate"):
            self.fb = self._accumulate(self.fb, out)
        with self.span("bench.sync"):
            timing.synchronize(self.ctx.device)
            segments = int(out.segments)
        self.frame_segments.append(segments)
        if checked:
            self.snaps[k] = dict(radiance=out.radiance.clone(), normal=out.aov_normal.clone(),
                                 depth=out.aov_depth.clone(), mat=out.aov_mat.clone(),
                                 segments=segments, before=before, after=_fb_copy(self.fb))

    def end_to_end(self, window_s: float) -> dict:
        return {"segments_per_s": (sum(self.frame_segments) / window_s, "segments/s")}

    @property
    def attempted(self) -> int:
        return len(self.frame_segments)

    def release(self):
        """Free the program's state; keep the checked frames' copies."""
        frames = len(self.frame_segments)
        self.count_gap = float((self.fb.count - frames * self.spp).abs().max())
        self.fb = self.tracer = None

    def check(self) -> list:
        """``[(name, value, limit)]`` over the checked frames."""
        import torch

        ctx = self.ctx
        scene = ref_scene.from_config(ctx.config, ctx.root)
        cam = pt.PinholeCamera(scene.camera, self.width, self.height)
        worst = {k: 0.0 for k in ref_render.LIMITS}
        self.failed = 0
        for k in sorted(self.snaps):
            ref = ref_render.reference_frame(scene, cam, self.spp, self.depth, self.seed, k,
                                             ctx.traffic["check_block_lanes"],
                                             torch.float32, ctx.device)
            snap = self.snaps[k]
            if k == 0:
                snap["before"] = ref_render.empty_framebuffer(self.height, self.width,
                                                              ctx.device)
            numbers = ref_render.judge_frame(snap, ref, self.height, self.width, self.spp)
            self.failed += any(v > ref_render.LIMITS[name] for name, v in numbers.items())
            for name, v in numbers.items():
                worst[name] = max(worst[name], v)
        worst["count_gap"] = self.count_gap
        worst["missing_frames"] = float(len(self.checked - set(self.snaps)))
        self.failed += int(worst["missing_frames"])
        return [(name, worst[name], limit) for name, limit in ref_render.LIMITS.items()]

    def work(self, first: int, count: int):
        """``(ops, bytes)`` of the window's frames ``first .. first+count-1``,
        their segments as the program counted them (the check holds those
        counts to the reference's)."""
        rows = ref_scene.from_config(self.ctx.config, self.ctx.root).rows
        lanes = self.width * self.height * self.spp
        pixels = self.width * self.height
        ops = nbytes = 0
        for segments in self.frame_segments[first:first + count]:
            o, b = workcount.render_frame_work(segments, lanes, pixels, rows)
            ops, nbytes = ops + o, nbytes + b
        return ops, nbytes
