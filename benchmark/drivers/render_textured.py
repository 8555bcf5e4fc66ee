"""Driver ``render_textured``: :mod:`render`'s frames on a textured scene
whose texels are made from the run's seed.

Set-up makes the configuration's maps (``harness/texdata.py``) and builds
the program's scene from them through its sample
(``samples.build(name, textures=...)``: the scene builder packs them onto
the card), then takes the tracer the CLI takes for a textured scene
(``ops.cuda_path.make_camera_path_tracer``: kernel 4) and warms it and the
accumulate up, as ``render.Session.setup`` does for a scene it builds
itself (this restates it; a program without the sample fails here).  The
frame loop and ``segments_per_s`` are ``render``'s own.

After the window, one frame of kernel 4's counting build
(``trace.counted``, frame 0) and the share of the maps' neighbouring texel
pairs that are smooth (``texdata.smooth_share``) are printed on standard
error; neither enters a metric.

The check is ``render``'s, on whole frames under ``reference/render.py``'s
``LIMITS``, with the reference's scene built from the configuration's
description and the same maps the program received, its tables built once
for the checked frames.  ``work()``: the segments the program counted, at
``harness/texwork.py``'s frozen count.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from benchmark.drivers import render
from benchmark.harness import texdata, texwork, timing
from benchmark.reference import pathtrace as pt
from benchmark.reference import render as ref_render
from benchmark.reference import scene as ref_scene


class Session(render.Session):
    def setup(self):
        from fspt_tpu_torch.config import RenderConfig
        from fspt_tpu_torch.ops import cuda_path
        from fspt_tpu_torch.render import framebuffer
        from fspt_tpu_torch.scene import samples

        ctx, dev = self.ctx, self.ctx.device
        t0 = time.perf_counter()
        self.maps = texdata.make_maps(ctx.config, ctx.seed)
        t1 = time.perf_counter()
        self.fbm = framebuffer
        b = samples.build(ctx.config["program"]["sample"], device=dev, textures=self.maps)
        scene = b.compile(device=dev)
        cfg = RenderConfig(width=self.width, height=self.height, spp=self.spp,
                           max_depth=self.depth)
        self.tracer = cuda_path.make_camera_path_tracer(scene, b.cameras[0], cfg)
        if self.tracer is None:
            raise RuntimeError("the configuration's scene takes no camera-fused tracer")
        del b, scene
        t2 = time.perf_counter()
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
        self.setup_phases = {"texels": t1 - t0, "scene and tracer": t2 - t1,
                             "warm-up frames": time.perf_counter() - t2}

    def release(self):
        """Count one frame's texel fetches and measure the maps'
        smoothness, then free the program's state."""
        counted = getattr(self.tracer, "counted", None)
        if counted is not None:
            out = counted(self.seed, 0)
            surface, sky = (int(x) for x in out.fetches.tolist())
            segments = int(out.segments)
            self.counted = dict(seed=self.seed, frame=0, surface=surface, sky=sky,
                                segments=segments)
            print(f"benchmark: counted frame 0 at seed {self.seed}: {surface} surface and "
                  f"{sky} sky texel fetches over {segments} segments, "
                  f"{(surface + sky) / max(segments, 1)!r} a segment", file=sys.stderr)
        share = texdata.smooth_share(self.maps, self.ctx.device)
        print(f"benchmark: smooth texel pairs {share!r} (relative step at most "
              f"{texdata.SMOOTH_RTOL})", file=sys.stderr, flush=True)
        super().release()

    def reference_scene(self):
        return ref_scene.build(self.ctx.config["reference"]["scene"], self.maps)

    def check(self) -> list:
        """``[(name, value, limit)]`` over the checked frames."""
        import torch

        ctx = self.ctx
        scene = self.reference_scene()
        tables = pt.Tables(scene, torch.float32, ctx.device)
        cam = pt.PinholeCamera(scene.camera, self.width, self.height)
        worst = {k: 0.0 for k in ref_render.LIMITS}
        self.failed = 0
        for k in sorted(self.snaps):
            ref = pt.trace_frame(tables, cam, self.spp, self.depth, self.seed, k * self.spp,
                                 ctx.traffic["check_block_lanes"])
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
        their segments as the program counted them."""
        rows = self.reference_scene().rows
        lanes = self.width * self.height * self.spp
        pixels = self.width * self.height
        ops = nbytes = 0
        for segments in self.frame_segments[first:first + count]:
            o, b = texwork.render_frame_work(segments, lanes, pixels, rows)
            ops, nbytes = ops + o, nbytes + b
        return ops, nbytes
