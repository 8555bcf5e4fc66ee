"""Driver ``render_mesh``: :mod:`render`'s frames on a triangle-mesh scene
through a thin-lens camera.

Set-up, the frame loop and the end-to-end reading are ``render``'s own
(imported): the tracer the CLI takes for the scene
(``ops.cuda_path.make_camera_path_tracer``; a program without one for a
mesh scene fails in set-up), frames back to back, frame ``k`` at samples
``k·spp``, one sync and segment read a frame; ``segments_per_s``.

The check is this driver's: the plain mesh reference
(``reference/mesh.py``, brute-force triangles) takes seconds a band, so
each checked frame (frame 0 and ``check_frames`` drawn from the seed in
``check_within``) is judged on ``check_rows`` image rows drawn from the
seed, every lane of them, under ``reference/render.py``'s ``LIMITS`` and
``judge_frame``: the rows' outputs and framebuffer against the reference's.
The rows' segment count is the program's own, traced again for those rows
after the window (a row must reproduce the timed frame's radiance bit for
bit, or its count reads −1); and the whole framebuffer after the frame is
held to the accumulation of the frame's own outputs onto the one before,
``framebuffer_mismatch`` the worse of the two.

``work()``: the segments the program counted, at
``harness/meshwork.py``'s frozen count per segment.
"""

from __future__ import annotations

import numpy as np

from benchmark.drivers import render
from benchmark.harness import meshwork
from benchmark.reference import mesh as ref_mesh
from benchmark.reference import render as ref_render
from benchmark.reference import scene as ref_scene


class Session(render.Session):
    def release(self):
        """Keep the tracer for the checked rows' segment counts."""
        self.row_tracer = self.tracer
        super().release()

    def check_rows(self, frame: int) -> list:
        rng = np.random.default_rng([abs(int(self.seed)), frame])
        n = min(self.ctx.traffic["check_rows"], self.height)
        return sorted(int(r) for r in rng.choice(self.height, size=n, replace=False))

    def _row_segments(self, frame: int, rows, radiance) -> int:
        """The program's segments of ``rows`` of frame ``frame``, traced
        again; −1 where a row's radiance is not the timed frame's."""
        import torch

        per_row = self.width * self.spp
        total = 0
        for i, row in enumerate(rows):
            out = self.row_tracer(self.seed, frame * self.spp, lane0=row * per_row,
                                  n_lanes=per_row)
            if not torch.equal(out.radiance, radiance[i * per_row:(i + 1) * per_row]):
                return -1
            total += int(out.segments)
        return total

    def check(self) -> list:
        """``[(name, value, limit)]`` over the checked frames."""
        import torch

        ctx, dev = self.ctx, self.ctx.device
        H, W, spp = self.height, self.width, self.spp
        scene = ref_scene.from_config(ctx.config, ctx.root)
        mesh = ref_mesh.mesh_from_config(ctx.config, torch.float32, dev,
                                         ctx.traffic["check_block_elems"])
        cam = ref_mesh.ThinLensCamera(scene.camera, W, H)
        worst = {k: 0.0 for k in ref_render.LIMITS}
        self.failed = 0
        for k in sorted(self.snaps):
            snap = self.snaps[k]
            if k == 0:
                snap["before"] = ref_render.empty_framebuffer(H, W, dev)
            rows = self.check_rows(k)
            ref = ref_mesh.reference_band(scene, mesh, cam, spp, self.depth, self.seed, k, rows,
                                          torch.float32, dev)
            lanes = ref_mesh.band_lanes(rows, W, spp, dev)
            idx = torch.as_tensor(rows, dtype=torch.int64, device=dev)
            band = {key: snap[key][lanes] for key in ("radiance", "normal", "depth", "mat")}
            band["segments"] = self._row_segments(k, rows, band["radiance"])
            band["before"] = {f: v[idx] for f, v in snap["before"].items()}
            band["after"] = {f: v[idx] for f, v in snap["after"].items()}
            numbers = ref_render.judge_frame(band, ref, len(rows), W, spp)
            own = (snap["radiance"], snap["normal"], snap["depth"], snap["mat"],
                   torch.zeros((1,), dtype=torch.int32, device=dev))
            whole = ref_render.judge_frame(snap, own, H, W, spp)["framebuffer_mismatch"]
            numbers["framebuffer_mismatch"] = max(numbers["framebuffer_mismatch"], whole)
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
        config = self.ctx.config
        rows = ref_scene.from_config(config, self.ctx.root).rows
        grid = config["reference"]["scene"]["mesh"]["grid"]
        n_triangles = 2 * (grid - 1) ** 2
        lanes = self.width * self.height * self.spp
        pixels = self.width * self.height
        ops = nbytes = 0
        for segments in self.frame_segments[first:first + count]:
            o, b = meshwork.render_frame_work(segments, lanes, pixels, rows, n_triangles)
            ops, nbytes = ops + o, nbytes + b
        return ops, nbytes
