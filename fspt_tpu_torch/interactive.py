"""Interactive render session: orbit / focus / progressive refinement.

Port of fspt_tpu/interactive.py, the stand-in for the reference's Win32
event loop (reference main.cpp:114-165): a host-side session object
exposes its interactions as methods —

* :meth:`RenderSession.orbit` — rotate the camera about its target
  (main.cpp:127-143's left-drag yaw/pitch); resets accumulation like
  ``DisplayFrame::Reset`` + ``ImagePlaneCache::Invalidate``
  (main.cpp:142-143),
* :meth:`RenderSession.focus_at` — click-to-focus: probe the scene depth
  under a pixel and set ``focal_depth`` (main.cpp:144-154 → TraceRange),
* :meth:`RenderSession.set_fast_render` — 1-bounce preview while dragging
  (main.cpp:124),
* :meth:`RenderSession.refine` — run N progressive frames,
* :meth:`RenderSession.snapshot` — tonemapped uint8 image on the host
  (optionally denoised).

The session renders on the CUDA card unless given ``device="cpu"``.  A
terminal loop lives in ``python -m fspt_tpu_torch.interactive <scene>``.
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from fspt_tpu_torch.camera import Camera, probe_ray
from fspt_tpu_torch.config import RenderConfig, resolve_device
from fspt_tpu_torch.render import framebuffer as fb_mod
from fspt_tpu_torch.render import integrator
from fspt_tpu_torch.utils import vecmath as vm


def trace_range(scene, camera: Camera, width: int, height: int, x, y):
    """Distance from the camera to the first hit under pixel (x, y), a 0-d
    float32 tensor on the camera's device.

    The reference's ``TraceRange`` (engine.cpp:298-329): un-jittered center
    ray, full scene trace (analytic primitives ∪ BVH triangles), distance
    or ``z_far`` on a miss.
    """
    start, seg = probe_ray(camera, width, height, x, y)
    hit = integrator.intersect_full(scene, start[None], seg[None])
    dist = torch.linalg.norm(hit.point[0] - start)
    return torch.where(hit.hit[0], dist, camera.z_far)


class RenderSession:
    """Progressive render with reference-style interactions.

    ``builder`` is a scene builder (``scene.builder.SceneBuilder``, or
    anything with ``compile(device=)`` and ``cameras``).  ``generation``
    counts the resets: :meth:`orbit`, :meth:`focus_at`,
    :meth:`set_fast_render` and :meth:`reset` bump it, so a frame rendered
    from an older state can be recognised and dropped
    (render/preview.py).
    """

    def __init__(self, builder, cfg: RenderConfig | None = None, seed: int = 0,
                 camera_index: int = 0, first_hit_cache: bool = False, device=None):
        self.device = resolve_device(device)
        self.builder = builder
        self.scene = builder.compile(device=self.device)
        if builder.cameras:
            cam = builder.cameras[camera_index]
            self.camera = Camera(*(t.to(self.device) for t in cam))
        else:
            self.camera = Camera.create(device=self.device)
        self.cfg = cfg or RenderConfig(width=400, height=240, spp=1)
        self.seed = seed
        self.frame = 0
        self.generation = 0
        self.fast_render = False
        self._fb = fb_mod.create(self.cfg.height, self.cfg.width, device=self.device)
        self._steps = {}
        self.path_name = None  # set when a step is first built
        # Warm-start first-hit cache (reference ImagePlaneCache,
        # engine.h:46-65): while the camera is still, depth 0 resolves
        # outside the queue from a pose-keyed bundle; a new pose rebuilds
        # it (main.cpp:142-143).  Opt-in: it freezes the camera jitter.
        self.first_hit_cache = first_hit_cache
        self._cached = None  # (step, cache_fn) | False (n/a)
        self._fh = None  # current pose bundle
        self._fh_key = None  # camera-pose key it was built for

    # -- interactions (main.cpp:117-154) -----------------------------------

    def reset(self):
        """Restart accumulation (DisplayFrame::Reset, frame.cpp:43-51)."""
        self._fb = fb_mod.create(self.cfg.height, self.cfg.width, device=self.device)
        self.frame = 0
        self.generation += 1

    def orbit(self, yaw: float, pitch: float):
        """Rotate camera origin about its target; resets accumulation."""
        up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=self.device)
        origin = self.camera.origin - self.camera.target
        origin = vm.rotate(origin, yaw, up)
        fwd = vm.normalize(-origin)
        right = vm.normalize(vm.cross(up, fwd))
        origin = vm.rotate(origin, pitch, right)
        self.camera = self.camera._replace(origin=origin + self.camera.target)
        self.reset()

    def focus_at(self, x: int, y: int):
        """Click-to-focus: focal_depth := scene depth under the pixel."""
        dist = trace_range(self.scene, self.camera, self.cfg.width, self.cfg.height, x, y)
        self.camera = self.camera._replace(focal_depth=dist)
        self.reset()
        return float(dist)

    def set_fast_render(self, enabled: bool):
        if enabled != self.fast_render:
            self.fast_render = enabled
            self.reset()

    # -- rendering ----------------------------------------------------------

    def _step_fn(self, fast_render: bool):
        """The step for the current cfg on the fastest camera-dynamic path
        (render/dispatch.py), built once a config."""
        from fspt_tpu_torch.render.dispatch import make_scene_step

        cfg = dataclasses.replace(self.cfg, fast_render=True) if fast_render else self.cfg
        if cfg not in self._steps:
            name, step = make_scene_step(self.scene, cfg)
            self.path_name = name
            self._steps[cfg] = step
        return self._steps[cfg]

    @staticmethod
    def _camera_key(camera):
        return b"".join(t.detach().cpu().numpy().tobytes() for t in camera)

    def _cached_step_fn(self):
        """``(step, cache_fn)`` of the first-hit-cached BVH path, or None
        when the scene or config cannot use it (analytic scenes keep their
        path: primaries are already cheap there)."""
        if self._cached is False:
            return None
        if self._cached is None:
            from fspt_tpu_torch.render.dispatch import make_cached_scene_step

            name, step, cache_fn = make_cached_scene_step(self.scene, self.cfg)
            if step is None:
                self._cached = False
                return None
            self.path_name = name
            self._cached = (step, cache_fn)
        return self._cached

    def _render(self, camera, fb, frame: int, frames: int, fast_render: bool):
        """Render ``frames`` progressive frames from ``(camera, fb, frame)``
        without touching the session's accumulation state; returns the new
        framebuffer and the segments traced.  The first-hit cache follows
        ``camera``'s pose."""
        cached = None
        if self.first_hit_cache and not fast_render:
            cached = self._cached_step_fn()
        segments = 0
        if cached is not None:
            step, cache_fn = cached
            key = self._camera_key(camera)
            if self._fh is None or key != self._fh_key:
                self._fh = cache_fn(self.scene, camera, self.seed)
                self._fh_key = key
            for i in range(frames):
                fb, segs = step(self.scene, camera, fb, self.seed, frame + i, self._fh)
                segments += int(segs)
            return fb, segments
        step = self._step_fn(fast_render)
        for i in range(frames):
            fb, segs = step(self.scene, camera, fb, self.seed, frame + i)
            segments += int(segs)
        return fb, segments

    def _commit(self, fb, frame: int, frames: int, generation: int) -> bool:
        """Make ``fb`` (``frames`` frames rendered from frame ``frame`` of
        generation ``generation``) the session's accumulation, unless the
        session changed since; returns whether it did."""
        if self.generation != generation or self.frame != frame:
            return False
        self._fb, self.frame = fb, frame + frames
        return True

    def refine(self, frames: int = 1):
        """Render and accumulate ``frames`` frames; returns the segments."""
        frame, generation = self.frame, self.generation
        fb, segments = self._render(self.camera, self._fb, frame, frames, self.fast_render)
        self._commit(fb, frame, frames, generation)
        return segments

    def _display(self, fb, denoise: bool = False):
        """``fb``'s tonemapped uint8 image, copied to the host."""
        image = fb.mean
        if denoise:
            from fspt_tpu_torch.render.denoiser import denoise as run_denoise

            image = run_denoise(fb)
        return fb_mod.to_display(image, self.cfg.gamma_correct).cpu().numpy()

    def snapshot(self, denoise: bool = False):
        return self._display(self._fb, denoise)

    @property
    def framebuffer(self):
        return self._fb


def main(argv=None):
    """Tiny terminal loop: orbit with a/d/w/s, f=focus center, q=quit."""
    import argparse

    p = argparse.ArgumentParser(description="fspt_tpu_torch interactive session")
    p.add_argument("file", help="input .scene file")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default: cuda)")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])
    from fspt_tpu_torch.scene.parser import load_scene
    from fspt_tpu_torch.utils.image import write_image

    device = resolve_device(args.device)
    session = RenderSession(load_scene(args.file, device=device), device=device)
    print("commands: a/d orbit yaw, w/s orbit pitch, f focus center, "
          "r refine 8 frames, p save preview.png, q quit")
    while True:
        cmd = input("> ").strip() or "r"
        if cmd == "q":
            break
        elif cmd == "a":
            session.orbit(-0.1, 0.0)
        elif cmd == "d":
            session.orbit(0.1, 0.0)
        elif cmd == "w":
            session.orbit(0.0, 0.1)
        elif cmd == "s":
            session.orbit(0.0, -0.1)
        elif cmd == "f":
            d = session.focus_at(session.cfg.width // 2, session.cfg.height // 2)
            print(f"Setting focus distance to {d:.2f}")  # main.cpp:151
        elif cmd == "p":
            write_image("preview.png", session.snapshot(denoise=True)[::-1])
            print("wrote preview.png")
        session.refine(4)
        print(f"frame {session.frame}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
