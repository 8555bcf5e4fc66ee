"""Metrics, timing and observability.

Port of fspt_tpu/utils/profiling.py: a structured logger, a per-frame
segments/s timer compatible with the reference counter, the spans that
mark the port's layer boundaries on the profiler's timeline, a
``torch.profiler`` trace context (in place of ``jax.profiler``) and the
device's memory counters.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import time

import torch

from fspt_tpu_torch.config import resolve_device

logger = logging.getLogger("fspt_tpu")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


def log_event(event: str, **fields):
    """One structured (JSON) log line."""
    logger.info("%s %s", event, json.dumps(fields, default=float))


class FrameTimer:
    """Rays/s accounting compatible with the reference counter (path
    segments per wall-clock second, engine.cpp:291-292).

    On a CUDA ``device`` each end of :meth:`frame` synchronizes it before
    reading the clock, so the seconds time the frame's kernels, not their
    launches.
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.frames = 0
        self.segments = 0
        self.seconds = 0.0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def frame(self):
        self._sync()
        t0 = time.perf_counter()
        yield self
        self._sync()
        self.seconds += time.perf_counter() - t0
        self.frames += 1

    def add_segments(self, n):
        self.segments += int(n)

    @property
    def mrays_per_sec(self):
        return self.segments / (1e6 * self.seconds) if self.seconds else 0.0

    def summary(self) -> dict:
        return dict(frames=self.frames, segments=self.segments,
                    seconds=self.seconds, mrays_per_sec=self.mrays_per_sec)


#: The C++ profiler's own switch: on only while a profiler records (not in
#: a ``torch.profiler`` schedule's wait or warm-up steps).
_profiler_enabled = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A range named ``name`` on the profiler's timeline while a profiler
    records (``torch.profiler.record_function``); otherwise one shared
    do-nothing context, with nothing of the profiler called.

    The port's spans mark its layer boundaries: ``fspt.trace`` (a camera
    tracer's call), ``fspt.accumulate`` (the framebuffer fold),
    ``fspt.recover.step`` and, inside it, ``fspt.recover.grad`` (the loss
    and gradient call) and ``fspt.recover.optimizer`` (the update and the
    parameter hand-off).  A span neither synchronizes, allocates nor
    launches anything on the device.
    """
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def device_trace(log_dir: str, device=None):
    """``torch.profiler`` trace of the block: CPU activity, and CUDA activity
    on a CUDA ``device``.  Yields the path of the Chrome trace (for
    perfetto or chrome://tracing) that it writes into ``log_dir`` when the
    block ends."""
    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with torch.profiler.profile(activities=activities) as prof:
        yield path
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(path)


def device_memory_stats(device=None) -> dict:
    """The integer counters of ``torch.cuda.memory_stats`` (bytes, counts)
    on a CUDA ``device``; ``{}`` on the CPU, which keeps none."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {}
    return {k: int(v) for k, v in torch.cuda.memory_stats(dev).items()
            if isinstance(v, int) and not isinstance(v, bool)}
