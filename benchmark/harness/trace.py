"""The traced window: ``torch.profiler`` over the first iterations of the
measured window, read into what the per-layer metrics need.

The profiler runs with one unrecorded warm-up iteration (its CUPTI start-up)
and then records ``count`` iterations, one profiler step each.  The window
is the span of the recorded steps on the profiler's clock, which the device
records share; only device operations that start inside it count.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

SPAN_PREFIX = "bench."


class Tracer:
    def __init__(self, count: int):
        from torch.profiler import ProfilerActivity, profile, schedule

        self.count = count
        self.done = 0
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                            schedule=schedule(wait=0, warmup=1, active=count, repeat=1))
        self.prof.__enter__()

    @property
    def active(self) -> bool:
        return self.prof is not None

    def step(self):
        """Close one iteration; stop after the warm-up and ``count``."""
        self.prof.step()
        self.done += 1
        if self.done == self.count + 1:
            self.prof.__exit__(None, None, None)
            self.events = self.prof.events()
            self.prof = None


def _device_time_us(e) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(e, attr, None)
        if v is not None:
            return float(v)
    return 0.0


class Reading:
    """What a per-layer reader sees of the traced window.

    ``kernels`` and ``device_ops`` are ``(name, start_us, end_us)`` of the
    device kernels (memory copies and sets left out) and of every device
    operation that starts in the window; ``busy_s`` is the union of the
    device operations' intervals; ``span_device_s`` the device seconds of
    the kernels launched under each of the benchmark's spans; ``work`` the
    cell's ``(ops, bytes)`` for the traced iterations and ``least_s`` the
    least time of that work, or None."""

    def __init__(self, events, iterations: int, driver: str):
        from torch.autograd import DeviceType

        self.iterations = iterations
        self.driver = driver
        steps = [e for e in events if e.name.startswith("ProfilerStep")
                 and e.device_type == DeviceType.CPU]
        t0 = min(e.time_range.start for e in steps)
        t1 = max(e.time_range.end for e in steps)
        self.window_s = (t1 - t0) * 1e-6
        dev, cpu = [], []
        for e in events:
            annotation = getattr(e, "is_user_annotation", False)
            if e.name.startswith("ProfilerStep") or (annotation
                                                     and e.device_type != DeviceType.CPU):
                continue
            rng = (e.name, e.time_range.start, e.time_range.end)
            if e.device_type == DeviceType.CUDA:
                if t0 <= e.time_range.start < t1:
                    dev.append(rng)
            elif e.device_type == DeviceType.CPU:
                cpu.append(rng)
        dev.sort(key=lambda r: r[1])
        self.device_ops = dev
        self.kernels = [r for r in dev if not r[0].startswith(("Memcpy", "Memset"))]
        busy, gaps, edge = 0.0, [], t0
        for _, s, f in dev:
            if s > edge:
                gaps.append((edge, s))
            busy += max(0.0, min(f, t1) - max(s, edge))
            edge = max(edge, f)
        if edge < t1:
            gaps.append((edge, t1))
        self.busy_s = busy * 1e-6
        self.gaps = gaps
        self._cpu = sorted(cpu, key=lambda r: r[1])
        span_us = defaultdict(float)
        for e in events:
            if e.device_type == DeviceType.CPU and e.name.startswith(SPAN_PREFIX):
                if t0 <= e.time_range.start < t1:
                    span_us[e.name] += _device_time_us(e)
        self.span_device_s = {k: v * 1e-6 for k, v in span_us.items()}
        self.work = None
        self.least_s = None

    def launches(self):
        """Device kernels an iteration, or None where none was recorded."""
        if not self.kernels:
            return None
        return len(self.kernels) / self.iterations

    def idle_share(self):
        """Percent of the window with nothing on the device, or None."""
        if self.window_s <= 0.0 or not self.device_ops:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def roofline_share(self):
        """Percent: the least time of the cell's work over the device time
        it took, or None without a work count or device time."""
        if self.least_s is None or self.busy_s <= 0.0:
            return None
        return 100.0 * self.least_s / self.busy_s

    def host_at(self, t_us: float) -> str:
        """What the host was doing at ``t_us`` (a gap's midpoint): the
        innermost benchmark span and the innermost other host event open
        then."""
        starts = [r[1] for r in self._cpu]
        i = bisect.bisect_right(starts, t_us)
        span = op = None
        for name, s, f in reversed(self._cpu[max(0, i - 400):i]):
            if f < t_us:
                continue
            if name.startswith(SPAN_PREFIX):
                span = span or name
            else:
                op = op or name
            if span and op:
                break
        return f"{span or 'outside the spans'} / {op or 'no host event'}"

    def breakdown(self, top: int = 10) -> dict:
        per_op = defaultdict(float)
        for name, s, f in self.device_ops:
            per_op[name] += (f - s) * 1e-6
        per_gap = defaultdict(float)
        for s, f in self.gaps:
            per_gap[self.host_at(0.5 * (s + f))] += (f - s) * 1e-6
        order = lambda d: [[k[:200], v] for k, v in  # noqa: E731
                           sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": order(per_op), "idle_gaps": order(per_gap)}
