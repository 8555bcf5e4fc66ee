"""The port's spans (``utils/profiling.span``) at its layer boundaries.

Under a ``torch.profiler`` each layer records its own range on the
profiler's timeline: ``fspt.trace`` a camera tracer's call,
``fspt.accumulate`` the framebuffer fold, ``fspt.recover.step`` a recovery
step with ``fspt.recover.grad`` and ``fspt.recover.optimizer`` inside it.
With no profiler recording, a span calls nothing of the profiler and the
outputs are the same bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.ops import cuda_path
from fspt_tpu_torch.parallel import train
from fspt_tpu_torch.render import framebuffer
from fspt_tpu_torch.scene import samples
from fspt_tpu_torch.utils import profiling

CPU = torch.device("cpu")
CFG = RenderConfig(width=16, height=8, spp=2, max_depth=3)
SPANS = ("fspt.trace", "fspt.accumulate", "fspt.recover.step", "fspt.recover.grad",
         "fspt.recover.optimizer")


def _scene(name="flagship"):
    b = samples.build(name, device=CPU)
    return b.compile(device=CPU), b.cameras[0]


def _spans(prof) -> dict:
    """``{name: [(start_us, end_us)]}`` of the port's spans the profiler
    recorded."""
    out = {}
    for e in prof.events():
        if e.name.startswith("fspt."):
            out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return out


def _recording():
    return profile(activities=[ProfilerActivity.CPU])


def _frame(tracer, fb):
    out = tracer(3, 0)
    return out, framebuffer.accumulate(fb, out.radiance, out.aov_normal, out.aov_depth,
                                       out.aov_mat, CFG.height, CFG.width, CFG.spp)


def _recovery(pool, adam):
    scene, camera = _scene()
    target = torch.full((CFG.height, CFG.width, 3), 0.3)
    fields = ("diffuse", "emissive") if pool == 1 else ("diffuse", "param")
    opt = (lambda ps: torch.optim.Adam(ps, lr=0.02)) if adam else None
    step = train.make_fused_recovery_step(None, scene, camera, CFG, fields=fields, pool=pool,
                                          lr=0.05, optimizer=opt)
    params = {k: getattr(scene.materials, k).detach().clone() * 0.8 for k in fields}
    if adam:
        state = step.init(params)
        return lambda: step(params, state, scene, camera, target, 5, 0)
    return lambda: step(params, scene, camera, target, 5, 0)


@pytest.mark.parametrize("name", ["flagship", "textured"])
def test_camera_tracer_records_one_trace_span(name):
    scene, camera = _scene(name)
    tracer = cuda_path.make_camera_path_tracer(scene, camera, CFG)
    with _recording() as prof:
        out = tracer(3, 0)
    assert int(out.segments) > 0
    spans = _spans(prof)
    assert set(spans) == {"fspt.trace"}
    assert len(spans["fspt.trace"]) == 1


def test_accumulate_records_one_accumulate_span():
    scene, camera = _scene()
    out = cuda_path.make_camera_path_tracer(scene, camera, CFG)(3, 0)
    fb = framebuffer.create(CFG.height, CFG.width, device=CPU)
    with _recording() as prof:
        fb = framebuffer.accumulate(fb, out.radiance, out.aov_normal, out.aov_depth,
                                    out.aov_mat, CFG.height, CFG.width, CFG.spp)
    assert float(fb.count.min()) == CFG.spp
    spans = _spans(prof)
    assert set(spans) == {"fspt.accumulate"} and len(spans["fspt.accumulate"]) == 1


@pytest.mark.parametrize("pool,adam", [(1, True), (1, False), (8, True)],
                         ids=["kernel8-adam", "kernel8-sgd", "kernels9-10-adam"])
def test_recovery_step_nests_its_spans(pool, adam):
    take_step = _recovery(pool, adam)
    with _recording() as prof:
        loss = take_step()[-1]
    assert np.isfinite(float(loss))
    spans = _spans(prof)
    assert set(spans) == {"fspt.recover.step", "fspt.recover.grad", "fspt.recover.optimizer"}
    assert all(len(v) == 1 for v in spans.values()), spans
    (s0, s1), = spans["fspt.recover.step"]
    (g0, g1), = spans["fspt.recover.grad"]
    (o0, o1), = spans["fspt.recover.optimizer"]
    assert s0 <= g0 < g1 <= o0 < o1 <= s1


def test_span_is_off_outside_a_recording_profiler():
    """One shared do-nothing context while no profiler records, also in a
    scheduled profiler's warm-up step; a profiler range while one does."""
    off = profiling.span("fspt.trace")
    assert off is profiling.span("fspt.accumulate")
    with off:
        pass
    prof = profile(activities=[ProfilerActivity.CPU],
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
    with prof:
        assert profiling.span("fspt.trace") is off
        prof.step()
        on = profiling.span("fspt.trace")
        assert isinstance(on, torch.profiler.record_function)
        with on:
            pass
    assert profiling.span("fspt.trace") is off
    assert set(_spans(prof)) == {"fspt.trace"}


def test_spans_without_a_profiler_call_nothing_and_change_nothing(monkeypatch):
    scene, camera = _scene()
    tracer = cuda_path.make_camera_path_tracer(scene, camera, CFG)

    def run():
        out, fb = _frame(tracer, framebuffer.create(CFG.height, CFG.width, device=CPU))
        params, *_, loss = _recovery(1, True)()
        return [out.radiance, out.aov_normal, out.aov_depth, out.aov_mat, out.segments,
                *fb, loss, *params.values()]

    with _recording() as prof:
        traced = run()
    assert set(_spans(prof)) == set(SPANS)

    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler recording")

    # The name a span calls; torch's own ranges (Adam's) are not the port's.
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    plain = run()
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype and torch.equal(a, b)
