"""The port's app layer on the CPU: ``vecmath.rotate``, ``camera.probe_ray``,
``interactive.trace_range`` and ``RenderSession``, and ``utils/profiling``,
modelled on tests/test_aux.py:13-140, 153-164 and tests/test_queue.py:202.

Scenes come from the reference builder (``conftest.build_cornell_box``,
``test_diff_intersect.build_bvh_scene``) through ``convert``, so both
packages see the same primitives, BVH and camera.  Bars: geometry (rotate,
probe ray, probed distance, orbit, focus) at rtol 1e-5, the float32
rounding of two libraries' ``sin``/``cos``/``tan``/``sqrt``; the mesh
session against a direct ``render_queued`` + ``accumulate`` at rtol 2e-5 /
atol 1e-6 (tests/test_aux.py:123); the mesh hit against a float64 NumPy
Möller–Trumbore sweep at rtol 1e-3 (tests/test_aux.py:93).
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from conftest import build_cornell_box
from test_diff_intersect import build_bvh_scene

from fspt_tpu.camera import probe_ray as ref_probe_ray
from fspt_tpu.interactive import RenderSession as RefSession
from fspt_tpu.interactive import trace_range as ref_trace_range
from fspt_tpu.utils import profiling as ref_profiling
from fspt_tpu.utils import vecmath as ref_vm
from fspt_tpu_torch import convert
from fspt_tpu_torch.camera import Camera, probe_ray
from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.interactive import RenderSession, trace_range
from fspt_tpu_torch.render import framebuffer as fb_mod
from fspt_tpu_torch.render.dispatch import MESH_PATH, make_scene_step
from fspt_tpu_torch.utils import profiling
from fspt_tpu_torch.utils import vecmath as vm

CPU = torch.device("cpu")
CFG = RenderConfig(width=16, height=12, spp=1, max_depth=2)


def _np_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


class Ported:
    """A reference builder seen through the port's builder interface
    (``compile(device=)`` and ``cameras``)."""

    def __init__(self, ref):
        self.ref = ref
        self.cameras = [convert.camera_from_numpy(_np_tree(c), device=CPU)
                        for c in ref.cameras]

    def compile(self, device=None):
        return convert.scene_from_numpy(_np_tree(self.ref.compile()), device=device)


BUILDERS = {"cornell": build_cornell_box, "bvh": build_bvh_scene}


@pytest.fixture(scope="module")
def scenes():
    """name → (reference builder, reference scene, port scene)."""
    out = {}
    for name, build in BUILDERS.items():
        ref = build()
        out[name] = (ref, ref.compile(), Ported(ref).compile(device=CPU))
    return out


def test_rotate_matches_reference():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(64, 3)).astype(np.float32) * 100.0
    axis = rng.normal(size=(64, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    for angle in (0.3, -1.7, 0.0):
        out = vm.rotate(torch.from_numpy(v), angle, torch.from_numpy(axis)).numpy()
        ref = np.asarray(ref_vm.rotate(v, angle, axis))
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-4)
    # A rotation keeps lengths, and one [3] axis broadcasts over the batch.
    out = vm.rotate(torch.from_numpy(v), 0.7, torch.tensor([0.0, 1.0, 0.0]))
    np.testing.assert_allclose(np.linalg.norm(out.numpy(), axis=-1),
                               np.linalg.norm(v, axis=-1), rtol=1e-5)
    np.testing.assert_allclose(out[:, 1].numpy(), v[:, 1], rtol=1e-6)


@pytest.mark.parametrize("w,h,x,y", [(32, 32, 16, 16), (16, 12, 0, 11), (400, 240, 399, 3)])
def test_probe_ray_matches_reference(w, h, x, y):
    ref_cam = build_cornell_box().cameras[0]._replace(
        origin=np.array([30.0, 12.0, -140.0], np.float32), fov_y=np.float32(60.0))
    cam = convert.camera_from_numpy(_np_tree(ref_cam), device=CPU)
    start, seg = probe_ray(cam, w, h, x, y)
    ref_start, ref_seg = ref_probe_ray(ref_cam, w, h, x, y)
    assert start.device == CPU and seg.shape == (3,)
    np.testing.assert_array_equal(start.numpy(), np.asarray(ref_start))
    np.testing.assert_allclose(seg.numpy(), np.asarray(ref_seg), rtol=1e-5, atol=1e-2)


# Cornell (15, 11) and bvh (5, 5) look past the scene: misses, z_far in both.
@pytest.mark.parametrize("name,pixels", [("cornell", [(8, 6), (1, 1), (15, 11)]),
                                         ("bvh", [(16, 16), (27, 10), (5, 5)])])
def test_trace_range_matches_reference(scenes, name, pixels):
    ref_b, ref_scene, scene = scenes[name]
    ref_cam = ref_b.cameras[0]
    cam = convert.camera_from_numpy(_np_tree(ref_cam), device=CPU)
    w, h = (16, 12) if name == "cornell" else (32, 32)
    hits = 0
    for x, y in pixels:
        d = trace_range(scene, cam, w, h, x, y)
        assert d.shape == () and d.dtype == torch.float32
        np.testing.assert_allclose(float(d), float(ref_trace_range(ref_scene, ref_cam, w, h,
                                                                   x, y)), rtol=1e-5)
        hits += float(d) < float(cam.z_far)
    assert hits >= 2


def test_trace_range_miss_returns_zfar():
    from fspt_tpu_torch.scene.builder import SceneBuilder

    b = SceneBuilder()
    b.add_camera(Camera.create(aperture_size=0.0, device=CPU))
    scene = b.compile(device=CPU)
    d = trace_range(scene, b.cameras[0], 8, 8, 4, 4)
    assert float(d) == float(b.cameras[0].z_far)


def test_trace_range_hits_mesh(scenes):
    """Click-to-focus on a BVH-triangle surface returns the true hit
    distance: a float64 NumPy Möller–Trumbore sweep over the triangle soup
    (the analytic light quad is behind the center ray's hit)."""
    _, _, scene = scenes["bvh"]
    assert scene.bvh is not None
    cam = Ported(build_bvh_scene()).cameras[0]
    w, h = 32, 32
    d = float(trace_range(scene, cam, w, h, w // 2, h // 2))
    assert d < float(cam.z_far), "mesh hit must not fall through to z_far"

    start, seg = probe_ray(cam, w, h, w // 2, h // 2)
    start, seg = start.double().numpy(), seg.double().numpy()
    bvh = scene.bvh
    order = np.argsort(bvh.tri_id.numpy())
    v0 = bvh.tri_v0.double().numpy()[order]
    e1 = bvh.tri_e1.double().numpy()[order]
    e2 = bvh.tri_e2.double().numpy()[order]
    p = np.cross(np.broadcast_to(seg, v0.shape), e2)
    det = np.einsum("ij,ij->i", e1, p)
    ok = np.abs(det) > 1e-12
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    s = start - v0
    u = np.einsum("ij,ij->i", s, p) * inv
    q = np.cross(s, e1)
    v = (q @ seg) * inv
    t = np.einsum("ij,ij->i", e2, q) * inv
    valid = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-9) & (t <= 1)
    assert valid.any()
    np.testing.assert_allclose(d, t[valid].min() * np.linalg.norm(seg), rtol=1e-3)


def test_app_path_selection(scenes):
    """The session's steps come from the port's dispatch: the queued
    wavefront with the treelet kernels for a BVH scene, kernel 1 under the
    torch integrator for an analytic one (plain versions on the CPU)."""
    name_bvh, _ = make_scene_step(scenes["bvh"][2], CFG)
    assert name_bvh == MESH_PATH == "queued wavefront + cuda treelet BVH"
    name_analytic, _ = make_scene_step(scenes["cornell"][2], CFG)
    assert name_analytic == "cuda intersect + torch shade"


def _ref_cfg():
    from fspt_tpu.config import RenderConfig as RefConfig

    return RefConfig(**vars(CFG))


def test_render_session_orbit_focus_refine():
    ref_b = build_cornell_box()
    s = RenderSession(Ported(ref_b), CFG, seed=3, device=CPU)
    ref = RefSession(ref_b, _ref_cfg(), seed=3)

    segs = s.refine(2)
    assert segs > 0 and s.frame == 2
    assert s.path_name == "cuda intersect + torch shade"
    assert float(s.framebuffer.count.min()) == 2.0
    # refine is the dispatch step, frame after frame.
    _, step = make_scene_step(s.scene, CFG)
    fb = fb_mod.create(CFG.height, CFG.width, device=CPU)
    for f in range(2):
        fb, _ = step(s.scene, s.camera, fb, 3, f)
    np.testing.assert_array_equal(s.framebuffer.mean.numpy(), fb.mean.numpy())
    img1 = s.snapshot()
    assert isinstance(img1, np.ndarray)
    assert img1.shape == (12, 16, 3) and img1.dtype == np.uint8
    assert s.snapshot(denoise=True).shape == (12, 16, 3)

    # Orbit resets accumulation and moves the camera as the reference's does.
    old_origin = s.camera.origin.numpy().copy()
    gen = s.generation
    s.orbit(0.3, 0.1)
    ref.orbit(0.3, 0.1)
    assert s.frame == 0 and s.generation == gen + 1
    assert float(s.framebuffer.count.max()) == 0.0
    assert not np.allclose(s.camera.origin.numpy(), old_origin)
    np.testing.assert_allclose(s.camera.origin.numpy(), np.asarray(ref.camera.origin),
                               rtol=1e-5, atol=1e-3)
    target = s.camera.target.numpy()
    np.testing.assert_allclose(np.linalg.norm(s.camera.origin.numpy() - target),
                               np.linalg.norm(old_origin - target), rtol=1e-4)

    # Click-to-focus sets focal_depth to the probed distance (TraceRange), a
    # 0-d float32 tensor on the session's device.
    d = s.focus_at(8, 6)
    assert 50.0 < d < 250.0
    np.testing.assert_allclose(d, ref.focus_at(8, 6), rtol=1e-5)
    fd = s.camera.focal_depth
    assert fd.shape == () and fd.dtype == torch.float32 and fd.device == CPU
    assert float(fd) == d and s.generation == gen + 2

    # Fast-render preview mode builds the fast config's step.
    s.refine(1)
    s.set_fast_render(True)
    assert s.frame == 0
    assert s.refine(1) > 0 and s.frame == 1
    s.set_fast_render(False)
    assert s.generation == gen + 4


def test_render_session_uses_fast_mesh_path(scenes):
    """RenderSession on a BVH scene renders through the queued path and
    matches the direct queued render."""
    from fspt_tpu_torch.ops.cuda_bvh import make_mesh_intersector
    from fspt_tpu_torch.render.queue import render_queued

    ref_b = build_bvh_scene()
    s = RenderSession(Ported(ref_b), CFG, seed=3, first_hit_cache=False, device=CPU)
    assert s.refine(1) > 0
    assert s.path_name == MESH_PATH

    scene = scenes["bvh"][2]
    out = render_queued(scene, s.camera, CFG, 3, 0, intersector=make_mesh_intersector(scene))
    fb = fb_mod.accumulate(fb_mod.create(CFG.height, CFG.width, device=CPU), out.radiance,
                           out.aov_normal, out.aov_depth, out.aov_mat,
                           CFG.height, CFG.width, CFG.spp)
    np.testing.assert_allclose(s.framebuffer.mean.numpy(), fb.mean.numpy(),
                               rtol=2e-5, atol=1e-6)


def test_render_session_first_hit_cache_invalidation():
    """The session keys the first-hit bundle on the camera pose: refine()
    reuses it while the camera is still, orbit invalidates it."""
    s = RenderSession(Ported(build_bvh_scene(grid=10)), CFG, seed=3, first_hit_cache=True,
                      device=CPU)
    assert s.refine(2) > 0
    assert s.path_name == MESH_PATH + " + first-hit cache"
    key1, pose1 = s._fh_key, s._fh
    assert key1 is not None
    s.refine(1)
    assert s._fh_key == key1 and s._fh is pose1  # camera still → same bundle
    s.orbit(0.2, 0.0)
    s.refine(1)
    assert s._fh_key != key1 and s._fh is not pose1  # pose changed → rebuilt
    assert s.frame == 1


def test_profiling_metrics():
    t = profiling.FrameTimer(device=CPU)
    ref = ref_profiling.FrameTimer()
    for timer in (t, ref):
        with timer.frame():
            timer.add_segments(torch.tensor(1000))
    assert t.frames == 1 and t.segments == 1000
    assert t.mrays_per_sec > 0
    assert t.summary().keys() == ref.summary().keys()
    assert {k: t.summary()[k] for k in ("frames", "segments")} == \
        {k: ref.summary()[k] for k in ("frames", "segments")}


def test_log_event_writes_one_json_line(caplog):
    with caplog.at_level(logging.INFO, logger="fspt_tpu"):
        profiling.log_event("frame", ms=1.5, segments=np.int64(7))
    rec = [r for r in caplog.records if r.name == "fspt_tpu"][-1]
    event, fields = rec.getMessage().split(" ", 1)
    assert event == "frame" and json.loads(fields) == {"ms": 1.5, "segments": 7.0}


def test_device_trace_writes_a_cpu_trace(tmp_path):
    with profiling.device_trace(str(tmp_path / "trace"), device=CPU) as path:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.dirname(path) == str(tmp_path / "trace")
    trace = json.loads(open(path).read())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


def test_device_memory_stats_cpu_is_empty():
    assert profiling.device_memory_stats(CPU) == {}
    assert profiling.device_memory_stats("cpu") == {}


def test_app_entry_points_refuse_cpu_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from fspt_tpu_torch import interactive
    from fspt_tpu_torch.render import preview

    with pytest.raises(RuntimeError, match="device='cpu'"):
        RenderSession(Ported(build_cornell_box()), CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profiling.FrameTimer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profiling.device_memory_stats()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with profiling.device_trace(str(tmp_path)):
            pass
    scene = os.path.join(os.path.dirname(__file__), "..", "scenes", "cornell.scene")
    for entry in (interactive, preview):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry.main([scene])
