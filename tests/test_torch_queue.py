"""The port's queued integrator, first-hit cache and mesh CLI on the CPU.

* ``render_queued`` with the mesh intersector (kernels 1, 5, 6 plain)
  equals the port's unrolled ``render_wavefront`` at the bar of
  tests/test_queue.py:24-39 (radiance and normals rtol 2e-3 / atol 2e-5,
  depth rtol 2e-3, material AOV and segments exact), with queues small
  enough to force many refills; the same on an analytic scene with fog,
  specular chains, fast render and banding.  The queue reschedules the
  same per-lane work, so the two agree to float rounding.
* The warm-start first-hit cache equals the uncached render of the same
  frozen-jitter estimator (``cam_sample0 = 0``) at the same bar, as in
  tests/test_queue.py.  ``aovs=False`` changes nothing but the AOVs
  (zeros), and a step built with ``queue=`` renders at that queue.
* With ``edge_eps`` the queue equals the wavefront (hit-id replay
  intersector), and the winners it records (``record_hits``), replayed
  through the wavefront, reproduce its render (tests/test_queue.py:120-160).
* The CLI renders a ``write_heightfield_scene`` output on the CPU with and
  without ``--first-hit-cache``, the two close to the reference's queued
  mesh render of the same frames; it refuses to resume a checkpoint made
  under the other estimator.
"""

import numpy as np
import pytest
import torch

from fspt_tpu_torch import cli
from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.ops.cuda_bvh import make_mesh_intersector
from fspt_tpu_torch.ops.cuda_trace import make_cuda_intersector
from fspt_tpu_torch.render import integrator
from fspt_tpu_torch.render.dispatch import MESH_PATH, make_cached_scene_step, make_scene_step
from fspt_tpu_torch.render.queue import compute_warm_pose, render_queued, warm_frame
from fspt_tpu_torch.scene import samples
from fspt_tpu_torch.utils import checkpoint as ckpt

CPU = torch.device("cpu")


def _close(ref, out):
    np.testing.assert_allclose(ref.radiance.numpy(), out.radiance.numpy(), rtol=2e-3,
                               atol=2e-5)
    np.testing.assert_allclose(ref.aov_normal.numpy(), out.aov_normal.numpy(), rtol=2e-3,
                               atol=2e-5)
    np.testing.assert_allclose(ref.aov_depth.numpy(), out.aov_depth.numpy(), rtol=2e-3)
    np.testing.assert_array_equal(ref.aov_mat.numpy(), out.aov_mat.numpy())
    assert int(ref.segments) == int(out.segments)


@pytest.fixture(scope="module")
def mesh():
    b = samples.build("heightfield", device=CPU, grid=10)
    scene = b.compile(device=CPU)
    return scene, b.cameras[0], make_mesh_intersector(scene)


@pytest.mark.parametrize("queue", [64, 384])
def test_queue_matches_wavefront_mesh(mesh, queue):
    scene, cam, inter = mesh
    cfg = RenderConfig(width=16, height=12, spp=2, max_depth=3)
    ref = integrator.render_wavefront(scene, cam, cfg, 11, 3, intersector=inter)
    out = render_queued(scene, cam, cfg, 11, 3, intersector=inter, queue=queue)
    _close(ref, out)
    assert out.radiance.mean() > 0.01


def _fog_scene():
    b = samples.build("all_families", device=CPU, aperture=1.5, focal_depth=120.0)
    scene = b.compile(device=CPU)
    inter = make_cuda_intersector(scene.geometry)
    return scene, b.cameras[0], inter


def test_queue_matches_wavefront_fog_and_specular():
    scene, cam, inter = _fog_scene()
    cfg = RenderConfig(width=16, height=12, spp=2, max_depth=5)
    ref = integrator.render_wavefront(scene, cam, cfg, 5, 2, intersector=inter)
    out = render_queued(scene, cam, cfg, 5, 2, intersector=inter, queue=100)
    _close(ref, out)


def test_queue_fast_render_and_banding():
    scene, cam, inter = _fog_scene()
    cfg = RenderConfig(width=16, height=16, spp=1, max_depth=6, fast_render=True)
    ref = integrator.render_wavefront(scene, cam, cfg, 5, 0, y0=4, rows=8, intersector=inter)
    out = render_queued(scene, cam, cfg, 5, 0, y0=4, rows=8, intersector=inter, queue=40)
    _close(ref, out)


@pytest.mark.parametrize("scene_kind", ["mesh", "fog"])
def test_warm_start_matches_uncached(mesh, scene_kind):
    scene, cam, inter = mesh if scene_kind == "mesh" else _fog_scene()
    cfg = RenderConfig(width=16, height=12, spp=2, max_depth=4)
    pose = compute_warm_pose(scene, cam, cfg, 7, 0, intersector=inter, chunk=128)
    assert 0 < int(pose.n_live) < 16 * 12 * 2
    for frame in (0, 3):  # bounce stream advances, camera stream frozen
        ref = render_queued(scene, cam, cfg, 7, frame * cfg.spp, intersector=inter,
                            queue=256, cam_sample0=0)
        warm = warm_frame(scene, cam, cfg, pose, 7, frame * cfg.spp, 0)
        out = render_queued(scene, cam, cfg, 7, frame * cfg.spp, intersector=inter,
                            queue=256, cam_sample0=0, warm=warm)
        _close(ref, out)


def test_dispatch_takes_the_queued_mesh_path(mesh):
    scene, cam, inter = mesh
    cfg = RenderConfig(width=8, height=6, spp=1, max_depth=3)
    name, step = make_scene_step(scene, cfg)
    assert name == MESH_PATH
    cname, cstep, cache_fn = make_cached_scene_step(scene, cfg)
    assert cname == MESH_PATH + " + first-hit cache"
    assert make_cached_scene_step(scene, RenderConfig(max_depth=1))[1] is None
    from fspt_tpu_torch.render import framebuffer

    fb, segs = step(scene, cam, framebuffer.create(6, 8, device=CPU), 3, 0)
    fb2, segs2 = cstep(scene, cam, framebuffer.create(6, 8, device=CPU), 3, 0,
                       cache_fn(scene, cam, 3))
    assert int(segs) > 0 and int(segs2) > 0
    assert torch.isfinite(fb.mean).all() and torch.isfinite(fb2.mean).all()
    # The winner record of the vertex recovery: one row per lane and depth.
    out, (ids, hitm) = render_queued(scene, cam, cfg, 3, 0, intersector=inter,
                                     record_hits=True, queue=20)
    assert ids.shape == hitm.shape == (6 * 8, 3) and ids.dtype == torch.int32
    assert int((ids >= 0).sum()) > 0 and bool(hitm[:, 0].any())
    ref = render_queued(scene, cam, cfg, 3, 0, intersector=inter, queue=20)
    assert torch.equal(out.radiance, ref.radiance)


@pytest.mark.parametrize("warm_start", [False, True])
def test_queue_without_aovs(mesh, warm_start):
    """``aovs=False`` (the reference's, for radiance-only consumers such as
    the vertex recorder) gives the same radiance and segments as
    ``aovs=True``, and zero AOVs."""
    scene, cam, inter = mesh
    cfg = RenderConfig(width=16, height=12, spp=2, max_depth=3)
    kw = {}
    if warm_start:
        pose = compute_warm_pose(scene, cam, cfg, 7, 0, intersector=inter, chunk=128)
        kw = dict(cam_sample0=0, warm=warm_frame(scene, cam, cfg, pose, 7, 2, 0))
    ref = render_queued(scene, cam, cfg, 7, 2, intersector=inter, queue=64, **kw)
    out = render_queued(scene, cam, cfg, 7, 2, intersector=inter, queue=64, aovs=False, **kw)
    assert torch.equal(out.radiance, ref.radiance)
    assert int(out.segments) == int(ref.segments)
    assert bool(ref.aov_depth.abs().sum() > 0)
    for a in (out.aov_normal, out.aov_depth, out.aov_mat):
        assert not bool(a.any())
    assert out.aov_normal.shape == ref.aov_normal.shape
    assert out.aov_mat.dtype == ref.aov_mat.dtype


@pytest.mark.parametrize("cached", [False, True])
def test_scene_step_takes_its_queue(mesh, monkeypatch, cached):
    """A mesh step built with ``queue=`` renders through a queue of that
    size (the reference's ``make_scene_step(queue=)``): the frame equals
    ``render_queued`` at that queue."""
    from fspt_tpu_torch.render import framebuffer
    from fspt_tpu_torch.render import queue as queue_mod

    scene, cam, inter = mesh
    cfg = RenderConfig(width=8, height=6, spp=2, max_depth=3)
    seen = []
    real = queue_mod.render_queued

    def spy(*args, **kw):
        seen.append(kw["queue"])
        return real(*args, **kw)

    monkeypatch.setattr(queue_mod, "render_queued", spy)
    q = 20
    if cached:
        _, step, cache_fn = make_cached_scene_step(scene, cfg, queue=q)
        pose = cache_fn(scene, cam, 3)
        fb, segs = step(scene, cam, framebuffer.create(6, 8, device=CPU), 3, 1, pose)
        warm = warm_frame(scene, cam, cfg, compute_warm_pose(scene, cam, cfg, 3, 0,
                                                             intersector=inter, chunk=q),
                          3, cfg.spp, 0)
        ref = real(scene, cam, cfg, 3, cfg.spp, intersector=inter, queue=q, cam_sample0=0,
                   warm=warm)
    else:
        _, step = make_scene_step(scene, cfg, queue=q)
        fb, segs = step(scene, cam, framebuffer.create(6, 8, device=CPU), 3, 1)
        ref = real(scene, cam, cfg, 3, cfg.spp, intersector=inter, queue=q)
    assert seen == [q]
    expect = framebuffer.accumulate(framebuffer.create(6, 8, device=CPU), ref.radiance,
                                    ref.aov_normal, ref.aov_depth, ref.aov_mat, 6, 8, cfg.spp)
    assert torch.equal(fb.mean, expect.mean)
    assert int(segs) == int(ref.segments)


@pytest.fixture(scope="module")
def diff_mesh(mesh):
    from fspt_tpu_torch.ops.diff_intersect import make_diff_mesh_intersector

    scene, cam, _ = mesh
    return scene, cam, make_diff_mesh_intersector(scene)


def test_queue_edge_eps_matches_wavefront(diff_mesh):
    """Edge reparameterization rides the queue's per-lane masks: the same
    pass-through decisions and ratios as the unrolled loop
    (tests/test_queue.py:120 at its bar)."""
    scene, cam, diff = diff_mesh
    cfg = RenderConfig(width=16, height=12, spp=2, max_depth=3, edge_eps=0.05)
    ref = integrator.render_wavefront(scene, cam, cfg, 11, 3, intersector=diff)
    out = render_queued(scene, cam, cfg, 11, 3, intersector=diff, queue=100)
    _close(ref, out)
    plain = integrator.render_wavefront(scene, cam, RenderConfig(width=16, height=12, spp=2,
                                                                 max_depth=3), 11, 3,
                                        intersector=diff)
    assert not torch.equal(plain.radiance, ref.radiance)  # the edge block ran


def test_recorded_replay_matches_queue(diff_mesh):
    """Winner ids recorded by the queue, replayed through the unrolled loop,
    reproduce the queued render (tests/test_queue.py:140)."""
    from fspt_tpu_torch.ops.diff_intersect import make_recorded_replay, tris_from_scene

    scene, cam, diff = diff_mesh
    cfg = RenderConfig(width=16, height=12, spp=2, max_depth=3, edge_eps=0.05)
    out, (ids, hitm) = render_queued(scene, cam, cfg, 7, 5, intersector=diff, queue=256,
                                     record_hits=True)
    assert ids.shape == (16 * 12 * 2, 3) and hitm.shape == ids.shape
    assert int((ids >= 0).sum()) > 0
    rep = integrator.render_wavefront(
        scene, cam, cfg, 7, 5,
        intersector=make_recorded_replay(scene)(tris_from_scene(scene), ids, hitm))
    _close(out, rep)


def _reference_queued(scene_file, w, h, spp, depth, frames, seed, cached):
    """The reference's CLI frames on the same scene file, through its queued
    mesh path (XLA BVH intersector)."""
    from fspt_tpu.config import RenderConfig as RefConfig
    from fspt_tpu.render import framebuffer as ref_fb
    from fspt_tpu.render import integrator as ref_integrator
    from fspt_tpu.render.queue import compute_warm_pose as ref_pose
    from fspt_tpu.render.queue import render_queued as ref_queued
    from fspt_tpu.render.queue import warm_frame as ref_warm
    from fspt_tpu.scene.parser import load_scene as ref_load

    b = ref_load(scene_file)
    scene, cam = b.compile(), b.cameras[0]
    cfg = RefConfig(width=w, height=h, spp=spp, max_depth=depth)

    def inter(o, d, alive=None):
        return ref_integrator._intersect_with_bvh(scene, o, d)

    inter.accepts_alive = True
    fb = ref_fb.create(h, w)
    pose = ref_pose(scene, cam, cfg, seed, 0, intersector=inter, chunk=256) if cached else None
    for f in range(frames):
        kw = dict(cam_sample0=0, warm=ref_warm(scene, cam, cfg, pose, seed, f * spp, 0)) \
            if cached else {}
        out = ref_queued(scene, cam, cfg, seed, f * spp, intersector=inter, queue=256, **kw)
        fb = ref_fb.accumulate(fb, out.radiance, out.aov_normal, out.aov_depth, out.aov_mat,
                               h, w, spp)
    return np.asarray(fb.mean)


@pytest.mark.parametrize("cached", [False, True])
def test_cli_renders_heightfield_scene(tmp_path, capsys, cached):
    scene_file = samples.write_heightfield_scene(str(tmp_path / "hf"), grid=12)
    ck = str(tmp_path / "ck.npz")
    w, h, spp, depth, frames = 12, 8, 2, 3, 2
    args = ["--file", scene_file, "--width", str(w), "--height", str(h), "--spp", str(spp),
            "--depth", str(depth), "--frames", str(frames), "--seed", "3",
            "--output", str(tmp_path / "hf.png"), "--checkpoint", ck, "--device", "cpu"]
    assert cli.main(args + (["--first-hit-cache"] if cached else [])) == 0
    printed = capsys.readouterr().out
    path = MESH_PATH + (" + first-hit cache" if cached else "")
    assert f"render path: {path}\n" in printed
    assert printed.count("Mrays/sec:") == frames
    fb, frame, extra = ckpt.load(ck, device="cpu", with_extra=True)
    assert frame == frames and bool(extra["first_hit_cache"]) == cached
    ref = _reference_queued(scene_file, w, h, spp, depth, frames, 3, cached)
    close = np.isclose(fb.mean.numpy(), ref, rtol=1e-4, atol=1e-5)
    assert close.mean() >= 0.999, close.mean()
    assert fb.mean.numpy().mean() > 0.01


def test_cli_refuses_to_mix_estimators(tmp_path, capsys):
    """A checkpoint records whether the first-hit cache made it; resuming
    under the other estimator is refused (the reference's cli.py:125 mixes
    them), resuming under the same one goes on."""
    scene_file = samples.write_heightfield_scene(str(tmp_path / "hf"), grid=10)
    ck = str(tmp_path / "ck.npz")
    base = ["--file", scene_file, "--width", "8", "--height", "6", "--depth", "2",
            "--output", str(tmp_path / "o.png"), "--checkpoint", ck, "--device", "cpu"]
    assert cli.main(base + ["--frames", "1"]) == 0
    with pytest.raises(SystemExit) as exc:
        cli.main(base + ["--frames", "2", "--first-hit-cache"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "without the first-hit cache" in err and "cannot be averaged" in err
    assert ckpt.load(ck, device="cpu")[1] == 1  # untouched
    assert cli.main(base + ["--frames", "2"]) == 0
    assert "resumed from" in capsys.readouterr().out
    assert ckpt.load(ck, device="cpu")[1] == 2
    assert ckpt.estimator_mismatch({}, True) is not None
    assert ckpt.estimator_mismatch({}, False) is None
