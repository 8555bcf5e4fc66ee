"""Kernel 13's plain version (the camera-fused path body walking the BVH)
against the port's queued mesh path, on the CPU.

The queued path (``render_queued`` with ``make_mesh_intersector(plain=True)``:
kernel 1's rows, then kernels 5 and 6 over treelets) is held against the
JAX package in tests/test_torch_queue.py; kernel 13 walks the scene's own
BVH and traces each lane's whole path in one body, so the two agree to
float rounding.  Bar: radiance at rtol 1e-4 / atol 1e-5 on every value,
normals at atol 1e-5, depth at rtol 1e-5, material AOVs and segment counts
equal.  The heightfield at grid 12 (242 triangles), through its thin-lens
camera (aperture 1.5, focal depth 95), at 32×24×2 spp, depth 4.  Besides:
``trace.counted`` equals ``trace`` with the walk's totals, and the path
body hands every intersector the lanes' liveness.
"""

import numpy as np
import pytest
import torch

from fspt_tpu_torch import materials as M
from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.ops import cuda_path, rng
from fspt_tpu_torch.ops.cuda_bvh import make_mesh_intersector
from fspt_tpu_torch.ops.cuda_trace import HostScene, intersect_lanes
from fspt_tpu_torch.render.queue import render_queued
from fspt_tpu_torch.scene import samples

CPU = torch.device("cpu")
CFG = RenderConfig(width=32, height=24, spp=2, max_depth=4)


@pytest.fixture(scope="module")
def heightfield():
    b = samples.build("heightfield", device=CPU, grid=12)
    scene = b.compile(device=CPU)
    return scene, b.cameras[0]


def _agree(out, ref):
    assert torch.isclose(out.radiance, ref.radiance, rtol=1e-4, atol=1e-5).all()
    assert torch.isclose(out.aov_normal, ref.aov_normal, rtol=0.0, atol=1e-5).all()
    assert torch.isclose(out.aov_depth, ref.aov_depth, rtol=1e-5, atol=0.0).all()
    assert torch.equal(out.aov_mat, ref.aov_mat)
    assert int(out.segments) == int(ref.segments)


@pytest.mark.parametrize("rows", [(0, None), (7, 9)])
def test_mesh_camera_path_matches_queue(heightfield, rows):
    """The whole frame through ``trace`` (no walk counts), and a band of
    rows 7-15 as lanes ``lane0`` .. ``lane0 + n_lanes`` of the frame through
    ``trace.counted`` (the walk's node steps and triangle tests)."""
    scene, cam = heightfield
    assert float(cam.aperture_size) == 1.5
    tracer = cuda_path.make_camera_path_tracer(scene, cam, CFG)
    y0, n_rows = rows
    n_rows = n_rows or CFG.height
    lanes_per_row = CFG.width * CFG.spp
    trace = tracer.counted if y0 else tracer
    out = trace(5, 6, lane0=y0 * lanes_per_row, n_lanes=n_rows * lanes_per_row)
    ref = render_queued(scene, cam, CFG, 5, 6, y0=y0, rows=n_rows,
                        intersector=make_mesh_intersector(scene, plain=True), queue=512)
    _agree(out, ref)
    if trace is tracer:
        assert out.walk is None
    else:
        nodes, tris = out.walk.tolist()
        assert nodes > int(out.segments) and tris > 0


def test_mesh_camera_path_refusals(heightfield):
    """Kernel 13 takes no textured material (kernel 4 is the textured form)
    and no edge reparameterization: those scenes keep the queue."""
    scene, cam = heightfield
    assert cuda_path.make_camera_path_tracer(
        scene, cam, RenderConfig(width=8, height=8, spp=1, edge_eps=0.05)) is None
    b = samples.build("heightfield", device=CPU, grid=12)
    tex = b.add_texture(np.ones((4, 4, 3), np.float32))
    b.add_sphere((0.0, 0.0, 0.0), 1.0, b.add_material(
        M.MaterialSpec(M.DIFFUSE, diffuse=(1, 1, 1), tex_id=tex)))
    textured = b.compile(device=CPU)
    assert textured.bvh is not None
    assert cuda_path.make_camera_path_tracer(textured, cam, CFG) is None
    assert cuda_path.make_path_tracer(scene, CFG) is None


def test_counted_trace_equals_trace(heightfield):
    """``trace.counted`` gives ``trace``'s planes bit for bit, with the
    walk's totals beside them: the plain version's (a band of rows 3-5)."""
    scene, cam = heightfield
    tracer = cuda_path.make_camera_path_tracer(scene, cam, CFG)
    lane0, n = 3 * CFG.width * CFG.spp, 3 * CFG.width * CFG.spp
    out, counted = tracer(4, 2, lane0, n), tracer.counted(4, 2, lane0, n)
    assert out.walk is None
    assert torch.equal(counted.walk, tracer.plain(4, 2, lane0, n).walk)
    for field in ("radiance", "aov_normal", "aov_depth", "aov_mat", "segments"):
        assert torch.equal(getattr(out, field), getattr(counted, field)), field


def test_path_body_hands_the_intersector_its_live_lanes():
    """``build_path_core`` calls ``intersect`` with the lanes' liveness: all
    lanes at the first bounce, then fewer as paths end; the outputs equal
    the default intersector's."""
    b = samples.build("flagship", device=CPU)
    sp = b.compile(device=CPU)
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=3)
    scene, mats = HostScene(sp.geometry), cuda_path.HostMaterials(sp.materials)
    cam = cuda_path.HostCamera(b.cameras[0], cfg.width, cfg.height)
    seen = []

    def intersect(sx, sy, sz, dx, dy, dz, alive):
        seen.append(int(alive.sum()))
        return intersect_lanes(scene, sx, sy, sz, dx, dy, dz, want_texcoords=False)

    h0 = rng.seed_hash(3)
    rays = cuda_path.build_fused_raygen(cam, cfg)(h0, 0, 0, 64, CPU)
    sky = int(sp.sky_mat)
    got = cuda_path.planes_to_output(cuda_path.build_path_core(
        scene, mats, cfg, sky, cam.z_far, intersect=intersect)(h0, *rays))
    want = cuda_path.planes_to_output(cuda_path.build_path_core(
        scene, mats, cfg, sky, cam.z_far)(h0, *rays))
    assert seen[0] == 64 and seen == sorted(seen, reverse=True) and seen[-1] < 64, seen
    for field in ("radiance", "aov_normal", "aov_depth", "aov_mat", "segments"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
