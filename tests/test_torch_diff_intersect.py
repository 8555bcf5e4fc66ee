"""The port's vertex-recovery path against the reference, on the CPU.

* ``Hit.edge_dist`` of the brute-force intersector equals the reference's
  at rtol 1e-5, and a zero segment (a lane stopped on a light) keeps its
  gradient finite, where the reference's sphere test makes it NaN;
* ``render_wavefront`` with edge reparameterization (brute-force triangle
  scenes of tests/test_grad.py:102 and :177): the image at the path bar
  (rtol 1e-4 / atol 1e-5 on ≥ 99.9 % of values) and the gradient of its mean
  in the vertices against ``jax.grad`` at rtol 1e-3;
* the hit-id replay (ops/diff_intersect.py) on the BVH heightfield of
  tests/test_diff_intersect.py: against the fast forward
  (tests/test_diff_intersect.py:63's bars), against the reference's
  ``_replay_hit`` fed the port's winners, its vertex gradient against
  ``jax.grad`` of that (rtol 1e-3) and one central difference (5 %, the
  reference's own FD bar);
* ``make_vertex_recovery_step`` and ``make_bvh_vertex_recovery_step``: one
  step's gradients against ``jax.grad`` of the reference's loss (the BVH
  step's replay fed the winners the port recorded), rtol 1e-3; two Adam
  steps lower the loss of a fixed frame.

The reference values come from its XLA paths only (no Pallas); each is
computed once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fspt_tpu.config import RenderConfig as RefConfig
from fspt_tpu.ops import diff_intersect as ref_di
from fspt_tpu.ops.intersect import intersect_scene as ref_intersect_scene
from fspt_tpu.parallel.train import apply_vertices as ref_apply_vertices
from fspt_tpu.parallel.train import render_image_rows as ref_render_image_rows
from fspt_tpu.render import integrator as ref_integrator

from fspt_tpu_torch import convert
from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.ops import diff_intersect as di
from fspt_tpu_torch.ops.cuda_bvh import make_mesh_intersector
from fspt_tpu_torch.ops.intersect import KIND_TRIANGLE, intersect_scene
from fspt_tpu_torch.parallel import train

from conftest import assert_images_close
from test_diff_intersect import build_bvh_scene, rays_toward_mesh
from test_grad import _silhouette_scene

VERTS = ("v0", "v1", "v2")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(scene, cam):
    return (convert.scene_from_numpy(_np_tree(scene), device="cpu"),
            convert.camera_from_numpy(_np_tree(cam), device="cpu"))


def _lit_triangle_scene():
    """tests/test_grad.py:102's slanted diffuse triangle under an area light."""
    from fspt_tpu import materials as M
    from fspt_tpu.camera import Camera
    from fspt_tpu.materials import MaterialSpec
    from fspt_tpu.scene.builder import SceneBuilder

    b = SceneBuilder()
    white = b.add_material(MaterialSpec(M.DIFFUSE, diffuse=(0.7, 0.7, 0.7)))
    light = b.add_material(MaterialSpec(M.LIGHT, emissive=(5.0, 5.0, 5.0)))
    b.add_quad_uv((-40, 49.0, -40), (80, 0, 0), (0, 0, 80), light)
    b.add_triangles(np.array([[-30.0, -20.0, 30.0]], np.float32),
                    np.array([[30.0, -20.0, 32.0]], np.float32),
                    np.array([[0.0, 25.0, 28.0]], np.float32), white)
    return b.compile(), Camera.create(origin=(0, 0, -60), aperture_size=0.0)


def _ref_verts(scene):
    g = scene.geometry
    return {"v0": g.tri_v0, "v1": g.tri_v0 + g.tri_e1, "v2": g.tri_v0 + g.tri_e2}


def test_edge_dist_matches_reference():
    scene, cam = _silhouette_scene()
    ps, _ = _port(scene, cam)
    r = np.random.default_rng(0)
    n = 2048
    start = np.broadcast_to(np.float32([0.0, 0.0, -60.0]), (n, 3)).astype(np.float32)
    targets = r.uniform([-25, -20, 30], [25, 20, 30], (n, 3))
    seg = ((targets - start) * 1.5).astype(np.float32)
    ref = ref_intersect_scene(scene.geometry, jnp.asarray(start), jnp.asarray(seg))
    out = intersect_scene(ps.geometry, torch.from_numpy(start), torch.from_numpy(seg))
    tri = np.asarray(ref.prim_kind) == KIND_TRIANGLE
    assert 0.2 < tri.mean() < 0.9
    np.testing.assert_array_equal(out.prim_kind.numpy(), np.asarray(ref.prim_kind))
    np.testing.assert_allclose(out.edge_dist.numpy()[tri], np.asarray(ref.edge_dist)[tri],
                               rtol=1e-5, atol=1e-6)
    assert (out.edge_dist.numpy()[~tri] == np.float32(3.0e38)).all()


def test_zero_segment_keeps_gradients_finite(bvh_pair):
    """A lane that stopped on a light carries a zero segment into the next
    depth's brute-force intersect (the replay's analytic lanes).  The
    reference's sphere test divides by 2·|seg|² = 0 there, so the zero
    cotangent of that masked lane becomes NaN (from depth 3 on it reaches
    the vertices); the port guards it as it guards missing rays: the same
    hits, a zero gradient for that lane."""
    scene, _, ps, _ = bvh_pair
    start = np.float32([[0, 5, -40], [1, 2, 3], [0, 10, 0]])
    seg = np.float32([[0, 0, 100], [0, 0, 0], [0, 50, 1]])

    def ref_sum(s):
        h = ref_intersect_scene(scene.geometry, jnp.asarray(start), s)
        return jnp.sum(jnp.where(h.hit, h.t, 0.0)), h

    (_, hr), g_ref = jax.value_and_grad(ref_sum, has_aux=True)(jnp.asarray(seg))
    s = torch.from_numpy(seg).requires_grad_()
    h = intersect_scene(ps.geometry, torch.from_numpy(start), s)
    (g,) = torch.autograd.grad(torch.where(h.hit, h.t, 0.0).sum(), [s])
    np.testing.assert_array_equal(h.hit.numpy(), np.asarray(hr.hit))
    np.testing.assert_allclose(h.t.detach().numpy(), np.asarray(hr.t), rtol=1e-6)
    assert np.isnan(np.asarray(g_ref)[1]).all()  # the reference's fault
    np.testing.assert_array_equal(g.numpy()[1], 0.0)
    np.testing.assert_allclose(g.numpy()[[0, 2]], np.asarray(g_ref)[[0, 2]], rtol=1e-5,
                               atol=1e-9)
    assert float(np.abs(g.numpy()).max()) > 0


# name → (scene factory, config): tests/test_grad.py:177's emitter at its
# bandwidth, and :102's lit triangle at the recovery's 0.05.
EDGE_CASES = {
    "silhouette": (_silhouette_scene, dict(width=8, height=8, spp=4, max_depth=2,
                                           edge_eps=3.0)),
    "lit": (_lit_triangle_scene, dict(width=8, height=8, spp=4, max_depth=2,
                                      edge_eps=0.05)),
}


@pytest.fixture(scope="module")
def edge_reference():
    """For each case: the reference's image and ``jax.grad`` of its mean in
    the vertices (seed 3, frame 1)."""
    out = {}
    for name, (factory, kw) in EDGE_CASES.items():
        scene, cam = factory()
        rcfg = RefConfig(**kw)

        def mean_img(params, scene=scene, cam=cam, rcfg=rcfg):
            img = ref_render_image_rows(ref_apply_vertices(scene, params), cam, rcfg, 3, 1,
                                        0, rcfg.height)
            return jnp.mean(img), img

        (_, img), g = jax.jit(jax.value_and_grad(mean_img, has_aux=True))(_ref_verts(scene))
        out[name] = (np.asarray(img), {k: np.asarray(v) for k, v in g.items()})
    return out


@pytest.mark.parametrize("name", list(EDGE_CASES))
def test_edge_reparameterized_render_and_vertex_gradient_match_reference(
        name, edge_reference):
    factory, kw = EDGE_CASES[name]
    scene, cam = factory()
    ps, pc = _port(scene, cam)
    cfg = RenderConfig(**kw)
    params = {k: torch.from_numpy(np.array(v)).requires_grad_()
              for k, v in _ref_verts(scene).items()}
    img = train.render_image_rows(train.apply_vertices(ps, params), pc, cfg, 3, 1, 0,
                                  cfg.height)
    grads = torch.autograd.grad(img.mean(), [params[k] for k in VERTS])
    ref_img, ref_g = edge_reference[name]
    assert_images_close(ref_img, img.detach().numpy(), rtol=1e-4, atol=1e-5, frac=0.999)
    scale = max(np.abs(g).max() for g in ref_g.values())
    assert scale > 0
    for k, g in zip(VERTS, grads):
        np.testing.assert_allclose(g.numpy(), ref_g[k], rtol=1e-3, atol=1e-5 * scale,
                                   err_msg=k)


@pytest.fixture(scope="module")
def bvh_pair():
    b = build_bvh_scene()
    scene, cam = b.compile(), b.cameras[0]
    assert scene.bvh is not None
    return (scene, cam) + _port(scene, cam)


def _shifted(tris, dv, flat=True):
    """The triangle dict with every vertex moved by ``dv`` (flat normals)."""
    tr = dict(tris)
    for k in VERTS:
        tr[k] = tris[k] + dv
    if flat:
        n = (di.flat_normals if isinstance(dv, torch.Tensor) else ref_di.flat_normals)(
            tr["v0"], tr["v1"], tr["v2"])
        tr["n0"] = tr["n1"] = tr["n2"] = n
    return tr


@pytest.fixture(scope="module")
def replay_case(bvh_pair):
    """The port's replay decisions on 256 rays toward the mesh and the
    reference's ``_replay_hit`` on them: its Hit and ``jax.grad`` of the
    summed triangle t in a common vertex shift."""
    scene, _, ps, _ = bvh_pair
    start, seg = (np.array(a) for a in rays_toward_mesh(256, seed=3))
    h = di.make_diff_mesh_intersector(ps)(torch.from_numpy(start), torch.from_numpy(seg))
    ids, hitm = h.prim_id.numpy(), h.hit.numpy()
    tris = ref_di.tris_from_scene(scene)

    def loss(dv, start, seg, ids, hitm):
        hr = ref_di._replay_hit(_shifted(tris, dv), scene.geometry, start, seg, ids, hitm)
        return jnp.sum(jnp.where(hr.prim_id >= 0, hr.t, 0.0)), hr

    (_, hr), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.zeros(3, jnp.float32), *(jnp.asarray(a) for a in (start, seg, ids, hitm)))
    return start, seg, ids, hitm, jax.tree_util.tree_map(np.asarray, hr), np.asarray(g)


def test_replay_matches_fast_forward_and_reference(bvh_pair, replay_case):
    _, _, ps, _ = bvh_pair
    start, seg, ids, hitm, hr, _ = replay_case
    s, d = torch.from_numpy(start), torch.from_numpy(seg)
    hf = make_mesh_intersector(ps)(s, d)
    hd = di.make_diff_mesh_intersector(ps)(s, d)
    hit = hf.hit.numpy()
    assert 0.3 < (hf.prim_id.numpy() >= 0).mean()
    np.testing.assert_array_equal(hit, hd.hit.numpy())
    np.testing.assert_array_equal(hf.prim_id.numpy(), hd.prim_id.numpy())
    np.testing.assert_allclose(hf.t.numpy()[hit], hd.t.numpy()[hit], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(hf.normal.numpy()[hit], hd.normal.numpy()[hit], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(hf.mat.numpy()[hit], hd.mat.numpy()[hit])
    # The reference's replay of the same decisions.
    np.testing.assert_array_equal(hd.prim_kind.numpy(), hr.prim_kind)
    np.testing.assert_array_equal(hd.mat.numpy(), hr.mat)
    np.testing.assert_allclose(hd.t.numpy()[hit], hr.t[hit], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(hd.normal.numpy()[hit], hr.normal[hit], rtol=1e-4, atol=1e-5)
    # edge_dist is a barycentric times a triangle height (~3.6 here): it
    # carries the barycentrics' rounding (differences of products, summed in
    # another order), ~1e-5 of that height.
    tri = ids >= 0
    np.testing.assert_allclose(hd.edge_dist.numpy()[tri], hr.edge_dist[tri], rtol=1e-5,
                               atol=1e-4)


def test_replay_vertex_gradient_matches_reference_and_fd(bvh_pair, replay_case):
    _, _, ps, _ = bvh_pair
    start, seg, ids, hitm, _, ref_g = replay_case
    tris = di.tris_from_scene(ps)
    bind = di.make_recorded_replay(ps)
    s, d = torch.from_numpy(start), torch.from_numpy(seg)
    ids_t, hit_t = torch.from_numpy(ids)[:, None], torch.from_numpy(hitm)[:, None]

    def loss(dv):
        h = bind(_shifted(tris, dv), ids_t, hit_t)(s, d)
        return torch.where(h.prim_id >= 0, h.t, 0.0).sum()

    dv = torch.zeros(3, requires_grad=True)
    (g,) = torch.autograd.grad(loss(dv), [dv])
    np.testing.assert_allclose(g.numpy(), ref_g, rtol=1e-3, atol=1e-6)
    eps = 1e-3
    for ax in range(3):
        e = torch.zeros(3)
        e[ax] = eps
        with torch.no_grad():
            fd = (float(loss(e)) - float(loss(-e))) / (2 * eps)
        assert abs(float(g[ax]) - fd) <= 5e-2 * max(1.0, abs(fd)), (ax, float(g[ax]), fd)


def _dual_loss(img_a, img_b, target):
    return jnp.mean((img_a - target) * (img_b - target))


@pytest.fixture(scope="module")
def vertex_step_case():
    """The silhouette scene moved off its truth, its target, and ``jax.grad``
    of the reference's pool-1 dual-buffer loss at frame 2 (seed 5)."""
    scene, cam = _silhouette_scene()
    kw = dict(width=8, height=8, spp=4, max_depth=2, edge_eps=2.0)
    rcfg = RefConfig(**kw)
    ps, pc = _port(scene, cam)
    with torch.no_grad():
        target = (sum(train.render_image_rows(ps, pc, RenderConfig(**kw), 5, f, 0, 8)
                      for f in range(4)) / 4).numpy()
    true = _ref_verts(scene)
    c = (true["v0"] + true["v1"] + true["v2"]) / 3.0
    start = {k: np.asarray(c + (v - c) * 0.8 + jnp.float32([3.0, -2.0, 0.0]))
             for k, v in true.items()}

    def loss(params, target):
        s = ref_apply_vertices(scene, params)
        a = ref_render_image_rows(s, cam, rcfg, 5, 2, 0, 8)
        b = ref_render_image_rows(s, cam, rcfg, 5, 2 + 10007, 0, 8)
        return _dual_loss(a, b, target)

    g = jax.jit(jax.grad(loss))({k: jnp.asarray(v) for k, v in start.items()},
                                jnp.asarray(target))
    return scene, cam, kw, target, start, {k: np.asarray(v) for k, v in g.items()}


def _adam(lr):
    return lambda ps: torch.optim.Adam(ps, lr=lr)


def _check_step_grads(state, ref_g):
    scale = max(np.abs(g).max() for g in ref_g.values())
    assert scale > 0
    for k in VERTS:
        np.testing.assert_allclose(state.leaves[k].grad.numpy(), ref_g[k], rtol=1e-3,
                                   atol=1e-5 * scale, err_msg=k)


def test_vertex_recovery_step_matches_reference_and_descends(vertex_step_case):
    scene, cam, kw, target, start, ref_g = vertex_step_case
    ps, pc = _port(scene, cam)
    cfg = RenderConfig(**kw)
    tgt = torch.from_numpy(target)
    params = convert.params_from_numpy(start, device="cpu")
    step = train.make_vertex_recovery_step(None, cfg, optimizer=_adam(0.05))
    state = step.init(params)
    p1, state, loss0 = step(params, state, ps, pc, tgt, 5, 2)
    _check_step_grads(state, ref_g)
    # Two steps on one frame's (deterministic) loss lower it.
    p2, state, _ = step(p1, state, ps, pc, tgt, 5, 2)
    evaluate = train.make_vertex_recovery_step(None, cfg, lr=0.0)
    assert float(evaluate(p2, ps, pc, tgt, 5, 2)[1]) < float(loss0)


@pytest.fixture(scope="module")
def bvh_step_case(bvh_pair):
    """The heightfield moved up by 0.4, its target, the winners the port's
    phase 1 records at frame 2 (seed 11), and ``jax.grad`` of the
    reference's loss through its recorded replay of those winners."""
    scene, cam, ps, pc = bvh_pair
    kw = dict(width=12, height=8, spp=2, max_depth=2, edge_eps=0.05)
    cfg, rcfg2 = RenderConfig(**kw), RefConfig(**dict(kw, spp=4))
    diff = di.make_diff_mesh_intersector(ps)
    with torch.no_grad():
        target = sum(train.render_image_rows(ps, pc, cfg, 11, f, 0, 8, intersector=diff)
                     for f in range(2)).numpy() / 2
    tris = ref_di.tris_from_scene(scene)
    start = {k: np.asarray(tris[k]) + np.float32([0.0, 0.4, 0.0]) for k in VERTS}
    step = train.make_bvh_vertex_recovery_step(None, cfg, ps, lr=0.0)
    ids, hitm = step.record(convert.params_from_numpy(start, device="cpu"), ps, pc, 11, 2, 0,
                            8)
    bind = ref_di.make_recorded_replay(scene)

    def loss(params, ids, hitm, target):
        tr = dict(tris, **params)
        tr["n0"] = tr["n1"] = tr["n2"] = ref_di.flat_normals(tr["v0"], tr["v1"], tr["v2"])
        out = ref_integrator.render_wavefront(scene, cam, rcfg2, 11, 2 * 4,
                                              intersector=bind(tr, ids, hitm))
        rad = out.radiance.reshape(8, 12, 2, 2, 3)
        return _dual_loss(rad[:, :, 0].mean(axis=2), rad[:, :, 1].mean(axis=2), target)

    g = jax.jit(jax.grad(loss))({k: jnp.asarray(v) for k, v in start.items()},
                                jnp.asarray(ids.numpy()), jnp.asarray(hitm.numpy()),
                                jnp.asarray(target))
    return cfg, target, start, ids, hitm, {k: np.asarray(v) for k, v in g.items()}


@pytest.mark.parametrize("use_queue", [False, True])
def test_bvh_vertex_recovery_step_matches_reference(bvh_pair, bvh_step_case, use_queue):
    """Both phase-1 recorders (wavefront and queue) record the same winners,
    and the step's gradients are the reference's replay gradients."""
    _, _, ps, pc = bvh_pair
    cfg, target, start, ids, hitm, ref_g = bvh_step_case
    params = convert.params_from_numpy(start, device="cpu")
    step = train.make_bvh_vertex_recovery_step(None, cfg, ps, optimizer=_adam(0.05),
                                               use_queue=use_queue, queue=100)
    got_ids, got_hit = step.record(params, ps, pc, 11, 2, 0, cfg.height)
    live = ids.numpy() >= 0
    assert live.mean() > 0.15
    np.testing.assert_array_equal(got_ids.numpy(), ids.numpy())
    # Lanes that died before a depth record no flag in the queue.
    np.testing.assert_array_equal(got_hit.numpy()[live], hitm.numpy()[live])
    state = step.init(params)
    step(params, state, ps, pc, torch.from_numpy(target), 11, 2)
    _check_step_grads(state, ref_g)


def test_bvh_vertex_recovery_descends(bvh_pair, bvh_step_case):
    _, _, ps, pc = bvh_pair
    cfg, target, start, _, _, _ = bvh_step_case
    tgt = torch.from_numpy(target)
    params = convert.params_from_numpy(start, device="cpu")
    # Two small steps on one frame's (deterministic) loss lower it; the
    # edge term's pass-through decisions make it piecewise, so larger steps
    # need not.
    step = train.make_bvh_vertex_recovery_step(None, cfg, ps, optimizer=_adam(0.01))
    state = step.init(params)
    params, state, loss0 = step(params, state, ps, pc, tgt, 11, 0)
    params, state, _ = step(params, state, ps, pc, tgt, 11, 0)
    evaluate = train.make_bvh_vertex_recovery_step(None, cfg, ps, lr=0.0)
    assert float(evaluate(params, ps, pc, tgt, 11, 0)[1]) < float(loss0)
    fixed = train.make_bvh_vertex_recovery_step(None, cfg, ps, lr=0.0, shade_normals="fixed")
    assert np.isfinite(float(fixed(params, ps, pc, tgt, 11, 0)[1]))
    # The one-phase form through the intersector_bind hook: the dual-buffer
    # loss of two renders through the replay intersector bound to params.
    tris = di.tris_from_scene(ps)
    bind = di.make_diff_mesh_intersector(ps).bind
    one_phase = train.make_recovery_step(
        None, cfg, param_names=train.VERTICES, lr=0.0, constraints={}, pool=1,
        apply_fn=lambda s, p: s, intersector_bind=lambda p: bind(dict(tris, **p)))
    _, loss1 = one_phase(params, ps, pc, tgt, 11, 0)
    inter = bind(dict(tris, **params))
    a, b = (train.render_image_rows(ps, pc, cfg, 11, f, 0, cfg.height, intersector=inter)
            for f in (0, 10007))
    assert float(loss1) == float(((a - tgt) * (b - tgt)).mean())
    with pytest.raises(ValueError, match="Not ported"):
        train.make_bvh_vertex_recovery_step(None, cfg, ps, replay="planar")
    assert callable(train.make_bvh_vertex_recovery_step(None, cfg, ps, replay="auto"))
