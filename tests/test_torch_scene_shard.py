"""The port's triangle-sharded rendering (parallel/scene_shard.py) in gloo
worlds of 2 and 4 CPU ranks: the two cases of
tests/test_sharding.py:219-277 at their shapes and bars (rtol 2e-5 /
atol 1e-6, material AOV and segments equal, against the replicated
render), the unrolled ``fast=False`` step also against the JAX package's
at ``make_mesh(n)`` (the port-vs-JAX bar of tests/test_torch_parallel.py),
``shard_scene_triangles`` against the reference's split, and the merge rule.
The rank harness is test_torch_parallel.py's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_parallel import (WORLDS, World, _fb_np, _np, _port, close_to_reference,
                                 plain_tree, result, run_cases)


def _random_hit(seed, n=512):
    """A local Hit of ``n`` lanes with ties across shards: t on a coarse
    grid (lanes of different seeds often meet at the same t)."""
    from fspt_tpu_torch.ops.intersect import Hit

    g = torch.Generator().manual_seed(seed)
    hit = torch.rand(n, generator=g) < 0.6
    t = torch.randint(1, 6, (n,), generator=g).float() * 0.125
    f = lambda *s: torch.rand(*s, generator=g)  # noqa: E731
    i = lambda hi: torch.randint(0, hi, (n,), generator=g, dtype=torch.int32)  # noqa: E731
    return Hit(t=torch.where(hit, t, 1e30), point=f(n, 3), normal=f(n, 3), texcoords=f(n, 2),
               mat=i(9), prim_kind=i(6), hit=hit,
               prim_id=torch.where(hit, i(1000), -1).to(torch.int32))


def _rank_cases(rank, world, payload):
    from fspt_tpu_torch.config import RenderConfig
    from fspt_tpu_torch.ops.cuda_bvh import make_mesh_intersector
    from fspt_tpu_torch.parallel import make_mesh, make_scene_sharded_render_step
    from fspt_tpu_torch.parallel.scene_shard import _merge_hits, merge_stacked_hits
    from fspt_tpu_torch.render import framebuffer as fb_mod
    from fspt_tpu_torch.render import integrator

    mesh = make_mesh(world, device="cpu")
    scene, camera = _port(payload["bvh"])
    cfg = RenderConfig(width=16, height=16, spp=1, max_depth=3)

    def render(step, intersector=None):
        fb = fb_mod.create(cfg.height, cfg.width, device="cpu")
        fb, segs = step(scene, camera, cfg, fb, 7, 0, intersector=intersector)
        return _fb_np(fb), int(segs)

    def sharded(fast):
        step = make_scene_sharded_render_step(mesh, cfg, scene, fast=fast)
        fb, segs = step(scene, camera, fb_mod.create(cfg.height, cfg.width, device="cpu"), 7, 0)
        return _fb_np(fb), int(segs), int(step.shard.gids.shape[0])

    def scene_sharded_matches_replicated():
        one = rank == 0 and render(integrator.render_step)
        return dict(n=sharded(False), one=one)

    def scene_sharded_fast_matches_replicated():
        one = rank == 0 and render(integrator.render_step, make_mesh_intersector(scene))
        return dict(n=sharded(True), one=one)

    def merge_rule():
        hits = [_random_hit(s) for s in range(world)]
        merged = _merge_hits(hits[rank], mesh)
        stacked = merge_stacked_hits(hits)
        return {k: (_np(getattr(merged, k)), _np(getattr(stacked, k)))
                for k in ("t", "point", "normal", "texcoords", "mat", "prim_kind", "hit",
                          "prim_id")}

    return run_cases({"scene_sharded_matches_replicated": scene_sharded_matches_replicated,
                      "scene_sharded_fast_matches_replicated":
                          scene_sharded_fast_matches_replicated,
                      "merge_rule": merge_rule})


@pytest.fixture(scope="module")
def bvh_builder():
    from test_diff_intersect import build_bvh_scene

    return build_bvh_scene()


@pytest.fixture(scope="module")
def runs(bvh_builder, tmp_path_factory):
    """The worlds of 2 and 4 ranks, and meanwhile the JAX package's
    ``fast=False`` scene-sharded step at ``make_mesh(n)``."""
    import jax

    from fspt_tpu.config import RenderConfig as RefConfig
    from fspt_tpu.parallel import make_mesh, make_scene_sharded_render_step
    from fspt_tpu.render import framebuffer as ref_fb

    scene, camera = bvh_builder.compile(), bvh_builder.cameras[0]
    payload = {"bvh": {"scene": plain_tree(scene), "camera": plain_tree(camera)}}
    tmp = tmp_path_factory.mktemp("scene_shard_worlds")
    started = {n: World(_rank_cases, n, tmp, payload) for n in WORLDS}
    cfg = RefConfig(width=16, height=16, spp=1, max_depth=3)
    ref = {}
    for n in WORLDS:
        step = make_scene_sharded_render_step(make_mesh(n), cfg, scene)
        fb, segs = step(scene, camera, ref_fb.create(cfg.height, cfg.width), 7, 0)
        ref[n] = (jax.tree_util.tree_map(np.asarray, fb), int(segs))
    return {n: w.results() for n, w in started.items()}, ref


def _assert_matches_replicated(worlds, n, case):
    r = result(worlds, n, case)
    (fb_n, segs_n, _), (fb_1, segs_1) = r["n"], r["one"]
    np.testing.assert_allclose(fb_n["mean"], fb_1["mean"], rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(fb_n["mat"], fb_1["mat"])
    assert segs_n == segs_1
    # Every rank holds the same frame, from its own shard of the triangles.
    shards = []
    for rank in range(n):
        fb_r, segs_r, n_tris = result(worlds, n, case, rank)["n"]
        np.testing.assert_array_equal(fb_r["mean"], fb_n["mean"])
        assert segs_r == segs_n
        shards.append(n_tris)
    assert sum(shards) == 2 * 11 * 11 and max(shards) - min(shards) <= 1
    return fb_n, segs_n


@pytest.mark.parametrize("n", WORLDS)
def test_scene_sharded_matches_replicated(runs, n):
    """``fast=False``: each rank's sub-BVH walk, the hits merged over the
    ranks, the unrolled integrator; against the replicated render, and
    against the JAX package's step at ``make_mesh(n)``."""
    worlds, ref = runs
    fb_n, segs_n = _assert_matches_replicated(worlds, n, "scene_sharded_matches_replicated")
    ref_fb, ref_segs = ref[n]
    close_to_reference(fb_n["mean"], ref_fb.mean)
    np.testing.assert_array_equal(fb_n["mat"], np.asarray(ref_fb.mat))
    assert segs_n == ref_segs


@pytest.mark.parametrize("n", WORLDS)
def test_scene_sharded_fast_matches_replicated(runs, n):
    """``fast=True``: kernel 1 and each rank's treelet tables through
    kernels 5 and 6 (their plain versions here) on the regenerating queue,
    against the replicated render on the mesh intersector (the reference's
    Pallas path runs in interpret mode: the port is held against itself,
    as the reference's test does)."""
    _assert_matches_replicated(runs[0], n, "scene_sharded_fast_matches_replicated")


@pytest.mark.parametrize("n", WORLDS)
def test_merge_over_ranks_is_the_stacked_rule(runs, n):
    """The ``all_reduce`` merge on every rank equals the one-process merge
    of all the shards' hits, bit for bit, with ties won by the lowest rank."""
    worlds, _ = runs
    for rank in range(n):
        for k, (merged, stacked) in result(worlds, n, "merge_rule", rank).items():
            np.testing.assert_array_equal(merged, stacked, err_msg=k)


@pytest.mark.parametrize("n", WORLDS)
def test_shard_split_matches_reference(bvh_builder, n):
    """The centroid-axis sort, the ``np.linspace`` bounds and each shard's
    global ids equal the reference's (fspt_tpu/parallel/scene_shard.py:41-122,
    whose gids are padded with −1 to a common length)."""
    from fspt_tpu.parallel import shard_scene_triangles as ref_shard
    from fspt_tpu_torch import convert
    from fspt_tpu_torch.parallel import shard_scene_triangles

    scene = bvh_builder.compile()
    _, _, ref_gids, ref_order, ref_bounds = ref_shard(scene, n)
    port_scene = convert.scene_from_numpy(plain_tree(scene), device="cpu")
    built, order, bounds = shard_scene_triangles(port_scene, n)
    np.testing.assert_array_equal(order, ref_order)
    np.testing.assert_array_equal(bounds, ref_bounds)
    ref_gids = np.asarray(ref_gids)
    for s in range(n):
        gids = built[s].gids.numpy()
        np.testing.assert_array_equal(gids, ref_gids[s][:len(gids)])
        assert (ref_gids[s][len(gids):] == -1).all()
        # The shard's own rows: shading attributes by global id, the sub-BVH
        # over the shard's triangles with shard-local ids.
        np.testing.assert_array_equal(built[s].shade.mat.numpy(),
                                      port_scene.tri_shade.mat.numpy()[gids])
        assert sorted(built[s].bvh.tri_id.tolist()) == list(range(len(gids)))
    # One rank builds its own shard only.
    mine, _, _ = shard_scene_triangles(port_scene, n, shards=(n - 1,))
    assert list(mine) == [n - 1]
    np.testing.assert_array_equal(mine[n - 1].gids.numpy(), built[n - 1].gids.numpy())


def test_shard_refusals_and_single_shard_identity(bvh_builder):
    from fspt_tpu_torch import convert
    from fspt_tpu_torch.parallel import shard_scene_triangles
    from fspt_tpu_torch.parallel.mesh import Mesh
    from fspt_tpu_torch.parallel.scene_shard import _merge_hits, merge_stacked_hits

    port_scene = convert.scene_from_numpy(plain_tree(bvh_builder.compile()), device="cpu")
    with pytest.raises(ValueError, match="242 triangles but 243 shards"):
        shard_scene_triangles(port_scene, 243)
    with pytest.raises(ValueError, match="needs a BVH scene"):
        shard_scene_triangles(port_scene._replace(bvh=None), 2)
    hit = _random_hit(0)
    # A mesh of one merges nothing; the rule over one shard keeps t, the
    # flag and the id, and every field of the lanes it hits (a miss's
    # fields are the empty sum, as in the reference's merge).
    assert _merge_hits(hit, Mesh(group=None, rank=0, size=1, device=torch.device("cpu"))) is hit
    one = merge_stacked_hits([hit])
    for k in ("t", "hit", "prim_id"):
        np.testing.assert_array_equal(_np(getattr(one, k)), _np(getattr(hit, k)), err_msg=k)
    for k in ("point", "normal", "texcoords", "mat", "prim_kind"):
        np.testing.assert_array_equal(_np(getattr(one, k)[hit.hit]),
                                      _np(getattr(hit, k)[hit.hit]), err_msg=k)
    # Ties go to the lowest shard; a lane no shard hits keeps t and gets −1.
    a, b = _random_hit(1), _random_hit(2)
    both = a.hit & b.hit & (a.t == b.t)
    m = merge_stacked_hits([a, b])
    assert both.any()
    np.testing.assert_array_equal(_np(m.prim_id[both]), _np(a.prim_id[both]))
    none = ~(a.hit | b.hit)
    assert (_np(m.prim_id[none]) == -1).all() and (_np(m.t[none]) == 1e30).all()
    closer_b = b.hit & (~a.hit | (b.t < a.t))
    np.testing.assert_array_equal(_np(m.mat[closer_b]), _np(b.mat[closer_b]))
