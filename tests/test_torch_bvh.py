"""The port's BVH layer against the reference's, on the CPU.

* builders: the port's native and NumPy BVH builders give identical arrays,
  both equal to ``fspt_tpu.ops.bvh._build_bvh_numpy``; the treelet chunking
  is array-equal to the reference's; the native OBJ parser equals the
  Python one;
* the plain cull (kernel 5's plain version + the key sort) against the
  NumPy formula of tests/test_pallas_bvh.py: same survivor sets, ascending
  entry t; every key equal on kernel 5's edge blocks (a dead block, one
  live ray, 1, 33 and 778 leaves, rays starting on and inside boxes);
* the plain culled traverser (kernels 5 and 6 plain) against the
  reference's XLA ``traverse_bvh``, at the reference's own bar
  (tests/test_pallas_bvh.py:66-98): t at rtol 1e-4 / atol 1e-6, ids equal on
  ≥ 99.9 % of hits (near-tie winners depend on blocking), u at rtol 1e-3 /
  atol 1e-4; dead lanes win nothing;
* the plain versions of kernels 11 (``make_bvh_traverser``, the fine tree)
  and 12 (``make_treelet_traverser``, 128-triangle leaves) against the
  reference's ``traverse_bvh`` at tests/test_pallas_bvh.py:37-63's bars (t
  rtol 1e-5 / atol 1e-7 and ids equal on hits; t rtol 1e-4 / atol 1e-6, ids
  on ≥ 99.9 % of hits, u rtol 1e-3 / atol 1e-4), dead lanes included; a
  ``max_leaf=8`` tree against brute force;
* whole renders of the heightfield sample: the port's BVH
  ``render_wavefront`` (its torch BVH walk, and the mesh intersector) against
  the reference's, at the path bar of tests/test_pallas_bvh.py:142-158
  (rtol 1e-4 / atol 1e-6 on ≥ 99.9 % of values, equal segments).
"""

import numpy as np
import pytest
import torch

from fspt_tpu import materials as ref_M
from fspt_tpu.camera import Camera as RefCamera
from fspt_tpu.config import RenderConfig as RefConfig
from fspt_tpu.ops import bvh as ref_bvh
from fspt_tpu.ops import pallas_bvh as ref_pbvh
from fspt_tpu.render import integrator as ref_integrator
from fspt_tpu.scene.builder import SceneBuilder as RefBuilder

from fspt_tpu_torch import convert
from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.ops import bvh, cuda_bvh
from fspt_tpu_torch.render import integrator
from fspt_tpu_torch.scene import samples
from fspt_tpu_torch.utils import native

from conftest import assert_images_close
from test_torch_kernels_gpu import CULL_CASES, cull_case, sweep_case
from test_torch_kernels_gpu import tris as _tris

CPU = torch.device("cpu")


def _rays(n, seed=1):
    rs = np.random.RandomState(seed)
    start = rs.uniform(-60, 60, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return start, (d * 200.0).astype(np.float32)


@pytest.mark.parametrize("max_leaf", [4, 128])
def test_native_and_numpy_builders_equal_reference(max_leaf):
    v0, v1, v2 = _tris(2000, seed=3)
    nat = native.build_bvh(v0, v1, v2, max_leaf)
    plain = bvh._build_bvh_numpy(v0, v1, v2, max_leaf)
    ref = ref_bvh._build_bvh_numpy(v0, v1, v2, max_leaf)
    for a, b, c, name in zip(nat, plain, ref, ["order", "bmin", "bmax", "first", "count",
                                               "miss"]):
        np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(a, c, err_msg=name)


def test_build_bvh_matches_reference():
    v0, v1, v2 = _tris(700, seed=4)
    port = bvh.build_bvh(v0, v1, v2, device=CPU)
    ref = ref_bvh.build_bvh(v0, v1, v2)
    for name in bvh.FlatBVH._fields:
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)


def test_native_obj_parser_equals_python(tmp_path):
    from fspt_tpu_torch.scene.mesh import parse_obj

    obj = tmp_path / "m.obj"
    obj.write_text(
        "# comment\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\n"
        "vn 0 0 1\nvn 0 1 0\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "f 1/1/1 2/2/1 3/3/1 4/4/1\n"
        "f -1//-1 -2// -3\n"
        "f 1 2 5\n")
    a, b = native.parse_obj(str(obj)), parse_obj(str(obj))
    for k in ("vertices", "normals", "texcoords", "faces"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("grid", [None, 40])
def test_treelet_chunks_equal_reference(grid):
    if grid is None:
        v0, v1, v2 = _tris(3000, seed=5)
    else:
        b = RefBuilder()
        samples.heightfield(b, ref_M, grid=grid)
        tris = b._merge_triangles()
        v0, v1, v2 = tris["v0"], tris["v1"], tris["v2"]
    port = cuda_bvh.build_treelet_chunks(v0, v1, v2)
    ref = ref_pbvh.build_treelet_chunks(v0, v1, v2)
    for name in bvh.FlatBVH._fields:
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    assert (port.count.numpy() == cuda_bvh.TREELET).sum() >= len(port.count) - 1


def test_morton_keys_equal_reference():
    """The blocking key (and so which rays share a block) is the
    reference's, dead lanes last."""
    import jax.numpy as jnp

    r = np.random.default_rng(0)
    start = r.uniform(-60, 60, (4000, 3)).astype(np.float32)
    seg = (r.normal(size=(4000, 3)) * 100).astype(np.float32)
    alive = r.random(4000) > 0.3
    lo, hi = np.float32([-45, -30, -45]), np.float32([45, -10, 45])
    ref = ref_pbvh.morton_keys(*(jnp.asarray(a) for a in (start, seg, alive, lo, hi)))
    port = cuda_bvh.morton_keys(*(torch.from_numpy(a) for a in (start, seg, alive, lo, hi)))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def _numpy_cull(sb, gb, tb, lbmin, lbmax, dtype=np.float32):
    """The cull key ``[B, L]`` by the NumPy formula of the reference's exact
    per-ray cull (tests/test_pallas_bvh.py; pallas_bvh.make_culled_traverser
    ``cull``, S == R): the minimum over each block's live rays of the slab
    entry t of every overlapping leaf, 3e38 elsewhere.  The float32 inputs'
    differences are float32; the reciprocal and everything after it are in
    ``dtype``: float32 rounds as ``plain_cull`` does, float64 does not."""
    f = dtype
    r = f(1.0) / np.where(np.abs(gb) < np.float32(1e-30),
                          np.where(gb >= 0, f(1e-30), f(-1e-30)), gb)
    ta = (lbmin[None] - sb[:, None]) * r[:, None]
    tbx = (lbmax[None] - sb[:, None]) * r[:, None]
    t_lo = np.minimum(ta, tbx).max(axis=-1)
    t_hi = np.maximum(ta, tbx).min(axis=-1)
    ov = ((t_lo <= t_hi) & (t_hi >= 0.0) & (t_lo <= np.minimum(tb, f(1.0))[:, None])
          & (tb > 0.0)[:, None])
    key = np.where(ov, np.maximum(t_lo, f(0.0)), f(3.0e38))
    assert key.dtype == dtype
    return key.reshape(sb.shape[0] // cuda_bvh.BLOCK_RAYS, cuda_bvh.BLOCK_RAYS, -1).min(axis=1)


def test_plain_cull_matches_numpy_formula():
    v0, v1, v2 = _tris(3000, seed=11)
    coarse = bvh.build_bvh(v0, v1, v2, max_leaf=cuda_bvh.TREELET, device=CPU)
    trav = cuda_bvh.make_culled_traverser(coarse)
    n = 512
    sb, gb = _rays(n, seed=12)
    tb = np.ones(n, np.float32)
    tb[::7] = 0.0  # dead lanes mixed in
    counts, order, tlo, _ = trav.prepare(torch.from_numpy(sb), torch.from_numpy(gb),
                                         torch.from_numpy(tb))

    count = coarse.count.numpy()
    leaves = np.nonzero(count > 0)[0]
    lbmin, lbmax = coarse.bmin.numpy()[leaves], coarse.bmax.numpy()[leaves]
    key = _numpy_cull(sb, gb, tb, lbmin, lbmax, dtype=np.float64)
    counts_ref = (key < 3.0e38).sum(axis=1)
    np.testing.assert_array_equal(counts.numpy(), counts_ref)
    assert counts_ref.min() > 0
    for b in range(len(counts_ref)):
        k = int(counts_ref[b])
        assert set(order[b, :k].tolist()) == set(np.nonzero(key[b] < 3.0e38)[0].tolist())
        assert (np.diff(tlo[b, :k].numpy()) >= 0).all()


@pytest.mark.parametrize("case", CULL_CASES)
def test_plain_cull_edge_blocks(case):
    """Kernel 5's plain version on its edge cases (all rays of a block dead,
    one live ray, 1, 33 and 778 leaves, rays starting on box faces and
    inside boxes; test_torch_kernels_gpu.cull_case): every key equal to the
    NumPy formula's, a dead block's row all 3e38, a ray starting on or in a
    box entering it at 0."""
    F, tables = cull_case(case)
    key = cuda_bvh.plain_cull(F, tables)
    Fn = F.numpy()
    ref = _numpy_cull(Fn[:, 6:9], Fn[:, 0:3], Fn[:, 10], tables.lbmin.numpy(),
                      tables.lbmax.numpy())
    np.testing.assert_array_equal(key.numpy(), ref)
    assert key.shape == (4, tables.n_leaves)
    assert (ref < 3.0e38).any()
    live = (Fn[:, 10] > 0).reshape(4, -1).sum(axis=1)
    for b in np.nonzero(live == 0)[0]:
        assert (ref[b] == np.float32(3.0e38)).all()
    if case == "all_dead":
        assert live[1] == 0
    if case == "one_live":
        assert live[2] == 1 and (ref[2] < 3.0e38).any()
    if case in ("on_face", "inside"):
        assert (ref[0] == 0.0).sum() >= 8


def _traverser_vs_xla(n_tris, n_rays, seed, t_init=None):
    v0, v1, v2 = _tris(n_tris, seed=seed)
    fine = ref_bvh.build_bvh(v0, v1, v2)
    coarse = bvh.build_bvh(v0, v1, v2, max_leaf=cuda_bvh.TREELET, device=CPU)
    start, seg = _rays(n_rays, seed=seed + 1)
    t_ref, id_ref, u_ref, _ = (np.asarray(a) for a in ref_bvh.traverse_bvh(fine, start, seg))
    trav = cuda_bvh.make_culled_traverser(coarse)
    out = trav(torch.from_numpy(start), torch.from_numpy(seg),
               None if t_init is None else torch.from_numpy(t_init))
    return (t_ref, id_ref, u_ref), tuple(a.numpy() for a in out)


def test_culled_traverser_matches_xla():
    (t_ref, id_ref, u_ref), (t, ids, u, _) = _traverser_vs_xla(3000, 1500, seed=7)
    np.testing.assert_allclose(t_ref, t, rtol=1e-4, atol=1e-6)
    h = t_ref < 2.0
    assert h.mean() > 0.2
    assert (id_ref[h] == ids[h]).mean() > 0.999
    np.testing.assert_allclose(u_ref[h], u[h], rtol=1e-3, atol=1e-4)


def test_culled_traverser_dead_lanes():
    alive = np.zeros(600, bool)
    alive[::3] = True
    t0 = np.where(alive, 2.0, 0.0).astype(np.float32)
    (t_ref, id_ref, _), (t, ids, _, _) = _traverser_vs_xla(1000, 600, seed=9, t_init=t0)
    assert (ids[~alive] == -1).all()
    np.testing.assert_array_equal(t[~alive], 0.0)
    live = alive & (t_ref < 2.0)
    np.testing.assert_allclose(t_ref[live], t[live], rtol=1e-4, atol=1e-6)
    assert (id_ref[live] == ids[live]).mean() > 0.999


def _nearest_brute_force(tables, start, seg, t_init):
    """Float64 Möller–Trumbore of every ray against every triangle:
    nearest original triangle id (−1: none), and whether the answer is
    clear: no other triangle hit, or missed by less than 1e-4 (edge, t
    range, parallel threshold), within 1e-3 of the winner's t."""
    v0, e1, e2 = (getattr(tables, n).numpy().astype(np.float64)
                  for n in ("tri_v0", "tri_e1", "tri_e2"))
    o, d = start.astype(np.float64)[:, None], seg.astype(np.float64)[:, None]
    p = np.cross(d, e2[None])
    det = (e1[None] * p).sum(-1)
    floor = 1e-5 * np.linalg.norm(np.cross(e1, e2), axis=-1)[None]
    inv = 1.0 / np.where(det != 0, det, 1.0)
    tv = o - v0[None]
    u = (tv * p).sum(-1) * inv
    q = np.cross(tv, e1[None])
    v = (d * q).sum(-1) * inv
    t = (e2[None] * q).sum(-1) * inv
    edge = np.minimum(np.minimum(u, v), 1.0 - u - v)
    t0 = t_init[:, None]
    hit = (np.abs(det) >= floor) & (edge >= 0) & (t >= 0) & (t < t0)
    near = ((np.abs(det) >= floor * (1 - 1e-4)) & (edge >= -1e-4) & (t >= -1e-4)
            & (t < t0 + 1e-4))
    t_hit = np.where(hit, t, np.inf).min(axis=1)
    t_near = np.sort(np.where(near & ~(hit & (t == t_hit[:, None])), t, np.inf), axis=1)[:, 0]
    with np.errstate(invalid="ignore"):  # inf − inf on rays that hit nothing
        clear = t_near - t_hit > 1e-3 * np.maximum(np.where(np.isfinite(t_hit), t_hit, 0), 1e-3)
    clear |= np.isinf(t_hit) & np.isinf(t_near)
    winner = np.argmin(np.where(hit, t, np.inf), axis=1)
    ids = np.where(np.isfinite(t_hit), tables.tri_id.numpy()[winner], -1)
    return ids, clear


def test_plain_sweep_contract():
    """The contract kernel 6 is held to, on kernel 6's plain version: on
    ~3,000 random triangles with one incoherent block (every leaf survives
    its cull), ``best`` is the brute-force nearest triangle wherever that
    is clear; ``visits[b]`` is at most ``counts[b]`` and a multiple of GROUP
    or ``counts[b]``; a block stops early only where the next leaf's ``tlo``
    exceeds min(its rays' largest t, 1); dead rays win nothing."""
    trav, (start, seg, t_init), (counts, order, tlo, F) = sweep_case()
    tables = trav.tables
    L, R, G = tables.n_leaves, cuda_bvh.BLOCK_RAYS, cuda_bvh.GROUP
    assert int(counts[0]) == L  # the incoherent block: every leaf
    assert int(counts[1:7].max()) < L
    t, best, visits = cuda_bvh.plain_sweep(counts, order, tlo, F, tables)

    c, v = counts.numpy(), visits.numpy()
    assert (v <= c).all()
    assert ((v % G == 0) | (v == c)).all()
    stopped = np.nonzero(v < c)[0]
    assert len(stopped) > 0
    t_blk = np.minimum(t.numpy().reshape(-1, R).max(axis=1), 1.0)
    for b in stopped:
        assert tlo[b, v[b]].item() > t_blk[b]
    assert int(v[0]) > G  # the incoherent block sweeps past its first group

    _, tri_id, _, _ = trav.post(torch.from_numpy(start), torch.from_numpy(seg),
                                torch.where(best >= 0, t, torch.from_numpy(t_init)), best)
    ids, clear = _nearest_brute_force(tables, start, seg, t_init)
    assert clear.mean() > 0.9 and (ids[clear] >= 0).mean() > 0.3
    np.testing.assert_array_equal(tri_id.numpy()[clear], ids[clear])
    dead = t_init == 0
    assert (best.numpy()[dead] == -1).all()
    np.testing.assert_array_equal(t.numpy()[dead], 0.0)


@pytest.mark.parametrize("case", ["survivors", "ties", "empty"])
def test_block_order_heaviest_first(case):
    """Kernel 6's launch order: a permutation of the blocks, survivor
    counts non-increasing along it."""
    if case == "survivors":
        counts = sweep_case()[2][0]
    elif case == "ties":
        counts = torch.from_numpy(np.random.RandomState(3).randint(0, 4, 4096).astype(np.int32))
    else:
        counts = torch.zeros(64, dtype=torch.int32)
    perm = cuda_bvh.block_order(counts)
    assert perm.dtype == torch.int64
    assert torch.equal(torch.sort(perm).values, torch.arange(counts.numel()))
    assert (counts[perm][1:] <= counts[perm][:-1]).all()


def test_torch_traverse_bvh_matches_reference():
    v0, v1, v2 = _tris(800, seed=2)
    start, seg = _rays(700, seed=3)
    t_ref, id_ref, u_ref, v_ref = (np.asarray(a) for a in ref_bvh.traverse_bvh(
        ref_bvh.build_bvh(v0, v1, v2), start, seg))
    t, ids, u, v = (a.numpy() for a in bvh.traverse_bvh(
        bvh.build_bvh(v0, v1, v2, device=CPU), torch.from_numpy(start), torch.from_numpy(seg)))
    np.testing.assert_allclose(t, t_ref, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(ids, id_ref)
    h = t_ref < 2.0
    np.testing.assert_allclose(u[h], u_ref[h], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(v[h], v_ref[h], rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def walk_case():
    """3000 triangles, 1500 rays, and the reference's ``traverse_bvh`` of
    them (tests/test_pallas_bvh.py:50-63's sizes)."""
    v0, v1, v2 = _tris(3000, seed=4)
    start, seg = _rays(1500, seed=5)
    ref = tuple(np.asarray(a) for a in ref_bvh.traverse_bvh(ref_bvh.build_bvh(v0, v1, v2),
                                                            start, seg))
    return (v0, v1, v2), start, seg, ref


@pytest.mark.parametrize("dead", [False, True])
def test_walk_traversers_plain_match_xla(walk_case, dead):
    """tests/test_pallas_bvh.py:37-63 with the plain versions of kernels 11
    (fine tree) and 12 (tree of 128-triangle leaves) in place of the Pallas
    kernels, at its bars; with ``dead``, every third lane has ``t_init =
    0`` and must win nothing while the others keep their hits
    (tests/test_pallas_bvh.py:82-98)."""
    tris, start, seg, (t_ref, id_ref, u_ref, _) = walk_case
    n = start.shape[0]
    alive = np.ones(n, bool)
    if dead:
        alive[::3] = False
    t0 = torch.from_numpy(np.where(alive, 2.0, 0.0).astype(np.float32)) if dead else None
    s, d = torch.from_numpy(start), torch.from_numpy(seg)
    k11 = cuda_bvh.make_bvh_traverser(bvh.build_bvh(*tris, device=CPU), bvh.MAX_LEAF_TRIS)
    k12 = cuda_bvh.make_treelet_traverser(bvh.build_bvh(*tris, max_leaf=cuda_bvh.TREELET,
                                                        device=CPU))
    (t11, id11, _, _), (t12, id12, u12, _) = (tuple(a.numpy() for a in k(s, d, t0))
                                              for k in (k11, k12))
    h = alive & (t_ref < 2.0)
    assert h.mean() > 0.2
    np.testing.assert_allclose(t11[alive], t_ref[alive], rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(id11[h], id_ref[h])
    np.testing.assert_allclose(t12[alive], t_ref[alive], rtol=1e-4, atol=1e-6)
    assert (id12[h] == id_ref[h]).mean() > 0.999
    np.testing.assert_allclose(u12[h], u_ref[h], rtol=1e-3, atol=1e-4)
    if dead:
        assert (id11[~alive] == -1).all() and (id12[~alive] == -1).all()
        assert (t11[~alive] == 0.0).all() and (t12[~alive] == 0.0).all()


def test_walk_counts_and_max_leaf_8_against_brute_force():
    """A tree of 8-triangle leaves walked with ``max_leaf=8`` finds the
    brute-force closest hit (with the default 4 it refuses instead of
    dropping triangles); the walks count their work, dead lanes none."""
    from fspt_tpu_torch.ops.intersect import intersect_triangles
    from fspt_tpu_torch.scene.builder import SceneBuilder
    from fspt_tpu_torch import materials as M
    from fspt_tpu_torch.materials import MaterialSpec

    v0, v1, v2 = _tris(600, seed=6)
    start, seg = (torch.from_numpy(a) for a in _rays(800, seed=7))
    tree = bvh.build_bvh(v0, v1, v2, max_leaf=8, device=CPU)
    assert int(tree.count.max()) > bvh.MAX_LEAF_TRIS
    with pytest.raises(ValueError, match="max_leaf"):
        bvh.traverse_bvh(tree, start, seg)
    with pytest.raises(ValueError, match="max_leaf"):
        cuda_bvh.make_bvh_traverser(tree, bvh.MAX_LEAF_TRIS)
    t, ids, _, _ = bvh.traverse_bvh(tree, start, seg, max_leaf=8)
    b = SceneBuilder()
    b.add_triangles(v0, v1, v2, b.add_material(MaterialSpec(M.DIFFUSE)))
    geometry = b.compile(bvh_threshold=10 ** 9, device=CPU).geometry
    t_bf, attrs = intersect_triangles(geometry, start, seg)
    assert (t_bf < 2.0).float().mean() > 0.1
    np.testing.assert_allclose(t.numpy(), t_bf.numpy(), rtol=1e-5, atol=1e-7)
    t_init = torch.where(torch.arange(800) % 4 == 0, 0.0, 2.0)
    *_, visits, tested = bvh.walk_bvh(tree, start, seg, t_init, max_leaf=8)
    dead = t_init == 0
    assert int(visits[dead].max()) == 0 and int(tested[dead].max()) == 0
    assert int(visits[~dead].min()) >= 1 and int(tested.sum()) > 0
    _, _, visits12, tested12 = cuda_bvh.make_treelet_traverser(
        bvh.build_bvh(v0, v1, v2, max_leaf=cuda_bvh.TREELET, device=CPU)).walk(start, seg, t_init)
    # Kernel 12 counts the real triangles of the leaves it sweeps.
    assert int(visits12[:800][dead].max()) == 0 and int(tested12[:800][dead].max()) == 0
    assert int(tested12.sum()) > 0 and int(tested12.max()) <= 600


def _builder_tree(builder, max_leaf, seed=3):
    v0, v1, v2 = _tris(700, seed=seed)
    if builder == "native":
        return bvh.build_bvh(v0, v1, v2, max_leaf=max_leaf, device=CPU)
    return bvh.flat_bvh(*bvh._build_bvh_numpy(v0, v1, v2, max_leaf), v0, v1, v2, CPU)


@pytest.mark.parametrize("max_leaf", [bvh.MAX_LEAF_TRIS, cuda_bvh.TREELET])
@pytest.mark.parametrize("builder", ["native", "python"])
def test_walk_records_round_trip(builder, max_leaf):
    """Both builders give preorder miss links (``i < miss[i]``, ``M`` on the
    last node), which kernels 11 and 12 rely on; their packed records give
    back the FlatBVH fields bit for bit: node (bmin, miss), (bmax, first or
    leaf ordinal << 8 | count), triangle (v0, area2), (e1, tri_id), (e2,
    0)."""
    tree = _builder_tree(builder, max_leaf)
    m = tree.n_nodes
    miss = tree.miss.long()
    assert bool((miss > torch.arange(m)).all()) and int(miss[-1]) == m
    assert int(miss.max()) == m and int(tree.count.max()) <= max_leaf
    bits = lambda t: t.contiguous().view(torch.int32)  # noqa: E731
    leaf = tree.count > 0

    def unpack(nodes, payload):
        assert nodes.shape == (m, 8) and nodes.dtype == torch.float32
        assert torch.equal(bits(nodes[:, 0:3]), bits(tree.bmin))
        assert torch.equal(bits(nodes[:, 4:7]), bits(tree.bmax))
        assert torch.equal(bits(nodes[:, 3]), tree.miss)
        meta = bits(nodes[:, 7])
        assert torch.equal(meta & ((1 << cuda_bvh.COUNT_BITS) - 1), tree.count)
        assert torch.equal((meta >> cuda_bvh.COUNT_BITS)[leaf], payload[leaf])
        assert int(meta[~leaf].abs().max()) == 0

    tables = cuda_bvh.make_bvh_traverser(tree, max_leaf).tables
    unpack(tables.nodes, tree.first)
    tr = tables.tris
    assert tr.shape == (tree.tri_v0.shape[0], 12)
    for cols, field in ((slice(0, 3), tree.tri_v0), (3, tree.tri_area2),
                        (slice(4, 7), tree.tri_e1), (7, tree.tri_id),
                        (slice(8, 11), tree.tri_e2)):
        assert torch.equal(bits(tr[:, cols]), bits(field) if field.is_floating_point()
                           else field)
    assert int(bits(tr[:, 11]).abs().max()) == 0
    if max_leaf == cuda_bvh.TREELET:
        wt = cuda_bvh.make_treelet_traverser(tree).walk_tables
        unpack(wt.nodes, wt.leaf_of)
        assert torch.equal(wt.leaf_of[leaf], torch.arange(int(leaf.sum()), dtype=torch.int32))


def test_walk_records_refuse_backward_links():
    """A miss link that does not point forward in preorder, or past the
    end, is refused when the records are built."""
    tree = _builder_tree("native", bvh.MAX_LEAF_TRIS)
    for i, target in ((5, 5), (7, 2), (0, tree.n_nodes + 1)):
        miss = tree.miss.clone()
        miss[i] = target
        with pytest.raises(ValueError, match="preorder miss links"):
            cuda_bvh.bvh_walk_tables(tree._replace(miss=miss))


def _heightfield_pair(grid=10):
    ref_b = RefBuilder()
    samples.heightfield(ref_b, ref_M, grid=grid)
    ref_b.add_camera(RefCamera.create(**samples.HEIGHTFIELD_CAMERA))
    port_b = samples.build("heightfield", device=CPU, grid=grid)
    return ref_b, port_b


@pytest.mark.parametrize("path", ["bvh_walk", "mesh_intersector"])
def test_render_wavefront_heightfield_matches_reference(path):
    ref_b, port_b = _heightfield_pair()
    ref_scene = ref_b.compile()
    scene = port_b.compile(device=CPU)
    assert scene.bvh is not None and ref_scene.bvh is not None
    w, h, spp, depth = 16, 12, 2, 3
    ref = ref_integrator.render_wavefront(ref_scene, ref_b.cameras[0],
                                          RefConfig(width=w, height=h, spp=spp, max_depth=depth),
                                          7, 0)
    inter = cuda_bvh.make_mesh_intersector(scene) if path == "mesh_intersector" else None
    out = integrator.render_wavefront(scene, port_b.cameras[0],
                                      RenderConfig(width=w, height=h, spp=spp, max_depth=depth),
                                      7, 0, intersector=inter)
    assert_images_close(np.asarray(ref.radiance), out.radiance.numpy(), rtol=1e-4,
                        atol=1e-6, frac=0.999)
    assert int(ref.segments) == int(out.segments)
    assert (np.asarray(ref.aov_mat) == out.aov_mat.numpy()).mean() >= 0.999
    assert out.radiance.mean() > 0.01


def test_heightfield_scene_file_equals_sample(tmp_path):
    """The written .scene + OBJ parse back into the sample scene exactly:
    the OBJ's clockwise faces meet the loader's CW→CCW flip."""
    from fspt_tpu_torch.scene.parser import load_scene

    fb = load_scene(samples.write_heightfield_scene(str(tmp_path), grid=10), device=CPU)
    sb = samples.build("heightfield", device=CPU, grid=10)
    from_file, sample = fb.compile(device=CPU), sb.compile(device=CPU)
    for part in ("geometry", "materials", "bvh", "tri_shade"):
        a, b = getattr(from_file, part), getattr(sample, part)
        for name in a._fields:
            assert torch.equal(getattr(a, name), getattr(b, name)), (part, name)
    assert int(from_file.sky_mat) == int(sample.sky_mat)
    for name in sb.cameras[0]._fields:
        assert torch.equal(getattr(fb.cameras[0], name), getattr(sb.cameras[0], name)), name


def test_convert_carries_the_bvh():
    ref_b, port_b = _heightfield_pair()
    converted = convert.scene_from_numpy(ref_b.compile(), device=CPU)
    scene = port_b.compile(device=CPU)
    for part in ("bvh", "tri_shade"):
        a, b = getattr(converted, part), getattr(scene, part)
        for name in a._fields:
            assert torch.equal(getattr(a, name), getattr(b, name)), (part, name)
