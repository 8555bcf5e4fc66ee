"""Kernel 1's plain version and the port's brute-force intersector against
the reference's, on seeded random segments over a scene of every kind.

Bars: t, normal and texcoords at rtol 1e-5 / atol 1e-6; material and kind
equal.  Inputs are made with NumPy and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fspt_tpu import materials as ref_M
from fspt_tpu.ops import intersect as ref_intersect
from fspt_tpu.ops import pallas_trace
from fspt_tpu.scene.builder import SceneBuilder as RefBuilder
from fspt_tpu_torch import materials as M
from fspt_tpu_torch.ops import cuda_trace, intersect
from fspt_tpu_torch.ops.kernel_check import random_segments
from fspt_tpu_torch.scene import samples
from fspt_tpu_torch.scene.builder import SceneBuilder

N = 4096


@pytest.fixture(scope="module")
def scenes():
    rb, pb = RefBuilder(), SceneBuilder()
    samples.all_primitives(rb, ref_M)
    samples.all_primitives(pb, M)
    return rb.compile(), pb.compile(device="cpu")


@pytest.fixture(scope="module")
def rays():
    start, seg = random_segments(N, seed=11, device="cpu")
    return start, seg


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def test_host_scene_rows_match_reference(scenes):
    ref, port = scenes
    hs = cuda_trace.HostScene(port.geometry)
    assert hs.prim_count == pallas_trace.HostScene(ref.geometry).prim_count
    assert hs.kind_counts() == {0: 1, 1: 1, 2: 1, 3: 6, 4: 6, 5: 10}


def test_intersect_lanes_matches_reference(scenes, rays):
    ref, port = scenes
    start, seg = rays
    s, d = start.numpy(), seg.numpy()
    want = pallas_trace.intersect_lanes(
        pallas_trace.HostScene(ref.geometry),
        *(jnp.asarray(s[:, k]) for k in range(3)),
        *(jnp.asarray(d[:, k]) for k in range(3)))
    got = cuda_trace.intersect_lanes(
        cuda_trace.HostScene(port.geometry),
        *(start[:, k] for k in range(3)), *(seg[:, k] for k in range(3)))
    assert 0.3 < (got[0].numpy() < 2.0).mean() < 1.0  # a mix of hits and misses
    for k in (0, 1, 2, 3, 6, 7):  # t, normal, texcoords
        _close(want[k], got[k].numpy())
    np.testing.assert_array_equal(np.asarray(want[4]), got[4].numpy())  # mat
    np.testing.assert_array_equal(np.asarray(want[5]), got[5].numpy())  # kind
    # Every primitive kind wins somewhere.
    assert set(np.unique(got[5].numpy())) >= {0, 1, 2, 3, 4, 5}


def test_intersect_scene_matches_reference(scenes, rays):
    ref, port = scenes
    start, seg = rays
    want = ref_intersect.intersect_scene(ref.geometry, jnp.asarray(start.numpy()),
                                         jnp.asarray(seg.numpy()))
    got = intersect.intersect_scene(port.geometry, start, seg)
    np.testing.assert_array_equal(np.asarray(want.hit), got.hit.numpy())
    hit = got.hit.numpy()
    for field in ("t", "normal", "texcoords"):
        _close(np.asarray(getattr(want, field))[hit], getattr(got, field).numpy()[hit])
    np.testing.assert_array_equal(np.asarray(want.mat), got.mat.numpy())
    np.testing.assert_array_equal(np.asarray(want.prim_kind), got.prim_kind.numpy())


def test_cpu_intersector_is_the_plain_version(scenes, rays):
    _, port = scenes
    start, seg = rays
    fn = cuda_trace.make_cuda_intersector(port.geometry)
    before = cuda_trace.INTERSECT.launches
    hit = fn(start, seg)
    assert cuda_trace.INTERSECT.launches == before  # no kernel on the CPU
    t, normal, mat, kind, uv = cuda_trace.plain_intersect(fn.host_scene, start, seg)
    assert torch.equal(hit.t, t) and torch.equal(hit.normal, normal)
    assert torch.equal(hit.mat, mat) and torch.equal(hit.prim_kind, kind)
    assert torch.equal(hit.texcoords, uv)
    assert torch.equal(hit.hit, t < 2.0)


def test_large_scene_gets_no_intersector():
    b = SceneBuilder()
    white = b.add_material(M.MaterialSpec(M.DIFFUSE, diffuse=(0.5, 0.5, 0.5)))
    for i in range(cuda_trace.MAX_SPECIALIZED_PRIMS + 1):
        b.add_sphere((float(i), 0.0, 0.0), 0.25, white)
    assert cuda_trace.make_cuda_intersector(b.compile(device="cpu").geometry) is None


def test_host_scene_rows_sorted_by_kind(scenes):
    """The path kernels walk the table one kind at a time (csrc
    stage_rows), so its rows must be sorted by kind: the merge order of
    every kind does that, and a table whose rows are not is refused."""
    hs = cuda_trace.HostScene(scenes[1].geometry)
    _, meta = hs.tables("cpu")
    kinds = meta[:, 0].numpy()
    assert sorted(set(kinds.tolist())) == list(range(6))  # every kind
    assert (np.diff(kinds) >= 0).all()
    hs.rows.reverse()
    hs._device_tables = {}
    with pytest.raises(ValueError, match="not sorted by kind"):
        hs.tables("cpu")
