"""The port's host layer against the reference: scene parse and compile,
state carried across with ``convert``, primary rays, the framebuffer and the
checkpoint layout."""

import os

import jax
import numpy as np
import pytest
import torch

from fspt_tpu.camera import generate_rays as ref_generate_rays
from fspt_tpu.render import framebuffer as ref_fb
from fspt_tpu.scene.parser import load_scene as ref_load_scene
from fspt_tpu.utils import checkpoint as ref_ckpt
from fspt_tpu_torch import convert
from fspt_tpu_torch.camera import generate_rays
from fspt_tpu_torch.render import framebuffer as fb_mod
from fspt_tpu_torch.scene.parser import load_scene
from fspt_tpu_torch.utils import checkpoint as ckpt

SCENE = os.path.join(os.path.dirname(__file__), "..", "scenes", "cornell.scene")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_fields_equal(port_tuple, ref_tuple):
    for name in port_tuple._fields:
        np.testing.assert_array_equal(getattr(port_tuple, name).cpu().numpy(),
                                      np.asarray(getattr(ref_tuple, name)), err_msg=name)


@pytest.fixture(scope="module")
def cornell():
    rb = ref_load_scene(SCENE)
    pb = load_scene(SCENE, device="cpu")
    return rb, rb.compile(), pb, pb.compile(device="cpu")


def test_cornell_scene_packs_equal(cornell):
    rb, ref, pb, port = cornell
    _assert_fields_equal(port.geometry, ref.geometry)
    _assert_fields_equal(port.materials, ref.materials)
    _assert_fields_equal(port.textures, ref.textures)
    assert int(port.sky_mat) == int(ref.sky_mat)
    assert port.bvh is None and ref.bvh is None
    assert len(pb.cameras) == len(rb.cameras) == 1
    _assert_fields_equal(pb.cameras[0], rb.cameras[0])


def test_convert_round_trips(cornell):
    rb, ref, _, port = cornell
    _assert_fields_equal(convert.scene_from_numpy(_np_tree(ref), device="cpu").geometry,
                         ref.geometry)
    back = convert.scene_from_numpy(port, device="cpu")  # port → port is a copy
    for a, b in ((back.geometry, port.geometry), (back.materials, port.materials)):
        for name in a._fields:
            assert torch.equal(getattr(a, name), getattr(b, name)), name
    _assert_fields_equal(convert.camera_from_numpy(_np_tree(rb.cameras[0]), device="cpu"),
                         rb.cameras[0])
    fb = ref_fb.create(4, 5)
    _assert_fields_equal(convert.framebuffer_from_numpy(_np_tree(fb), device="cpu"), fb)


@pytest.mark.parametrize("aperture", [0.0, 1.5])
def test_generate_rays_matches_reference(cornell, aperture):
    rb, _, pb, _ = cornell
    rcam = rb.cameras[0]._replace(aperture_size=np.float32(aperture),
                                  focal_depth=np.float32(110.0))
    pcam = pb.cameras[0]._replace(aperture_size=torch.tensor(aperture),
                                  focal_depth=torch.tensor(110.0))
    want = ref_generate_rays(rcam, 24, 16, 3, 5, 6, y0=2, rows=10)
    got = generate_rays(pcam, 24, 16, 3, 5, 6, y0=2, rows=10)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))  # pixel ids
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))  # sample ids
    for k in (0, 1):  # start, seg (|seg| ~ 1e4: atol at its float32 ulp scale)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-3)


def test_framebuffer_accumulate_and_display_agree():
    h, w, spp = 6, 5, 3
    r = np.random.default_rng(3)
    fb_r = ref_fb.create(h, w)
    fb_p = fb_mod.create(h, w, device="cpu")
    for _ in range(2):
        rad = r.gamma(0.5, 0.6, (h * w * spp, 3)).astype(np.float32)
        nrm = r.normal(size=(h * w * spp, 3)).astype(np.float32)
        dep = r.uniform(0, 100, h * w * spp).astype(np.float32)
        mat = r.integers(0, 9, h * w * spp).astype(np.int32)
        fb_r = ref_fb.accumulate(fb_r, rad, nrm, dep, mat, h, w, spp)
        fb_p = fb_mod.accumulate(fb_p, *(torch.from_numpy(x) for x in (rad, nrm, dep, mat)),
                                 h, w, spp)
    for name in fb_p._fields:
        np.testing.assert_allclose(getattr(fb_p, name).numpy(),
                                   np.asarray(getattr(fb_r, name)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(fb_mod.variance_of_mean(fb_p).numpy(),
                               np.asarray(ref_fb.variance_of_mean(fb_r)), rtol=1e-5)
    for gamma in (True, False):
        got = fb_mod.to_display(fb_p.mean, gamma).numpy()
        want = np.asarray(ref_fb.to_display(fb_r.mean, gamma))
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_checkpoint_crosses_packages(tmp_path):
    h, w = 4, 3
    r = np.random.default_rng(5)
    fb = ref_fb.create(h, w)._replace(
        mean=r.uniform(size=(h, w, 3)).astype(np.float32),
        count=np.full((h, w), 8.0, np.float32),
        mat=r.integers(0, 5, (h, w)).astype(np.int32))
    path = str(tmp_path / "ref.npz")
    ref_ckpt.save(path, fb, 8)
    got, frame = ckpt.load(path, device="cpu")
    assert frame == 8
    _assert_fields_equal(got, fb)
    back = str(tmp_path / "port.npz")
    ckpt.save(back, got, 9)
    fb2, frame2 = ref_ckpt.load(back)
    assert frame2 == 9
    _assert_fields_equal(got, fb2)
    assert ckpt.load(str(tmp_path / "missing.npz"), device="cpu") is None


def test_textures_and_recovery_params_cross_packages():
    """A textured scene's TexturePack (texels, offsets, sizes) crosses over
    through ``convert`` and equals the port's own build of the same sample;
    recovery parameters cross as float32 tensors."""
    from fspt_tpu import materials as RM
    from fspt_tpu.scene.builder import SceneBuilder as RefBuilder
    from fspt_tpu_torch.scene import samples

    rb = RefBuilder()
    samples.SCENES["all_families_textured"](rb, RM)
    ref = rb.compile()
    assert int(np.asarray(ref.textures.offset).shape[0]) == 3
    crossed = convert.scene_from_numpy(_np_tree(ref), device="cpu")
    _assert_fields_equal(crossed.textures, ref.textures)
    _assert_fields_equal(crossed.materials, ref.materials)
    own = samples.build("all_families_textured", device="cpu").compile(device="cpu")
    _assert_fields_equal(own.textures, ref.textures)
    _assert_fields_equal(own.materials, ref.materials)

    params = {"diffuse": np.asarray(ref.materials.diffuse, np.float64),
              "texels": np.asarray(ref.textures.texels)}
    got = convert.params_from_numpy(params, device="cpu")
    for k, v in params.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v.astype(np.float32))
