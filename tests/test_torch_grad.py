"""The gradient front doors of the port (kernels 7, 8 in its affine and
whole-chain constructions, and 9-10: plain versions on the CPU) against the
reference's planar differentiable path (ops/diff_path.py) under
``jax.value_and_grad``, which the reference's own tests pin to its kernels
7-10 (tests/test_pallas_grad.py:33-376), and against central differences.

Bars, the reference's own: images at the path bar (rtol 1e-4 / atol 1e-5 on
≥ 99.9 % of values: a last-bit ``sin``/``cos`` difference between torch and
XLA can flip a lane's branch), gradients at rtol 1e-3 / atol 1e-7
(tests/test_pallas_grad.py:153-159: the affine fold sums the path in
another order than the planar chain), the fused loss at rtol 1e-5, the
texel gradient within 2e-2 of central differences (float32 steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import build_cornell_box
from fspt_tpu import materials as RM
from fspt_tpu.camera import Camera as RefCamera
from fspt_tpu.config import RenderConfig as RefConfig
from fspt_tpu.ops.diff_path import make_diff_path, make_image_fn
from fspt_tpu.scene.builder import SceneBuilder as RefBuilder
from fspt_tpu_torch import convert
from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.ops import cuda_grad
from fspt_tpu_torch.ops.cuda_path import camera_pvec

FRACTION = 0.999


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(b, **cfg_kw):
    scene, cam = b.compile(), b.cameras[0]
    cfg = RenderConfig(**cfg_kw)
    ps = convert.scene_from_numpy(_np_tree(scene), device="cpu")
    pc = convert.camera_from_numpy(_np_tree(cam), device="cpu")
    return scene, cam, ps, pc, cfg


def _leaves(ps, names=("diffuse", "emissive")):
    return {k: getattr(ps.materials, k).clone().requires_grad_() for k in names}


@pytest.fixture(scope="module")
def specular_reference():
    """The reference's planar image of the specular Cornell box (16×16, 2
    spp, depth 4) and ``jax.value_and_grad`` of ``mean(img²)`` with respect
    to diffuse, emissive and param, computed once for the module."""
    scene, cam, ps, pc, cfg = _setup(build_cornell_box(with_specular=True),
                                     width=16, height=16, spp=2, max_depth=4)
    di = make_image_fn(scene, RefConfig(**vars(cfg)), z_far=float(np.asarray(cam.z_far)))

    def loss_d(p):
        img, segs = di(scene.materials._replace(**p), cam, 5, 0, 0, cfg.height)
        return jnp.mean(img ** 2), (img, segs)

    params = {k: getattr(scene.materials, k) for k in ("diffuse", "emissive", "param")}
    (vd, (img_d, seg_d)), gd = jax.value_and_grad(loss_d, has_aux=True)(params)
    return ps, pc, cfg, float(vd), np.asarray(img_d), int(seg_d), _np_tree(gd)


def test_affine_image_and_grads_match_planar_reference(specular_reference):
    ps, pc, cfg, vd, img_d, seg_d, gd = specular_reference
    gi = cuda_grad.make_affine_grad_image_fn(ps, pc, cfg)
    leaves = _leaves(ps)
    img, segs = gi(leaves, 5, 0, 0, cfg.height)
    loss = (img ** 2).mean()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert int(segs) == int(seg_d)
    close = np.isclose(img.detach().numpy(), np.asarray(img_d), rtol=1e-4, atol=1e-5)
    assert close.mean() >= FRACTION, close.mean()
    np.testing.assert_allclose(float(loss.detach()), float(vd), rtol=1e-5)
    for name, g in zip(leaves, grads):
        assert np.abs(np.asarray(gd[name])).max() > 0, name
        np.testing.assert_allclose(g.numpy(), np.asarray(gd[name]), rtol=1e-3,
                                   atol=1e-7, err_msg=name)


def _textured_floor():
    """The reference test's textured scene (tests/test_pallas_grad.py:178)."""
    b = RefBuilder()
    tex = np.stack(np.meshgrid(np.linspace(0.2, 0.9, 8),
                               np.linspace(0.3, 0.8, 8))[:1] * 3,
                   axis=-1).reshape(8, 8, 3).astype(np.float32)
    tid = b.add_texture(tex)
    mat = b.add_material(RM.MaterialSpec(RM.DIFFUSE, diffuse=(1, 1, 1), tex_id=tid,
                                         tex_scale=1.0))
    light = b.add_material(RM.MaterialSpec(RM.LIGHT, emissive=(9.0, 9.0, 9.0)))
    sky = b.add_material(RM.MaterialSpec(RM.LIGHT, emissive=(0.1, 0.2, 0.3)))
    b.set_sky(sky)
    b.add_quad_uv((-40, -10, -40), (80, 0, 0), (0, 0, 80), mat)
    b.add_quad_uv((-15, 30, -15), (30, 0, 0), (0, 0, 30), light)
    b.add_camera(RefCamera.create(origin=(0, 20, -70), target=(0, -5, 0),
                                  aperture_size=0.0))
    return b


def test_texel_gradient_matches_central_differences():
    _, _, ps, pc, cfg = _setup(_textured_floor(), width=12, height=12, spp=2,
                               max_depth=3)
    gi = cuda_grad.make_affine_grad_image_fn(ps, pc, cfg)
    texels0 = ps.textures.texels

    def loss(texels):
        img, _ = gi({"texels": texels}, 5, 0, 0, cfg.height)
        return (img ** 2).mean()

    leaf = texels0.clone().requires_grad_()
    (g,) = torch.autograd.grad(loss(leaf), [leaf])
    gn = g.numpy()
    ti, tc = np.unravel_index(np.abs(gn).argmax(), gn.shape)
    eps = 1e-2
    dv = torch.zeros_like(texels0)
    dv[ti, tc] = eps
    with torch.no_grad():
        fd = (float(loss(texels0 + dv)) - float(loss(texels0 - dv))) / (2 * eps)
    np.testing.assert_allclose(float(gn[ti, tc]), fd, rtol=2e-2, atol=1e-6)


@pytest.mark.parametrize("fast", [False, True])
def test_fused_loss_matches_lane_level_planar_reference(fast):
    """Kernel 8's affine construction (its plain version on the CPU)
    against the reference's lane-level planar loss, with the fast-render
    white slot (``mat_e < 0``) and without."""
    scene, cam, ps, pc, cfg = _setup(build_cornell_box(with_specular=True),
                                     width=16, height=12, spp=2, max_depth=3,
                                     fast_render=fast)
    rcfg = RefConfig(**vars(cfg))
    trace = make_diff_path(scene, rcfg, z_far=float(np.asarray(cam.z_far)))
    target = np.random.default_rng(0).random((cfg.height, cfg.width, 3),
                                             dtype=np.float32)
    tgt_lane = jnp.repeat(jnp.asarray(target).reshape(-1, 3), cfg.spp, axis=0)

    def ref_loss(p, f0):
        table = scene.materials._replace(**p)
        a = trace(table, cam, 5, f0 * cfg.spp)
        b = trace(table, cam, 5, (f0 + 10007) * cfg.spp)
        loss = jnp.mean((a.radiance - tgt_lane) * (b.radiance - tgt_lane))
        return loss, a.segments + b.segments

    params = {"diffuse": scene.materials.diffuse, "emissive": scene.materials.emissive}
    (ref_v, ref_segs), ref_g = jax.value_and_grad(ref_loss, has_aux=True)(params, 3)

    fused = cuda_grad.make_fused_loss_grad_fn(ps, pc, cfg)
    loss, grads, segs = fused({k: getattr(ps.materials, k) for k in params},
                              torch.from_numpy(target), 5, 3, 0, cfg.height)
    np.testing.assert_allclose(float(loss), float(ref_v), rtol=1e-5)
    assert int(segs) == int(ref_segs)
    for k in params:
        assert np.abs(np.asarray(ref_g[k])).max() > 0, k
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(ref_g[k]), rtol=1e-3,
                                   atol=1e-8, err_msg=k)


@pytest.mark.parametrize("front_door", ["affine_image", "fused_loss", "grad_image"])
def test_band_split_gradients_sum_to_full_frame(front_door):
    _, _, ps, pc, cfg = _setup(build_cornell_box(), width=16, height=8, spp=1,
                               max_depth=3)
    if front_door in ("affine_image", "grad_image"):
        gi = (cuda_grad.make_affine_grad_image_fn(ps, pc, cfg) if front_door == "affine_image"
              else cuda_grad.make_grad_image_fn(ps, pc, cfg))

        def band_grads(y0, rows):
            leaves = _leaves(ps)
            img, _ = gi(leaves, 5, 0, y0, rows)
            return dict(zip(leaves, torch.autograd.grad((img ** 2).sum(),
                                                        list(leaves.values()))))
    else:
        fused = cuda_grad.make_fused_loss_grad_fn(ps, pc, cfg)
        target = torch.from_numpy(np.random.default_rng(1).random(
            (cfg.height, cfg.width, 3), dtype=np.float32))
        params = {k: getattr(ps.materials, k) for k in ("diffuse", "emissive")}

        def band_grads(y0, rows):
            # Undo the per-call 1/(3n) so bands add up.
            _, grads, _ = fused(params, target[y0:y0 + rows], 5, 0, y0, rows)
            return {k: g * (3 * rows * cfg.width * cfg.spp) for k, g in grads.items()}

    full = band_grads(0, 8)
    lower, upper = band_grads(0, 4), band_grads(4, 4)
    for k in full:
        assert float(full[k].abs().max()) > 0, k
        np.testing.assert_allclose((lower[k] + upper[k]).numpy(), full[k].numpy(),
                                   rtol=1e-4, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("kwargs", [
    dict(fields=("diffuse", "param")), dict(fields=("ior",)),
    dict(fields=("diffuse", "camera")), dict(affine=False), dict(remat=True),
])
def test_fused_loss_refuses_path_adjoint_requests(kwargs):
    """The requests the affine construction cannot serve (refused until the
    path-body adjoint was ported) take the whole chain, and give finite
    gradients of every requested field."""
    _, _, ps, pc, cfg = _setup(build_cornell_box(with_specular=True), width=8, height=8,
                               spp=1, max_depth=2)
    fn = cuda_grad.make_fused_loss_grad_fn(ps, pc, cfg, **kwargs)
    fields = kwargs.get("fields", ("diffuse", "emissive"))
    params = {f: camera_pvec(pc) if f == "camera" else getattr(ps.materials, f)
              for f in fields}
    target = torch.full((cfg.height, cfg.width, 3), 0.3)
    loss, grads, segs = fn(params, target, 5, 1, 0, cfg.height)
    assert bool(torch.isfinite(loss)) and int(segs) > 0
    assert set(grads) == set(fields)
    for f, g in grads.items():
        assert g.shape == params[f].shape and bool(torch.isfinite(g).all()), f


def test_pack_params_round_trip():
    _, _, ps, _, _ = _setup(build_cornell_box(), width=8, height=8)
    mats = ps.materials
    fields = ("glow", "diffuse", "frost")
    params = {"diffuse": mats.diffuse, "glow": mats.glow, "frost": mats.frost}
    pvec = cuda_grad.pack_params(params, fields)
    assert pvec.shape == (cuda_grad.param_count(mats, fields),)
    back = cuda_grad.unpack_params(pvec, mats, fields)
    for k in fields:
        assert torch.equal(back[k], params[k]), k


@pytest.mark.parametrize("affine", [True, False])
def test_fused_loss_entry_takes_no_launch_options(affine):
    """The front door keeps the reference's arguments (params, target,
    seed, frame_idx, y0, rows) on both constructions, and no launch option
    or second entry rides on it."""
    import inspect

    _, _, ps, pc, cfg = _setup(build_cornell_box(), width=8, height=4, spp=1, max_depth=2)
    fn = cuda_grad.make_fused_loss_grad_fn(ps, pc, cfg, affine=affine)
    assert list(inspect.signature(fn).parameters) == [
        "params", "target", "seed", "frame_idx", "y0", "rows"]
    assert not hasattr(fn, "launch_fwdmode")
    params = {k: getattr(ps.materials, k) for k in ("diffuse", "emissive")}
    target = torch.zeros((cfg.height, cfg.width, 3))
    with pytest.raises(TypeError):
        fn(params, target, 1, 0, 0, cfg.height, fwdmode=True)


def test_fused_loss_takes_fields_in_any_order():
    """The reference's kernels read the packed vector in canonical column
    order whatever order ``fields`` names (pallas_grad.py:_TableView); the
    port's kernel 8 takes each column by name, so the order is free."""
    _, _, ps, pc, cfg = _setup(build_cornell_box(), width=8, height=8, spp=1,
                               max_depth=3)
    target = torch.full((cfg.height, cfg.width, 3), 0.3)
    params = {k: getattr(ps.materials, k) for k in ("diffuse", "emissive")}
    got = {}
    for fields in (("diffuse", "emissive"), ("emissive", "diffuse")):
        fused = cuda_grad.make_fused_loss_grad_fn(ps, pc, cfg, fields=fields)
        got[fields] = fused(params, target, 5, 1, 0, cfg.height)
    (la, ga, _), (lb, gb, _) = got.values()
    assert float(la) == float(lb)
    for k in params:
        assert torch.equal(ga[k], gb[k]), k


@pytest.mark.parametrize("fields", [("diffuse", "emissive"), ("diffuse", "emissive", "glow")])
def test_bias_column_is_the_wrappers_and_maps_each_row(fields):
    """The bias column that kernels 7 and 8 read is made once with the
    path body and equals ``mats.bias_column()``; ``bias_table`` and
    ``table_grads`` fed from it pick, row by row, the reference's column
    (pallas_path.py:922-926): glow for Glow, diffuse for Fog, emissive for
    every other row (the lights and the sky among them)."""
    from fspt_tpu_torch import materials as M
    from fspt_tpu_torch.ops import cuda_path
    from fspt_tpu_torch.scene import samples

    b = samples.build("all_families", device="cpu")
    ps, cfg = b.compile(device="cpu"), RenderConfig(width=8, height=8, spp=1, max_depth=2)
    planes = cuda_grad.make_affine_planes(ps, b.cameras[0], cfg)
    mats, bias = planes.mats, planes.bias
    assert bias.shape == (mats.count, 1)
    assert torch.equal(bias[:, 0], torch.from_numpy(mats.bias_column()))
    assert set(mats.bias_column().tolist()) == {0, 1, 2}

    rng = np.random.default_rng(3)
    diffuse, emissive, glow, g_coef, g_bias = (
        torch.from_numpy(rng.random((mats.count, 3), dtype=np.float32)) for _ in range(5))
    values = cuda_path.bias_table(bias, diffuse, emissive, glow)
    grads = cuda_grad.table_grads(bias, g_coef, g_bias, fields)
    assert list(grads) == list(fields)
    zero = torch.zeros(3)
    for r, t in enumerate(mats.mtype.tolist()):
        fog, is_glow = t == M.FOG, t == M.GLOW
        want = diffuse[r] if fog else glow[r] if is_glow else emissive[r]
        assert torch.equal(values[r], want), r
        per_row = {"diffuse": g_coef[r] + (g_bias[r] if fog else zero),
                   "emissive": zero if fog or is_glow else g_bias[r],
                   "glow": g_bias[r] if is_glow else zero}
        for f in fields:
            assert torch.equal(grads[f][r], per_row[f]), (f, r)


def test_grad_image_matches_planar_reference(specular_reference):
    """Kernels 9-10 (their plain version: autograd of the body with the
    parameters as table tensors) against the reference's planar path
    (tests/test_pallas_grad.py:33-57)."""
    ps, pc, cfg, vd, img_d, seg_d, gd = specular_reference
    fields = ("diffuse", "emissive", "param")
    gi = cuda_grad.make_grad_image_fn(ps, pc, cfg, fields=fields)
    leaves = _leaves(ps, fields)
    img, segs = gi(leaves, 5, 0, 0, cfg.height)
    loss = (img ** 2).mean()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert int(segs) == int(seg_d)
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(img_d), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(vd), rtol=1e-5)
    for name, g in zip(leaves, grads):
        assert np.abs(np.asarray(gd[name])).max() > 0, name
        np.testing.assert_allclose(g.numpy(), np.asarray(gd[name]), rtol=1e-3,
                                   atol=1e-7, err_msg=name)


@pytest.mark.parametrize("depth", [1, 8])
def test_grad_forward_ragged_band_is_lane_independent(depth):
    """Kernel 9's plain forward on a ragged band (lane0 = 5, n = 37: off and
    across the 32-lane chunks the kernel's warps take) equals the same
    lanes of the full-frame run bit for bit, radiance and segments: a
    lane's path depends only on its index, which the kernel's regenerating
    lanes rely on.  The band also matches the reference's planar forward on
    those lanes at the path bar, and the frame its segment count."""
    scene, cam, ps, pc, cfg = _setup(build_cornell_box(with_specular=True),
                                     width=16, height=12, spp=2, max_depth=depth)
    fields = ("diffuse", "emissive", "param")
    tracer = cuda_grad.make_grad_path_tracer(ps, pc, cfg, fields=fields)
    pvec = cuda_grad.pack_params({f: getattr(ps.materials, f) for f in fields},
                                 tracer.fields)
    lane0, n, n_all = 5, 37, cfg.height * cfg.width * cfg.spp
    with torch.no_grad():
        full, seg_full = tracer.plain(pvec, 5, 3, 0, n_all)
        band, seg_band = tracer.plain(pvec, 5, 3, lane0, n)
    assert torch.equal(band, full[:, lane0:lane0 + n])
    assert torch.equal(seg_band, seg_full[lane0:lane0 + n])
    trace = make_diff_path(scene, RefConfig(**vars(cfg)), z_far=float(np.asarray(cam.z_far)))
    ref = trace(scene.materials, cam, 5, 3)
    np.testing.assert_allclose(band.t().numpy(), np.asarray(ref.radiance)[lane0:lane0 + n],
                               rtol=1e-4, atol=1e-5)
    assert int(seg_full.sum()) == int(ref.segments)
    assert float(band.abs().max()) > 0


def test_grad_tracer_glow_field_and_pack_round_trip():
    """tests/test_pallas_grad.py:82-112: the pack of ``diffuse`` and ``glow``
    round-trips, and the glow sphere's column carries gradient."""
    b = build_cornell_box()
    glow = b.add_material(RM.MaterialSpec(RM.GLOW, diffuse=(0.4, 0.3, 0.2), param=0.5,
                                          glow=(1.5, 0.5, 0.25)))
    b.add_sphere((0.0, -20.0, -10.0), 8.0, glow)
    _, _, ps, pc, cfg = _setup(b, width=12, height=12, spp=1, max_depth=3)
    tracer = cuda_grad.make_grad_path_tracer(ps, pc, cfg, fields=("diffuse", "glow"))
    params = {"diffuse": ps.materials.diffuse, "glow": ps.materials.glow}
    pvec = cuda_grad.pack_params(params, tracer.fields)
    assert pvec.shape == (tracer.n_params,)
    back = cuda_grad.unpack_params(pvec, tracer.mats, tracer.fields)
    for k in params:
        assert torch.equal(back[k], params[k]), k
    leaf = pvec.clone().requires_grad_()
    (g,) = torch.autograd.grad((tracer(leaf, 3, 0).radiance ** 2).mean(), [leaf])
    gd = cuda_grad.unpack_params(g, tracer.mats, tracer.fields)
    assert bool(torch.isfinite(g).all())
    assert float(gd["glow"].abs().max()) > 0


def test_grad_tracer_declines_textured_scenes():
    _, _, ps, pc, cfg = _setup(_textured_floor(), width=8, height=8, spp=1, max_depth=2)
    assert cuda_grad.make_grad_path_tracer(ps, pc, cfg) is None
    assert cuda_grad.make_grad_image_fn(ps, pc, cfg) is None


def test_grad_tracer_route_rule():
    """Kernel 9 records its lanes for kernel 10 to sweep only where the call
    wants a gradient and the record fits in an eighth of the card: the
    pool-8 band (1080p×4, depth 8) does on an 80 GB card, a band past the
    eighth does not, and a call that wants no gradient never does."""
    card = 85_017_493_504  # an H100 80GB HBM3's total_memory
    n = 1920 * 1080 * 4
    assert cuda_grad.record_bytes(n, 8) == n * 8 * 48 + n * 16
    assert cuda_grad.keeps_record(n, 8, card, True)
    assert not cuda_grad.keeps_record(n, 8, card, False)
    most = card // 8 // (8 * 48 + 16)  # the most lanes at depth 8
    assert cuda_grad.keeps_record(most, 8, card, True)
    assert not cuda_grad.keeps_record(most + 1, 8, card, True)
    assert not cuda_grad.keeps_record(n, 40, card, True)
    assert not cuda_grad.keeps_record(1, 1, card, False)


def test_fused_loss_backward_modes_agree():
    """tests/test_pallas_grad.py:255-283: affine, remat and whole chain give
    the same loss, gradients (up to float re-association) and segments."""
    _, _, ps, pc, cfg = _setup(build_cornell_box(with_specular=True), width=16, height=12,
                               spp=2, max_depth=3)
    params = {k: getattr(ps.materials, k) for k in ("diffuse", "emissive")}
    target = torch.from_numpy(np.random.default_rng(1).random(
        (cfg.height, cfg.width, 3), dtype=np.float32))
    runs = {name: cuda_grad.make_fused_loss_grad_fn(ps, pc, cfg, **kw)(
        params, target, 9, 2, 0, cfg.height) for name, kw in (
            ("chain", dict(affine=False)), ("affine", dict(affine=True)),
            ("remat", dict(affine=False, remat=True)))}
    l_un, g_un, s_un = runs["chain"]
    for name in ("affine", "remat"):
        loss, grads, segs = runs[name]
        np.testing.assert_allclose(float(loss), float(l_un), rtol=1e-5, err_msg=name)
        assert int(segs) == int(s_un), name
        for k in grads:
            assert float(g_un[k].abs().max()) > 0, k
            np.testing.assert_allclose(grads[k].numpy(), g_un[k].numpy(), rtol=1e-4,
                                       atol=1e-8, err_msg=f"{name}:{k}")


@pytest.fixture(scope="module")
def camera_reference():
    """The reference's planar path (ops/diff_path.py) under
    ``jax.value_and_grad`` of the lane-level dual-buffer loss with respect to
    the camera 9-vector, with the reference test's thin-lens camera
    (tests/test_pallas_grad.py:299-346), 16×12, 2 spp, depth 3; computed once
    for the module."""
    b = build_cornell_box(with_specular=True)
    scene = b.compile()
    cam = RefCamera.create(origin=(3.0, -2.0, -140.0), target=(1.0, 0.5, 0.0),
                           aperture_size=1.5, focal_depth=120.0)
    cfg = RenderConfig(width=16, height=12, spp=2, max_depth=3)
    target = np.random.default_rng(2).random((cfg.height, cfg.width, 3), dtype=np.float32)
    tgt_lane = np.repeat(target.reshape(-1, 3), cfg.spp, axis=0)
    planar = make_diff_path(scene, RefConfig(**vars(cfg)), z_far=float(np.asarray(cam.z_far)))

    def ref_loss(cv):
        c = cam._replace(origin=cv[0:3], target=cv[3:6], fov_y=cv[6], aperture_size=cv[7],
                         focal_depth=cv[8])
        a = planar(scene.materials, c, 5, 3 * cfg.spp)
        bb = planar(scene.materials, c, 5, (3 + 10007) * cfg.spp)
        loss = jnp.mean((a.radiance - tgt_lane) * (bb.radiance - tgt_lane))
        return loss, a.segments + bb.segments

    cvec = jnp.concatenate([cam.origin, cam.target, jnp.stack([
        cam.fov_y, cam.aperture_size, cam.focal_depth])])
    (ref_v, ref_segs), ref_g = jax.value_and_grad(ref_loss, has_aux=True)(cvec)
    ps = convert.scene_from_numpy(_np_tree(scene), device="cpu")
    pc = convert.camera_from_numpy(_np_tree(cam), device="cpu")
    return ps, pc, cfg, target, float(ref_v), int(ref_segs), np.asarray(ref_g)


def test_fused_loss_camera_gradient_matches_diff_path(camera_reference):
    """Kernel 8's whole chain with ``"camera"`` (its plain version: the
    traced raygen, build_traced_raygen, and the body under autograd) against
    the reference's planar path under ``jax.value_and_grad`` of the same
    lane-level loss, at the reference test's bar (rtol 2e-3,
    tests/test_pallas_grad.py:345), with remat off and on."""
    ps, pc, cfg, target, ref_v, ref_segs, ref_g = camera_reference
    assert np.abs(ref_g).min() > 0  # every camera scalar moves the loss
    for remat in (False, True):
        fused = cuda_grad.make_fused_loss_grad_fn(ps, pc, cfg, fields=("camera",),
                                                  remat=remat)
        loss, grads, segs = fused.plain({"camera": camera_pvec(pc)}, torch.from_numpy(target),
                                        5, 3, 0, cfg.height)
        np.testing.assert_allclose(float(loss), ref_v, rtol=1e-5, err_msg=f"remat={remat}")
        assert int(segs) == ref_segs, remat
        np.testing.assert_allclose(grads["camera"].numpy(), ref_g, rtol=2e-3, atol=1e-10,
                                   err_msg=f"remat={remat}")


def test_fused_loss_joint_material_camera_fields():
    """tests/test_pallas_grad.py:349-376: material columns and the camera
    9-vector through one call; the material entries equal the camera-free
    whole chain's."""
    _, _, ps, pc, cfg = _setup(build_cornell_box(with_specular=True), width=16, height=8,
                               spp=1, max_depth=2)
    target = torch.from_numpy(np.random.default_rng(3).random(
        (cfg.height, cfg.width, 3), dtype=np.float32))
    params = {"diffuse": ps.materials.diffuse, "emissive": ps.materials.emissive,
              "camera": camera_pvec(pc)}
    joint = cuda_grad.make_fused_loss_grad_fn(ps, pc, cfg,
                                              fields=("diffuse", "emissive", "camera"))
    l1, g1, s1 = joint(params, target, 9, 2, 0, cfg.height)
    assert set(g1) == {"diffuse", "emissive", "camera"}
    assert bool(torch.isfinite(g1["camera"]).all())
    base = cuda_grad.make_fused_loss_grad_fn(ps, pc, cfg, affine=False)
    l2, g2, s2 = base({k: params[k] for k in ("diffuse", "emissive")}, target, 9, 2, 0,
                      cfg.height)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    assert int(s1) == int(s2)
    for k in g2:
        np.testing.assert_allclose(g1[k].numpy(), g2[k].numpy(), rtol=1e-4, atol=1e-8,
                                   err_msg=k)


def test_fused_loss_affine_rejects_scalar_fields():
    _, _, ps, pc, cfg = _setup(build_cornell_box(), width=16, height=8, spp=1, max_depth=2)
    with pytest.raises(ValueError):
        cuda_grad.make_fused_loss_grad_fn(ps, pc, cfg, fields=("diffuse", "param"),
                                          affine=True)
    # Auto mode takes the whole chain for scalar fields.
    assert cuda_grad.make_fused_loss_grad_fn(ps, pc, cfg,
                                             fields=("diffuse", "param")) is not None
