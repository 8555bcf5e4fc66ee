"""The deferred modes of the plain path body (kernels 4 and 7), the two
folds, and the textured camera-fused tracer, against the reference's XLA
body (``build_path_core(..., ops=XlaOps)``), its folds and its integrator.

Bars: slot fields within rtol 1e-4 / atol 1e-5 on ≥ 99.9 % of values, the
material rows and the light mask equal — torch's and XLA's CPU
``sin``/``cos`` may differ in the last bit and flip a lane's branch (the
same bar as tests/test_torch_path.py).  The folds on the same seeded planes
agree at rtol 1e-6 and their gradients at rtol 1e-5: the two run the same
operations, but the reference gathers rows with a lattice of selects and
the port with an indexed gather, whose adjoint sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import build_cornell_box
from fspt_tpu import materials as RM
from fspt_tpu.camera import Camera as RefCamera
from fspt_tpu.camera import generate_rays as ref_generate_rays
from fspt_tpu.config import RenderConfig as RefConfig
from fspt_tpu.ops import pallas_path as rpp
from fspt_tpu.ops import rng as ref_rng
from fspt_tpu.render import integrator as ref_integrator
from fspt_tpu.scene.builder import SceneBuilder as RefBuilder
from fspt_tpu_torch import convert
from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.ops import cuda_path, rng
from fspt_tpu_torch.ops.cuda_trace import HostScene
from fspt_tpu_torch.scene import samples

FRACTION = 0.999
W, H, SPP, DEPTH = 16, 12, 2, 4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def ref_scene(name, **cam_kw):
    """A sample scene built with the reference builder, and its camera."""
    b = RefBuilder()
    samples.SCENES[name](b, RM)
    cam = RefCamera.create(origin=samples.CAMERA_ORIGIN, **cam_kw)
    return b.compile(), cam


def fog_glow_scene():
    """The specular Cornell box with a glow sphere inside a fog sphere."""
    b = build_cornell_box(with_specular=True, with_fog=True)
    glow = b.add_material(RM.MaterialSpec(RM.GLOW, diffuse=(0.4, 0.3, 0.2),
                                          param=0.5, glow=(1.5, 0.5, 0.25)))
    b.add_sphere((0.0, -20.0, -10.0), 8.0, glow)
    return b.compile(), b.cameras[0]


def _port(scene, cam):
    return (convert.scene_from_numpy(_np_tree(scene), device="cpu"),
            convert.camera_from_numpy(_np_tree(cam), device="cpu"))


def _ref_h0(seed):
    h = ref_rng.pcg_hash(jnp.uint32(seed) ^ jnp.uint32(0x9E3779B9))
    return jax.lax.bitcast_convert_type(h, jnp.int32)


def _run_cores(scene, cam, cfg, seed, **mode):
    """Reference and port deferred bodies on the reference's primary rays."""
    rays = [np.array(x) for x in
            ref_generate_rays(cam, cfg.width, cfg.height, cfg.spp, seed, 0)]
    start, seg, pix, smp = rays
    z_far = float(np.asarray(cam.z_far))
    sky = int(np.asarray(scene.sky_mat))
    ref_core = rpp.build_path_core(rpp.HostScene(scene.geometry),
                                   rpp.HostMaterials(scene.materials),
                                   RefConfig(**vars(cfg)), sky, z_far,
                                   ops=rpp.XlaOps, **mode)
    ref = ref_core(_ref_h0(seed), *(start[:, c] for c in range(3)),
                   *(seg[:, c] for c in range(3)), pix, smp)
    ps, _ = _port(scene, cam)
    core = cuda_path.build_path_core(HostScene(ps.geometry),
                                     cuda_path.HostMaterials(ps.materials),
                                     cfg, sky, z_far, **mode)
    t = torch.from_numpy
    out = core(rng.seed_hash(seed), *(t(start[:, c].copy()) for c in range(3)),
               *(t(seg[:, c].copy()) for c in range(3)), t(pix), t(smp))
    return out, ref


def _compare_slots(out, ref, float_keys, int_keys):
    slots, p_light, *_, segcnt = out
    rslots, rp_light, *_, rsegcnt = ref
    assert len(slots) == len(rslots)
    for key in float_keys:
        close = np.isclose(np.stack([sl[key].numpy() for sl in slots]),
                           np.stack([np.asarray(sl[key]) for sl in rslots]),
                           rtol=1e-4, atol=1e-5)
        assert close.mean() >= FRACTION, (key, close.mean())
    for key in int_keys:
        np.testing.assert_array_equal(np.stack([sl[key].numpy() for sl in slots]),
                                      np.stack([np.asarray(sl[key]) for sl in rslots]),
                                      err_msg=key)
    np.testing.assert_array_equal(p_light.numpy(), np.asarray(rp_light))
    np.testing.assert_array_equal(segcnt.numpy(), np.asarray(rsegcnt))


@pytest.mark.parametrize("name", ["textured", "all_families_textured"])
def test_deferred_tex_slots_match_reference(name):
    scene, cam = ref_scene(name, aperture_size=0.0)
    cfg = RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH)
    out, ref = _run_cores(scene, cam, cfg, seed=3, deferred_tex=True)
    _compare_slots(out, ref, cuda_path.DEFERRED_TEX_FIELDS, ("mat",))
    # The planes carry signal: textured rows defer, the sky event fires.
    assert any(float(sl["s"].abs().max()) > 0 for sl in out[0])
    assert any(float(sl["se"].max()) == 3.0 for sl in out[0])


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("which", ["textured", "fog_glow"])
def test_defer_all_slots_match_reference(which, fast):
    scene, cam = (ref_scene("textured", aperture_size=0.0) if which == "textured"
                  else fog_glow_scene())
    cfg = RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH, fast_render=fast)
    out, ref = _run_cores(scene, cam, cfg, seed=5, defer_all=True)
    _compare_slots(out, ref, ("s", "k", "se", "u", "v"), ("mat", "mat_e"))
    assert len(out[0]) == cuda_path.n_slots(cfg)


def test_textured_camera_tracer_matches_integrator():
    scene, cam = ref_scene("all_families_textured", aperture_size=0.0)
    ps, pc = _port(scene, cam)
    cfg = RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH)
    out = cuda_path.make_camera_path_tracer(ps, pc, cfg)(9, 2)
    ref = ref_integrator.render_wavefront(scene, cam, RefConfig(**vars(cfg)), 9, 2)
    close = np.isclose(out.radiance.numpy(), np.asarray(ref.radiance),
                       rtol=1e-4, atol=1e-5)
    assert close.mean() >= FRACTION, close.mean()
    assert int(out.segments) == int(ref.segments)
    np.testing.assert_array_equal(out.aov_mat.numpy(), np.asarray(ref.aov_mat))
    np.testing.assert_allclose(out.aov_depth.numpy(), np.asarray(ref.aov_depth),
                               rtol=1e-4)
    assert float(out.radiance.mean()) > 0.01


def _seeded_planes(count, n_slots=4, n=96, seed=0):
    r = np.random.default_rng(seed)
    f = lambda lo, hi: r.uniform(lo, hi, (n_slots, n)).astype(np.float32)
    rows = lambda: r.integers(-1, count, (n_slots, n)).astype(np.int32)
    return dict(s=f(0, 1), k=f(0, 0.5), k1=f(0, 0.5), k2=f(0, 0.5),
                se=f(0, 3), ke0=f(0, 2), ke1=f(0, 2), ke2=f(0, 2),
                u=f(-3, 3), v=f(-3, 3), mat=rows(), mat_e=rows(),
                p_light=r.random(n) < 0.5, w=r.normal(size=(3, n)).astype(np.float32))


@pytest.mark.parametrize("name,live", [
    ("all_families", ("diffuse", "emissive", "glow")),
    ("all_families_textured", ("diffuse", "emissive", "texels")),
])
def test_folds_and_their_gradients_match_reference(name, live):
    # A textured row reads its texel instead of its table value, so each
    # scene leaves some columns without gradient; ``live`` are the others.
    scene, _ = ref_scene(name)
    ps = convert.scene_from_numpy(_np_tree(scene), device="cpu")
    cfg = RenderConfig()
    pl = _seeded_planes(int(scene.materials.count))
    t = {k: torch.from_numpy(v) for k, v in pl.items()}
    rmats = rpp.HostMaterials(scene.materials)
    pmats = cuda_path.HostMaterials(ps.materials)
    bias = torch.from_numpy(pmats.bias_column())[:, None]

    def ref_params(diffuse, emissive, glow, texels):
        tex = scene.textures._replace(texels=texels)
        a = rpp.fold_deferred_params(rmats, cfg, diffuse, emissive, glow, tex,
                                     pl["s"], pl["k"], pl["se"], pl["mat"],
                                     pl["mat_e"], pl["u"], pl["v"], pl["p_light"])
        b = rpp.fold_deferred_radiance(scene.materials, tex, cfg, pl["s"], pl["k"],
                                       pl["k1"], pl["k2"], pl["se"], pl["ke0"],
                                       pl["ke1"], pl["ke2"], pl["u"], pl["v"],
                                       pl["mat"], pl["p_light"])
        return (jnp.stack(a), jnp.stack(b))

    def port_params(diffuse, emissive, glow, texels):
        tex = ps.textures._replace(texels=texels)
        a = cuda_path.fold_deferred_params(
            pmats, bias, cfg, diffuse, emissive, glow, tex, t["s"], t["k"], t["se"],
            t["mat"], t["mat_e"], t["u"], t["v"], t["p_light"])
        b = cuda_path.fold_deferred_radiance(
            ps.materials, tex, cfg, t["s"], t["k"], t["k1"], t["k2"], t["se"],
            t["ke0"], t["ke1"], t["ke2"], t["u"], t["v"], t["mat"], t["p_light"])
        return torch.stack(a), torch.stack(b)

    names = ("diffuse", "emissive", "glow")
    rvals = [scene.materials.diffuse, scene.materials.emissive, scene.materials.glow,
             scene.textures.texels]
    ra, rb = ref_params(*rvals)
    pvals = [getattr(ps.materials, k).clone().requires_grad_() for k in names]
    pvals.append(ps.textures.texels.clone().requires_grad_())
    pa, pb = port_params(*pvals)
    np.testing.assert_allclose(pa.detach().numpy(), np.asarray(ra), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pb.detach().numpy(), np.asarray(rb), rtol=1e-6, atol=1e-7)
    assert np.asarray(ra).std() > 0 and np.asarray(rb).std() > 0

    w = pl["w"]
    rgrads = jax.grad(lambda *v: jnp.sum(ref_params(*v)[0] * w)
                      + jnp.sum(ref_params(*v)[1] * w), argnums=(0, 1, 2, 3))(*rvals)
    loss = (pa * t["w"]).sum() + (pb * t["w"]).sum()
    pgrads = torch.autograd.grad(loss, pvals)
    for field, g, rg in zip(names + ("texels",), pgrads, rgrads):
        assert (np.abs(np.asarray(rg)).max() > 0) == (field in live), field
        np.testing.assert_allclose(g.numpy(), np.asarray(rg), rtol=1e-5, atol=1e-6,
                                   err_msg=field)


def test_deferred_band_split_is_exact():
    b = samples.build("textured", device="cpu")
    scene = b.compile(device="cpu")
    cfg = RenderConfig(width=16, height=8, spp=1, max_depth=3)
    tracer = cuda_path.make_camera_path_tracer(scene, b.cameras[0], cfg)
    full = tracer(5, 0)
    half = cfg.width * cfg.height // 2 + 5
    lower = tracer(5, 0, lane0=0, n_lanes=half)
    upper = tracer(5, 0, lane0=half, n_lanes=cfg.width * cfg.height - half)
    assert torch.equal(full.radiance, torch.cat([lower.radiance, upper.radiance]))
    assert torch.equal(full.aov_mat, torch.cat([lower.aov_mat, upper.aov_mat]))
    assert int(full.segments) == int(lower.segments) + int(upper.segments)
