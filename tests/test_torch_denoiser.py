"""The port's AOV-guided denoiser (render/denoiser.py) and the CLI's
``--denoise`` on the CPU.

* ``denoise`` and ``atrous_pass`` (strides 1, 2, 4) against the
  reference's on one seeded 24×32 framebuffer with normal, depth and
  material discontinuities, miss pixels (zero normal and depth) and pixels
  at count 0 and 1.  Bar: rtol 1e-4 / atol 1e-6 on every value; the worst
  measured error is 4.8e-7 absolute (values up to ~10) and 1.4e-6
  relative, at stride 4 (the two libraries' float32 ``exp``/``pow``/``sqrt``
  and the order of the dot products).
* The port's own MSE test, modelled on tests/test_scene_io.py:171-207, on
  the port's renders: denoising 4 frames beats the noisy image by half and
  16 frames (4× the samples).
* ``python -m fspt_tpu_torch.cli --denoise --device cpu`` writes
  ``to_display(denoise(fb))`` of its own framebuffer.
"""

import os

import numpy as np
import pytest
import torch

from conftest import build_cornell_box
from fspt_tpu.render import denoiser as ref_denoiser
from fspt_tpu.render import framebuffer as ref_fb
from fspt_tpu_torch import cli, convert
from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.render import denoiser
from fspt_tpu_torch.render import framebuffer as fb_mod
from fspt_tpu_torch.render import integrator
from fspt_tpu_torch.utils import checkpoint as ckpt

CPU = torch.device("cpu")
STRIDES = (1, 2, 4)
H, W = 24, 32


def _seeded_framebuffer(seed=0):
    """A NumPy framebuffer with the discontinuities the weights stop at."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    left = xx < 13
    normal = np.where(left[..., None], np.float32([0.0, 0.0, -1.0]),
                      np.float32([0.0, 1.0, 0.0]) + 0.2 * rng.normal(size=(H, W, 3)))
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    depth = np.where(left, 80.0 + 0.5 * yy, 140.0 + rng.normal(size=(H, W)))
    mat = np.where(left, 1, np.where(yy < 9, 2, 3))
    miss = (yy >= 20) & (xx >= 26)
    normal[miss], depth[miss], mat[miss] = 0.0, 0.0, 0
    count = np.full((H, W), 4.0)
    count[rng.random((H, W)) < 0.08] = 0.0
    count[rng.random((H, W)) < 0.08] = 1.0
    mean = rng.gamma(0.6, 0.5, (H, W, 3)) * np.where(mat == 3, 4.0, 1.0)[..., None]
    m2 = rng.gamma(0.6, 0.3, (H, W, 3)) * (count[..., None] > 1)
    mean[count == 0] = 0.0
    f = lambda a: np.ascontiguousarray(a, np.float32)
    return ref_fb.Framebuffer(mean=f(mean), m2=f(m2), count=f(count), normal=f(normal),
                              depth=f(depth), mat=mat.astype(np.int32))


@pytest.fixture(scope="module")
def case():
    """(numpy framebuffer, sigma_dev, reference denoise, reference passes)."""
    import jax.numpy as jnp

    fb = _seeded_framebuffer()
    jfb = ref_fb.Framebuffer(*[jnp.asarray(a) for a in fb])
    sigma = np.random.default_rng(1).gamma(1.0, 0.05, (H, W)).astype(np.float32) + 1e-3
    passes = {s: np.asarray(ref_denoiser.atrous_pass(jfb.mean, jfb.normal, jfb.depth, jfb.mat,
                                                     jnp.asarray(sigma), stride=s))
              for s in STRIDES}
    return fb, sigma, np.asarray(ref_denoiser.denoise(jfb)), passes


def test_denoise_matches_reference(case):
    fb, _, ref, _ = case
    out = denoiser.denoise(convert.framebuffer_from_numpy(fb, device=CPU))
    assert out.shape == (H, W, 3) and out.dtype == torch.float32 and out.device == CPU
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-6)
    # The filter moved the image: it is not the mean passed through.
    assert np.abs(ref - fb.mean).max() > 0.1


@pytest.mark.parametrize("stride", STRIDES)
def test_atrous_pass_matches_reference(case, stride):
    fb, sigma, _, passes = case
    t = convert.framebuffer_from_numpy(fb, device=CPU)
    out = denoiser.atrous_pass(t.mean, t.normal, t.depth, t.mat, torch.from_numpy(sigma),
                               stride=stride)
    np.testing.assert_allclose(out.numpy(), passes[stride], rtol=1e-4, atol=1e-6)


def test_shift_clamps_at_the_edges():
    x = torch.arange(12.0).reshape(3, 4)
    np.testing.assert_array_equal(denoiser._shift2d(x, 2, 0).numpy(),
                                  x[[0, 0, 0]].numpy())
    np.testing.assert_array_equal(denoiser._shift2d(x, 0, -3).numpy(),
                                  x[:, [3, 3, 3, 3]].numpy())
    np.testing.assert_array_equal(denoiser._shift2d(x, -1, 1).numpy(),
                                  x[[1, 2, 2]][:, [0, 0, 1, 2]].numpy())


def test_denoiser_improves_mse():
    """AOV-guided denoise of a low-spp render beats the noisy image by half
    and 4× the samples (the reference's claim, README.md:11), on the
    port's renders."""
    import jax

    b = build_cornell_box()
    scene = convert.scene_from_numpy(jax.tree_util.tree_map(np.asarray, b.compile()),
                                     device=CPU)
    cam = convert.camera_from_numpy(jax.tree_util.tree_map(np.asarray, b.cameras[0]),
                                    device=CPU)
    cfg = RenderConfig(width=32, height=24, spp=1, max_depth=3)

    def render(frames, seed):
        fb = fb_mod.create(cfg.height, cfg.width, device=CPU)
        for f in range(frames):
            fb, _ = integrator.render_step(scene, cam, cfg, fb, seed, f)
        return fb

    def tone(x):  # display space (frame.cpp:66-69) — what the claim is about
        return np.clip(x.numpy(), 0, 1) ** (1 / 2.2)

    reference = tone(render(96, seed=123).mean)  # converged-ish target
    noisy_fb = render(4, seed=7)
    more_fb = render(16, seed=7)  # 4x the samples

    mse_noisy = float(np.mean((tone(noisy_fb.mean) - reference) ** 2))
    mse_denoised = float(np.mean((tone(denoiser.denoise(noisy_fb)) - reference) ** 2))
    mse_4x = float(np.mean((tone(more_fb.mean) - reference) ** 2))

    assert mse_denoised < mse_noisy * 0.5, (mse_noisy, mse_denoised)
    assert mse_denoised < mse_4x, (mse_denoised, mse_4x)


def _read_ppm(path):
    with open(path, "rb") as f:
        data = f.read()
    magic, dims, maxval, pixels = data.split(b"\n", 3)
    w, h = map(int, dims.split())
    assert magic == b"P6" and maxval == b"255"
    return np.frombuffer(pixels, np.uint8).reshape(h, w, 3)


def test_cli_denoise_writes_the_denoised_image(tmp_path, capsys):
    scene = os.path.join(os.path.dirname(__file__), "..", "scenes", "cornell.scene")
    out, ck = str(tmp_path / "out.ppm"), str(tmp_path / "ck.npz")
    args = ["--file", scene, "--width", "16", "--height", "12", "--spp", "2",
            "--frames", "2", "--depth", "3", "--output", out, "--checkpoint", ck,
            "--device", "cpu"]
    assert cli.main(args + ["--denoise"]) == 0
    assert "wrote" in capsys.readouterr().out
    fb, frame = ckpt.load(ck, device=CPU)
    assert frame == 2
    want = fb_mod.to_display(denoiser.denoise(fb)).numpy()[::-1]
    np.testing.assert_array_equal(_read_ppm(out), want)
    # Without the flag the same run writes the undenoised mean.
    os.remove(ck)
    assert cli.main(args) == 0
    np.testing.assert_array_equal(_read_ppm(out), fb_mod.to_display(fb.mean).numpy()[::-1])
    assert not np.array_equal(want, fb_mod.to_display(fb.mean).numpy()[::-1])
