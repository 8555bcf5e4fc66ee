"""The port's CLI renders scenes/cornell.scene on the CPU like two frames of
the reference's XLA ``render_step``.

Bar as tests/test_torch_path.py: the accumulated mean within rtol 1e-4 /
atol 1e-5 on ≥ 99.9 % of values (a lane whose branch flips on a last-bit
difference of a CPU ``sin``/``cos`` follows another path), the last-sample
material AOV equal, the sample count exact.
"""

import os

import numpy as np

from fspt_tpu.config import RenderConfig as RefConfig
from fspt_tpu.render import framebuffer as ref_fb
from fspt_tpu.render import integrator as ref_integrator
from fspt_tpu.scene.parser import load_scene as ref_load_scene
from fspt_tpu_torch import cli
from fspt_tpu_torch.utils import checkpoint as ckpt

SCENE = os.path.join(os.path.dirname(__file__), "..", "scenes", "cornell.scene")


def test_cli_matches_reference_render_step(tmp_path, capsys):
    out_png = str(tmp_path / "out.png")
    ck = str(tmp_path / "ck.npz")
    w, h, spp, frames = 32, 24, 2, 2
    rc = cli.main(["--file", SCENE, "--width", str(w), "--height", str(h),
                   "--spp", str(spp), "--frames", str(frames), "--seed", "3",
                   "--output", out_png, "--checkpoint", ck, "--device", "cpu"])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "render path: camera-fused plain torch" in printed
    assert printed.count("Mrays/sec:") == frames
    assert os.path.getsize(out_png) > 0
    fb, frame = ckpt.load(ck, device="cpu")
    assert frame == frames

    b = ref_load_scene(SCENE)
    scene, camera = b.compile(), b.cameras[0]
    cfg = RefConfig(width=w, height=h, spp=spp, max_depth=8)
    ref = ref_fb.create(h, w)
    for f in range(frames):
        ref, _ = ref_integrator.render_step(scene, camera, cfg, ref, 3, f)

    close = np.isclose(fb.mean.numpy(), np.asarray(ref.mean), rtol=1e-4, atol=1e-5)
    assert close.mean() >= 0.999, close.mean()
    np.testing.assert_array_equal(fb.count.numpy(), np.asarray(ref.count))
    np.testing.assert_array_equal(fb.mat.numpy(), np.asarray(ref.mat))
    assert fb.mean.numpy().mean() > 0.01  # a lit box, not a black frame


def test_cli_renders_textured_scene_like_reference(tmp_path, capsys):
    """A textured copy of cornell.scene (EXR textures on two walls and the
    sky) takes the texture-deferred tracer and matches the reference's
    integrator at the same bar."""
    from fspt_tpu_torch.scene import samples

    data = os.path.join(os.path.dirname(__file__), "data")
    scene_file = samples.write_textured_cornell(
        SCENE, str(tmp_path / "textured.scene"), os.path.join(data, "piz_pattern.exr"),
        os.path.join(data, "piz_dome.exr"))
    ck = str(tmp_path / "ck.npz")
    w, h, spp, frames = 24, 16, 2, 1
    rc = cli.main(["--file", scene_file, "--width", str(w), "--height", str(h),
                   "--spp", str(spp), "--frames", str(frames), "--seed", "4",
                   "--depth", "4", "--output", str(tmp_path / "t.png"), "--checkpoint", ck,
                   "--device", "cpu"])
    assert rc == 0
    assert "render path: texture-deferred camera-fused plain torch" in capsys.readouterr().out
    fb, _ = ckpt.load(ck, device="cpu")

    b = ref_load_scene(scene_file)
    scene, camera = b.compile(), b.cameras[0]
    cfg = RefConfig(width=w, height=h, spp=spp, max_depth=4)
    ref, _ = ref_integrator.render_step(scene, camera, cfg, ref_fb.create(h, w), 4, 0)
    close = np.isclose(fb.mean.numpy(), np.asarray(ref.mean), rtol=1e-4, atol=1e-5)
    assert close.mean() >= 0.999, close.mean()
    np.testing.assert_array_equal(fb.mat.numpy(), np.asarray(ref.mat))
