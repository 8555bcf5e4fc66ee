"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points run on the CUDA card unless told to use the CPU."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "fspt_tpu_torch", "fspt_tpu_torch.cli", "fspt_tpu_torch.convert",
    "fspt_tpu_torch.camera", "fspt_tpu_torch.config", "fspt_tpu_torch.materials",
    "fspt_tpu_torch.ops._build", "fspt_tpu_torch.ops.bvh", "fspt_tpu_torch.ops.cuda_bvh",
    "fspt_tpu_torch.ops.cuda_grad",
    "fspt_tpu_torch.ops.cuda_path",
    "fspt_tpu_torch.ops.cuda_trace", "fspt_tpu_torch.ops.diff_intersect",
    "fspt_tpu_torch.ops.diff_path",
    "fspt_tpu_torch.ops.intersect",
    "fspt_tpu_torch.ops.kernel_check", "fspt_tpu_torch.ops.rng",
    "fspt_tpu_torch.render.dispatch", "fspt_tpu_torch.render.framebuffer",
    "fspt_tpu_torch.render.integrator", "fspt_tpu_torch.render.queue",
    "fspt_tpu_torch.scene.builder",
    "fspt_tpu_torch.scene.geometry", "fspt_tpu_torch.scene.mesh",
    "fspt_tpu_torch.scene.parser", "fspt_tpu_torch.scene.samples",
    "fspt_tpu_torch.utils.checkpoint", "fspt_tpu_torch.utils.image",
    "fspt_tpu_torch.utils.native", "fspt_tpu_torch.utils.vecmath", "fspt_tpu_torch.parallel",
    "fspt_tpu_torch.parallel.train", "fspt_tpu_torch.examples",
    "fspt_tpu_torch.examples.recover_albedo", "fspt_tpu_torch.examples.recover_camera",
    "fspt_tpu_torch.examples.recover_texture", "fspt_tpu_torch.examples.recover_vertices",
    "fspt_tpu_torch.examples.recover_vertices_bvh", "fspt_tpu_torch.interactive",
    "fspt_tpu_torch.render.denoiser", "fspt_tpu_torch.render.preview",
    "fspt_tpu_torch.utils.profiling",
    "chip_smoke",
]


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'fspt_tpu' or m.startswith('fspt_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    # -I: no PYTHONPATH or site hooks that could preload jax.
    proc = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_entry_points_refuse_cpu_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from fspt_tpu_torch import Camera, SceneBuilder, cli
    from fspt_tpu_torch.render import framebuffer
    from fspt_tpu_torch.utils import checkpoint

    with pytest.raises(RuntimeError, match="device='cpu'"):
        SceneBuilder().compile()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Camera.create()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        framebuffer.create(2, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        checkpoint.load("missing.npz")
    scene = os.path.join(REPO, "scenes", "cornell.scene")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--file", scene, "--width", "8", "--height", "8", "--frames", "1"])
    from fspt_tpu_torch import convert
    from fspt_tpu_torch.examples import (recover_albedo, recover_camera, recover_texture,
                                         recover_vertices, recover_vertices_bvh)

    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.params_from_numpy({"diffuse": [[0.5, 0.5, 0.5]]})
    for example in (recover_albedo, recover_texture, recover_camera, recover_vertices,
                    recover_vertices_bvh):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            example.main(["--iters", "1"])
    # The mesh path: a BVH scene through the CLI (both estimators), the
    # BVH builder and the heightfield sample.
    from fspt_tpu_torch.ops import bvh
    from fspt_tpu_torch.scene import samples

    hf = samples.write_heightfield_scene(str(tmp_path), grid=10)
    for extra in ([], ["--first-hit-cache"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["--file", hf, "--width", "8", "--height", "8", "--frames", "1"] + extra)
    tri = [[[0.0, 0.0, 0.0]], [[1.0, 0.0, 0.0]], [[0.0, 1.0, 0.0]]]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bvh.build_bvh(*tri)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        samples.build("heightfield", grid=10)
