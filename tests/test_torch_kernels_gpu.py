"""Each CUDA kernel against its plain PyTorch version, on the card.

Marked ``gpu``: they need a CUDA card and nvcc, and skip elsewhere.  Run
them on the card with ``python -m pytest tests/test_torch_kernels_gpu.py
-m gpu``.  The comparisons and their bars live in
fspt_tpu_torch/ops/kernel_check.py, shared with chip_smoke.py.
"""

import pytest
import torch

from fspt_tpu_torch.config import RenderConfig

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def test_intersect_kernel_matches_plain(cuda):
    from fspt_tpu_torch.ops import kernel_check
    from fspt_tpu_torch.scene import samples

    scene = samples.build("all_primitives", device=cuda).compile(device=cuda)
    start, seg = kernel_check.random_segments(1 << 16, seed=1, device=cuda)
    kernel_check.check_intersect(scene.geometry, start, seg)


def test_ray_path_kernel_matches_plain(cuda):
    from fspt_tpu_torch.ops import kernel_check
    from fspt_tpu_torch.scene import samples

    b = samples.build("all_families", device=cuda)
    cfg = RenderConfig(width=64, height=48, spp=2, max_depth=8)
    kernel_check.check_path_tracer(b.compile(device=cuda), b.cameras[0], cfg, seed=4)


def test_camera_path_kernel_matches_plain(cuda):
    from fspt_tpu_torch.ops import kernel_check
    from fspt_tpu_torch.scene import samples

    b = samples.build("all_families", device=cuda, aperture=1.5, focal_depth=120.0)
    cfg = RenderConfig(width=64, height=48, spp=2, max_depth=8)
    kernel_check.check_camera_tracer(b.compile(device=cuda), b.cameras[0], cfg, seed=5,
                                     sample0=2)


def test_deferred_camera_kernel_matches_plain(cuda):
    from fspt_tpu_torch.ops import kernel_check
    from fspt_tpu_torch.scene import samples

    b = samples.build("all_families_textured", device=cuda, aperture=1.5,
                      focal_depth=120.0)
    cfg = RenderConfig(width=64, height=48, spp=2, max_depth=8)
    kernel_check.check_deferred_tracer(b.compile(device=cuda), b.cameras[0], cfg,
                                       seed=6, sample0=2)


@pytest.mark.parametrize("fast", [False, True])
def test_affine_planes_kernel_matches_plain(cuda, fast):
    from fspt_tpu_torch.ops import kernel_check
    from fspt_tpu_torch.scene import samples

    b = samples.build("all_families_textured", device=cuda, aperture=1.5,
                      focal_depth=120.0)
    cfg = RenderConfig(width=64, height=48, spp=2, max_depth=8, fast_render=fast)
    kernel_check.check_affine_planes(b.compile(device=cuda), b.cameras[0], cfg, seed=7)


def test_fused_loss_kernel_matches_plain(cuda):
    import numpy as np

    from fspt_tpu_torch.ops import kernel_check
    from fspt_tpu_torch.scene import samples

    b = samples.build("flagship", device=cuda)
    cfg = RenderConfig(width=64, height=48, spp=2, max_depth=8)
    target = torch.from_numpy(np.random.default_rng(0).random(
        (cfg.height, cfg.width, 3), dtype=np.float32)).to(cuda)
    kernel_check.check_fused_loss(b.compile(device=cuda), b.cameras[0], cfg, target,
                                  seed=8, frame_idx=3)


ADJOINT_FIELDS = ("diffuse", "emissive", "glow", "param", "ior", "reflectivity", "frost")


def test_grad_path_kernels_match_plain(cuda):
    """Kernel 9 against its plain version and kernel 10 against autograd of
    it, on all nine families through a thin-lens camera."""
    from fspt_tpu_torch.ops import kernel_check
    from fspt_tpu_torch.scene import samples

    b = samples.build("all_families", device=cuda, aperture=1.5, focal_depth=120.0)
    cfg = RenderConfig(width=64, height=48, spp=2, max_depth=4)
    kernel_check.check_grad_path_tracer(b.compile(device=cuda), b.cameras[0], cfg,
                                        ADJOINT_FIELDS, seed=3, sample0=1)


@pytest.mark.parametrize("scene_name,fields", [
    ("all_families", ADJOINT_FIELDS), ("flagship", ("camera",)),
    ("flagship", ("diffuse", "emissive", "param", "camera")),
])
def test_fused_loss_chain_kernel_matches_plain(cuda, scene_name, fields):
    """Kernel 8's whole chain (and remat, the same kernel) against its plain
    version, material fields and the camera."""
    import numpy as np

    from fspt_tpu_torch.ops import kernel_check
    from fspt_tpu_torch.scene import samples

    b = samples.build(scene_name, device=cuda, aperture=1.5, focal_depth=120.0)
    cfg = RenderConfig(width=64, height=48, spp=2, max_depth=4)
    target = torch.from_numpy(np.random.default_rng(1).random(
        (cfg.height, cfg.width, 3), dtype=np.float32)).to(cuda)
    kernel_check.check_fused_loss_chain(b.compile(device=cuda), b.cameras[0], cfg, target,
                                        fields, seed=4, frame_idx=2)


@pytest.fixture
def heightfield(cuda):
    from fspt_tpu_torch.scene import samples

    b = samples.build("heightfield", device=cuda, grid=60)
    return b.compile(device=cuda), b.cameras[0]


def test_treelet_kernels_match_plain(cuda, heightfield):
    """Kernels 5 and 6 on primary rays and on one queue iteration's bounce
    rays of the heightfield, fed as the mesh intersector feeds them."""
    from fspt_tpu_torch.camera import generate_rays
    from fspt_tpu_torch.ops import kernel_check
    from fspt_tpu_torch.ops.cuda_bvh import make_mesh_intersector
    from fspt_tpu_torch.render.queue import render_queued

    scene, cam = heightfield
    inter = make_mesh_intersector(scene)
    calls = []

    def recording(o, d, alive):
        calls.append((o, d, alive))
        return inter(o, d, alive)

    recording.accepts_alive = True
    cfg = RenderConfig(width=64, height=48, spp=2, max_depth=4)
    render_queued(scene, cam, cfg, 3, 0, intersector=recording)
    start, seg, _, _ = generate_rays(cam, 64, 48, 2, 3, 0)
    for o, d, alive in ((start, seg, None), calls[1]):
        kernel_check.check_treelet_kernels(inter.traverser, *inter.sweep_inputs(o, d, alive)[:3])


def test_mesh_frame_matches_plain(cuda, heightfield):
    from fspt_tpu_torch.ops import kernel_check

    scene, cam = heightfield
    cfg = RenderConfig(width=64, height=48, spp=2, max_depth=4)
    kernel_check.check_mesh_frame(scene, cam, cfg, seed=5, queue=1024)
