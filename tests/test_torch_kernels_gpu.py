"""Each CUDA kernel against its plain PyTorch version, on the card.

Marked ``gpu``: they need a CUDA card and nvcc, and skip elsewhere.  Run
them on the card with ``python -m pytest --noconftest -m gpu
tests/test_torch_kernels_gpu.py`` (tests/conftest.py imports jax, which the
card's machine does not have).  The comparisons and their bars live in
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


#: Kernel 2's and kernel 4's cases: (width, height, spp, fast_render); 61×37×3
#: is a ragged lane count (6,771, not a multiple of a block).
CAMERA_CASES = ((64, 48, 2, False), (64, 48, 2, True), (61, 37, 3, False))


@pytest.mark.parametrize("case", CAMERA_CASES)
def test_camera_path_kernel_matches_plain(cuda, case):
    """Kernel 2 against its plain version on 100 % of values, with the band
    split and a second launch bit for bit: all families through a thin-lens
    camera, fast render off and on, a ragged lane count."""
    from fspt_tpu_torch.ops import kernel_check
    from fspt_tpu_torch.scene import samples

    w, h, spp, fast = case
    cfg = RenderConfig(width=w, height=h, spp=spp, max_depth=8, fast_render=fast)
    b = samples.build("all_families", device=cuda, aperture=1.5, focal_depth=120.0)
    kernel_check.check_camera_tracer(b.compile(device=cuda), b.cameras[0], cfg, seed=5,
                                     sample0=2)


def test_camera_path_kernel_lanes_dying_at_depth_0(cuda):
    """Kernel 2 as above on the flagship seen from inside the box looking
    out, where most lanes die at depth 0."""
    from fspt_tpu_torch.camera import Camera
    from fspt_tpu_torch.ops import cuda_path, kernel_check, rng
    from fspt_tpu_torch.scene import samples

    cfg = RenderConfig(width=64, height=48, spp=2, max_depth=8)
    flag = samples.build("flagship", device=cuda).compile(device=cuda)
    out = Camera.create(origin=(0.0, 20.0, 45.0), target=(0.0, -40.0, -200.0), fov_y=60.0,
                        aperture_size=0.0, device=cuda)
    kernel_check.check_camera_tracer(flag, out, cfg, seed=3, sample0=1)
    body = cuda_path.PathBody(flag, out, cfg)
    h0 = rng.seed_hash(3)
    segcnt = body.core()(h0, *body.raygen(h0, 1, 0, cfg.width * cfg.height * cfg.spp,
                                          cuda))[-1]
    assert float((segcnt == 1).float().mean()) > 0.5


@pytest.mark.parametrize("scene_name", ["all_primitives", "414_rows", "512_rows"])
def test_path_kernels_staged_rows(cuda, scene_name):
    """Kernels 1, 2, 3 and 7 walk the rows a block stages in shared memory
    one kind at a time: every primitive kind (all_primitives, with
    triangles), 414 rows, whose 56 KB of staged rows need the kernels to ask
    for more than 48 KB of shared memory, and the 512-row limit
    (MAX_SPECIALIZED_PRIMS: the flagship and 498 spheres, 69.6 KB)."""
    from fspt_tpu_torch.ops import cuda_trace, kernel_check
    from fspt_tpu_torch.scene import samples

    cfg = RenderConfig(width=48, height=32, spp=2, max_depth=6)
    if scene_name == "all_primitives":
        b = samples.build("all_primitives", device=cuda)
    else:
        rows = int(scene_name.split("_")[0])
        b = samples.build("flagship_rows", device=cuda, rows=rows)
    scene = b.compile(device=cuda)
    if scene_name != "all_primitives":
        assert cuda_trace.HostScene(scene.geometry).prim_count == rows
    kernel_check.check_camera_tracer(scene, b.cameras[0], cfg, seed=5)
    kernel_check.check_path_tracer(scene, b.cameras[0], cfg, seed=4)
    kernel_check.check_intersect(scene.geometry,
                                 *kernel_check.random_segments(100_003, seed=6, device=cuda))
    kernel_check.check_affine_planes(scene, b.cameras[0], cfg, seed=7)


@pytest.mark.parametrize("case", CAMERA_CASES)
def test_deferred_camera_kernel_matches_plain(cuda, case):
    """Kernel 4 (the texel fold in the kernel) against the fold of its plain
    slot planes on 100 % of values, with the band split and a second launch
    bit for bit: all families with textured walls and a textured sky,
    through a thin-lens camera, fast render off and on, a ragged lane
    count."""
    from fspt_tpu_torch.ops import kernel_check
    from fspt_tpu_torch.scene import samples

    w, h, spp, fast = case
    cfg = RenderConfig(width=w, height=h, spp=spp, max_depth=8, fast_render=fast)
    b = samples.build("all_families_textured", device=cuda, aperture=1.5,
                      focal_depth=120.0)
    scene = b.compile(device=cuda)
    assert int(scene.materials.tex_id[int(scene.sky_mat)]) >= 0  # the sky is textured
    kernel_check.check_deferred_tracer(scene, b.cameras[0], cfg, seed=6, sample0=2)


#: Kernel 4's outputs (``kernel_check.output_digest``) in each of
#: CAMERA_CASES, as the build before the counting build was added gave them
#: on an NVIDIA H100 80GB HBM3: the default build must still give them.
DEFERRED_DIGESTS = {
    (64, 48, 2, False): "6f2a9760ff318de0ca1ab4acf310d88a207b347d318058b25217137364d82bc8",
    (64, 48, 2, True): "e0411f9802ced78c19224e6a720c532e8f7231a6205b2b3ff7118e3e89de93b4",
    (61, 37, 3, False): "e94bb58737dd2afd8cb28090dd63a7c3e99917506fceab9409354f0a6a002ad8",
}


@pytest.mark.parametrize("case", CAMERA_CASES)
def test_deferred_counting_build_matches_plain(cuda, case):
    """Kernel 4's counting build counts the texel fetches of the surface
    rows and of the sky that its plain version counts from its slot planes,
    its outputs equal the default build's bit for bit (band split and
    second launch too), and the default build's outputs are those it gave
    before the counting build was added."""
    from fspt_tpu_torch.ops import kernel_check
    from fspt_tpu_torch.scene import samples

    w, h, spp, fast = case
    cfg = RenderConfig(width=w, height=h, spp=spp, max_depth=8, fast_render=fast)
    b = samples.build("all_families_textured", device=cuda, aperture=1.5,
                      focal_depth=120.0)
    rep = kernel_check.check_deferred_counting(b.compile(device=cuda), b.cameras[0], cfg,
                                               seed=6, sample0=2)
    surface, sky = rep["fetches"]
    assert surface > 0 and sky > 0, rep
    assert rep["digest"] == DEFERRED_DIGESTS[case], rep


def test_deferred_camera_kernel_refuses_texel_grad(cuda):
    """Kernel 4 gives the texels no gradient, so on the card it refuses
    texels that require grad and names kernel 7's route."""
    from fspt_tpu_torch.ops import cuda_path
    from fspt_tpu_torch.scene import samples

    b = samples.build("all_families_textured", device=cuda)
    scene = b.compile(device=cuda)
    tex = scene.textures._replace(texels=scene.textures.texels.clone().requires_grad_(True))
    tracer = cuda_path.make_camera_path_tracer(scene._replace(textures=tex), b.cameras[0],
                                               RenderConfig(width=16, height=8, spp=1))
    launches = cuda_path.DEFERRED_PATH.launches
    with pytest.raises(ValueError, match="make_affine_grad_image_fn"):
        tracer(0, 0)
    assert cuda_path.DEFERRED_PATH.launches == launches


@pytest.mark.parametrize("fast", [False, True])
def test_affine_planes_kernel_matches_plain(cuda, fast):
    from fspt_tpu_torch.ops import kernel_check
    from fspt_tpu_torch.scene import samples

    b = samples.build("all_families_textured", device=cuda, aperture=1.5,
                      focal_depth=120.0)
    cfg = RenderConfig(width=64, height=48, spp=2, max_depth=8, fast_render=fast)
    kernel_check.check_affine_planes(b.compile(device=cuda), b.cameras[0], cfg, seed=7)


@pytest.mark.parametrize("case", ["flagship", "64_rows_16_slots", "fast_render", "band",
                                  "ragged"])
def test_fused_loss_kernel_matches_plain(cuda, case):
    """Kernel 8 affine against its plain version, two launches bit for bit:
    the flagship; 64 material rows at 16 slots (the widest columns and the
    longest record); fast render (the white slot, mat_e < 0); a band of
    rows below the top; and 560,282 lanes, not a multiple of a block's 64
    (the last block half full)."""
    import numpy as np

    from fspt_tpu_torch.ops import kernel_check
    from fspt_tpu_torch.scene import samples

    name, y0, rows = "flagship", 0, None
    cfg = RenderConfig(width=64, height=48, spp=2, max_depth=8)
    if case == "64_rows_16_slots":
        name, cfg = "many_materials", RenderConfig(width=64, height=48, spp=2, max_depth=16)
    elif case == "fast_render":
        cfg = RenderConfig(width=64, height=48, spp=2, max_depth=8, fast_render=True)
    elif case == "band":
        y0, rows = 13, 17
    elif case == "ragged":
        cfg = RenderConfig(width=613, height=457, spp=2, max_depth=4)
    b = samples.build(name, device=cuda)
    n_rows = cfg.height - y0 if rows is None else rows
    target = torch.from_numpy(np.random.default_rng(0).random(
        (n_rows, cfg.width, 3), dtype=np.float32)).to(cuda)
    kernel_check.check_fused_loss(b.compile(device=cuda), b.cameras[0], cfg, target,
                                  seed=8, frame_idx=3, y0=y0, rows=rows)


@pytest.mark.parametrize("n_mats,n_slot,n,block,grid", [
    (7, 8, 8_294_400, 128, 129_600),  # the flagship at 1080p×4: 64 lanes a block
    (32, 8, 98_304, 128, 1_536),      # 99 KB of columns
    (64, 8, 1000, 128, 16),           # 198 KB of columns: 128 threads still fit
    (64, 16, 1001, 128, 16),          # a record of 16 slots; the last block part full
])
def test_fused_loss_plan(cuda, n_mats, n_slot, n, block, grid):
    """Kernel 8 affine's launch (csrc/fspt_grad.cu fspt_fused_loss_plan):
    the block by the reverse kernels' rule (column_block) over its
    gradient columns, two threads a lane, the grid one block per block/2
    lanes; past 64 rows or 16 slots it raises."""
    from fspt_tpu_torch.ops import cuda_grad

    assert cuda_grad.loss_plan(n_mats, n_slot, n) == (block, grid)
    with pytest.raises(ValueError, match="at most 64 material rows and 16 slots"):
        cuda_grad.loss_plan(n_mats, 17, n)
    with pytest.raises(ValueError, match="at most 64 material rows and 16 slots"):
        cuda_grad.loss_plan(65, n_slot, n)


def test_pool1_step_waits_on_nothing(cuda, monkeypatch):
    """The pool-1 recovery step (kernel 8 affine, then Adam and the clip)
    makes no synchronizing call: after a warm-up step, two steps under
    ``torch.cuda.set_sync_debug_mode("error")`` raise nothing, so the host
    queues the gradient mapping and the update while kernel 8 runs.  Their
    loss, gradients, parameters and Adam moments are bit-equal to the same
    steps with the bias column copied from ``mats.bias_column()`` on every
    call, before the launch and after it (the copy that waited for the
    card), which the mode refuses."""
    import numpy as np

    from fspt_tpu_torch.ops import cuda_grad, cuda_path
    from fspt_tpu_torch.parallel import make_fused_recovery_step
    from fspt_tpu_torch.scene import samples

    cfg = RenderConfig(width=96, height=64, spp=2, max_depth=8)
    b = samples.build("flagship", device=cuda)
    scene, cam = b.compile(device=cuda), b.cameras[0]
    target = torch.from_numpy(np.random.default_rng(0).random(
        (cfg.height, cfg.width, 3), dtype=np.float32)).to(cuda)
    mats = cuda_path.HostMaterials(scene.materials)

    def copied_column(device):
        return torch.from_numpy(mats.bias_column()).to(device)[:, None]

    def copying_bias_table(_bias, diffuse, emissive, glow):
        bc = copied_column(diffuse.device)
        return torch.where(bc == 1, glow, torch.where(bc == 2, diffuse, emissive))

    def copying_table_grads(_bias, g_coef, g_bias, fields):
        bc = copied_column(g_coef.device)
        per_field = {"diffuse": g_coef + torch.where(bc == 2, g_bias, 0.0),
                     "emissive": torch.where(bc == 0, g_bias, 0.0),
                     "glow": torch.where(bc == 1, g_bias, 0.0)}
        return {f: per_field[f] for f in fields}

    def steps(sync_mode):
        step = make_fused_recovery_step(None, scene, cam, cfg, pool=1,
                                        optimizer=lambda ps: torch.optim.Adam(ps, lr=0.02))
        params = {"diffuse": scene.materials.diffuse * 0.8,
                  "emissive": scene.materials.emissive * 0.7}
        state = step.init(params)
        params, state, _ = step(params, state, scene, cam, target, 5, 0)
        torch.cuda.synchronize()
        out = []
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(sync_mode)
        try:
            for i in (1, 2):
                params, state, loss = step(params, state, scene, cam, target, 5, i)
                moments = state.optimizer.state
                out.append((loss, {k: v.clone() for k, v in params.items()},
                            {k: (leaf.grad.clone(), moments[leaf]["exp_avg"].clone(),
                                 moments[leaf]["exp_avg_sq"].clone())
                             for k, leaf in state.leaves.items()}))
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        return out

    got = steps("error")
    with monkeypatch.context() as m:
        m.setattr(cuda_grad, "bias_table", copying_bias_table)
        m.setattr(cuda_grad, "table_grads", copying_table_grads)
        want = steps("default")
        with pytest.raises(RuntimeError, match="synchroniz"):
            steps("error")
    for (loss, params, per_leaf), (w_loss, w_params, w_leaf) in zip(got, want):
        assert torch.equal(loss, w_loss)
        for k in w_params:
            assert torch.equal(params[k], w_params[k]), k
        for k in w_leaf:
            for a, w in zip(per_leaf[k], w_leaf[k]):
                assert torch.equal(a, w), k


ADJOINT_FIELDS = ("diffuse", "emissive", "glow", "param", "ior", "reflectivity", "frost")


#: Kernel 9's ragged bands: (lane0, n) with n off and across the 32-lane
#: chunks a warp takes.
RAGGED_BANDS = ((5, 1), (7, 31), (40, 33), (100, 1000))


@pytest.mark.parametrize("fields,depth", [
    (ADJOINT_FIELDS, 4), (ADJOINT_FIELDS[:4], 1), (ADJOINT_FIELDS[:4], 8),
    (ADJOINT_FIELDS[:4], 16), (ADJOINT_FIELDS[:4], 17), (ADJOINT_FIELDS[:4], 18),
])
def test_grad_path_kernels_match_plain(cuda, fields, depth):
    """Kernel 9 against its plain version and kernel 10 (reverse mode)
    against autograd of it, on all nine families through a thin-lens
    camera: every material field (P = 169, shared-memory columns above 48
    KB), and 16 bounces (the most the per-thread record holds) against 17
    and 18 (the device scratch).  Kernel 10's sweep of kernel 9's record
    (the autograd glue's route) and its remat route give the same gradient
    and non-finite count bit for bit.  Then kernel 9 alone (persistent,
    regenerating lanes): radiance and segments bit-equal to the plain
    version, between two launches and with and without its record, on
    ragged bands with lane0 ≠ 0 and on the flagship seen from inside the
    box looking out, where most lanes die at depth 0.  A call that wants no
    gradient records nothing; the flagship's recovery front door takes the
    sweep route."""
    from fspt_tpu_torch.camera import Camera
    from fspt_tpu_torch.ops import cuda_grad, kernel_check
    from fspt_tpu_torch.scene import samples

    b = samples.build("all_families", device=cuda, aperture=1.5, focal_depth=120.0)
    cfg = RenderConfig(width=64, height=48, spp=2, max_depth=depth)
    scene = b.compile(device=cuda)
    kernel_check.check_grad_path_tracer(scene, b.cameras[0], cfg, fields, seed=3, sample0=1)

    tracer = cuda_grad.make_grad_path_tracer(scene, b.cameras[0], cfg, fields=fields)
    pvec = cuda_grad.pack_params({f: getattr(scene.materials, f) for f in fields},
                                 tracer.fields)
    for lane0, n in RAGGED_BANDS:
        rep = kernel_check.check_grad_forward(tracer, pvec, 3, 1, lane0, n)
        assert rep["radiance_bits_equal"] == 1.0, rep

    fb = samples.build("flagship", device=cuda)
    flag = fb.compile(device=cuda)
    out = Camera.create(origin=(0.0, 20.0, 45.0), target=(0.0, -40.0, -200.0), fov_y=60.0,
                        aperture_size=0.0, device=cuda)
    tracer = cuda_grad.make_grad_path_tracer(flag, out, cfg, fields=("diffuse",))
    pvec = cuda_grad.pack_params({"diffuse": flag.materials.diffuse}, tracer.fields)
    n = cfg.height * cfg.width * cfg.spp
    rep = kernel_check.check_grad_forward(tracer, pvec, 3, 1, 0, n)
    assert rep["radiance_bits_equal"] == 1.0, rep
    _, seg = tracer.plain(pvec, 3, 1, 0, n)
    assert float((seg == 1).float().mean()) > 0.5  # most lanes die at depth 0

    # No gradient wanted (grad mode off, or a pvec that needs none): kernel
    # 9 writes no record and kernel 10 never sweeps one.
    sweeps = cuda_grad.GRAD_SWEEP.launches
    with torch.no_grad():
        tracer(pvec.detach().requires_grad_(), 3, 1, 0, n)
    assert tracer.record_bytes == 0
    tracer(pvec.detach(), 3, 1, 0, n)
    assert tracer.record_bytes == 0 and cuda_grad.GRAD_SWEEP.launches == sweeps

    # The recovery's front door on the flagship (the pool-8 route's fields):
    # kernel 9 records, kernel 10 sweeps, and no lane is traced again.
    img_fn = cuda_grad.make_grad_image_fn(flag, fb.cameras[0], cfg,
                                          fields=("diffuse", "emissive", "param"))
    params = {f: getattr(flag.materials, f).detach().clone().requires_grad_()
              for f in img_fn.tracer.fields}
    remats = cuda_grad.GRAD_BACKWARD.launches
    img, _ = img_fn(params, 5, 0, 0, cfg.height)
    assert img_fn.tracer.record_bytes == cuda_grad.record_bytes(n, cfg.effective_depth)
    grads = torch.autograd.grad(img.sum(), list(params.values()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert cuda_grad.GRAD_SWEEP.launches == sweeps + 1
    assert cuda_grad.GRAD_BACKWARD.launches == remats


@pytest.mark.parametrize("scene_name,fields,depth", [
    ("all_families", ADJOINT_FIELDS, 4), ("flagship", ("camera",), 4),
    ("flagship", ("diffuse", "emissive", "param", "camera"), 4),
    ("all_families", ("diffuse", "param", "frost", "camera"), 16),
    ("all_families", ("diffuse", "param", "frost", "camera"), 17),
    ("all_families", ("diffuse", "param", "frost", "camera"), 18),
])
def test_fused_loss_chain_kernel_matches_plain(cuda, scene_name, fields, depth):
    """Kernel 8's whole chain (reverse mode; remat is the same kernel,
    launched again, so equal bit for bit) against its plain version,
    material fields and the camera, with the per-thread record (4 and 16
    bounces) and the device scratch (17 and 18)."""
    import numpy as np

    from fspt_tpu_torch.ops import kernel_check
    from fspt_tpu_torch.scene import samples

    b = samples.build(scene_name, device=cuda, aperture=1.5, focal_depth=120.0)
    cfg = RenderConfig(width=64, height=48, spp=2, max_depth=depth)
    target = torch.from_numpy(np.random.default_rng(1).random(
        (cfg.height, cfg.width, 3), dtype=np.float32)).to(cuda)
    kernel_check.check_fused_loss_chain(b.compile(device=cuda), b.cameras[0], cfg, target,
                                        fields, seed=4, frame_idx=2)


@pytest.mark.parametrize("n_mats,rows,depth,block,scratch_words", [
    (13, 169, 4, 128, 0),    # all_families, seven fields: 87 KB of columns
    (64, 430, 16, 128, 0),   # the most bounces the per-thread record holds
    (64, 841, 17, 64, 170),  # every field of 64 rows and the camera: past 227 KB at 128
    (64, 1000, 40, 32, 400),
])
def test_reverse_adjoint_plan(cuda, n_mats, rows, depth, block, scratch_words):
    """The reverse kernels' launch (csrc/fspt_adjoint.cu fspt_adjoint_plan):
    128 threads a block, or fewer where the gradient columns and the table
    would pass a block's shared memory; the per-thread record up to 16
    bounces, 10 words a bounce of device scratch past it; a table past
    shared memory raises."""
    from fspt_tpu_torch.ops import cuda_grad

    assert cuda_grad.adjoint_plan(n_mats, rows, depth) == (block, scratch_words)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_grad.adjoint_plan(n_mats, 60000, depth)
    with pytest.raises(ValueError, match="material rows"):
        cuda_grad.adjoint_plan(65, rows, depth)


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


#: Kernel 5's edge cases (:func:`cull_case`).
CULL_CASES = ("all_dead", "one_live", "leaves_1", "leaves_33", "leaves_778", "on_face",
              "inside")


def cull_case(case, device=None):
    """Kernel 5's inputs for an edge case (numpy, seeded): ray features
    ``F`` of 4 blocks of 64 rays and ``TreeletTables`` whose leaf boxes
    (the only part the cull reads) are random, 300 of them unless the case
    names a count.  Rays start in the boxes' region with random directions
    (200 long) and ``t0`` in (0, 1.5], some dead; ``all_dead`` kills block
    1, ``one_live`` leaves one live ray in block 2; ``on_face`` starts each
    ray of block 0 on a face of a box (a box with a -0.0 face and a flat
    box of faces -0.0 and +0.0, met by origins at +0.0, so a slab's near
    and far t are zeros of either sign; axis-aligned directions, ±0
    components included); ``inside`` starts the rays of block 0 inside
    boxes.  Shared with
    tests/test_torch_bvh.py, which holds the plain version against the
    NumPy formula."""
    import numpy as np

    from fspt_tpu_torch.ops import cuda_bvh

    rs = np.random.RandomState(CULL_CASES.index(case) + 31)
    L = int(case.split("_")[1]) if case.startswith("leaves_") else 300
    R = cuda_bvh.BLOCK_RAYS
    centre = rs.uniform(-40, 40, (L, 3)).astype(np.float32)
    half = rs.uniform(1, 10 if L > 1 else 30, (L, 3)).astype(np.float32)
    lo, hi = centre - half, centre + half
    start = rs.uniform(-50, 50, (4 * R, 3)).astype(np.float32)
    d = rs.normal(size=(4 * R, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    seg = (d * 200.0).astype(np.float32)
    t0 = rs.uniform(0.01, 1.5, 4 * R).astype(np.float32)
    t0[rs.rand(4 * R) < 0.2] = 0.0
    if case == "all_dead":
        t0[R:2 * R] = 0.0
    elif case == "one_live":
        t0[2 * R:3 * R] = 0.0
        t0[2 * R + 17] = 0.7
    elif case == "on_face":
        lo[0, 0], hi[0, 0] = -0.0, 4.0  # a -0.0 face
        lo[1, 0], hi[1, 0] = -0.0, 0.0  # a flat box, its faces -0.0 and +0.0
        for j in range(R):
            q = j % L
            axis, side = j % 3, (j // 3) % 2
            start[j] = rs.uniform(lo[q], hi[q])
            start[j, axis] = (lo if side == 0 else hi)[q, axis]
            if j < 16:  # on box 0's -0.0 face or in box 1's plane, at +0.0
                start[j] = (0.0, centre[j // 8, 1], centre[j // 8, 2])
            if j % 4 == 0:  # along the axis, the other components ±0
                seg[j] = 0.0
                seg[j, axis] = 200.0 if j % 8 == 0 else -200.0
                if j % 16 == 0:
                    seg[j, (axis + 1) % 3] = -0.0
        t0[:R] = 1.0
    elif case == "inside":
        for j in range(R):
            q = rs.randint(L)
            start[j] = rs.uniform(lo[q], hi[q])
        t0[:R] = 1.0
    dev = torch.device("cpu") if device is None else device
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    empty = torch.zeros((0, 3), dtype=torch.float32, device=dev)
    tables = cuda_bvh.TreeletTables(
        lbmin=t(lo), lbmax=t(hi),
        weights=torch.zeros((L, cuda_bvh.TREELET, cuda_bvh.W_ROWS), device=dev),
        leaf_first=torch.zeros((L,), dtype=torch.int32, device=dev), tri_v0=empty,
        tri_e1=empty, tri_e2=empty, tri_id=torch.zeros((0,), dtype=torch.int32, device=dev))
    return cuda_bvh.ray_features(t(start), t(seg), t(t0)), tables


@pytest.mark.parametrize("case", CULL_CASES)
def test_treelet_cull_edge_blocks(cuda, case):
    """Kernel 5 against its plain version, every key bit-equal and two
    launches bit-equal: a block of dead rays (a row of BIG), a block with
    one live ray, 1, 33 and 778 leaves (its CTA sized to them), rays
    starting on box faces (a -0.0 face at +0.0 among them) and inside
    boxes."""
    from fspt_tpu_torch.ops import cuda_bvh, kernel_check

    F, tables = cull_case(case, device=cuda)
    _, key, _ = kernel_check.check_cull(F, tables)
    threads, per_thread = cuda_bvh.cull_shape(tables.n_leaves)
    assert threads % 32 == 0 and threads <= 256
    assert threads * per_thread >= min(tables.n_leaves, 256 * per_thread)
    if case == "all_dead":
        assert bool((key[1] == cuda_bvh.BIG).all())
    if case in ("on_face", "inside"):
        assert bool((key[0] == 0.0).any())


def tris(n, seed=0):
    """``n`` random triangles in a box of side 80, edges up to 8 (numpy,
    float32); shared with tests/test_torch_bvh.py."""
    import numpy as np

    rs = np.random.RandomState(seed)
    v0 = rs.uniform(-40, 40, (n, 3)).astype(np.float32)
    v1 = v0 + rs.uniform(-8, 8, (n, 3)).astype(np.float32)
    v2 = v0 + rs.uniform(-8, 8, (n, 3)).astype(np.float32)
    return v0, v1, v2


def sweep_case(n_tris=3000, seed=22, device=None, dead_blocks=()):
    """Kernel 6's inputs on ``n_tris`` random triangles cut into
    128-triangle leaves and 8 blocks of 64 rays: block 0 incoherent (origins
    all over the mesh box, directions anywhere, so every leaf survives its
    cull), blocks 1-7 coherent (one origin 70 from the centre, a narrow cone
    towards it each), the rays of block 7 alternately dead and those of
    ``dead_blocks`` all dead.  Returns the traverser on ``device``, the rays
    (numpy) and ``(counts, order, tlo, F)`` from its cull.  Shared with
    tests/test_torch_bvh.py, which the card's machine cannot import."""
    import numpy as np

    from fspt_tpu_torch.ops import cuda_bvh

    v0, v1, v2 = tris(n_tris, seed=seed)
    trav = cuda_bvh.make_culled_traverser(cuda_bvh.build_treelet_chunks(v0, v1, v2),
                                          device=device)
    rs = np.random.RandomState(seed + 1)
    R = cuda_bvh.BLOCK_RAYS
    start = np.empty((8 * R, 3), np.float32)
    d = rs.normal(size=(8 * R, 3))
    start[:R] = rs.uniform(-40, 40, (R, 3))
    for b in range(1, 8):
        axis = rs.normal(size=3)
        axis /= np.linalg.norm(axis)
        start[b * R:(b + 1) * R] = 70.0 * axis
        d[b * R:(b + 1) * R] = 0.05 * d[b * R:(b + 1) * R] - axis
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    seg = (d * 200.0).astype(np.float32)
    t_init = np.ones(8 * R, np.float32)
    for b in dead_blocks:
        t_init[b * R:(b + 1) * R] = 0.0
    t_init[7 * R::2] = 0.0
    rays = (start, seg, t_init)
    return trav, rays, trav.prepare(*(torch.from_numpy(a).to(trav.tables.weights.device)
                                      for a in rays))


@pytest.mark.parametrize("case", ["incoherent", "empty", "ragged"])
def test_treelet_sweep_edge_blocks(cuda, case):
    """Kernel 6 against its plain version, every output bit-equal, and two
    launches bit-equal (the heaviest-first block order does not reach the
    results): a block whose survivor list is every leaf; an all-dead block
    and live blocks given no leaves; survivor counts cut to values that are
    not multiples of GROUP."""
    from fspt_tpu_torch.ops import cuda_bvh

    trav, _, (counts, order, tlo, F) = sweep_case(20000, device=cuda, dead_blocks=(6,))
    L = trav.tables.n_leaves
    assert int(counts[0]) == L and int(counts[6]) == 0
    if case == "empty":
        counts = counts.clone()
        counts[1:3] = 0
    elif case == "ragged":
        cut = torch.tensor([L - 3, 13, 9, 3, 17, 1, 0, 11], dtype=torch.int32, device=cuda)
        counts = torch.minimum(counts, cut)
        assert int((counts % cuda_bvh.GROUP != 0).sum()) >= 5
    first = cuda_bvh.launch_sweep(counts, order, tlo, F, trav.tables)
    again = cuda_bvh.launch_sweep(counts, order, tlo, F, trav.tables)
    plain = cuda_bvh.plain_sweep(counts, order, tlo, F, trav.tables)
    torch.cuda.synchronize()
    for name, k, a, p in zip(("t", "best", "visits"), first, again, plain):
        assert torch.equal(k, p), name
        assert torch.equal(k, a), name
    visits = first[2]
    if case == "incoherent":
        assert int(visits[0]) == L  # the whole list swept
    assert int(visits[6]) == 0 and (first[1].view(8, -1)[6] == -1).all()
    if case == "empty":
        assert (visits[1:3] == 0).all()
        assert torch.equal(first[0].view(8, -1)[1:3], F[:, 10].view(8, -1)[1:3])


def test_mesh_frame_matches_plain(cuda, heightfield):
    from fspt_tpu_torch.ops import kernel_check

    scene, cam = heightfield
    cfg = RenderConfig(width=64, height=48, spp=2, max_depth=4)
    kernel_check.check_mesh_frame(scene, cam, cfg, seed=5, queue=1024)


#: Kernel 13's cases: (grid, width, height, spp, aperture); 61×37×3 is a
#: ragged lane count, grid 224 at 1024²×4 the heightfield-render cell.
#: (grid, width, height, spp, aperture, depth); at depth 8 most warps reach
#: the walk with few live lanes, which its votes take over the lanes that
#: entered.
MESH_CAMERA_CASES = ((60, 64, 48, 2, 1.5, 4), (60, 61, 37, 3, 0.0, 4),
                     (224, 1024, 1024, 4, 1.5, 4), (60, 256, 192, 4, 1.5, 8))


@pytest.mark.parametrize("case", MESH_CAMERA_CASES)
def test_mesh_camera_path_kernel_matches_plain(cuda, case):
    """Kernel 13 (kernel 2's body walking the BVH in warp-wide phases)
    against its plain version on 100 % of values, walk counts equal, with
    the band split, a second launch and the build that counts nothing bit
    for bit; through the scene's thin-lens camera or a pinhole."""
    from fspt_tpu_torch.ops import kernel_check
    from fspt_tpu_torch.scene import samples

    grid, w, h, spp, aperture, depth = case
    b = samples.build("heightfield", device=cuda, grid=grid)
    cam = b.cameras[0]._replace(aperture_size=torch.tensor(aperture, device=cuda))
    cfg = RenderConfig(width=w, height=h, spp=spp, max_depth=depth)
    kernel_check.check_mesh_camera_tracer(b.compile(device=cuda), cam, cfg, seed=3_000_000_123,
                                          sample0=8)


def test_mesh_camera_path_kernel_against_the_queue(cuda):
    """Kernel 13 against the queued mesh path (kernels 1, 5 and 6 under
    render/queue.py) on the heightfield-render cell's frame: the two pick
    another triangle only at near ties (kernel 6 orders hits by t rounded
    to 128 ulps, then by column; kernel 13 by exact t, then by tree order),
    so the bars are fractions: radiance within rtol 1e-4 / atol 1e-5 on
    ≥ 99.99 % of values, material AOVs equal on ≥ 99.999 % of lanes,
    segments within 1e-6 (a 1024²×4 frame at seed 1,234,567 on an H100:
    8,311,632 against 8,311,630, 99.9962 % and 99.9997 %)."""
    from fspt_tpu_torch.ops import cuda_path, kernel_check
    from fspt_tpu_torch.ops.cuda_bvh import make_mesh_intersector
    from fspt_tpu_torch.render.queue import render_queued
    from fspt_tpu_torch.scene import samples

    b = samples.build("heightfield", device=cuda)
    scene, cam = b.compile(device=cuda), b.cameras[0]
    cfg = RenderConfig(width=1024, height=1024, spp=4, max_depth=4)
    k = cuda_path.make_camera_path_tracer(scene, cam, cfg)(1_234_567, 8)
    q = render_queued(scene, cam, cfg, 1_234_567, 8, intersector=make_mesh_intersector(scene))
    assert kernel_check._frac_close(k.radiance, q.radiance, 1e-4, 1e-5) >= 0.9999
    assert kernel_check._frac_equal(k.aov_mat, q.aov_mat) >= 0.99999
    assert abs(int(k.segments) - int(q.segments)) <= 1e-6 * int(q.segments)


@pytest.mark.parametrize("case", ["sorted", "unsorted", "ragged", "dead", "kernel1_seed",
                                  "python_tree"])
def test_walk_kernels_match_plain(cuda, heightfield, case):
    """Kernels 11 (the scene's fine BVH) and 12 (a tree of 128-triangle
    leaves over the same triangles), every output bit-equal to the plain
    version (``kernel_check.check_bvh_walk`` / ``check_treelet_walk``), on
    the rays the mesh intersector's sweep sees (sorted, seeded, dead lanes
    included) of a queue iteration's bounces and on primaries; then the same
    rays in a seeded random order (incoherent warps); a ray count that is
    not a multiple of 32, 64 or 128; every third lane dead; the seed t of
    kernel 1 alone (no clip to the mesh box); trees from the Python builder
    (the others come from the native one)."""
    import numpy as np

    from fspt_tpu_torch.camera import generate_rays
    from fspt_tpu_torch.ops import bvh, cuda_bvh, kernel_check
    from fspt_tpu_torch.ops.cuda_trace import make_cuda_intersector
    from fspt_tpu_torch.ops.diff_intersect import tris_from_scene
    from fspt_tpu_torch.render.queue import render_queued

    scene, cam = heightfield
    inter = cuda_bvh.make_mesh_intersector(scene)
    calls = []

    def recording(o, d, alive):
        calls.append((o, d, alive))
        return inter(o, d, alive)

    recording.accepts_alive = True
    cfg = RenderConfig(width=64, height=48, spp=2, max_depth=4)
    render_queued(scene, cam, cfg, 3, 0, intersector=recording, queue=2048)
    tr = tris_from_scene(scene)
    v = [tr[k].cpu().numpy() for k in ("v0", "v1", "v2")]
    if case == "python_tree":
        trees = [bvh.flat_bvh(*bvh._build_bvh_numpy(*v, leaf), *v, cuda)
                 for leaf in (bvh.MAX_LEAF_TRIS, cuda_bvh.TREELET)]
    else:
        trees = [scene.bvh, bvh.build_bvh(*v, max_leaf=cuda_bvh.TREELET, device=cuda)]
    k11 = cuda_bvh.make_bvh_traverser(trees[0], bvh.MAX_LEAF_TRIS)
    k12 = cuda_bvh.make_treelet_traverser(trees[1])
    start, seg, _, _ = generate_rays(cam, 64, 48, 2, 3, 0)
    for o, d, alive in ((start, seg, None), calls[1]):
        s, g, t_init, perm = inter.sweep_inputs(o, d, alive)
        if case == "unsorted":
            perm = torch.from_numpy(np.random.RandomState(5).permutation(s.shape[0])).to(cuda)
            s, g, t_init = s[perm], g[perm], t_init[perm]
        elif case == "ragged":
            n = s.shape[0] - 61
            assert n % 32 and n % 64 and n % 128
            s, g, t_init = s[:n], g[:n], t_init[:n]
        elif case == "dead":
            t_init = torch.where(torch.arange(s.shape[0], device=cuda) % 3 == 0, 0.0, t_init)
        elif case == "kernel1_seed":
            t_init = make_cuda_intersector(scene.geometry)(s, g).t
            if alive is not None:
                t_init = torch.where(alive[perm], t_init, 0.0)
        rep11 = kernel_check.check_bvh_walk(k11, s, g, t_init)
        rep12 = kernel_check.check_treelet_walk(k12, s, g, t_init)
        assert rep11["hit_fraction"] > 0.0 and rep12["hit_fraction"] > 0.0


def test_vertex_gather_rules(cuda, monkeypatch):
    """The replay's stand-in rows (lanes without a triangle) spread over the
    triangles, as ``diff_intersect._gather_rows`` does, against all on row
    0 (the reference's ``max(tid, 0)``): the same gradient on a full-width
    vertex step (heightfield, 99,458 triangles, 512²×2 spp, depth 2,
    edge_eps 0.05), and each rule's ms a step printed (host clock, mean of
    two steps after a warm-up; ``-s`` shows it).  On row 0 the gathers'
    backward adds about a million lanes to one row in turn."""
    import time

    from fspt_tpu_torch.ops import diff_intersect
    from fspt_tpu_torch.parallel import train
    from fspt_tpu_torch.scene import samples

    b = samples.build("heightfield", device=cuda)
    scene, cam = b.compile(device=cuda), b.cameras[0]
    cfg = RenderConfig(width=512, height=512, spp=2, max_depth=2, edge_eps=0.05)
    tris = diff_intersect.tris_from_scene(scene)
    shift = torch.tensor([0.0, 0.5, 0.0], device=cuda)
    params = {k: tris[k] + shift for k in train.VERTICES}
    target = torch.zeros((cfg.height, cfg.width, 3), device=cuda)

    class KeepGradients:  # an optimizer that keeps the gradient and moves nothing
        def __init__(self, ps):
            self.ps, self.grads = ps, None

        def step(self):
            self.grads = [p.grad.clone() for p in self.ps]

    step = train.make_bvh_vertex_recovery_step(None, cfg, scene, optimizer=KeepGradients)
    rules = {"spread": diff_intersect._gather_rows,
             "row 0": lambda tid_raw, n_rows: torch.clamp(tid_raw, min=0).long()}
    grads, ms = {}, {}
    for name, rule in rules.items():
        monkeypatch.setattr(diff_intersect, "_gather_rows", rule)
        state = step.init(params)
        step(params, state, scene, cam, target, 11, 1)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            step(params, state, scene, cam, target, 11, 1)
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) / 2 * 1e3
        grads[name] = state.optimizer.grads
    print(f"vertex step 512x512x2, depth 2: stand-in rows spread {ms['spread']:.1f} ms, "
          f"row 0 {ms['row 0']:.1f} ms a step")
    for spread, row0 in zip(grads["spread"], grads["row 0"]):
        assert bool(torch.isfinite(spread).all()) and float(spread.abs().max()) > 0.0
        torch.testing.assert_close(row0, spread, rtol=1e-5,
                                   atol=1e-6 * float(spread.abs().max()))


@pytest.mark.parametrize("scene_name", ["flagship", "heightfield"])
def test_render_session_launches_its_kernels(cuda, scene_name):
    """A CUDA RenderSession renders through kernel 1 under the torch
    integrator (flagship) or kernels 1, 5 and 6 under the queue
    (heightfield, uncached and with the first-hit cache), and keeps its
    framebuffer on the card."""
    from fspt_tpu_torch.interactive import RenderSession
    from fspt_tpu_torch.ops import cuda_bvh, cuda_trace
    from fspt_tpu_torch.scene import samples

    kw = {"grid": 40} if scene_name == "heightfield" else {}
    cfg = RenderConfig(width=64, height=48, spp=2, max_depth=4)
    counters = (cuda_trace.INTERSECT, cuda_bvh.TREELET_CULL, cuda_bvh.TREELET_SWEEP)
    for cached in (False, True):
        s = RenderSession(samples.build(scene_name, device=cuda, **kw), cfg, seed=3,
                          first_hit_cache=cached, device=cuda)
        for c in counters:
            c.launches = 0
        assert s.refine(2) > 0
        k1, k5, k6 = (c.launches for c in counters)
        if scene_name == "flagship":
            assert (k1, k5, k6) == (2 * cfg.max_depth, 0, 0)
        else:
            assert k1 == k5 == k6 > 0
        fb = s.framebuffer
        assert fb.mean.device.type == "cuda" and bool(torch.isfinite(fb.mean).all())
        assert float(fb.count.min()) == 2.0 * cfg.spp
        s.orbit(0.2, 0.1)
        assert 0.0 < s.focus_at(32, 24) < float(s.camera.z_far)
        assert s.camera.focal_depth.device.type == "cuda"
        s.refine(1)
        assert s.snapshot(denoise=True).shape == (48, 64, 3)


def test_denoise_on_the_card_matches_the_cpu(cuda):
    """The denoiser's torch code on the card against the same code on the
    CPU, on a rendered framebuffer, at the CPU test's bar."""
    from fspt_tpu_torch.interactive import RenderSession
    from fspt_tpu_torch.render.denoiser import denoise
    from fspt_tpu_torch.render.framebuffer import Framebuffer
    from fspt_tpu_torch.scene import samples

    s = RenderSession(samples.build("flagship", device=cuda),
                      RenderConfig(width=96, height=64, spp=2, max_depth=4), seed=5, device=cuda)
    s.refine(2)
    fb = s.framebuffer
    out = denoise(fb)
    assert out.device.type == "cuda"
    want = denoise(Framebuffer(*(t.cpu() for t in fb)))
    torch.testing.assert_close(out.cpu(), want, rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def nccl_mesh():
    """A one-rank NCCL world (``multihost.initialize()``: an in-process
    store) and its mesh of 1; torn down after the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL runs on the card only")
    import torch.distributed as dist

    from fspt_tpu_torch.parallel import make_mesh, multihost

    owned = not dist.is_initialized()
    multihost.initialize()
    assert dist.get_backend() == "nccl"
    yield make_mesh(1)
    if owned:
        dist.destroy_process_group()


def test_sharded_megakernel_step_on_one_nccl_rank(nccl_mesh):
    """Kernel 2 through ``make_sharded_megakernel_step`` on a one-rank NCCL
    world at 128²×2: two frames bit-equal to the tracer's own launches and
    accumulate, the segments all-reduced on the card; then ``step.local``
    over the 4 bands of a 4-rank world, stitched bit-equal to one frame."""
    from fspt_tpu_torch.ops import cuda_path
    from fspt_tpu_torch.parallel import make_sharded_megakernel_step, sharded_framebuffer
    from fspt_tpu_torch.parallel.mesh import Mesh
    from fspt_tpu_torch.render import framebuffer as fb_mod
    from fspt_tpu_torch.scene import samples

    dev = nccl_mesh.device
    cfg = RenderConfig(width=128, height=128, spp=2, max_depth=8)
    b = samples.build("flagship", device=dev)
    scene, cam = b.compile(device=dev), b.cameras[0]
    step = make_sharded_megakernel_step(nccl_mesh, scene, cam, cfg)
    tracer = cuda_path.make_camera_path_tracer(scene, cam, cfg)
    before = cuda_path.CAMERA_PATH.launches
    fb = sharded_framebuffer(nccl_mesh, cfg.height, cfg.width)
    ref = fb_mod.create(cfg.height, cfg.width, device=dev)
    for f in range(2):
        fb, segs = step(fb, 3, f)
        out = tracer(3, f * cfg.spp)
        ref = fb_mod.accumulate(ref, out.radiance, out.aov_normal, out.aov_depth, out.aov_mat,
                                cfg.height, cfg.width, cfg.spp)
        assert segs.device.type == "cuda" and int(segs) == int(out.segments)
    assert cuda_path.CAMERA_PATH.launches - before == 4
    for k in fb_mod.Framebuffer._fields:
        assert torch.equal(getattr(fb, k), getattr(ref, k)), k

    step4 = make_sharded_megakernel_step(Mesh(group=None, rank=0, size=4, device=dev), scene,
                                         cam, cfg)
    bands = [step4.local(band, fb_mod.create(cfg.height // 4, cfg.width, device=dev), 3, 0)
             for band in range(4)]
    out = tracer(3, 0)
    one = fb_mod.accumulate(fb_mod.create(cfg.height, cfg.width, device=dev), out.radiance,
                            out.aov_normal, out.aov_depth, out.aov_mat, cfg.height, cfg.width,
                            cfg.spp)
    for k in fb_mod.Framebuffer._fields:
        assert torch.equal(torch.cat([getattr(b, k) for b, _ in bands]), getattr(one, k)), k
    assert sum(int(s) for _, s in bands) == int(out.segments)


def test_fused_loss_kernel_on_two_bands_against_the_frame(nccl_mesh):
    """Kernel 8 affine on the bands ``y0 = 0`` and ``y0 = H/2`` of a 2-rank
    world: their mean loss and gradients against one launch over the whole
    frame (rtol 1e-5), and a pool-1 recovery step under the one-rank mesh
    bit-equal to the step with ``mesh=None``."""
    import numpy as np

    from fspt_tpu_torch.ops import cuda_grad
    from fspt_tpu_torch.parallel import make_fused_recovery_step
    from fspt_tpu_torch.scene import samples

    dev = nccl_mesh.device
    cfg = RenderConfig(width=96, height=64, spp=2, max_depth=8)
    b = samples.build("flagship", device=dev)
    scene, cam = b.compile(device=dev), b.cameras[0]
    target = torch.from_numpy(np.random.default_rng(0).random(
        (cfg.height, cfg.width, 3), dtype=np.float32)).to(dev)
    params = {"diffuse": scene.materials.diffuse * 0.8, "emissive": scene.materials.emissive}
    fn = cuda_grad.make_fused_loss_grad_fn(scene, cam, cfg)
    half = cfg.height // 2
    loss, grads, segs = fn(params, target, 5, 1, 0, cfg.height)
    parts = [fn(params, target[y0:y0 + half], 5, 1, y0, half) for y0 in (0, half)]
    torch.testing.assert_close((parts[0][0] + parts[1][0]) / 2, loss, rtol=1e-5, atol=0.0)
    for k in grads:
        torch.testing.assert_close((parts[0][1][k] + parts[1][1][k]) / 2, grads[k], rtol=1e-5,
                                   atol=1e-5 * float(grads[k].abs().max()))
    assert int(parts[0][2]) + int(parts[1][2]) == int(segs)
    steps = [make_fused_recovery_step(m, scene, cam, cfg, pool=1) for m in (nccl_mesh, None)]
    (p_mesh, l_mesh), (p_none, l_none) = (s(dict(params), scene, cam, target, 5, 1)
                                          for s in steps)
    assert torch.equal(l_mesh, l_none)
    for k in p_none:
        assert torch.equal(p_mesh[k], p_none[k]), k
