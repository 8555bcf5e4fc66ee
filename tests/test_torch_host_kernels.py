"""The CUDA sources of kernels 1-4 and 13 compiled as host code, against
their plain versions on the CPU.

g++ builds fspt_tpu_torch/csrc/fspt_kernels.cu and fspt_deferred.cu against
tests/host_shim/cuda_runtime.h, where a launch runs every thread of the grid
in turn, and the tests call the kernels' C launchers on CPU tensors, each
with the launch head its card wrapper passes (``cuda_path.PathBody.head``:
the table pointers, PathParams and CamParams).  So the kernels' arithmetic
and control flow (the primitive walk over the rows a block stages one kind
at a time, the material switch, kernel 4's texel fold) run here, where
there is no card; the card runs the same comparisons in
tests/test_torch_kernels_gpu.py and chip_smoke.py.  Bars: radiance at rtol
1e-4 / atol 1e-5, material AOVs and segment counts equal, on every value
(the host's sinf / cosf round some lanes' last bit otherwise than torch's);
kernel 1's t, normal and texcoords at rtol 1e-5 / atol 1e-6, material and
kind equal; kernel 13's walk counts and kernel 4's texel fetch counts
equal.  Building both libraries takes
a few seconds.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from fspt_tpu_torch.camera import generate_rays
from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.ops import _build, cuda_grad, cuda_path, cuda_trace, rng
from fspt_tpu_torch.ops.kernel_check import random_segments
from fspt_tpu_torch.scene import samples

SHIM = Path(__file__).resolve().parent / "host_shim"
PROLOGUE = """#include "cuda_runtime.h"
uint3 threadIdx, blockIdx;
dim3 blockDim, gridDim;
int shim_pass;
namespace fspt { float4 smem[16384]; }
void shim_reset() { __builtin_memset(fspt::smem, 0, sizeof(fspt::smem)); }
"""
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel sources as host code")
    out = tmp_path_factory.mktemp("host_kernels")
    built = {}
    for lib in ("fspt_kernels", "fspt_deferred"):
        src = _build.LIBRARIES[lib]
        text = re.sub(r"(\w+)\s*<<<(.*?)>>>",
                      lambda m: f"host_launch({m.group(1)}, {m.group(2)})",
                      src.read_text(), flags=re.S)
        cpp = out / f"{lib}.cpp"
        cpp.write_text(PROLOGUE + text)
        so = out / f"lib{lib}.so"
        subprocess.run(["g++", "-std=c++17", "-O1", "-fPIC", "-shared", "-ffp-contract=off",
                        "-Wno-attributes", "-I", str(SHIM), "-I", str(src.parent), "-o",
                        str(so), str(cpp)], check=True)
        cdll = ctypes.CDLL(str(so))
        for sym, argtypes in _build._SIGNATURES[lib].items():
            fn = getattr(cdll, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        built[lib] = cdll
    return built


def _close(a, b, rtol, atol):
    return bool(torch.isclose(a, b, rtol=rtol, atol=atol).all())


def _held(k, p):
    assert _close(k.radiance, p.radiance, 1e-4, 1e-5)
    assert torch.equal(k.aov_mat, p.aov_mat)
    assert int(k.segments) == int(p.segments)


#: (scene, width, height, spp, fast_render, seed, aperture): every material
#: family (textured walls and sky for kernel 4) through a thin-lens camera,
#: the flagship, and every primitive kind.
CASES = [("all_families", 32, 24, 2, False, 5, 1.5), ("all_families", 32, 24, 2, True, 5, 1.5),
         ("all_families_textured", 32, 24, 2, False, 6, 1.5),
         ("all_families_textured", 32, 24, 2, True, 6, 1.5),
         ("flagship", 48, 32, 2, False, 0, 0.0), ("all_primitives", 31, 23, 2, False, 0, 0.0)]


def _setup(name, w, h, spp, fast, aperture):
    b = samples.build(name, device=CPU, aperture=aperture, focal_depth=120.0)
    sp = b.compile(device=CPU)
    cfg = RenderConfig(width=w, height=h, spp=spp, max_depth=8, fast_render=fast)
    return b, sp, cfg


@pytest.mark.parametrize("case", CASES)
def test_camera_kernels_on_host(libs, case):
    """Kernel 2, or kernel 4 for a textured scene, against the tracer's plain
    version (for kernel 4, the fold of its plain slot planes)."""
    name, w, h, spp, fast, seed, aperture = case
    b, sp, cfg = _setup(name, w, h, spp, fast, aperture)
    body = cuda_path.PathBody(sp, b.cameras[0], cfg)
    head = body.head(CPU)
    n = w * h * spp
    outs = cuda_path._path_outputs(n, CPU)
    tail = (rng.seed_hash(seed), 2, 0, n, *(o.data_ptr() for o in outs), None)
    if body.textured:
        scale, pack = _tex_pack(sp, body)
        assert libs["fspt_deferred"].fspt_deferred_camera_path(*head, pack, *tail[:-1], None,
                                                               None) == 0
    else:
        assert libs["fspt_kernels"].fspt_camera_path(*head, *tail) == 0
    _held(cuda_path._trace_output(*outs),
          cuda_path.make_camera_path_tracer(sp, b.cameras[0], cfg)(seed, 2))


def _tex_pack(sp, body):
    tex = sp.textures
    scale = torch.from_numpy(body.mats.tex_scale.astype(np.float32))
    return scale, _build.TexPack(texels=tex.texels.data_ptr(), offset=tex.offset.data_ptr(),
                                 width=tex.width.data_ptr(), height=tex.height.data_ptr(),
                                 scale=scale.data_ptr(), n_texels=tex.texels.shape[0])


@pytest.mark.parametrize("band", [(0, None), (301, 555)])
def test_deferred_kernel_counts_fetches_on_host(libs, band):
    """Kernel 4's counting build (textured walls, lamp, mirror, ceramic,
    glow and sky) over the whole frame and over a band from a later lane:
    its surface and sky texel fetches equal those its plain version counts
    from its slot planes, and its outputs equal the build that counts
    nothing, bit for bit (the host launch counts on its second pass)."""
    b, sp, cfg = _setup("all_families_textured", 32, 24, 2, False, 1.5)
    tracer = cuda_path.make_camera_path_tracer(sp, b.cameras[0], cfg)
    body = cuda_path.PathBody(sp, b.cameras[0], cfg)
    scale, pack = _tex_pack(sp, body)
    lane0, n = band
    n = n or cfg.width * cfg.height * cfg.spp
    plain = tracer.counted(7, 4, lane0=lane0, n_lanes=n)
    got = []
    for counted in (True, False):
        outs = cuda_path._path_outputs(n, CPU)
        totals = torch.zeros((cuda_path.TEX_TOTALS,), dtype=torch.int64)
        assert libs["fspt_deferred"].fspt_deferred_camera_path(
            *body.head(CPU), pack, rng.seed_hash(7), 4, lane0, n,
            *(o.data_ptr() for o in outs), totals.data_ptr() if counted else None, None) == 0
        got.append(cuda_path._trace_output(*outs))
        _held(got[-1], plain)
        assert torch.equal(totals, plain.fetches if counted else torch.zeros_like(totals))
    for field in ("radiance", "aov_normal", "aov_depth", "aov_mat"):
        assert torch.equal(getattr(got[0], field), getattr(got[1], field)), field
    surface, sky = plain.fetches.tolist()
    assert surface > 0 and sky > 0


@pytest.mark.parametrize("name", ["all_families", "all_primitives"])
def test_ray_path_kernel_on_host(libs, name):
    """Kernel 3 against its plain version on rays from generate_rays."""
    b, sp, cfg = _setup(name, 31, 23, 2, False, 0.0)
    cam = b.cameras[0]
    start, seg, pix, smp = generate_rays(cam, cfg.width, cfg.height, cfg.spp, 4, 0)
    n = start.shape[0]
    body = cuda_path.PathBody(sp, None, cfg, z_far=float(cam.z_far))
    head = body.head(CPU)
    assert len(head) == 5  # no CamParams: the rays come in
    outs = cuda_path._path_outputs(n, CPU)
    assert libs["fspt_kernels"].fspt_ray_path(
        *head, start.data_ptr(), seg.data_ptr(), pix.data_ptr(), smp.data_ptr(),
        rng.seed_hash(4), n, *(o.data_ptr() for o in outs), None) == 0
    tracer = cuda_path.make_path_tracer(sp, cfg, z_far=float(cam.z_far))
    _held(cuda_path._trace_output(*outs), tracer(start, seg, pix, smp, 4))


def _intersect_held(libs, scene, start, seg):
    """Kernel 1's C launcher against its plain version on CPU segments."""
    n = start.shape[0]
    prims, meta = scene.tables(CPU)
    t = torch.empty((n,), dtype=torch.float32)
    normal = torch.empty((n, 3), dtype=torch.float32)
    mat = torch.empty((n,), dtype=torch.int32)
    kind = torch.empty((n,), dtype=torch.int32)
    uv = torch.empty((n, 2), dtype=torch.float32)
    assert libs["fspt_kernels"].fspt_intersect(
        prims.data_ptr(), meta.data_ptr(), scene.prim_count, start.data_ptr(), seg.data_ptr(),
        n, t.data_ptr(), normal.data_ptr(), mat.data_ptr(), kind.data_ptr(), uv.data_ptr(),
        None) == 0
    p = cuda_trace.plain_intersect(scene, start, seg)
    assert _close(t, p[0], 1e-5, 1e-6) and _close(normal, p[1], 1e-5, 1e-6)
    assert _close(uv, p[4], 1e-5, 1e-6)
    assert torch.equal(mat, p[2]) and torch.equal(kind, p[3])


def _host_scene(name, **kw):
    return cuda_trace.HostScene(samples.build(name, device=CPU, **kw).compile(device=CPU).geometry)


def test_intersect_kernel_on_host(libs):
    """Kernel 1 (the staged rows walked one kind at a time) against its
    plain version on seeded random segments."""
    scene = _host_scene("all_primitives")
    _intersect_held(libs, scene, *random_segments(2048, seed=3, device=CPU))


@pytest.mark.parametrize("case", [("all_primitives", {}, 50021), ("flagship_rows", {}, 3001)])
def test_intersect_kernel_grid_and_rows_on_host(libs, case):
    """Kernel 1 on more segments than its grid takes in one stride, so
    that every block loops (all_primitives), and at the 512-row limit (the
    flagship and 498 spheres: 69.6 KB of staged rows); ragged counts."""
    name, kw, n = case
    scene = _host_scene(name, **kw)
    grid, tile = ctypes.c_int(), ctypes.c_int()
    assert libs["fspt_kernels"].fspt_intersect_plan(
        scene.prim_count, n, ctypes.byref(grid), ctypes.byref(tile)) == 0
    if name == "flagship_rows":
        assert scene.prim_count == cuda_trace.MAX_SPECIALIZED_PRIMS
    else:
        assert n > 2 * grid.value * tile.value, (grid.value, tile.value)
    _intersect_held(libs, scene, *random_segments(n, seed=4, device=CPU))


@pytest.mark.parametrize("name", ["all_families", "all_families_textured"])
@pytest.mark.parametrize("fast", [False, True])
def test_affine_planes_kernel_on_host(libs, name, fast):
    """Kernel 7 (the slot planes of every depth, on staged rows) against its
    plain version: 3 field planes, or 5 with the texcoords of a textured
    scene, fast render off and on, over a ragged frame from lane 0 and over
    a band from a later lane.  Fields at check_affine_planes's bar on every
    value; the material rows, p_light and the segment count equal."""
    b, sp, cfg = _setup(name, 31, 23, 2, fast, 1.5)
    planes = cuda_grad.make_affine_planes(sp, b.cameras[0], cfg)
    body = cuda_path.PathBody(sp, b.cameras[0], cfg)
    head = body.head(CPU)
    S = cuda_path.n_slots(cfg)
    for lane0, n in ((0, cfg.width * cfg.height * cfg.spp), (301, 555)):
        p = planes.plain(8, 2, lane0, n)
        assert len(p.fields) == (5 if name.endswith("textured") else 3)
        fields = torch.empty((len(p.fields), S, n), dtype=torch.float32)
        rows = torch.empty((2, S, n), dtype=torch.int32)
        p_light = torch.empty((n,), dtype=torch.bool)
        segcnt = torch.empty((n,), dtype=torch.int32)
        assert libs["fspt_deferred"].fspt_affine_planes(
            *head, rng.seed_hash(8), 2, lane0, n, fields.data_ptr(), len(p.fields),
            rows[0].data_ptr(), rows[1].data_ptr(), p_light.data_ptr(), segcnt.data_ptr(),
            None) == 0
        for f, key in enumerate(p.fields):
            assert _close(fields[f], p.fields[key], 1e-4, 1e-5), key
        assert torch.equal(rows[0], p.mat) and torch.equal(rows[1], p.mat_e)
        assert torch.equal(p_light, p.p_light)
        assert int(segcnt.sum()) == int(p.segments)


@pytest.mark.parametrize("band", [(0, None), (301, 555)])
def test_mesh_camera_path_kernel_on_host(libs, band):
    """Kernel 13 (kernel 2's body walking the BVH after the staged rows)
    against its plain version on the heightfield at grid 12 (242
    triangles) through its thin-lens camera, over the whole frame and over
    a band from a later lane, with its walk counted and without: the totals
    equal the plain walk's node steps and triangle tests (the host launch
    counts on its second pass).  A host thread walks alone, so each leaf
    is a leaf phase of its own and each segment a warp walk."""
    b = samples.build("heightfield", device=CPU, grid=12)
    sp = b.compile(device=CPU)
    cfg = RenderConfig(width=32, height=24, spp=2, max_depth=4)
    tracer = cuda_path.make_camera_path_tracer(sp, b.cameras[0], cfg)
    body = cuda_path.PathBody(sp, b.cameras[0], cfg)
    assert body.cam.aperture == 1.5
    lane0, n = band
    n = n or cfg.width * cfg.height * cfg.spp
    shade = cuda_path.mesh_shade(sp.tri_shade)
    plain = tracer.counted(9, 4, lane0=lane0, n_lanes=n)
    for counted in (True, False):
        outs = cuda_path._path_outputs(n, CPU)
        totals = torch.zeros((cuda_path.MESH_TOTALS,), dtype=torch.int64)
        walk, phases = totals[:2], totals[2:]
        assert libs["fspt_kernels"].fspt_mesh_camera_path(
            *body.head(CPU), tracer.tables.nodes.data_ptr(),
            tracer.tables.n_nodes, tracer.tables.tris.data_ptr(), shade.data_ptr(),
            rng.seed_hash(9), 4, lane0, n, *(o.data_ptr() for o in outs),
            totals.data_ptr() if counted else None, None) == 0
        k = cuda_path._trace_output(*outs)
        _held(k, plain)
        assert _close(k.aov_normal, plain.aov_normal, 1e-5, 1e-6)
        assert _close(k.aov_depth, plain.aov_depth, 1e-5, 1e-6)
        assert torch.equal(walk, plain.walk if counted else torch.zeros_like(walk))
        leaf_phases, leaves, warp_walks = phases.tolist()
        if counted:
            assert leaf_phases == leaves > 0 and warp_walks == int(k.segments)
        else:
            assert leaf_phases == leaves == warp_walks == 0
    assert int(plain.walk[1]) > 0
