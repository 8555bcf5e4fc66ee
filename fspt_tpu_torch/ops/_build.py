"""Build and bind the port's CUDA kernels (csrc/*.cu).

Each source in :data:`LIBRARIES` is compiled by ``nvcc`` into a shared
library with a plain C interface at first use, into
``build/fspt_tpu_torch/`` at the root of the checkout, under a name keyed by
a hash of its sources; ``ctypes`` loads it.  The first use of any kernel
starts one ``nvcc`` per missing library, all at once, and waits for them.
There is no fallback: a missing ``nvcc`` or a failed compile raises with the
compiler's output.

Flags: ``sm_90a`` (Hopper), ``-O3``, ``-fmad=false`` and no
``--use_fast_math``.  ``-fmad=false`` keeps every multiply and add rounded
on its own, as the plain PyTorch versions round them, so the kernels follow
the same branch decisions (``u0 < reflectivity``, ``n·l > 0.001``, near-tie
hits) lane for lane; it costs speed and is there for parity.
``-Xptxas -v`` reports registers and spills, kept in ``ptxas.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
HEADERS = (CSRC / "fspt_kernels.cuh", CSRC / "fspt_tangent.cuh", CSRC / "fspt_adjoint.cuh",
           CSRC / "fspt_mesh.cuh")
#: library name → its one source file; all share :data:`HEADERS`.
LIBRARIES = {
    "fspt_kernels": CSRC / "fspt_kernels.cu",    # kernels 1-3 and 13
    "fspt_deferred": CSRC / "fspt_deferred.cu",  # kernels 4 and 7
    "fspt_grad": CSRC / "fspt_grad.cu",          # kernel 8
    "fspt_bvh": CSRC / "fspt_bvh.cu",            # kernels 5, 6, 11 and 12
    "fspt_adjoint": CSRC / "fspt_adjoint.cu",    # kernels 9, 10, 8 whole chain
}
BUILD_DIR = PACKAGE_DIR.parent / "build" / "fspt_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint


class KernelCounter:
    """A kernel's identity and its launch count.

    ``launches`` rises by one each time the wrapper launches the kernel on
    the card, and nowhere else; the plain PyTorch path never touches it.
    """

    def __init__(self, name: str, library: str, symbol: str, replaces: str):
        self.name = name
        self.library = library
        self.symbol = symbol
        self.replaces = replaces
        self.launches = 0


class PathParams(ctypes.Structure):
    """Per-render constants of the path body (mirrors ``PathParams`` in
    csrc/fspt_kernels.cuh, passed by value)."""

    _fields_ = [
        ("ray_offset", ctypes.c_float),
        ("seg_scale", ctypes.c_float),  # z_far - ray_offset
        ("z_far", ctypes.c_float),
        ("light_clamp", ctypes.c_float),
        ("sky_e", ctypes.c_float * 3),
        ("depth", ctypes.c_int),
        ("bounce_slots", ctypes.c_int),
        ("sky_idx", ctypes.c_int),
        ("fast_render", ctypes.c_int),
        ("n_prims", ctypes.c_int),
        ("n_mats", ctypes.c_int),
    ]


class CamParams(ctypes.Structure):
    """Per-render camera constants of the fused raygen (mirrors
    ``CamParams`` in csrc/fspt_kernels.cuh, passed by value)."""

    _fields_ = [
        ("origin", ctypes.c_float * 3),
        ("proj_origin", ctypes.c_float * 3),
        ("right", ctypes.c_float * 3),
        ("up", ctypes.c_float * 3),
        ("focal_plane", ctypes.c_float * 4),
        ("half_w", ctypes.c_float),
        ("half_h", ctypes.c_float),
        ("inv_wm1", ctypes.c_float),
        ("inv_hm1", ctypes.c_float),
        ("aperture", ctypes.c_float),
        ("z_far", ctypes.c_float),
        ("width", ctypes.c_int),
        ("spp", ctypes.c_int),
        ("dof", ctypes.c_int),
    ]


class TracedCamParams(ctypes.Structure):
    """Constants of the traced raygen (mirrors ``TracedCamParams`` in
    csrc/fspt_kernels.cuh, passed by value)."""

    _fields_ = [
        ("aspect", ctypes.c_float),    # width / height
        ("half_deg", ctypes.c_float),  # 0.5·π/180
    ]


class TexPack(ctypes.Structure):
    """Kernel 4's texture pack and per-row tiling scales (mirrors ``TexPack``
    in csrc/fspt_deferred.cu, passed by value)."""

    _fields_ = [
        ("texels", ctypes.c_void_p),  # [K,3] float32
        ("offset", ctypes.c_void_p),  # [T] int32
        ("width", ctypes.c_void_p),   # [T] int32
        ("height", ctypes.c_void_p),  # [T] int32
        ("scale", ctypes.c_void_p),   # [M] float32, the rows' tex_scale
        ("n_texels", ctypes.c_int),
    ]


#: The head every path-body launcher takes first (ops/cuda_path.PathBody):
#: prims, meta, mats, mat_meta, PathParams, CamParams.  Kernel 3, whose rays
#: come in, takes it without CamParams.
_BODY_HEAD = [_P, _P, _P, _P, PathParams, CamParams]
_RAY_HEAD = _BODY_HEAD[:5]

# library → exported symbol → argtypes (every pointer and the stream as c_void_p)
_SIGNATURES = {
    "fspt_kernels": {
        # n_prims, n, *grid, *tile
        "fspt_intersect_plan": [_I, _I, _P, _P],
        # prims, meta, n_prims, start, seg, n, t, normal, mat, kind, uv, stream
        "fspt_intersect": [_P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P],
        # head, h0, sample0, lane0, n, radiance, normal, depth, aov_mat,
        # segcnt, stream
        "fspt_camera_path": [*_BODY_HEAD, _U, _I, _I, _I, _P, _P, _P, _P, _P, _P],
        # ray head, start, seg, pixel, sample, h0, n, radiance, normal, depth,
        # aov_mat, segcnt, stream
        "fspt_ray_path": [*_RAY_HEAD, _P, _P, _P, _P, _U, _I, _P, _P, _P, _P, _P, _P],
        # head, nodes, n_nodes, tris, shade, h0, sample0, lane0, n, radiance,
        # normal, depth, aov_mat, segcnt, walk (cuda_path.MESH_TOTALS int64, or
        # null), stream
        "fspt_mesh_camera_path": [*_BODY_HEAD, _P, _I, _P, _P, _U, _I, _I, _I, _P, _P, _P,
                                  _P, _P, _P, _P],
    },
    "fspt_deferred": {
        # head, TexPack, h0, sample0, lane0, n, radiance, normal, depth,
        # aov_mat, segcnt, stream
        "fspt_deferred_camera_path": [*_BODY_HEAD, TexPack, _U, _I, _I, _I, _P, _P, _P, _P,
                                      _P, _P],
        # head, h0, sample0, lane0, n, fields, n_fields, mat, mat_e, p_light,
        # segcnt, stream
        "fspt_affine_planes": [*_BODY_HEAD, _U, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P],
    },
    "fspt_grad": {
        # n_mats, n_slot, n, *block, *grid
        "fspt_fused_loss_plan": [_I, _I, _I, _P, _P],
        # head, tc_tab, te_tab, h0, sample0_a, sample0_b, lane0, n, target,
        # partial, int_partial, out, int_out, stream
        "fspt_fused_loss": [*_BODY_HEAD, _P, _P, _U, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    },
    "fspt_bvh": {
        # F, lbmin, lbmax, n_leaves, n_blocks, key, stream
        "fspt_treelet_cull": [_P, _P, _P, _I, _I, _P, _P],
        # heavy_first, counts, order, tlo, n_leaves, group, F, weights,
        # n_blocks, t, best, visits, stream
        "fspt_treelet_sweep": [_P, _P, _P, _P, _I, _I, _P, _P, _I, _P, _P, _P, _P],
        # shape: int[3] out (threads, rays a thread, threads a ray)
        "fspt_sweep_shape": [_P],
        # n_leaves, *shape (threads, leaves a thread)
        "fspt_cull_shape": [_I, _P],
        # start, seg, t_init, n, nodes, n_nodes, tris, t, id, u, v, visits,
        # tested, next (scratch int), stream
        "fspt_bvh_walk": [_P, _P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P],
        # F, n_pad, nodes, n_nodes, weights, t, best, visits, tested, stream
        "fspt_treelet_walk": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P],
    },
    "fspt_adjoint": {
        # head, pvec, cells, n_cells, h0, sample0, lane0, n, radiance, segcnt,
        # record, stream
        "fspt_grad_forward": [*_BODY_HEAD, _P, _P, _I, _U, _I, _I, _I, _P, _P, _P, _P],
        # n_mats, n, *grid, *refill
        "fspt_grad_forward_plan": [_I, _I, _P, _P],
        # n_mats, rows, depth, *block, *scratch_words
        "fspt_adjoint_plan": [_I, _I, _I, _P, _P],
        # ... as fspt_grad_forward up to n, then cot, scratch, partial,
        # int_partial, out, int_out, stream
        "fspt_grad_backward": [*_BODY_HEAD, _P, _P, _I, _U, _I, _I, _I, _P, _P, _P, _P, _P,
                               _P, _P],
        # ... as fspt_grad_backward, with kernel 9's record in place of scratch
        "fspt_grad_sweep": [*_BODY_HEAD, _P, _P, _I, _U, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                            _P],
        # head, TracedCamParams, pvec, cells, n_cells, use_camera, h0,
        # sample0_a, sample0_b, lane0, n, target, scratch, partial,
        # int_partial, out, int_out, stream
        "fspt_fused_loss_chain": [*_BODY_HEAD, TracedCamParams, _P, _P, _I, _I, _U, _I, _I,
                                  _I, _I, _P, _P, _P, _P, _P, _P, _P],
    },
}

_libraries = {}


def source_hash(name: str) -> str:
    h = hashlib.sha256()
    for src in (LIBRARIES[name], *HEADERS):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / source_hash(name) / f"lib{name}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the fspt_tpu_torch kernels")


def build_all() -> dict:
    """Compile every library whose build for these sources is missing, one
    ``nvcc`` each, all started together; returns ``{name: path}``."""
    paths = {name: _lib_path(name) for name in LIBRARIES}
    procs = {}
    for name, lib in paths.items():
        if lib.exists():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.parent / f"lib{name}.{os.getpid()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(LIBRARIES[name])]
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (cmd, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
            continue
        (paths[name].parent / "ptxas.log").write_text(log)
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def ptxas_log() -> str:
    """The ``-Xptxas -v`` reports of the current builds ('' where not built)."""
    logs = []
    for name in LIBRARIES:
        path = _lib_path(name).parent / "ptxas.log"
        if path.exists():
            logs.append(path.read_text())
    return "\n".join(logs)


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built on first use."""
    if name not in _libraries:
        lib = ctypes.CDLL(str(build_all()[name]))
        for symbol, argtypes in _SIGNATURES[name].items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libraries[name] = lib
    return _libraries[name]


def launch(counter: KernelCounter, *args) -> None:
    """Call a launcher; raise on a non-zero ``cudaGetLastError``, else count
    the launch."""
    err = getattr(library(counter.library), counter.symbol)(*args)
    if err != 0:
        raise RuntimeError(f"{counter.name} kernel launch failed: CUDA error {err}")
    counter.launches += 1


def check_cuda_tensor(name: str, t, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
