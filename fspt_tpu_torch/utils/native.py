"""ctypes bindings for the native host library (``csrc/fspt_native.cpp``).

Port of fspt_tpu/utils/native.py.  The C++ source is the repository's own
(``csrc/`` at the root of the checkout) and is only read: the port compiles
its own copy with ``g++`` at first use into ``build/fspt_tpu_torch/<hash>/``,
keyed by a hash of the source and the flags, as ops/_build.py does for
``nvcc``.  The flags leave out ``-march=native`` so the library does not
depend on the host's instruction set.  A failed build raises with the
compiler's output; nothing falls back.

* :func:`build_bvh` — pre-order BVH build, the contract of
  ops/bvh.py's ``_build_bvh_preorder``: ``(order, bmin, bmax, first,
  count, miss)``.
* :func:`parse_obj` — OBJ parse, the contract of scene/mesh.py's
  ``parse_obj``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

from fspt_tpu_torch.ops._build import BUILD_DIR

SOURCE = BUILD_DIR.parents[1] / "csrc" / "fspt_native.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
_lib = None


class _ObjCounts(ctypes.Structure):
    _fields_ = [("n_verts", ctypes.c_int64), ("n_normals", ctypes.c_int64),
                ("n_texcoords", ctypes.c_int64), ("n_tris", ctypes.c_int64)]


def library_path():
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / h.hexdigest()[:16] / "libfspt_native.so"


def build():
    """Compile the library if this source's build is missing; its path."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found to build fspt_native")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.parent / f"libfspt_native.{os.getpid()}.so"
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.fspt_build_bvh.restype = ctypes.c_int64
    lib.fspt_build_bvh.argtypes = [f32p, f32p, f32p, ctypes.c_int64,
                                   ctypes.c_int64, i64p, f32p, f32p, i64p,
                                   i64p, i64p]
    lib.fspt_obj_count.restype = ctypes.c_int
    lib.fspt_obj_count.argtypes = [ctypes.c_char_p, ctypes.POINTER(_ObjCounts)]
    lib.fspt_obj_parse.restype = ctypes.c_int
    lib.fspt_obj_parse.argtypes = [ctypes.c_char_p, f32p, f32p, f32p, i64p]
    _lib = lib
    return lib


def build_bvh(v0, v1, v2, max_leaf: int):
    """Native pre-order BVH build → ``(order, bmin, bmax, first, count,
    miss)``, NumPy arrays."""
    lib = _load()
    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)
    n = len(v0)
    cap = max(1, 2 * n)
    order = np.empty(n, np.int64)
    bmin = np.empty((cap, 3), np.float32)
    bmax = np.empty((cap, 3), np.float32)
    first = np.empty(cap, np.int64)
    count = np.empty(cap, np.int64)
    miss = np.empty(cap, np.int64)
    m = lib.fspt_build_bvh(v0, v1, v2, n, max_leaf, order, bmin, bmax,
                           first, count, miss)
    return (order, bmin[:m].copy(), bmax[:m].copy(), first[:m].copy(),
            count[:m].copy(), miss[:m].copy())


def parse_obj(path: str):
    """Native OBJ parse → dict of vertices/normals/texcoords/faces."""
    lib = _load()
    counts = _ObjCounts()
    if lib.fspt_obj_count(path.encode(), ctypes.byref(counts)) != 0:
        raise IOError(f"cannot read {path}")
    verts = np.empty((max(counts.n_verts, 1), 3), np.float32)
    normals = np.empty((max(counts.n_normals, 1), 3), np.float32)
    texcoords = np.empty((max(counts.n_texcoords, 1), 2), np.float32)
    faces = np.empty((max(counts.n_tris, 1), 3, 3), np.int64)
    if lib.fspt_obj_parse(path.encode(), verts, normals, texcoords,
                          faces.reshape(-1)) != 0:
        raise IOError(f"cannot parse {path}")
    return dict(
        vertices=verts[: counts.n_verts],
        normals=normals[: counts.n_normals],
        texcoords=texcoords[: counts.n_texcoords],
        faces=faces[: counts.n_tris],
    )
