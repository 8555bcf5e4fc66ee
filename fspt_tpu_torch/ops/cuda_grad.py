"""Gradient kernels: 7 (affine slot planes) and 8 (fused dual-buffer loss,
affine construction).

Counterpart of fspt_tpu/ops/pallas_grad.py.  Both kernels rest on one fact:
the radiometric table values (diffuse, emissive, glow, texels) scale
radiance but never bend a ray, so the path traced for any value of them is
the same, and the radiance is an affine fold over per-depth slots that the
trace emits (ops/cuda_path.py ``build_path_core(defer_all=True)``).  The
gradient then needs no adjoint of the path body.

* ``affine_planes_kernel`` (csrc/fspt_deferred.cu) replaces
  ``pallas_grad.py:make_affine_grad_image_fn`` (kernel ``:360``): it writes
  the slot planes; :func:`ops.cuda_path.fold_deferred_params` folds them in
  torch, and torch autograd differentiates that fold.  The planes do not
  depend on any parameter, so no ``torch.autograd.Function`` is needed.
* ``fused_loss_kernel`` (csrc/fspt_grad.cu) replaces
  ``pallas_grad.py:make_fused_loss_grad_fn`` (kernel ``:589``) in its
  affine construction: two traces, the fold, the lane loss and the
  hand-written adjoint of fold and clamp in one launch, with a fixed-order
  reduction across blocks.

The whole-chain and remat constructions of kernel 8, the in-kernel-adjoint
pair (kernels 9-10), scalar fields and camera gradients need the adjoint of
the path body itself; they raise ``NotImplementedError`` naming that slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fspt_tpu_torch.ops import _build, rng
from fspt_tpu_torch.ops.cuda_path import (
    HostCamera,
    _cam_params,
    _device_of,
    _path_params,
    _specializable,
    bias_table,
    build_fused_raygen,
    build_path_core,
    fold_deferred_params,
    n_slots,
)

VEC3_FIELDS = ("diffuse", "emissive", "glow")
SCALAR_FIELDS = ("param", "ior", "reflectivity", "frost")
#: Pseudo-field: the 9 camera scalars, always packed last.
CAMERA_FIELD = "camera"
CAMERA_PARAM_COUNT = 9
#: Fields whose values scale radiance without ever bending a ray.
RADIOMETRIC_FIELDS = frozenset({"diffuse", "emissive", "glow"})

PATH_ADJOINT_SLICE = (
    "comes with the path-body-adjoint slice of the port (kernels 9-10 and "
    "kernel 8's whole-chain and remat constructions)")

#: Limits of kernel 8's per-thread arrays (csrc/fspt_grad.cu).
GRAD_BLOCK = 128
MAX_SLOTS = 16
MAX_GRAD_MATS = 64

AFFINE_PLANES = _build.KernelCounter(
    "affine_planes", "fspt_deferred", "fspt_affine_planes",
    "fspt_tpu/ops/pallas_grad.py:403 make_affine_grad_image_fn (body :360)")
FUSED_LOSS = _build.KernelCounter(
    "fused_loss", "fspt_grad", "fspt_fused_loss",
    "fspt_tpu/ops/pallas_grad.py:792 make_fused_loss_grad_fn (body :589)")


def _field_size(mats, f) -> int:
    if f == CAMERA_FIELD:
        return CAMERA_PARAM_COUNT
    return (3 if f in VEC3_FIELDS else 1) * mats.count


def param_count(mats, fields) -> int:
    return sum(_field_size(mats, f) for f in fields)


def _ordered(fields):
    """Canonical pack order: material columns first, camera last."""
    mat = [f for f in fields if f != CAMERA_FIELD]
    return tuple(mat) + ((CAMERA_FIELD,) if CAMERA_FIELD in fields else ())


def pack_params(params: dict, fields):
    """Flatten ``{field: column}`` (canonical order) into one f32 vector."""
    return torch.cat([torch.as_tensor(params[f], dtype=torch.float32).reshape(-1)
                      for f in _ordered(fields)])


def unpack_params(pvec, mats, fields) -> dict:
    """Inverse of :func:`pack_params` (works on gradients too)."""
    out = {}
    off = 0
    for f in _ordered(fields):
        n = _field_size(mats, f)
        col = pvec[off:off + n]
        out[f] = col.reshape(mats.count, 3) if f in VEC3_FIELDS else col
        off += n
    return out


class AffinePlanes(NamedTuple):
    """Kernel 7's outputs: ``fields`` maps s, k, se (and u, v for a textured
    scene) to ``[S, N]`` float32 planes; ``mat``, ``mat_e`` are ``[S, N]``
    int32; ``p_light`` is ``[N]`` bool; ``segments`` the segment count."""

    fields: dict
    mat: torch.Tensor
    mat_e: torch.Tensor
    p_light: torch.Tensor
    segments: torch.Tensor


def make_affine_planes(scene_pack, camera, cfg):
    """Kernel 7: ``planes(seed, sample0, lane0, n) → AffinePlanes`` over the
    frame lanes ``lane0 .. lane0+n-1``, or None for a scene the megakernels
    do not take.  A scene on the CPU runs the plain version
    (``build_path_core(defer_all=True, want_aovs=False)``), which
    ``planes.plain`` runs on any device."""
    found = _specializable(scene_pack)
    if found is None:
        return None
    scene, mats = found
    sky_idx = int(scene_pack.sky_mat)
    cam = HostCamera(camera, cfg.width, cfg.height)
    dev = _device_of(scene_pack)
    raygen = build_fused_raygen(cam, cfg)
    core = build_path_core(scene, mats, cfg, sky_idx, cam.z_far, defer_all=True,
                           want_aovs=False)
    S = n_slots(cfg)
    fkeys = ("s", "k", "se") + (("u", "v") if mats.any_textured else ())

    def plain(seed, sample0, lane0, n) -> AffinePlanes:
        h0 = rng.seed_hash(seed)
        slots, p_light, *_, segcnt = core(h0, *raygen(h0, sample0, lane0, n, dev))
        stack = lambda key: torch.stack([sl[key] for sl in slots])
        return AffinePlanes({k: stack(k) for k in fkeys}, stack("mat"),
                            stack("mat_e"), p_light, segcnt.sum())

    def planes(seed, sample0, lane0, n) -> AffinePlanes:
        if dev.type == "cpu":
            return plain(seed, sample0, lane0, n)
        prims, meta = scene.tables(dev)
        mtab, mmeta = mats.tables(dev)
        fields = torch.empty((len(fkeys), S, n), dtype=torch.float32, device=dev)
        mat = torch.empty((S, n), dtype=torch.int32, device=dev)
        mat_e = torch.empty((S, n), dtype=torch.int32, device=dev)
        p_light = torch.empty((n,), dtype=torch.int32, device=dev)
        segcnt = torch.empty((n,), dtype=torch.int32, device=dev)
        _build.launch(AFFINE_PLANES, prims.data_ptr(), meta.data_ptr(),
                      mtab.data_ptr(), mmeta.data_ptr(),
                      _path_params(scene, mats, cfg, sky_idx, cam.z_far),
                      _cam_params(cam, cfg), rng.seed_hash(seed), int(sample0),
                      int(lane0), n, fields.data_ptr(), len(fkeys), mat.data_ptr(),
                      mat_e.data_ptr(),
                      p_light.data_ptr(), segcnt.data_ptr(),
                      torch.cuda.current_stream(dev).cuda_stream)
        return AffinePlanes(dict(zip(fkeys, fields)), mat, mat_e, p_light != 0,
                            segcnt.sum())

    planes.scene, planes.mats = scene, mats
    planes.plain = plain
    return planes


def make_affine_grad_image_fn(scene_pack, camera, cfg):
    """Affine-deferred gradient renderer (kernel 7): radiometric fields and
    texels, any scene the megakernels take, textured included.

    Returns ``img_fn(params, seed, frame_idx, y0, rows) → ([rows,W,3]
    mean-over-spp image, segments)``, differentiable by torch autograd with
    respect to the tensors in ``params`` — any of ``diffuse``, ``emissive``,
    ``glow`` ([M,3] columns) and ``texels`` ([K,3]) — or None when the scene
    cannot be specialized.  Exact for these fields: path geometry never
    depends on them.  ``img_fn.planes`` is kernel 7 itself
    (:func:`make_affine_planes`).
    """
    planes = make_affine_planes(scene_pack, camera, cfg)
    if planes is None:
        return None
    mats = planes.mats
    table = scene_pack.materials
    base_tex = scene_pack.textures

    def img_fn(params, seed, frame_idx, y0, rows):
        n = rows * cfg.width * cfg.spp
        p = planes(seed, frame_idx * cfg.spp, y0 * cfg.width * cfg.spp, n)
        tex = base_tex
        if "texels" in params:
            tex = base_tex._replace(texels=params["texels"])
        u = p.fields.get("u", torch.zeros_like(p.fields["s"]))
        v = p.fields.get("v", torch.zeros_like(p.fields["s"]))
        Lx, Ly, Lz = fold_deferred_params(
            mats, cfg, params.get("diffuse", table.diffuse),
            params.get("emissive", table.emissive), params.get("glow", table.glow),
            tex, p.fields["s"], p.fields["k"], p.fields["se"], p.mat, p.mat_e, u, v,
            p.p_light)
        rad = torch.stack([Lx, Ly, Lz], dim=-1)
        img = rad.reshape(rows, cfg.width, cfg.spp, 3).mean(dim=2)
        return img, p.segments

    img_fn.planes = planes
    return img_fn


def table_grads(mats, g_coef, g_bias, fields) -> dict:
    """Map the gradient with respect to the coefficient values (diffuse,
    ``[M,3]``) and the bias values (:func:`ops.cuda_path.bias_table`,
    ``[M,3]``) onto the table fields."""
    bc = torch.from_numpy(mats.bias_column()).to(g_coef.device)[:, None]
    per_field = {"diffuse": g_coef + torch.where(bc == 2, g_bias, 0.0),
                 "emissive": torch.where(bc == 0, g_bias, 0.0),
                 "glow": torch.where(bc == 1, g_bias, 0.0)}
    return {f: per_field[f] for f in fields}


def make_fused_loss_grad_fn(scene_pack, camera, cfg, fields=("diffuse", "emissive"),
                            remat: bool = False, affine: bool | None = None):
    """ONE kernel per call: dual-buffer loss AND parameter gradient
    (kernel 8, affine construction).

    Buffer A takes the samples of ``frame_idx``, buffer B those of
    ``frame_idx + 10007``; the loss pairs them lane by lane,
    ``mean((A − t)(B − t))`` over lanes and channels, an unbiased estimate
    of the squared error.  Its gradient comes from the adjoint of the fold
    only: the trace never depends on radiometric values.

    Returns ``fn(params, target[rows,W,3], seed, frame_idx, y0, rows) →
    (loss, grads, segments)`` normalized by ``1/(3n)`` as the reference,
    or None for a textured scene (as the reference: texel recovery takes
    kernel 7) or one the megakernels do not take.  Scalar fields,
    ``"camera"``, ``affine=False`` and ``remat=True`` need the adjoint of the
    path body and raise ``NotImplementedError``.

    A scene on the CPU runs the plain version: the plain ``defer_all``
    traces, :func:`ops.cuda_path.fold_deferred_params`, the lane loss and
    ``torch.autograd.grad``.  ``fn.plain`` runs it on any device.
    """
    fields = _ordered(fields)
    if remat or affine is False:
        raise NotImplementedError(f"remat and whole-chain backwards {PATH_ADJOINT_SLICE}")
    if not set(fields) <= RADIOMETRIC_FIELDS:
        raise NotImplementedError(
            f"gradients of {sorted(set(fields) - RADIOMETRIC_FIELDS)} {PATH_ADJOINT_SLICE}")
    planes = make_affine_planes(scene_pack, camera, cfg)
    if planes is None or planes.mats.any_textured:
        return None
    scene, mats = planes.scene, planes.mats
    sky_idx = int(scene_pack.sky_mat)
    cam = HostCamera(camera, cfg.width, cfg.height)
    dev = _device_of(scene_pack)
    table = scene_pack.materials
    if dev.type == "cuda" and (mats.count > MAX_GRAD_MATS or n_slots(cfg) > MAX_SLOTS):
        raise ValueError(f"kernel 8 takes at most {MAX_GRAD_MATS} material rows and "
                         f"{MAX_SLOTS} slots; got {mats.count} and {n_slots(cfg)}")

    def values(params):
        return (params.get("diffuse", table.diffuse), params.get("emissive", table.emissive),
                params.get("glow", table.glow))

    def plain(params, target, seed, sample_a, sample_b, lane0, n):
        leaves = {f: params[f].detach().clone().requires_grad_() for f in fields}
        diffuse, emissive, glow = values({**params, **leaves})
        tgt = target.reshape(-1, 3).repeat_interleave(cfg.spp, dim=0)
        segs = 0
        res = []
        for sample0 in (sample_a, sample_b):
            p = planes.plain(seed, sample0, lane0, n)
            zero = torch.zeros_like(p.fields["s"])
            rad = torch.stack(fold_deferred_params(
                mats, cfg, diffuse, emissive, glow, scene_pack.textures,
                p.fields["s"], p.fields["k"], p.fields["se"], p.mat, p.mat_e, zero,
                zero, p.p_light), dim=-1)
            res.append(rad - tgt)
            segs = segs + p.segments
        loss = (res[0] * res[1]).sum()
        grads = torch.autograd.grad(loss, [leaves[f] for f in fields])
        return loss.detach(), dict(zip(fields, grads)), segs

    def launch(params, target, seed, sample_a, sample_b, lane0, n):
        diffuse, emissive, glow = values(params)
        tc_tab = diffuse.detach().to(torch.float32).contiguous()
        te_tab = bias_table(mats, diffuse, emissive, glow).detach().contiguous()
        tgt = target.detach().to(torch.float32).reshape(-1, 3).contiguous()
        _build.check_cuda_tensor("target", tgt, torch.float32, (n // cfg.spp, 3), dev)
        _build.check_cuda_tensor("diffuse", tc_tab, torch.float32, (mats.count, 3), dev)
        blocks = -(-n // GRAD_BLOCK)
        width = 1 + 6 * mats.count
        partial = torch.empty((blocks, width), dtype=torch.float32, device=dev)
        seg_partial = torch.empty((blocks,), dtype=torch.int32, device=dev)
        out = torch.zeros((width,), dtype=torch.float64, device=dev)
        seg_out = torch.zeros((1,), dtype=torch.int64, device=dev)
        prims, meta = scene.tables(dev)
        mtab, mmeta = mats.tables(dev)
        _build.launch(FUSED_LOSS, prims.data_ptr(), meta.data_ptr(), mtab.data_ptr(),
                      mmeta.data_ptr(), _path_params(scene, mats, cfg, sky_idx, cam.z_far),
                      _cam_params(cam, cfg), tc_tab.data_ptr(), te_tab.data_ptr(),
                      rng.seed_hash(seed), int(sample_a), int(sample_b), int(lane0), n,
                      tgt.data_ptr(), partial.data_ptr(), seg_partial.data_ptr(),
                      out.data_ptr(), seg_out.data_ptr(),
                      torch.cuda.current_stream(dev).cuda_stream)
        out = out.to(torch.float32)
        g = out[1:].reshape(2, mats.count, 3)
        return out[0], table_grads(mats, g[0], g[1], fields), seg_out[0]

    def entry(run):
        def fn(params, target, seed, frame_idx, y0, rows):
            n = rows * cfg.width * cfg.spp
            loss, grads, segs = run(params, target, seed, frame_idx * cfg.spp,
                                    (frame_idx + 10007) * cfg.spp,
                                    y0 * cfg.width * cfg.spp, n)
            norm = 1.0 / (3.0 * n)
            return loss * norm, {f: g * norm for f, g in grads.items()}, segs

        fn.fields = fields
        return fn

    fn = entry(plain if dev.type == "cpu" else launch)
    fn.plain = entry(plain)
    return fn
