"""Gradient kernels: 7 (affine slot planes), 8 (fused dual-buffer loss),
9 and 10 (the path tracer with run-time parameters and its adjoint).

Counterpart of fspt_tpu/ops/pallas_grad.py.

* ``affine_planes_kernel`` (csrc/fspt_deferred.cu) replaces
  ``pallas_grad.py:make_affine_grad_image_fn`` (kernel ``:360``): it writes
  the slot planes of the ``defer_all`` body; :func:`ops.cuda_path.
  fold_deferred_params` folds them in torch, and torch autograd
  differentiates that fold.  The radiometric values (diffuse, emissive,
  glow, texels) scale radiance but never bend a ray, so the planes do not
  depend on them and no adjoint of the path body is needed.
* ``fused_loss_kernel`` (csrc/fspt_grad.cu) replaces
  ``pallas_grad.py:make_fused_loss_grad_fn`` (kernel ``:589``) in its
  affine construction: two traces, the fold, the lane loss and the
  hand-written adjoint of fold and clamp in one launch (two threads a
  lane, one a buffer), the gradient in per-thread shared-memory columns
  and the fixed-order reduction across blocks that the reverse kernels
  use.
* ``fused_loss_chain_kernel`` (csrc/fspt_adjoint.cu) is kernel 8's whole
  chain (``:700-753``), for scalar fields (param, ior, reflectivity, frost)
  and the camera: two traces, the lane loss and the adjoint of both whole
  paths in one launch.
* ``grad_forward_kernel`` and ``grad_sweep_kernel`` or ``grad_backward_kernel``
  (csrc/fspt_adjoint.cu) replace ``pallas_grad.py:make_grad_path_tracer``
  (kernels ``:216`` and ``:227``): radiance with the optimized table cells
  read at run time, and its vector-Jacobian product for a radiance
  cotangent, glued by a ``torch.autograd.Function``.  Kernel 10 sweeps the
  record kernel 9 wrote of each lane where the call wants a gradient and
  the record fits (:func:`keeps_record`), and otherwise traces the lanes
  again (remat).

The adjoint of the path body is reverse mode on the card (kernels 10 and
8's whole chain: one recorded float trace and a hand-written per-bounce
sweep, csrc/fspt_adjoint.cu), whose cost does not grow with the number of
parameters; each kernel's plain version is torch autograd of the plain body
with ``tmats`` (:func:`ops.cuda_path.build_path_core`), which the tests hold
against the reference's ``jax.grad``.  Parameters are mapped onto table
cells by name, so ``fields`` may come in any order.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from fspt_tpu_torch.ops import _build, rng
from fspt_tpu_torch.ops.cuda_path import (
    CAMERA_PARAM_COUNT,
    PathBody,
    bias_table,
    build_traced_raygen,
    fold_deferred_params,
    n_slots,
)
from fspt_tpu_torch.render.integrator import TraceOutput
from fspt_tpu_torch.utils import vecmath as vm

VEC3_FIELDS = ("diffuse", "emissive", "glow")
SCALAR_FIELDS = ("param", "ior", "reflectivity", "frost")
#: Pseudo-field: the 9 camera scalars (cuda_path.camera_pvec), packed last.
CAMERA_FIELD = "camera"
#: Fields whose values scale radiance without ever bending a ray.
RADIOMETRIC_FIELDS = frozenset({"diffuse", "emissive", "glow"})
#: The first column of each field in a material table row (csrc kMatStride).
FIELD_COLUMN = {"diffuse": 0, "emissive": 3, "glow": 6, "param": 9, "ior": 10,
                "reflectivity": 11, "frost": 12}

AFFINE_PLANES = _build.KernelCounter(
    "affine_planes", "fspt_deferred", "fspt_affine_planes",
    "fspt_tpu/ops/pallas_grad.py:403 make_affine_grad_image_fn (body :360)")
FUSED_LOSS = _build.KernelCounter(
    "fused_loss", "fspt_grad", "fspt_fused_loss",
    "fspt_tpu/ops/pallas_grad.py:792 make_fused_loss_grad_fn (body :589)")
GRAD_FORWARD = _build.KernelCounter(
    "grad_forward", "fspt_adjoint", "fspt_grad_forward",
    "fspt_tpu/ops/pallas_grad.py:216 make_grad_path_tracer fwd (body :188)")
#: Kernel 10's remat route: it traces the lanes again.
GRAD_BACKWARD = _build.KernelCounter(
    "grad_backward", "fspt_adjoint", "fspt_grad_backward",
    "fspt_tpu/ops/pallas_grad.py:227 make_grad_path_tracer bwd (body :193)")
#: Kernel 10's sweep route: it sweeps kernel 9's record of the lanes.
GRAD_SWEEP = _build.KernelCounter(
    "grad_sweep", "fspt_adjoint", "fspt_grad_sweep",
    "fspt_tpu/ops/pallas_grad.py:227 make_grad_path_tracer bwd (body :193)")
FUSED_LOSS_CHAIN = _build.KernelCounter(
    "fused_loss_chain", "fspt_adjoint", "fspt_fused_loss_chain",
    "fspt_tpu/ops/pallas_grad.py:792 make_fused_loss_grad_fn, whole chain "
    "(body :589, :700-753)")


#: The most of the card's memory one recorded band may take.
RECORD_SHARE = 1 / 8


def record_shape(n: int, depth: int) -> tuple[int, int, int]:
    """Kernel 9's record of ``n`` lanes at ``depth`` bounces, float32
    (csrc/fspt_adjoint.cu RecordStore): planes of float4, three a bounce
    (segment, throughput, winner row: 10 words padded to 12) and one for the
    lane's tail (radiance before the clamp, segments and flags)."""
    return (3 * depth + 1, n, 4)


def record_bytes(n: int, depth: int) -> int:
    """Bytes of kernel 9's record of ``n`` lanes at ``depth`` bounces."""
    planes, lanes, words = record_shape(n, depth)
    return 4 * planes * lanes * words


def keeps_record(n: int, depth: int, total_memory: int, needs_grad: bool) -> bool:
    """Whether kernel 9 records ``n`` lanes for kernel 10 to sweep: where
    the call wants a gradient and the record fits in :data:`RECORD_SHARE`
    of the card's ``total_memory``.  Otherwise kernel 9 writes none and
    kernel 10 traces the lanes again."""
    return bool(needs_grad) and record_bytes(n, depth) <= total_memory * RECORD_SHARE


def adjoint_plan(n_mats: int, rows: int, depth: int) -> tuple[int, int]:
    """The reverse kernels' launch for ``n_mats`` table rows, ``rows``
    gradient rows and ``depth`` bounces (csrc/fspt_adjoint.cu
    fspt_adjoint_plan, which the launchers follow): the threads of a block,
    and the floats of device scratch a lane's record takes per buffer (0
    where the per-thread record holds it).  Loads the kernel library."""
    block, words = ctypes.c_int(), ctypes.c_int()
    err = _build.library("fspt_adjoint").fspt_adjoint_plan(
        n_mats, rows, depth, ctypes.byref(block), ctypes.byref(words))
    if err != 0:
        raise ValueError(f"the reverse-mode adjoint cannot take {n_mats} material rows with "
                         f"{rows} gradient rows: the table or the gradient columns pass "
                         f"the shared memory of a block")
    return block.value, words.value


def forward_plan(n_mats: int, n: int) -> tuple[int, int]:
    """Kernel 9's launch for ``n`` lanes over ``n_mats`` table rows
    (csrc/fspt_adjoint.cu fspt_grad_forward_plan, which the launcher
    follows): its grid, the card's resident blocks of 128 threads (fewer
    where the band has fewer 32-lane chunks than they have warps), and the
    idle threads of a warp at which it takes new lanes.  Loads the kernel
    library."""
    grid, refill = ctypes.c_int(), ctypes.c_int()
    err = _build.library("fspt_adjoint").fspt_grad_forward_plan(
        n_mats, n, ctypes.byref(grid), ctypes.byref(refill))
    if err != 0:
        raise ValueError(f"kernel 9 cannot take {n_mats} material rows (CUDA error {err})")
    return grid.value, refill.value


def loss_plan(n_mats: int, n_slot: int, n: int) -> tuple[int, int]:
    """Kernel 8 affine's launch for ``n_mats`` table rows, ``n_slot`` slots
    a buffer and ``n`` lanes (csrc/fspt_grad.cu fspt_fused_loss_plan, which
    the launcher follows): the threads of a block (two a lane) and the
    blocks of the grid.  Loads the kernel library."""
    block, grid = ctypes.c_int(), ctypes.c_int()
    err = _build.library("fspt_grad").fspt_fused_loss_plan(
        n_mats, n_slot, n, ctypes.byref(block), ctypes.byref(grid))
    if err != 0:
        raise ValueError(f"kernel 8 takes at most 64 material rows and 16 slots a buffer; "
                         f"got {n_mats} and {n_slot}")
    return block.value, grid.value


def _record_scratch(words, buffers, n, dev):
    """The device scratch ``[buffers, words, n]`` of the reverse sweep's
    records, or None where the per-thread record holds them."""
    return torch.empty((buffers, words, n), dtype=torch.float32, device=dev) if words else None


def _ptr(t):
    return 0 if t is None else t.data_ptr()


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
    """Inverse of :func:`pack_params` (works on gradients too).  Trailing
    dimensions of ``pvec`` (per-lane copies ``[P, n]``) are kept."""
    out = {}
    off = 0
    for f in _ordered(fields):
        n = _field_size(mats, f)
        col = pvec[off:off + n]
        out[f] = col.reshape(mats.count, 3, *col.shape[1:]) if f in VEC3_FIELDS else col
        off += n
    return out


def _material_fields(fields):
    return tuple(f for f in _ordered(fields) if f != CAMERA_FIELD)


def cell_map(mats, fields) -> np.ndarray:
    """The table cell (row·16 + column) of each packed material parameter,
    in :func:`pack_params` order: the kernels write the parameter vector
    into these cells by name."""
    cells = []
    for f in _material_fields(fields):
        width = 3 if f in VEC3_FIELDS else 1
        cells += [row * 16 + FIELD_COLUMN[f] + c for row in range(mats.count)
                  for c in range(width)]
    return np.asarray(cells, np.int32)


def _param_table(table, mats, fields, pvec):
    """``table`` with the material fields of ``pvec`` in place: the ``tmats``
    of :func:`ops.cuda_path.build_path_core`."""
    cols = unpack_params(pvec, mats, fields)
    return table._replace(**{f: cols[f] for f in _material_fields(fields)})


def _lane_leaves(pvec, n):
    """``pvec`` as per-lane leaves ``[P, n]``: autograd then returns every
    lane's gradient, whose sum over lanes the plain versions take in
    float64."""
    return pvec.detach().to(torch.float32)[:, None].expand(-1, n).clone().requires_grad_()


def _lane_grad(value, leaves):
    """``d value / d leaves`` in float64; zeros where ``value`` does not
    depend on them (no lane reached a parameter's table cell)."""
    if not value.requires_grad:
        return torch.zeros(leaves.shape, dtype=torch.float64, device=leaves.device)
    (g,) = torch.autograd.grad(value, [leaves])
    return g.double()


def _traced_params(cfg) -> _build.TracedCamParams:
    return _build.TracedCamParams(aspect=cfg.width / cfg.height,
                                  half_deg=0.5 * (float(vm.PI) / 180.0))


class _GradTrace(torch.autograd.Function):
    """Kernel 9 forward, kernel 10 backward (the reference's custom VJP,
    pallas_grad.py:239-255).  ``forward_fn(pvec, wants_grad)`` returns the
    radiance, the segments and kernel 9's record of the lanes or None; the
    record stays on ``ctx`` until the backward sweeps it
    (``backward_fn(pvec, cot, record)``), or until the graph goes."""

    @staticmethod
    def forward(ctx, pvec, grad_enabled, forward_fn, backward_fn):
        radiance, segcnt, ctx.record = forward_fn(pvec,
                                                  grad_enabled and ctx.needs_input_grad[0])
        ctx.backward_fn = backward_fn
        ctx.save_for_backward(pvec)
        ctx.mark_non_differentiable(segcnt)
        return radiance, segcnt

    @staticmethod
    def backward(ctx, g_radiance, _g_segcnt):
        (pvec,) = ctx.saved_tensors
        record, ctx.record = ctx.record, None  # freed once swept; a retained graph retraces
        return ctx.backward_fn(pvec, g_radiance, record), None, None, None


def make_grad_path_tracer(scene_pack, camera, cfg, fields=("diffuse", "emissive")):
    """The path tracer with run-time material parameters, differentiable
    with respect to them: kernels 9 and 10.

    Returns ``trace(pvec, seed, sample0, lane0=0, n_lanes=None) →
    TraceOutput`` (radiance ``[N,3]``; the AOVs are zeros, as the
    reference's loss-only tracer) differentiable with respect to ``pvec =
    pack_params(params, fields)``, or None for a BVH scene, a textured one
    or one over 512 primitives.  A scene on the CPU runs autograd of the
    plain body with ``tmats``; on the card the forward launches kernel 9 and
    the backward kernel 10 with the radiance cotangent.

    Kernel 10 takes one of two routes, by what the call shows
    (:func:`keeps_record`): where the call wants a gradient (``pvec``
    requires one, with grad mode on) and the band's record fits in an
    eighth of the card's memory, kernel 9 records each lane's live bounces
    and its tail as it traces it (``n·(48·depth + 16)`` bytes, 3.3 GB at
    1080p×4, depth 8), the record is held until the backward, and kernel
    10 only sweeps it (``GRAD_SWEEP``); otherwise kernel 9 writes none and
    kernel 10 traces the lanes again before its sweep (remat,
    ``GRAD_BACKWARD``), as the TPU reference does, whose fast memory is
    small.  Both routes sweep the same bits in the same order: the same
    gradient bit for bit.

    ``trace.fields``, ``trace.n_params``, ``trace.mats``; ``trace.plain``
    runs the plain version on any device, ``trace.plain_grad(pvec, cot,
    seed, sample0, lane0, n)`` its ``torch.autograd.grad`` with lane sums in
    float64, and ``trace.kernel_forward(pvec, seed, sample0, lane0, n,
    record=None)`` and ``trace.kernel_backward(pvec, cot, seed, sample0,
    lane0, n, record=None)`` launch the kernels themselves (card only):
    with ``record`` (``trace.new_record(n)``) kernel 9 writes it and kernel
    10 sweeps it, without it kernel 10 takes the remat route.
    ``trace.nonfinite`` holds the lanes whose non-finite contribution the
    last kernel-10 launch zeroed, ``trace.record_bytes`` the bytes of the
    record the last kernel-9 launch wrote (0 for none).
    """
    if CAMERA_FIELD in fields:
        raise ValueError("camera gradients take make_fused_loss_grad_fn; the "
                         "in-kernel-adjoint pair uses the fixed camera")
    body = PathBody(scene_pack, camera, cfg)
    if body.bvh or not body.fits or body.textured:  # as pallas_grad.py:157-164
        return None
    mats, dev, depth = body.mats, body.dev, cfg.effective_depth
    fields = _ordered(fields)
    P = param_count(mats, fields)
    table = scene_pack.materials

    def plain_planes(pvec, seed, sample0, lane0, n):
        h0 = rng.seed_hash(seed)
        core = body.core(want_aovs=False, tmats=_param_table(table, mats, fields, pvec))
        outs = core(h0, *body.raygen(h0, sample0, lane0, n, dev))
        return torch.stack(outs[:3]), outs[8]

    def plain_grad(pvec, cot, seed, sample0, lane0, n):
        leaves = _lane_leaves(pvec, n)
        radiance, _ = plain_planes(leaves, seed, sample0, lane0, n)
        return _lane_grad((radiance * cot.detach()).sum(), leaves).sum(dim=1)

    if dev.type == "cuda":
        cells = torch.from_numpy(cell_map(mats, fields)).to(dev)
        block, words = adjoint_plan(mats.count, P, depth)
        total_memory = torch.cuda.get_device_properties(dev).total_memory

    def new_record(n):
        """An empty record of ``n`` lanes for kernel 9 to write."""
        return torch.empty(record_shape(n, depth), dtype=torch.float32, device=dev)

    def check_record(record, n):
        _build.check_cuda_tensor("record", record, torch.float32, record_shape(n, depth), dev)

    def launch_pvec(pvec):
        """The launch's float32 parameter vector."""
        pvec = pvec.detach().to(torch.float32).contiguous()
        _build.check_cuda_tensor("pvec", pvec, torch.float32, (P,), dev)
        return pvec

    def kernel_forward(pvec, seed, sample0, lane0, n, record=None):
        """Kernel 9: radiance ``[3, n]`` and segments ``[n]``; each lane's
        record into ``record`` where given."""
        pv = launch_pvec(pvec)
        if record is not None:
            check_record(record, n)
        radiance = torch.empty((3, n), dtype=torch.float32, device=dev)
        segcnt = torch.empty((n,), dtype=torch.int32, device=dev)
        body.launch(GRAD_FORWARD, pv.data_ptr(), cells.data_ptr(), P, rng.seed_hash(seed),
                    int(sample0), int(lane0), n, radiance.data_ptr(), segcnt.data_ptr(),
                    _ptr(record))
        trace.record_bytes = 0 if record is None else record.nbytes
        return radiance, segcnt

    def kernel_backward(pvec, cot, seed, sample0, lane0, n, record=None):
        """Kernel 10 (reverse mode): ``Σ_lanes cotᵀ·∂radiance/∂pvec`` for
        ``cot [3, n]``: the sweep of ``record`` (kernel 9's of the same
        lanes) where given, else the lanes traced again and swept."""
        pv = launch_pvec(pvec)
        cot = cot.to(torch.float32).contiguous()
        _build.check_cuda_tensor("cotangent", cot, torch.float32, (3, n), dev)
        blocks = -(-n // block)
        partial = torch.empty((P, blocks), dtype=torch.float32, device=dev)
        int_partial = torch.empty((2, blocks), dtype=torch.int32, device=dev)
        out = torch.empty((P,), dtype=torch.float64, device=dev)
        int_out = torch.empty((2,), dtype=torch.int64, device=dev)
        if record is None:
            counter, store = GRAD_BACKWARD, _record_scratch(words, 1, n, dev)
        else:
            check_record(record, n)
            counter, store = GRAD_SWEEP, record
        body.launch(counter, pv.data_ptr(), cells.data_ptr(), P, rng.seed_hash(seed),
                    int(sample0), int(lane0), n, cot.data_ptr(), _ptr(store),
                    partial.data_ptr(), int_partial.data_ptr(), out.data_ptr(),
                    int_out.data_ptr())
        trace.nonfinite = int_out[1]
        return out.to(torch.float32)

    def recorded_forward(pvec, seed, sample0, lane0, n, wants_grad):
        """Kernel 9 for the autograd glue, with a record where the route
        rule keeps one."""
        keep = keeps_record(n, depth, total_memory, wants_grad)
        record = new_record(n) if keep else None
        radiance, segcnt = kernel_forward(pvec, seed, sample0, lane0, n, record=record)
        return radiance, segcnt, record

    def trace(pvec, seed, sample0, lane0=0, n_lanes=None):
        n = n_lanes if n_lanes is not None else cfg.height * cfg.width * cfg.spp
        if dev.type == "cpu":
            planes, segcnt = plain_planes(pvec, seed, sample0, lane0, n)
        else:
            planes, segcnt = _GradTrace.apply(
                pvec.to(torch.float32), torch.is_grad_enabled(),
                lambda pv, wants: recorded_forward(pv, seed, sample0, lane0, n, wants),
                lambda pv, cot, rec: kernel_backward(pv, cot, seed, sample0, lane0, n,
                                                     record=rec))
        zeros = torch.zeros((n,), dtype=torch.float32, device=dev)
        return TraceOutput(radiance=planes.t(), aov_normal=torch.zeros((n, 3), device=dev),
                           aov_depth=zeros, aov_mat=zeros.to(torch.int32),
                           segments=segcnt.sum())

    trace.fields = fields
    trace.n_params = P
    trace.mats = mats
    trace.plain = plain_planes
    trace.plain_grad = plain_grad
    trace.kernel_forward = kernel_forward
    trace.kernel_backward = kernel_backward
    trace.new_record = new_record
    trace.nonfinite = None
    trace.record_bytes = 0
    return trace


def make_grad_image_fn(scene_pack, camera, cfg, fields=("diffuse", "emissive")):
    """Band images on kernels 9-10 (pallas_grad.py:291-316): ``img_fn(params,
    seed, frame_idx, y0, rows) → ([rows,W,3] mean-over-spp image,
    segments)``, differentiable with respect to the tensors in ``params``
    (the selected table columns), or None where
    :func:`make_grad_path_tracer` is."""
    tracer = make_grad_path_tracer(scene_pack, camera, cfg, fields=fields)
    if tracer is None:
        return None

    def img_fn(params, seed, frame_idx, y0, rows):
        pvec = pack_params(params, tracer.fields)
        n = rows * cfg.width * cfg.spp
        out = tracer(pvec, seed, frame_idx * cfg.spp, y0 * cfg.width * cfg.spp, n)
        img = out.radiance.reshape(rows, cfg.width, cfg.spp, 3).mean(dim=2)
        return img, out.segments

    img_fn.tracer = tracer
    return img_fn


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
    ``planes.plain`` runs on any device.  ``planes.scene``, ``.mats`` and
    ``.bias`` are the body's (:class:`ops.cuda_path.PathBody`), for the
    fold."""
    body = PathBody(scene_pack, camera, cfg)
    if body.bvh or not body.fits:
        return None
    return _affine_planes(body)


def _affine_planes(body: PathBody):
    """Kernel 7 on ``body``'s scene: :func:`make_affine_planes`'s ``planes``."""
    cfg, dev, mats = body.cfg, body.dev, body.mats
    core = body.core(defer_all=True, want_aovs=False)
    S = n_slots(cfg)
    fkeys = ("s", "k", "se") + (("u", "v") if body.textured else ())

    def plain(seed, sample0, lane0, n) -> AffinePlanes:
        h0 = rng.seed_hash(seed)
        slots, p_light, *_, segcnt = core(h0, *body.raygen(h0, sample0, lane0, n, dev))
        stack = lambda key: torch.stack([sl[key] for sl in slots])
        return AffinePlanes({k: stack(k) for k in fkeys}, stack("mat"),
                            stack("mat_e"), p_light, segcnt.sum())

    def planes(seed, sample0, lane0, n) -> AffinePlanes:
        if dev.type == "cpu":
            return plain(seed, sample0, lane0, n)
        fields = torch.empty((len(fkeys), S, n), dtype=torch.float32, device=dev)
        rows = torch.empty((2 * S + 1, n), dtype=torch.int32, device=dev)  # mat, mat_e, segcnt
        p_light = torch.empty((n,), dtype=torch.bool, device=dev)
        at = rows.data_ptr()
        body.launch(AFFINE_PLANES, rng.seed_hash(seed), int(sample0), int(lane0), n,
                    fields.data_ptr(), len(fkeys), at, at + 4 * S * n, p_light.data_ptr(),
                    at + 8 * S * n)
        return AffinePlanes(dict(zip(fkeys, fields)), rows[:S], rows[S:2 * S], p_light,
                            rows[2 * S].sum())

    planes.scene, planes.mats, planes.bias = body.scene, mats, body.bias
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
            mats, planes.bias, cfg, params.get("diffuse", table.diffuse),
            params.get("emissive", table.emissive), params.get("glow", table.glow),
            tex, p.fields["s"], p.fields["k"], p.fields["se"], p.mat, p.mat_e, u, v,
            p.p_light)
        rad = torch.stack([Lx, Ly, Lz], dim=-1)
        img = rad.reshape(rows, cfg.width, cfg.spp, 3).mean(dim=2)
        return img, p.segments

    img_fn.planes = planes
    return img_fn


def table_grads(bias, g_coef, g_bias, fields) -> dict:
    """Map the gradient with respect to the coefficient values (diffuse,
    ``[M,3]``) and the bias values (:func:`ops.cuda_path.bias_table`,
    ``[M,3]``) onto the table fields, by ``bias``, the ``[M,1]`` bias
    column on the gradients' device (:attr:`ops.cuda_path.PathBody.bias`)."""
    per_field = {"diffuse": g_coef + torch.where(bias == 2, g_bias, 0.0),
                 "emissive": torch.where(bias == 0, g_bias, 0.0),
                 "glow": torch.where(bias == 1, g_bias, 0.0)}
    return {f: per_field[f] for f in fields}


def make_fused_loss_grad_fn(scene_pack, camera, cfg, fields=("diffuse", "emissive"),
                            remat: bool = False, affine: bool | None = None):
    """ONE kernel per call: dual-buffer loss AND parameter gradient (kernel
    8).

    Buffer A takes the samples of ``frame_idx``, buffer B those of
    ``frame_idx + 10007``; the loss pairs them lane by lane,
    ``mean((A − t)(B − t))`` over lanes and channels, an unbiased estimate
    of the squared error.  ``fields`` are any of :data:`VEC3_FIELDS`,
    :data:`SCALAR_FIELDS` and ``"camera"`` (the 9-vector of
    :func:`ops.cuda_path.camera_pvec`, packed last).  Constructions, as the
    reference chooses them (pallas_grad.py:583-587):

    * affine (the default for radiometric fields; ``affine=True`` with any
      other field raises ``ValueError``): two ``defer_all`` traces, the fold
      and the hand-written adjoint of the fold only (csrc/fspt_grad.cu): the
      trace never depends on radiometric values.
    * whole chain (the default otherwise, or ``affine=False``): two traces
      and the adjoint of both whole paths (csrc/fspt_adjoint.cu); with
      ``"camera"`` the rays come from the traced raygen
      (:func:`ops.cuda_path.build_traced_raygen`).
    * remat (``remat=True`` where the whole chain applies): on the card the
      same kernel as the whole chain, which is itself the reference's remat
      construction (pallas_grad.py:700-753): each bounce is re-run from its
      recorded boundary state in the reverse sweep (and the reference's
      kernel miscompiles on the TPU, pallas_grad.py:542-548).  Its plain
      version checkpoints each bounce of the stepper
      (``torch.utils.checkpoint``).

    Returns ``fn(params, target[rows,W,3], seed, frame_idx, y0, rows) →
    (loss, grads, segments)`` normalized by ``1/(3n)`` as the reference, or
    None for a textured scene (as the reference: texel recovery takes kernel
    7) or one the megakernels do not take.  A scene on the CPU runs the
    plain version, ``fn.plain`` runs it on any device: the plain traces, the
    lane loss and ``torch.autograd.grad`` (the whole chain's with per-lane
    leaves summed in float64, returned in float64).  ``fn.nonfinite`` holds
    the lanes whose non-finite contribution the last whole-chain launch
    zeroed.
    """
    fields = _ordered(fields)
    radiometric_only = set(fields) <= RADIOMETRIC_FIELDS
    if affine and not radiometric_only:
        raise ValueError(f"the affine backward needs radiometric fields, got {fields}")
    unknown = set(fields) - set(VEC3_FIELDS + SCALAR_FIELDS) - {CAMERA_FIELD}
    if unknown:
        raise ValueError(f"unknown fields {sorted(unknown)}")
    body = PathBody(scene_pack, camera, cfg)
    if body.bvh or not body.fits or body.textured:
        return None
    build = _affine_loss if (radiometric_only if affine is None else affine) else _chain_loss
    plain, launch = build(scene_pack, fields, remat, body)

    def entry(run, cast):
        def fn(params, target, seed, frame_idx, y0, rows):
            n = rows * cfg.width * cfg.spp
            loss, grads, segs = run(params, target, seed, frame_idx * cfg.spp,
                                    (frame_idx + 10007) * cfg.spp,
                                    y0 * cfg.width * cfg.spp, n)
            norm = 1.0 / (3.0 * n)
            if cast:
                loss, grads = loss.float(), {f: g.float() for f, g in grads.items()}
            return loss * norm, {f: g * norm for f, g in grads.items()}, segs

        fn.fields = fields
        return fn

    fn = entry(plain, True) if body.dev.type == "cpu" else entry(launch, False)
    fn.plain = entry(plain, False)
    fn.nonfinite = None
    launch.owner = fn
    return fn


def _affine_loss(scene_pack, fields, _remat, body: PathBody):
    """Kernel 8's affine construction: ``(plain, launch)``."""
    cfg, dev, mats = body.cfg, body.dev, body.mats
    planes = _affine_planes(body)
    table = scene_pack.materials
    if dev.type == "cuda":
        loss_plan(mats.count, n_slots(cfg), 0)  # raises past the kernel's limits

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
                mats, body.bias, cfg, diffuse, emissive, glow, scene_pack.textures,
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
        te_tab = bias_table(body.bias, diffuse, emissive, glow).detach().contiguous()
        tgt = target.detach().to(torch.float32).reshape(-1, 3).contiguous()
        _build.check_cuda_tensor("target", tgt, torch.float32, (n // cfg.spp, 3), dev)
        _build.check_cuda_tensor("diffuse", tc_tab, torch.float32, (mats.count, 3), dev)
        _, grid = loss_plan(mats.count, n_slots(cfg), n)
        width = 1 + 6 * mats.count
        partial = torch.empty((width, grid), dtype=torch.float32, device=dev)
        int_partial = torch.empty((2, grid), dtype=torch.int32, device=dev)
        out = torch.zeros((width,), dtype=torch.float64, device=dev)
        int_out = torch.zeros((2,), dtype=torch.int64, device=dev)
        body.launch(FUSED_LOSS, tc_tab.data_ptr(), te_tab.data_ptr(), rng.seed_hash(seed),
                    int(sample_a), int(sample_b), int(lane0), n, tgt.data_ptr(),
                    partial.data_ptr(), int_partial.data_ptr(), out.data_ptr(),
                    int_out.data_ptr())
        out = out.to(torch.float32)
        g = out[1:].reshape(2, mats.count, 3)
        return out[0], table_grads(body.bias, g[0], g[1], fields), int_out[0]

    return plain, launch


def _chain_loss(scene_pack, fields, remat, body: PathBody):
    """Kernel 8's whole chain (and remat): ``(plain, launch)``."""
    cfg, dev, mats = body.cfg, body.dev, body.mats
    table = scene_pack.materials
    use_camera = CAMERA_FIELD in fields
    P = param_count(mats, fields)
    P_mat = P - (CAMERA_PARAM_COUNT if use_camera else 0)
    traygen = build_traced_raygen(body.cam, cfg)

    def rays(leaves, h0, sample0, lane0, n):
        if use_camera:
            return traygen(list(leaves[P_mat:]), h0, sample0, lane0, n, dev)
        return body.raygen(h0, sample0, lane0, n, dev)

    def radiance(leaves, h0, sample0, lane0, n):
        tm = _param_table(table, mats, fields, leaves)
        r = rays(leaves, h0, sample0, lane0, n)
        if not remat:
            outs = body.core(want_aovs=False, tmats=tm)(h0, *r)
        else:
            init, step, finalize = body.core(want_aovs=False, tmats=tm, return_stepper=True)
            st = init(h0, *r)
            for depth in range(cfg.effective_depth):
                st = checkpoint(lambda s, d=depth: step(d, s)[0], st, use_reentrant=False)
            outs = finalize(st, [])
        return torch.stack(outs[:3], dim=-1), outs[8].sum()

    def plain(params, target, seed, sample_a, sample_b, lane0, n):
        leaves = _lane_leaves(pack_params(params, fields).to(dev), n)
        tgt = target.reshape(-1, 3).repeat_interleave(cfg.spp, dim=0).double()
        h0 = rng.seed_hash(seed)
        res, segs = [], 0
        for sample0 in (sample_a, sample_b):
            rad, seg = radiance(leaves, h0, sample0, lane0, n)
            res.append(rad.double() - tgt)
            segs = segs + seg
        loss = (res[0] * res[1]).sum()
        g = _lane_grad(loss, leaves).sum(dim=1)
        return loss.detach(), unpack_params(g, mats, fields), segs

    if dev.type == "cuda":
        cells = torch.from_numpy(cell_map(mats, fields)).to(dev)
        tp = _traced_params(cfg)
        block, words = adjoint_plan(mats.count, 1 + P, cfg.effective_depth)

    def launch(params, target, seed, sample_a, sample_b, lane0, n):
        scratch = _record_scratch(words, 2, n, dev)
        pvec = pack_params(params, fields).detach().to(dev).contiguous()
        tgt = target.detach().to(torch.float32).reshape(-1, 3).contiguous()
        _build.check_cuda_tensor("target", tgt, torch.float32, (n // cfg.spp, 3), dev)
        blocks = -(-n // block)
        partial = torch.empty((1 + P, blocks), dtype=torch.float32, device=dev)
        int_partial = torch.empty((2, blocks), dtype=torch.int32, device=dev)
        out = torch.empty((1 + P,), dtype=torch.float64, device=dev)
        int_out = torch.empty((2,), dtype=torch.int64, device=dev)
        body.launch(FUSED_LOSS_CHAIN, tp, pvec.data_ptr(), cells.data_ptr(), P_mat,
                    int(use_camera), rng.seed_hash(seed), int(sample_a), int(sample_b),
                    int(lane0), n, tgt.data_ptr(), _ptr(scratch), partial.data_ptr(),
                    int_partial.data_ptr(), out.data_ptr(), int_out.data_ptr())
        launch.owner.nonfinite = int_out[1]
        out = out.to(torch.float32)
        return out[0], unpack_params(out[1:], mats, fields), int_out[0]

    return plain, launch
