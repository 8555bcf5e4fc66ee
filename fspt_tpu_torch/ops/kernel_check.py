"""Hold each CUDA kernel against its plain PyTorch version on the card.

Both run on the same CUDA tensors; the kernels' launch counts rise, the
plain versions' do not.  The GPU-marked tests and ``chip_smoke.py`` call
these functions; each returns a report and raises ``AssertionError`` when
a bar is missed.

Bars (path tracers): radiance within rtol 1e-4 / atol 1e-5 on ≥ 99.9 % of
values, material AOV equal on ≥ 99.9 % of lanes, total segments within
0.1 %.  The two sides round every operation alike (the kernels build with
``-fmad=false``), but the card's ``sinf``/``cosf`` and torch's may still
differ in the last bit, and a lane whose branch (``u0 < reflectivity``, a
near-tie hit) flips follows another path: hence fractions, not equality.
Intersect: t, normal and texcoords within rtol 1e-5 / atol 1e-6, material
and kind equal, each on ≥ 99.9 % of lanes.  The ``lane0`` band split of the
camera-fused kernels must reproduce the full frame bit for bit.

The camera-fused kernels 2 and 4 meet the path bar on 100 % of values
(radiance, normal and depth AOVs close, material AOVs and segment counts
equal; kernel 4 against the fold of its plain slot planes), and the reports
give the bit-equal shares; their band split and a second launch reproduce
the full frame bit for bit.  Kernel 13 (kernel 2's body walking a BVH)
meets the same bar against its plain version over :func:`ops.bvh.walk_bvh`,
with the walk's node steps and triangle tests equal and its build that
counts nothing equal to the counting one bit for bit.  Kernel 4's counting
build counts the texel fetches its plain version counts from its slot
planes, and its outputs equal its build that counts nothing, bit for bit.

Kernel 7: every float slot plane at the radiance bar, the material rows
equal, on ≥ 99.9 % of values, segments within 0.1 %.  Its image through
the fold at the radiance bar, and its gradients
(torch autograd of the fold on the kernel's planes and on the plain
version's) within rtol 1e-4 of the largest: the fold's adjoint is an
``index_add`` that sums millions of lanes per table row in float32, in no
fixed order on the card.  Kernel 8:
loss at rtol 1e-5, gradients within rtol 1e-4 of the largest, segments
equal, against the plain version run with float64 parameters: the kernel
sums its blocks in another order, and at 1080p the float32 plain version's
own sums are off by more than 1e-4 of the largest gradient; and two
launches equal bit for bit (a fixed grid, fixed-order sums, no atomics).

Adjoint kernels (9, 10, 8's whole chain).  Kernel 9 against its plain
version (the body with ``tmats``): 100 % of radiance values at the path bar
and equal segment counts, as kernel 2, and two launches equal bit for bit
(its regenerating schedule hands lanes to threads in another order each
time, but a lane's path depends only on its index).  The report also gives
the bit-equal share of the radiance values; the GPU-marked tests and
``chip_smoke.py`` phase 21 require it to be 1.0, as the card has shown
(kernel 9 is kernel 2's float body over the same table values).  Kernel 10
and kernel 8's gradients against ``torch.autograd.grad`` of the plain
version, with each lane's gradient summed over lanes in float64: every
entry within rtol 1e-3, or within 1e-5 of the largest |entry| (the kernel's
hand-written adjoint and autograd's order every sum of the chain rule
differently, and an entry whose lanes cancel keeps only that noise); kernel
8's loss within rtol 1e-5 and its segments equal, its camera entries within
rtol 2e-3 (the reference's own bar, tests/test_pallas_grad.py:345);
``remat=True`` equal to ``remat=False`` bit for bit (one kernel, so two
launches equal bit for bit), and two launches of kernel 10 equal bit for
bit (no atomics).

Treelet kernels (5, 6): equal to their plain versions on 100 % of values —
every key of the cull bit for bit (its float32 bits), and the survivor
counts, leaf order and entry t after the key sort (kernel 5),
the packed winner, its t and the leaf visits (kernel 6).  Both sides add
the same terms in the same order (kernel 6's integer min over packed keys
does not depend on how its threads split a leaf), so anything less is a
fault.  The mesh frame on the kernel path (kernels 1, 5, 6) against the
plain path: the path bar above, with equal segment counts.

Tree walks (11, 12), at the reference's bars (tests/test_pallas_bvh.py:
37-63): kernel 11's t within rtol 1e-5 / atol 1e-7 and its ids equal on
every hit; kernel 12's t within rtol 1e-4 / atol 1e-6, ids equal on
≥ 99.9 % of hits, u within rtol 1e-3 / atol 1e-4.  Both add the same terms
in the same order as their plain versions, so the reports also give the
bit-equal shares (and the equal node and triangle counts), expected 1.0.
"""

from __future__ import annotations

import numpy as np
import torch

from fspt_tpu_torch.camera import generate_rays
from fspt_tpu_torch.ops import cuda_bvh, cuda_grad, cuda_path, cuda_trace, rng
from fspt_tpu_torch.scene.geometry import INVALID_PARAM

FRACTION = 0.999


def random_segments(n: int, seed: int, device, box: float = 48.0):
    """``n`` seeded random segments starting inside the Cornell box, with
    uniform directions and lengths in [20, 200]."""
    r = np.random.default_rng(seed)
    start = r.uniform(-box, box, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    seg = (d * r.uniform(20.0, 200.0, (n, 1))).astype(np.float32)
    return (torch.from_numpy(start).to(device), torch.from_numpy(seg).to(device))


def _frac_close(a, b, rtol, atol):
    """Share of values of ``a`` close to ``b``, from an integer count."""
    return _frac_equal(torch.isclose(a, b, rtol=rtol, atol=atol), True)


def _frac_equal(a, b):
    """Share of equal values from an integer count: exactly 1.0 when all
    are equal (a float mean on the card need not be), and for no values."""
    return int((a == b).sum()) / a.numel() if a.numel() else 1.0


def _max_abs(a, b):
    return (a - b).abs().max().item() if a.numel() else 0.0


def check_intersect(geometry, start, seg) -> dict:
    """Kernel 1 against :func:`cuda_trace.plain_intersect` on CUDA rays."""
    scene = cuda_trace.HostScene(geometry)
    k = cuda_trace.launch_intersect(scene, start, seg)
    p = cuda_trace.plain_intersect(scene, start, seg)
    torch.cuda.synchronize()
    hit = p[0] < INVALID_PARAM
    rep = dict(
        lanes=start.shape[0],
        hit_fraction=hit.float().mean().item(),
        t_close=_frac_close(k[0], p[0], 1e-5, 1e-6),
        normal_close=_frac_close(k[1], p[1], 1e-5, 1e-6),
        uv_close=_frac_close(k[4], p[4], 1e-5, 1e-6),
        mat_equal=_frac_equal(k[2], p[2]),
        kind_equal=_frac_equal(k[3], p[3]),
        max_abs_err=max(_max_abs(k[0], p[0]), _max_abs(k[1], p[1])),
    )
    for key in ("t_close", "normal_close", "uv_close", "mat_equal", "kind_equal"):
        assert rep[key] >= FRACTION, (key, rep)
    return rep


def compare_paths(k, p, every: bool = False) -> dict:
    """Hold a kernel's TraceOutput ``k`` against the plain version's ``p``;
    with ``every``, at the bar on 100 % of values: radiance, normal and
    depth AOVs close, material AOVs and segment counts equal."""
    seg_k, seg_p = int(k.segments), int(p.segments)
    rep = dict(
        lanes=k.radiance.shape[0],
        radiance_close=_frac_close(k.radiance, p.radiance, 1e-4, 1e-5),
        radiance_bits_equal=_frac_equal(k.radiance, p.radiance),
        aov_mat_equal=_frac_equal(k.aov_mat, p.aov_mat),
        segments=seg_k,
        plain_segments=seg_p,
        segments_rel_diff=abs(seg_k - seg_p) / max(seg_p, 1),
        max_abs_err=_max_abs(k.radiance, p.radiance),
        radiance_mean=k.radiance.mean().item(),
    )
    assert np.isfinite(rep["radiance_mean"]), rep
    if not every:
        assert rep["radiance_close"] >= FRACTION, rep
        assert rep["aov_mat_equal"] >= FRACTION, rep
        assert rep["segments_rel_diff"] <= 1e-3, rep
        return rep
    rep["aov_normal_close"] = _frac_close(k.aov_normal, p.aov_normal, 1e-4, 1e-5)
    rep["aov_depth_close"] = _frac_close(k.aov_depth, p.aov_depth, 1e-4, 1e-5)
    rep["aovs_bits_equal"] = _frac_equal(
        torch.cat([k.aov_normal.reshape(-1), k.aov_depth]),
        torch.cat([p.aov_normal.reshape(-1), p.aov_depth]))
    for key in ("radiance_close", "aov_normal_close", "aov_depth_close", "aov_mat_equal"):
        assert rep[key] == 1.0, (key, rep)
    assert seg_k == seg_p, rep
    return rep


def _same_output(a, b) -> bool:
    """Two TraceOutputs equal bit for bit (and their walk counts, where
    kernel 13 gives them, and their texel fetch counts, where kernel 4
    does; not kernel 13's phase totals, which follow how the lanes fall
    into warps)."""
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in
               ("radiance", "aov_normal", "aov_depth", "aov_mat")) and (
        int(a.segments) == int(b.segments)) and all(
        (x is None) == (y is None) and (x is None or torch.equal(x, y))
        for x, y in ((a.walk, b.walk), (a.fetches, b.fetches)))


def _cat_outputs(a, b):
    """Two bands' outputs as one frame's: lane planes joined, totals added."""
    planes = {f: torch.cat([getattr(a, f), getattr(b, f)])
              for f in ("radiance", "aov_normal", "aov_depth", "aov_mat")}
    add = lambda x, y: None if x is None else x + y  # noqa: E731
    return a._replace(**planes, segments=a.segments + b.segments, walk=add(a.walk, b.walk),
                      phases=add(a.phases, b.phases), fetches=add(a.fetches, b.fetches))


def output_digest(out) -> str:
    """SHA-256 of a TraceOutput's lane planes (radiance, normal, depth,
    material, in that order, as bytes) and its segment count: two builds
    that agree bit for bit give the same digest."""
    import hashlib

    h = hashlib.sha256()
    for f in ("radiance", "aov_normal", "aov_depth", "aov_mat"):
        h.update(getattr(out, f).detach().cpu().contiguous().numpy().tobytes())
    h.update(str(int(out.segments)).encode())
    return h.hexdigest()


def check_lane_independence(tracer, seed: int, sample0: int, n: int, full) -> dict:
    """A camera-fused tracer's ``lane0`` band split (an uneven one: ragged
    tails in both halves) and a second launch over the whole frame, each
    against its first launch ``full``, bit for bit."""
    half = n // 2 + 37
    band = _cat_outputs(tracer(seed, sample0, lane0=0, n_lanes=half),
                        tracer(seed, sample0, lane0=half, n_lanes=n - half))
    again = tracer(seed, sample0)
    torch.cuda.synchronize()
    rep = dict(band_split_exact=_same_output(band, full),
               relaunch_bit_equal=_same_output(again, full))
    assert rep["band_split_exact"] and rep["relaunch_bit_equal"], rep
    return rep


def check_path_tracer(scene_pack, camera, cfg, seed: int, sample0: int = 0) -> dict:
    """Kernel 3 against :func:`cuda_path.build_path_core` on rays from
    :func:`generate_rays`, both on the card."""
    tracer = cuda_path.make_path_tracer(scene_pack, cfg, z_far=float(camera.z_far))
    start, seg, pix, smp = generate_rays(camera, cfg.width, cfg.height, cfg.spp,
                                         seed, sample0)
    k = tracer(start, seg, pix, smp, seed)
    core = cuda_path.PathBody(scene_pack, None, cfg, z_far=float(camera.z_far)).core()
    p = cuda_path.planes_to_output(core(
        rng.seed_hash(seed), start[:, 0], start[:, 1], start[:, 2],
        seg[:, 0], seg[:, 1], seg[:, 2], pix, smp))
    torch.cuda.synchronize()
    return compare_paths(k, p)


def check_camera_tracer(scene_pack, camera, cfg, seed: int, sample0: int = 0) -> dict:
    """Kernel 2 against :func:`cuda_path.build_fused_raygen` +
    :func:`cuda_path.build_path_core` on the card, on 100 % of values
    (:func:`compare_paths` with ``every``), and the ``lane0`` band split and
    a second launch against the full frame, bit for bit."""
    tracer = cuda_path.make_camera_path_tracer(scene_pack, camera, cfg)
    assert tracer.kernel is cuda_path.CAMERA_PATH, tracer.kernel.name
    k = tracer(seed, sample0)
    n = cfg.height * cfg.width * cfg.spp
    body = cuda_path.PathBody(scene_pack, camera, cfg)
    h0 = rng.seed_hash(seed)
    p = cuda_path.planes_to_output(body.core()(h0, *body.raygen(h0, sample0, 0, n, body.dev)))
    torch.cuda.synchronize()
    rep = compare_paths(k, p, every=True)
    rep.update(check_lane_independence(tracer, seed, sample0, n, k))
    return rep


def check_mesh_camera_tracer(scene_pack, camera, cfg, seed: int, sample0: int = 0) -> dict:
    """Kernel 13 against its plain version (``trace.plain``: the path body
    over :func:`ops.bvh.walk_bvh`) on the card: its counting build
    (``trace.counted``) on 100 % of values (:func:`compare_paths` with
    ``every``) and the walk's node steps and triangle tests equal, with its
    phase totals (``phases``: leaf phases, leaves tested in them, warp
    walks) in the report; its ``lane0`` band split and a second launch
    against the full frame, bit for bit; the build that counts nothing
    (``trace``) equal to the counting one, bit for bit."""
    tracer = cuda_path.make_camera_path_tracer(scene_pack, camera, cfg)
    assert tracer.kernel is cuda_path.MESH_CAMERA_PATH, tracer.kernel.name
    n = cfg.height * cfg.width * cfg.spp
    k = tracer.counted(seed, sample0)
    p = tracer.plain(seed, sample0, 0, n)
    torch.cuda.synchronize()
    rep = compare_paths(k, p, every=True)
    rep.update(walk=k.walk.tolist(), plain_walk=p.walk.tolist(), phases=k.phases.tolist())
    assert torch.equal(k.walk, p.walk), rep
    phases, leaves, walks = rep["phases"]
    assert phases <= leaves and 0 < walks <= rep["segments"], rep
    rep.update(check_lane_independence(tracer.counted, seed, sample0, n, k))
    uncounted = tracer(seed, sample0)
    rep["uncounted_bit_equal"] = _same_output(uncounted._replace(walk=k.walk), k)
    assert rep["uncounted_bit_equal"] and uncounted.walk is None and uncounted.phases is None, rep
    return rep


def check_deferred_tracer(scene_pack, camera, cfg, seed: int, sample0: int = 0) -> dict:
    """Kernel 4 (the slot fold in the kernel) against its plain version on
    the card, the fold of the plain slot planes (``trace.fold(
    trace.plain_planes(...))``), on 100 % of values (:func:`compare_paths`
    with ``every``), and the ``lane0`` band split and a second launch
    against the full frame, bit for bit."""
    tracer = cuda_path.make_camera_path_tracer(scene_pack, camera, cfg)
    assert tracer.kernel is cuda_path.DEFERRED_PATH, tracer.kernel.name
    n = cfg.height * cfg.width * cfg.spp
    k = tracer(seed, sample0)
    p = tracer.fold(tracer.plain_planes(seed, sample0, 0, n))
    torch.cuda.synchronize()
    rep = compare_paths(k, p, every=True)
    rep.update(check_lane_independence(tracer, seed, sample0, n, k))
    return rep


def check_deferred_counting(scene_pack, camera, cfg, seed: int, sample0: int = 0) -> dict:
    """Kernel 4's counting build (``trace.counted``) on the card: its
    surface and sky texel fetch counts equal those its plain version counts
    from its slot planes (``trace.fetch_counts``), its outputs equal the
    build that counts nothing bit for bit, and its ``lane0`` band split and
    a second launch against its full frame, bit for bit with the counts
    added.  The report gives the default build's :func:`output_digest`."""
    tracer = cuda_path.make_camera_path_tracer(scene_pack, camera, cfg)
    assert tracer.kernel is cuda_path.DEFERRED_PATH, tracer.kernel.name
    n = cfg.height * cfg.width * cfg.spp
    k = tracer(seed, sample0)
    c = tracer.counted(seed, sample0)
    plain = tracer.fetch_counts(tracer.plain_planes(seed, sample0, 0, n))
    torch.cuda.synchronize()
    rep = dict(fetches=c.fetches.tolist(), plain_fetches=plain.tolist(),
               segments=int(c.segments), digest=output_digest(k),
               counted_bit_equal=_same_output(c._replace(fetches=None), k))
    assert k.fetches is None and rep["fetches"] == rep["plain_fetches"], rep
    assert rep["counted_bit_equal"], rep
    rep.update(check_lane_independence(tracer.counted, seed, sample0, n, c))
    return rep


def _check_planes(rep, prefix, k, p):
    """Float planes close and int planes equal on ≥ FRACTION of values."""
    if k.dtype.is_floating_point:
        rep[f"{prefix}_close"] = _frac_close(k, p, 1e-4, 1e-5)
        rep["max_abs_err"] = max(rep.get("max_abs_err", 0.0), _max_abs(k, p))
    else:
        rep[f"{prefix}_close"] = _frac_equal(k, p)
    assert rep[f"{prefix}_close"] >= FRACTION, (prefix, rep)


def _grad_close(g, g_ref, rtol=1e-4):
    """|g − g_ref| within rtol of max |g_ref| everywhere; returns the ratio."""
    scale = float(g_ref.abs().max())
    err = float((g - g_ref).abs().max())
    assert err <= rtol * max(scale, 1e-30), (err, scale)
    return err / max(scale, 1e-30)


def check_affine_planes(scene_pack, camera, cfg, seed: int, sample0: int = 0, y0: int = 0,
                        rows=None) -> dict:
    """Kernel 7 against its plain version on the card over the frame rows
    ``y0 .. y0+rows-1`` (all by default): the slot planes, then the image
    through the fold and its gradients with respect to diffuse and emissive
    (and texels on a textured scene) by torch autograd."""
    planes = cuda_grad.make_affine_planes(scene_pack, camera, cfg)
    rows = cfg.height - y0 if rows is None else rows
    n = rows * cfg.width * cfg.spp
    lane0 = y0 * cfg.width * cfg.spp
    k = planes(seed, sample0, lane0, n)
    p = planes.plain(seed, sample0, lane0, n)
    torch.cuda.synchronize()
    rep = {"lanes": n}
    for name in k.fields:
        _check_planes(rep, name, k.fields[name], p.fields[name])
    _check_planes(rep, "mat", k.mat, p.mat)
    _check_planes(rep, "mat_e", k.mat_e, p.mat_e)
    _check_planes(rep, "p_light", k.p_light, p.p_light)
    seg_k, seg_p = int(k.segments), int(p.segments)
    rep.update(segments=seg_k, plain_segments=seg_p,
               segments_rel_diff=abs(seg_k - seg_p) / max(seg_p, 1))
    assert rep["segments_rel_diff"] <= 1e-3, rep
    rep["slot_max_abs_err"] = rep.pop("max_abs_err")

    table = scene_pack.materials
    names = ["diffuse", "emissive"] + (["texels"] if planes.mats.any_textured else [])
    base = {"diffuse": table.diffuse, "emissive": table.emissive,
            "texels": scene_pack.textures.texels}

    def image_and_grads(pl):
        leaves = {nm: base[nm].detach().clone().requires_grad_() for nm in names}
        tex = scene_pack.textures._replace(texels=leaves.get("texels", base["texels"]))
        zero = torch.zeros_like(pl.fields["s"])
        rad = torch.stack(cuda_path.fold_deferred_params(
            planes.mats, planes.bias, cfg, leaves["diffuse"], leaves["emissive"], table.glow,
            tex, pl.fields["s"], pl.fields["k"], pl.fields["se"], pl.mat, pl.mat_e,
            pl.fields.get("u", zero), pl.fields.get("v", zero), pl.p_light), dim=-1)
        img = rad.reshape(rows, cfg.width, cfg.spp, 3).mean(dim=2)
        grads = torch.autograd.grad((img ** 2).mean(), [leaves[nm] for nm in names])
        return img.detach(), dict(zip(names, grads))

    img_k, g_k = image_and_grads(k)
    img_p, g_p = image_and_grads(p)
    rep["image_close"] = _frac_close(img_k, img_p, 1e-4, 1e-5)
    assert rep["image_close"] >= FRACTION, rep
    rep["max_abs_err"] = _max_abs(img_k, img_p)
    rep["image_mean"] = img_k.mean().item()
    for nm in names:
        rep[f"grad_{nm}_rel_err"] = _grad_close(g_k[nm], g_p[nm])
    return rep


def check_fused_loss(scene_pack, camera, cfg, target, seed: int, frame_idx: int = 0,
                     params=None, fields=("diffuse", "emissive"), y0: int = 0,
                     rows=None) -> dict:
    """Kernel 8 affine against its plain version on the card (plain
    ``defer_all`` traces, the torch fold, the lane loss and
    ``torch.autograd.grad``) on the frame rows ``y0 .. y0+rows-1`` (all by
    default; ``target`` holds those rows only), and two launches bit for
    bit.

    The bar is held against the plain version with the parameters in
    float64, which folds the same float32 slots and sums the lanes exactly
    enough that only the kernel's own rounding shows; the float32 plain
    version's error against it is reported beside (its ``index_add`` sums
    millions of lanes per table row in float32, in no fixed order)."""
    fn = cuda_grad.make_fused_loss_grad_fn(scene_pack, camera, cfg, fields=fields)
    if params is None:
        params = {f: getattr(scene_pack.materials, f) for f in fields}
    rows = cfg.height - y0 if rows is None else rows
    loss_k, g_k, seg_k = fn(params, target, seed, frame_idx, y0, rows)
    loss_a, g_a, seg_a = fn(params, target, seed, frame_idx, y0, rows)
    loss_p, g_p, seg_p = fn.plain({f: v.double() for f, v in params.items()}, target,
                                  seed, frame_idx, y0, rows)
    loss_32, g_32, _ = fn.plain(params, target, seed, frame_idx, y0, rows)
    torch.cuda.synchronize()
    rep = dict(lanes=rows * cfg.width * cfg.spp, lane0=_band(cfg, y0, rows)[0],
               loss=float(loss_k), plain_loss=float(loss_p), segments=int(seg_k),
               plain_segments=int(seg_p))
    rep["bit_equal"] = bool(float(loss_a) == float(loss_k) and int(seg_a) == int(seg_k)
                            and all(torch.equal(g_a[f], g_k[f]) for f in g_k))
    assert rep["bit_equal"], rep
    rep["loss_rel_err"] = abs(rep["loss"] - rep["plain_loss"]) / max(abs(rep["plain_loss"]),
                                                                     1e-30)
    assert rep["loss_rel_err"] <= 1e-5, rep
    assert rep["segments"] == rep["plain_segments"], rep
    for f in fields:
        rep[f"grad_{f}_rel_err"] = _grad_close(g_k[f].double(), g_p[f])
        rep[f"plain_f32_grad_{f}_rel_err"] = (
            float((g_32[f].double() - g_p[f]).abs().max())
            / max(float(g_p[f].abs().max()), 1e-30))
    rep["max_abs_err"] = max(float((g_k[f].double() - g_p[f]).abs().max()) for f in fields)
    return rep


def _count(x):
    """A launch's device-side count as an int (None where no kernel ran)."""
    return None if x is None else int(x)


def _adjoint_close(g, g_ref, rtol=1e-3, floor=1e-5, atol=0.0):
    """Every entry of ``g`` within ``rtol`` of ``g_ref`` or within ``floor``
    of max |g_ref| (or ``atol``); returns the worst error over its allowance."""
    g, g_ref = g.double().reshape(-1), g_ref.double().reshape(-1)
    allow = torch.maximum(rtol * g_ref.abs(), torch.full_like(g_ref, max(
        floor * float(g_ref.abs().max()), atol, 1e-30)))
    ratio = float(((g - g_ref).abs() / allow).max())
    assert ratio <= 1.0, (ratio, g.tolist(), g_ref.tolist())
    return ratio


def _band(cfg, y0, rows):
    """The frame lanes of rows ``y0 .. y0+rows-1``: ``(lane0, n)``."""
    rows = cfg.height - y0 if rows is None else rows
    return y0 * cfg.width * cfg.spp, rows * cfg.width * cfg.spp


def _forward_report(rad_k, seg_k, rad_p, seg_p) -> dict:
    """Kernel 9's radiance ``[3, n]`` and per-lane segments against its plain
    version's: 100 % of values within the path bar, equal segments."""
    rep = dict(radiance_close=_frac_close(rad_k, rad_p, 1e-4, 1e-5),
               radiance_equal=_frac_equal(rad_k, rad_p),
               segments=int(seg_k.sum()), plain_segments=int(seg_p.sum()),
               segments_equal=_frac_equal(seg_k, seg_p),
               max_abs_err=_max_abs(rad_k, rad_p))
    assert rep["radiance_close"] == 1.0, rep
    assert rep["segments_equal"] == 1.0, rep
    return rep


def check_grad_forward(tracer, pvec, seed: int, sample0: int, lane0: int, n: int) -> dict:
    """Kernel 9 alone against its plain version, with no autograd (so at any
    size the plain body fits in memory): radiance at the path bar and every
    lane's segments equal (the report gives the equal and bit-equal shares
    of the radiance values), a second launch bit-equal to the first (the
    regenerating schedule reaches no result), and a third that writes the
    lanes' record bit-equal too (the record changes no arithmetic)."""
    rad_k, seg_k = tracer.kernel_forward(pvec, seed, sample0, lane0, n)
    rad_a, seg_a = tracer.kernel_forward(pvec, seed, sample0, lane0, n)
    rad_r, seg_r = tracer.kernel_forward(pvec, seed, sample0, lane0, n,
                                         record=tracer.new_record(n))
    with torch.no_grad():
        rad_p, seg_p = tracer.plain(pvec.detach(), seed, sample0, lane0, n)
    torch.cuda.synchronize()
    bits = lambda rad, seg: (torch.equal(rad_k.view(torch.int32), rad.view(torch.int32))
                             and torch.equal(seg_k, seg))
    rep = dict(lanes=n, lane0=lane0, params=tracer.n_params,
               radiance_bits_equal=_frac_equal(rad_k.view(torch.int32),
                                               rad_p.view(torch.int32)),
               relaunch_equal=bool(bits(rad_a, seg_a)), recorded_equal=bool(bits(rad_r, seg_r)),
               **_forward_report(rad_k, seg_k, rad_p, seg_p))
    assert rep["relaunch_equal"] and rep["recorded_equal"], rep
    return rep


def check_grad_path_tracer(scene_pack, camera, cfg, fields, seed: int, sample0: int = 0,
                           params=None, y0: int = 0, rows=None) -> dict:
    """Kernel 9 against its plain version (100 % of radiance values, equal
    segments) and kernel 10 against ``torch.autograd.grad`` of the plain
    version for a seeded radiance cotangent, through the autograd glue, on
    the frame rows ``y0 .. y0+rows-1`` (all by default), from ``params``
    (the table's columns by default).  The glue takes the sweep route (a
    band the card's memory holds); the remat route's launch on the same
    lanes gives the same gradient and non-finite count bit for bit."""
    tracer = cuda_grad.make_grad_path_tracer(scene_pack, camera, cfg, fields=fields)
    lane0, n = _band(cfg, y0, rows)
    if params is None:
        params = {f: getattr(scene_pack.materials, f) for f in fields}
    pvec = cuda_grad.pack_params(params, tracer.fields).detach().requires_grad_()
    sweeps, remats = cuda_grad.GRAD_SWEEP.launches, cuda_grad.GRAD_BACKWARD.launches
    out = tracer(pvec, seed, sample0, lane0, n)
    record_bytes = tracer.record_bytes
    planes_p, seg_p = tracer.plain(pvec.detach(), seed, sample0, lane0, n)
    cot = torch.from_numpy(np.random.default_rng(seed).normal(size=(3, n)).astype(
        np.float32)).to(pvec.device)
    (g_k,) = torch.autograd.grad((out.radiance.t() * cot).sum(), [pvec])
    nonfinite = _count(tracer.nonfinite)
    routes = dict(sweep=cuda_grad.GRAD_SWEEP.launches - sweeps,
                  remat=cuda_grad.GRAD_BACKWARD.launches - remats)
    g_again = tracer.kernel_backward(pvec, cot, seed, sample0, lane0, n)
    nonfinite_again = _count(tracer.nonfinite)
    g_p = tracer.plain_grad(pvec, cot, seed, sample0, lane0, n)
    torch.cuda.synchronize()
    rep = dict(lanes=n, lane0=lane0, params=tracer.n_params, routes=routes,
               record_bytes=record_bytes,
               bit_equal=bool(torch.equal(g_k, g_again) and nonfinite == nonfinite_again))
    assert routes == dict(sweep=1, remat=0), rep
    assert record_bytes == cuda_grad.record_bytes(n, cfg.effective_depth), rep
    assert rep["bit_equal"], rep
    rep.update(_forward_report(out.radiance.t(), out.segments, planes_p, seg_p.sum()))
    del rep["segments_equal"]  # the glue returns the sum only
    rep.update(grad_max_abs_err=float((g_k.double() - g_p).abs().max()),
               grad_max=float(g_p.abs().max()), nonfinite_lanes=nonfinite)
    assert rep["grad_max"] > 0, rep
    rep["grad_err_over_bar"] = _adjoint_close(g_k, g_p)
    return rep


def check_fused_loss_chain(scene_pack, camera, cfg, target, fields, seed: int,
                           frame_idx: int = 0, params=None, y0: int = 0, rows=None) -> dict:
    """Kernel 8's whole chain against its plain version (autograd of the two
    traces and the lane loss, lane sums in float64), and ``remat=True``
    against ``remat=False`` (the same kernel launched again: equal bit for
    bit), on the
    frame rows ``y0 .. y0+rows-1`` (all by default; ``target`` holds those
    rows only), from ``params`` (the table's columns and the camera by
    default)."""
    fn = cuda_grad.make_fused_loss_grad_fn(scene_pack, camera, cfg, fields=fields,
                                           affine=False)
    if params is None:
        params = {f: (cuda_path.camera_pvec(camera) if f == cuda_grad.CAMERA_FIELD
                      else getattr(scene_pack.materials, f)) for f in fields}
    rows = cfg.height - y0 if rows is None else rows
    loss_k, g_k, seg_k = fn(params, target, seed, frame_idx, y0, rows)
    nonfinite = fn.nonfinite
    remat = cuda_grad.make_fused_loss_grad_fn(scene_pack, camera, cfg, fields=fields,
                                              affine=False, remat=True)
    loss_r, g_r, seg_r = remat(params, target, seed, frame_idx, y0, rows)
    loss_p, g_p, seg_p = fn.plain(params, target, seed, frame_idx, y0, rows)
    torch.cuda.synchronize()
    rep = dict(lanes=rows * cfg.width * cfg.spp, lane0=_band(cfg, y0, rows)[0],
               params=cuda_grad.param_count(cuda_path.HostMaterials(scene_pack.materials),
                                            fields),
               loss=float(loss_k), plain_loss=float(loss_p), segments=int(seg_k),
               plain_segments=int(seg_p), nonfinite_lanes=_count(nonfinite))
    rep["loss_rel_err"] = abs(rep["loss"] - rep["plain_loss"]) / max(abs(rep["plain_loss"]),
                                                                     1e-30)
    assert rep["loss_rel_err"] <= 1e-5, rep
    assert rep["segments"] == rep["plain_segments"], rep
    rep["remat_equal"] = bool(float(loss_r) == float(loss_k) and int(seg_r) == int(seg_k)
                              and all(torch.equal(g_r[f], g_k[f]) for f in g_k))
    assert rep["remat_equal"], rep
    for f in g_k:
        camera_field = f == cuda_grad.CAMERA_FIELD
        rep[f"grad_{f}_err_over_bar"] = _adjoint_close(
            g_k[f], g_p[f], rtol=2e-3 if camera_field else 1e-3,
            atol=1e-7 if camera_field else 0.0)
    rep["max_abs_err"] = max(float((g_k[f].double() - g_p[f]).abs().max()) for f in g_k)
    return rep


def check_cull(F, tables) -> tuple:
    """Kernel 5 against its plain version on CUDA features ``F``: every key
    bit-equal (the float32 bits, so a zero's sign counts), two launches
    too.  Returns the report and both keys."""
    key_k = cuda_bvh.launch_cull(F, tables)
    again = cuda_bvh.launch_cull(F, tables)
    key_p = cuda_bvh.plain_cull(F, tables)
    torch.cuda.synchronize()
    bits_k, bits_p = key_k.view(torch.int32), key_p.view(torch.int32)
    rep = dict(key_equal=_frac_equal(bits_k, bits_p),
               relaunch_equal=bool(torch.equal(bits_k, again.view(torch.int32))),
               live_rays=int((F[:, 10] > 0).sum()),
               culled_fraction=(key_p >= cuda_bvh.BIG).float().mean().item())
    assert rep["key_equal"] == 1.0 and rep["relaunch_equal"], rep
    return rep, key_k, key_p


def check_treelet_kernels(traverser, start, seg, t_init) -> dict:
    """Kernels 5 and 6 against their plain versions on CUDA rays, as the
    mesh intersector feeds them (sorted, seeded): every output equal, every
    key of the cull bit-equal."""
    tables = traverser.tables
    F = cuda_bvh.ray_features(start, seg, t_init)
    cull_rep, key_k, key_p = check_cull(F, tables)
    ck, ok_, tk = cuda_bvh.order_from_key(key_k)
    cp, op, tp = cuda_bvh.order_from_key(key_p)
    t_k, best_k, vis_k = cuda_bvh.launch_sweep(cp, op, tp, F, tables)
    t_p, best_p, vis_p = cuda_bvh.plain_sweep(cp, op, tp, F, tables)
    torch.cuda.synchronize()
    n_leaves = tables.n_leaves
    # Only the first counts[b] entries of a row are leaves; the rest are pads.
    listed = torch.arange(n_leaves, device=cp.device)[None, :] < cp[:, None].long()
    rep = dict(
        rays=start.shape[0], blocks=int(cp.shape[0]), leaves=n_leaves,
        live_fraction=(t_init > 0).float().mean().item(),
        key_equal=cull_rep["key_equal"],
        counts_equal=_frac_equal(ck, cp),
        order_equal=_frac_equal(ok_[listed], op[listed]),
        tlo_equal=_frac_equal(tk[listed], tp[listed]),
        t_equal=_frac_equal(t_k, t_p),
        best_equal=_frac_equal(best_k, best_p),
        visits_equal=_frac_equal(vis_k, vis_p),
        hit_fraction=(best_p[:start.shape[0]] >= 0).float().mean().item(),
        mean_survivors=cp.float().mean().item(),
        mean_visits=vis_p.float().mean().item(),
        max_visits=int(vis_p.max()),
        max_abs_err=_max_abs(t_k, t_p),
    )
    for key in ("counts_equal", "order_equal", "tlo_equal", "t_equal", "best_equal",
                "visits_equal"):
        assert rep[key] == 1.0, (key, rep)
    return rep


def check_mesh_frame(scene_pack, camera, cfg, seed: int, sample0: int = 0,
                     queue: int = 1 << 18) -> dict:
    """One queued mesh frame on the kernel path (kernels 1, 5, 6) against
    the same frame with their plain versions, both on the card."""
    from fspt_tpu_torch.render.queue import render_queued

    outs = [render_queued(scene_pack, camera, cfg, seed, sample0, queue=queue,
                          intersector=cuda_bvh.make_mesh_intersector(scene_pack, plain=plain))
            for plain in (False, True)]
    torch.cuda.synchronize()
    rep = compare_paths(*outs)
    assert rep["segments"] == rep["plain_segments"], rep
    return rep


def _walk_report(k, p, names) -> dict:
    """Bit-equal share of each output of a walk, kernel against plain (float
    outputs compared by their bits)."""
    bits = lambda a: a.view(torch.int32) if a.is_floating_point() else a  # noqa: E731
    return {f"{name}_equal": _frac_equal(bits(a), bits(b)) for name, a, b in zip(names, k, p)}


def check_bvh_walk(traverser, start, seg, t_init) -> dict:
    """Kernel 11 against :func:`ops.bvh.walk_bvh` on the same CUDA rays
    (``traverser`` from ``cuda_bvh.make_bvh_traverser``): every output (t,
    ids, u, v, the nodes and the triangles each ray tested) equal on every
    ray."""
    from fspt_tpu_torch.ops.bvh import walk_bvh

    bvh = traverser.bvh
    max_leaf = int(bvh.count.max())
    k = cuda_bvh.launch_bvh_walk(traverser.tables, start, seg, t_init)
    p = walk_bvh(bvh, start, seg, t_init, max_leaf)
    torch.cuda.synchronize()
    hit = p[1] >= 0
    rep = dict(rays=start.shape[0], live_fraction=(t_init > 0).float().mean().item(),
               hit_fraction=hit.float().mean().item(),
               t_close=_frac_close(k[0], p[0], 1e-5, 1e-7),
               ids_equal_on_hits=_frac_equal(k[1][hit], p[1][hit]),
               mean_visits=p[4].float().mean().item(), max_visits=int(p[4].max()),
               mean_tested=p[5].float().mean().item(),
               max_abs_err=_max_abs(k[0], p[0]))
    names = ("t", "ids", "u", "v", "visits", "tested")
    rep.update(_walk_report(k, p, names))
    for key in ("t_close", "ids_equal_on_hits", *(f"{name}_equal" for name in names)):
        assert rep[key] == 1.0, (key, rep)
    return rep


def check_treelet_walk(traverser, start, seg, t_init) -> dict:
    """Kernel 12 against :func:`cuda_bvh.plain_treelet_walk` on the same
    CUDA rays (``traverser`` from ``cuda_bvh.make_treelet_traverser``): the
    raw walk outputs (t, best, the nodes and the triangles each ray tested)
    equal on every padded row, and ``(t, tri_id, u)`` after
    :func:`cuda_bvh.post`."""
    wt = traverser.walk_tables
    n = start.shape[0]
    F = cuda_bvh.ray_features(start, seg, t_init)
    k = cuda_bvh.launch_treelet_walk(F, wt)
    p = cuda_bvh.plain_treelet_walk(F, wt)
    torch.cuda.synchronize()
    post_k, post_p = (cuda_bvh.post(wt.tables, start, seg,
                                    torch.where(w[1][:n] >= 0, w[0][:n], t_init), w[1][:n])
                      for w in (k, p))
    hit = post_p[1] >= 0
    rep = dict(rays=n, live_fraction=(t_init > 0).float().mean().item(),
               hit_fraction=hit.float().mean().item(),
               t_close=_frac_close(post_k[0], post_p[0], 1e-4, 1e-6),
               ids_equal_on_hits=_frac_equal(post_k[1][hit], post_p[1][hit]),
               u_close_on_hits=_frac_close(post_k[2][hit], post_p[2][hit], 1e-3, 1e-4),
               mean_visits=p[2].float().mean().item(), max_visits=int(p[2].max()),
               mean_tested=p[3].float().mean().item(),
               max_abs_err=_max_abs(post_k[0], post_p[0]))
    names = ("t", "best", "visits", "tested")
    rep.update(_walk_report(k, p, names))
    for key in ("t_close", "ids_equal_on_hits", "u_close_on_hits",
                *(f"{name}_equal" for name in names)):
        assert rep[key] == 1.0, (key, rep)
    return rep
