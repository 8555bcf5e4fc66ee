"""Queued wavefront integrator: ray regeneration for full-occupancy bounces.

Port of fspt_tpu/render/queue.py.  The unrolled bounce loop
(render/integrator.py) intersects the full ``rows·W·spp`` wavefront at every
depth, though after the primary bounce only a fraction of the lanes is
alive.  Here the same computation runs through a fixed-size ray queue:
each iteration refills dead slots with fresh primary rays, traces one
segment for every live lane and scatters finished lanes' radiance to their
output row (persistent-threads wavefront path tracing, Laine et al. 2013).

The reference's ``lax.while_loop`` is a Python loop with one host sync per
iteration, on ``(cursor < limit) | any(alive)``.  Every scatter has defined
semantics (the reference's ``scatter_unique``): a dropped lane writes its
own pad row past the end, so no two lanes of an iteration share a row.

Equivalence with the unrolled loop is deterministic: a lane's RNG streams
are keyed by (seed, pixel, sample, depth), none of which depend on the
schedule, and each output row is owned by one lane lineage.  The two agree
to float rounding (tests/test_torch_queue.py).

``warm`` (from :func:`warm_frame`) resolves depth 0 outside the queue: the
first-hit cache.  ``cfg.edge_eps > 0`` (edge reparameterization) rides
per-lane masks like every other quirk, and ``record_hits`` scatters each
traced segment's winner id into an ``[N, D]`` record: what the two-phase
vertex recovery (parallel/train.make_bvh_vertex_recovery_step) replays.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fspt_tpu_torch import materials as mat_mod
from fspt_tpu_torch.camera import Camera, rays_for_lanes
from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.ops import rng
from fspt_tpu_torch.ops.intersect import Hit
from fspt_tpu_torch.render.integrator import TraceOutput, edge_reparameterize
from fspt_tpu_torch.scene.builder import ScenePack
from fspt_tpu_torch.utils import vecmath as vm

DEFAULT_QUEUE = 1 << 18


def _intersect(intersector, o, d, alive):
    if getattr(intersector, "accepts_alive", False):
        return intersector(o, d, alive)
    return intersector(o, d)


def render_queued(scene: ScenePack, camera: Camera, cfg: RenderConfig,
                  seed, sample0, y0=0, rows=None, *, intersector,
                  queue: int = DEFAULT_QUEUE, aovs: bool = True,
                  record_hits: bool = False, cam_sample0=None, warm=None):
    """Render a band through a regenerating ray queue of ``queue`` lanes.

    Drop-in for ``integrator.render_wavefront``.  ``aovs=False`` skips the
    AOV scatter buffers (zeros returned) for radiance-only consumers such as
    the vertex recorder (the reference's ``aovs``).  ``cam_sample0``
    decouples the camera sample counter (jitter and lens uniforms) from the
    bounce counter ``sample0``; frames that freeze it re-trace identical
    primary rays.
    ``warm`` (from :func:`warm_frame`, same ``cam_sample0``) resolves depth
    0 outside the queue: misses and light hits land in pre-filled output
    rows and only possibly-alive lanes enqueue, at depth 1.  It needs
    ``cfg.effective_depth >= 2``, no fast render, ``edge_eps == 0`` and no
    ``record_hits``.  The returned ``segments`` then include the ``n``
    cache-served depth-0 segments.

    With ``record_hits=True`` the intersector must give ``Hit.prim_id``, and
    the result is ``(TraceOutput, (ids [N, D] int32, hit [N, D] bool))``:
    row ``(lane, d)`` holds the winner id and hit flag of the lane's
    depth-``d`` segment (−1 / False where none was traced), ``D =
    cfg.effective_depth``.
    """
    if warm is not None and (cfg.effective_depth < 2 or cfg.fast_render
                             or cfg.edge_eps != 0.0 or record_hits):
        raise ValueError("warm start needs effective_depth >= 2, no fast render, "
                         "edge_eps == 0 and no record_hits")
    if rows is None:
        rows = cfg.height
    if cam_sample0 is None:
        cam_sample0 = sample0
    n = rows * cfg.width * cfg.spp
    q = min(queue, n)
    table, tex = scene.materials, scene.textures
    dev = table.mtype.device
    z_far = camera.z_far
    eff_depth = cfg.effective_depth
    limit = n if warm is None else warm["n_live"]
    iota = torch.arange(q, dtype=torch.int64, device=dev)

    def scatter(buf, mask, idx, val, pad_base=n):
        """Rows ``idx`` of the masked lanes get ``val``; every other lane
        writes its own pad row ``pad_base + lane``."""
        tgt = torch.where(mask & (idx >= 0), idx.to(torch.int64), pad_base + iota)
        buf[tgt] = val
        return buf

    f32 = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    st = dict(
        o=f32(q, 3), d=f32(q, 3), radiance=f32(q, 3), throughput=f32(q, 3),
        lane_id=torch.full((q,), -1, dtype=torch.int64, device=dev),
        depth=torch.zeros((q,), dtype=torch.int64, device=dev),
        alive=torch.zeros((q,), dtype=torch.bool, device=dev),
        plh=torch.zeros((q,), dtype=torch.bool, device=dev),
        fog_active=torch.zeros((q,), dtype=torch.bool, device=dev),
        fog_from=f32(q, 3), fog_diffuse=f32(q, 3), fog_density=f32(q), fog_u=f32(q),
        cursor=torch.zeros((), dtype=torch.int64, device=dev),
        segments=torch.zeros((), dtype=torch.int64, device=dev))
    pad = lambda a: torch.cat([a, torch.zeros((q,) + tuple(a.shape[1:]), dtype=a.dtype,
                                              device=dev)])
    rad_buf = f32(n + q, 3) if warm is None else pad(warm["radiance_init"])
    if not aovs:
        aov_n, aov_d = f32(n, 3), f32(n)
        aov_m = torch.zeros((n,), dtype=torch.int32, device=dev)
    elif warm is None:
        aov_n, aov_d = f32(n + q, 3), f32(n + q)
        aov_m = torch.zeros((n + q,), dtype=torch.int32, device=dev)
    else:
        aov_n, aov_d = pad(warm["aov_normal"]), pad(warm["aov_depth"])
        aov_m = pad(warm["aov_mat"].to(torch.int32))
    if record_hits:
        # q pad rows past the n·D record rows, one per queue slot.
        rec_ids = torch.full((n * eff_depth + q,), -1, dtype=torch.int32, device=dev)
        rec_hit = torch.zeros((n * eff_depth + q,), dtype=torch.bool, device=dev)

    def refill(st):
        """Fresh primary rays into dead slots, in lane-id order."""
        dead = ~st["alive"]
        new_id = st["cursor"] + torch.cumsum(dead.to(torch.int64), 0) - 1
        has = dead & (new_id < n)
        lane_id = torch.where(has, new_id, torch.where(dead, -1, st["lane_id"]))
        o_new, d_new, _, _ = rays_for_lanes(camera, cfg.width, cfg.height, cfg.spp,
                                            seed, cam_sample0,
                                            torch.clamp(lane_id, min=0), y0=y0)
        h3 = has[:, None]
        st["o"] = torch.where(h3, o_new, st["o"])
        st["d"] = torch.where(h3, d_new, st["d"])
        st["lane_id"] = lane_id
        st["depth"] = torch.where(has, 0, st["depth"])
        st["radiance"] = torch.where(h3, 0.0, st["radiance"])
        st["throughput"] = torch.where(h3, 1.0, st["throughput"])
        st["alive"] = st["alive"] | has
        st["plh"] = st["plh"] & ~has
        st["fog_active"] = st["fog_active"] & ~has
        st["cursor"] = st["cursor"] + has.sum()

    def refill_warm(st):
        """Post-primary (depth-1) lanes into dead slots: ids from the
        pose-frozen enqueue order, state from the per-frame warm table.
        Lanes whose depth-0 shade ends the path arrive dead (their radiance
        is already in the pre-filled rows) and free the slot next time."""
        dead = ~st["alive"]
        new_idx = st["cursor"] + torch.cumsum(dead.to(torch.int64), 0) - 1
        has = dead & (new_idx < warm["n_live"])
        src = warm["ids"][torch.where(has, new_idx, 0)].to(torch.int64)
        row = warm["state"][torch.where(has, src, 0)]  # [q, 22]
        h3 = has[:, None]
        st["o"] = torch.where(h3, row[:, 0:3], st["o"])
        st["d"] = torch.where(h3, row[:, 3:6], st["d"])
        st["radiance"] = torch.where(h3, row[:, 6:9], st["radiance"])
        st["throughput"] = torch.where(h3, row[:, 9:12], st["throughput"])
        st["lane_id"] = torch.where(has, src, torch.where(dead, -1, st["lane_id"]))
        st["depth"] = torch.where(has, 1, st["depth"])
        st["alive"] = st["alive"] | (has & (row[:, 21] > 0.5))
        st["plh"] = st["plh"] & ~has
        st["fog_active"] = torch.where(has, row[:, 12] > 0.5, st["fog_active"])
        st["fog_from"] = torch.where(h3, row[:, 13:16], st["fog_from"])
        st["fog_diffuse"] = torch.where(h3, row[:, 16:19], st["fog_diffuse"])
        st["fog_density"] = torch.where(has, row[:, 19], st["fog_density"])
        st["fog_u"] = torch.where(has, row[:, 20], st["fog_u"])
        st["cursor"] = st["cursor"] + has.sum()

    while bool((st["cursor"] < limit) | st["alive"].any()):
        refill(st) if warm is None else refill_warm(st)
        o, d, alive, depth = st["o"], st["d"], st["alive"], st["depth"]
        radiance, throughput = st["radiance"], st["throughput"]
        st["segments"] = st["segments"] + alive.sum()
        hit = _intersect(intersector, o, d, alive)

        lane_id = st["lane_id"]
        if record_hits:
            ridx = lane_id * eff_depth + depth
            scatter(rec_ids, alive, ridx, hit.prim_id.to(torch.int32), n * eff_depth)
            scatter(rec_hit, alive, ridx, hit.hit, n * eff_depth)
        pix = ((torch.div(lane_id, cfg.width * cfg.spp, rounding_mode="floor") + y0)
               * cfg.width + torch.remainder(
                   torch.div(lane_id, cfg.spp, rounding_mode="floor"), cfg.width))
        smp = torch.remainder(lane_id, cfg.spp) + int(sample0)

        side = vm.dot(hit.normal, o - hit.point)
        normal = torch.where((side < 0.0)[:, None], -hit.normal, hit.normal)

        # Deferred depth-0 fog resolves on the lane's next segment.
        light_pos = torch.where(hit.hit[:, None], hit.point, o + d)
        dist = vm.length(light_pos - st["fog_from"])
        thresh = torch.clamp(dist * dist * st["fog_density"] * 0.00005, 0.0, 1.0)
        absorbed = st["fog_active"] & (st["fog_u"] < thresh) & (depth >= 1)
        radiance = radiance + torch.where((absorbed & alive)[:, None],
                                          throughput * st["fog_diffuse"], 0.0)
        alive = alive & ~absorbed
        fog_active = st["fog_active"] & (depth < 1)

        miss = alive & ~hit.hit
        view_dir = vm.normalize(d)
        sky_rgb = mat_mod.sample_sky(table, tex, scene.sky_mat, view_dir)
        radiance = radiance + torch.where(miss[:, None], throughput * sky_rgb, 0.0)

        active = alive & hit.hit
        view = vm.normalize(hit.point - o)
        uniforms = rng.bounce_uniforms(seed, pix, smp, depth, cfg.bounce_slots)
        sh = mat_mod.shade(table, tex, hit.mat, view, normal, hit.texcoords, uniforms)
        if cfg.edge_eps > 0.0 and hit.edge_dist is not None:
            throughput, sh = edge_reparameterize(cfg, hit.edge_dist, active, d, sh,
                                                 rng.edge_uniform(seed, pix, smp, depth),
                                                 throughput)

        at0 = depth == 0
        if aovs:
            scatter(aov_n, at0, lane_id, torch.where(hit.hit[:, None], normal, view_dir))
            scatter(aov_d, at0, lane_id,
                    torch.where(hit.hit, vm.length(hit.point - o), z_far))
            scatter(aov_m, at0, lane_id, torch.where(
                hit.hit, hit.mat, scene.sky_mat.to(torch.int32)).to(torch.int32))
        plh = torch.where(at0, hit.hit & sh.is_light, st["plh"])
        mark = active & sh.is_fog & at0
        st["fog_active"] = fog_active | mark
        st["fog_from"] = torch.where(mark[:, None], hit.point, st["fog_from"])
        st["fog_diffuse"] = torch.where(mark[:, None], sh.fog_diffuse, st["fog_diffuse"])
        st["fog_density"] = torch.where(mark, sh.fog_density, st["fog_density"])
        st["fog_u"] = torch.where(mark, uniforms[:, 3], st["fog_u"])

        radiance = radiance + torch.where(active[:, None], throughput * sh.bias, 0.0)
        throughput = torch.where(active[:, None], throughput * sh.coef, throughput)

        new_o = hit.point + sh.direction * cfg.ray_offset
        new_d = sh.direction * (z_far - cfg.ray_offset)
        st["o"] = torch.where(active[:, None], new_o, o)
        st["d"] = torch.where(active[:, None], new_d, d)

        was_live = st["alive"]
        alive = active & sh.will_indirect
        depth = torch.where(was_live, depth + 1, depth)
        capped = alive & (depth >= eff_depth)
        if cfg.fast_render:
            radiance = radiance + torch.where(capped[:, None], throughput, 0.0)
        alive = alive & ~capped

        # Depth-0 light tone clamp at lane death (integrator semantics).
        died = was_live & ~alive
        norm2 = torch.sqrt(torch.clamp(vm.dot(radiance, radiance), min=1e-20))
        scale = torch.where(plh & (norm2 > cfg.light_clamp), cfg.light_clamp / norm2, 1.0)
        scatter(rad_buf, died, lane_id, radiance * scale[:, None])

        st.update(radiance=radiance, throughput=throughput, depth=depth, alive=alive,
                  plh=plh)

    segments = st["segments"] + (n if warm is not None else 0)
    out = TraceOutput(radiance=rad_buf[:n], aov_normal=aov_n[:n], aov_depth=aov_d[:n],
                      aov_mat=aov_m[:n], segments=segments)
    if record_hits:
        return out, (rec_ids[:n * eff_depth].reshape(n, eff_depth),
                     rec_hit[:n * eff_depth].reshape(n, eff_depth))
    return out


def compute_first_hits(scene: ScenePack, camera: Camera, cfg: RenderConfig,
                       seed, cam_sample0, *, intersector, y0=0, rows=None,
                       chunk: int = DEFAULT_QUEUE) -> Hit:
    """Depth-0 collision of every lane of a band (frozen camera stream
    ``cam_sample0``), traced ``chunk`` lanes at a time: the first-hit
    G-buffer (reference ImagePlaneCache, engine.cpp:33-105)."""
    if rows is None:
        rows = cfg.height
    n = rows * cfg.width * cfg.spp
    dev = scene.materials.mtype.device
    parts = []
    for a in range(0, n, chunk):
        lanes = torch.arange(a, min(a + chunk, n), dtype=torch.int32, device=dev)
        o, d, _, _ = rays_for_lanes(camera, cfg.width, cfg.height, cfg.spp, seed,
                                    cam_sample0, lanes, y0=y0)
        parts.append(_intersect(intersector, o, d,
                                torch.ones(lanes.shape, dtype=torch.bool, device=dev)))
    return Hit(*(None if f[0] is None else torch.cat(f) for f in zip(*parts)))


class WarmPose(NamedTuple):
    """The pose-frozen half of the warm start: the first-hit G-buffer, the
    enqueue order (hit, non-light lanes first), the pre-filled radiance of
    the lanes that end at depth 0 whatever the frame (miss → sky, light hit
    → clamped emission) and the depth-0 AOVs."""

    first_hits: Hit  # [n]
    ids: torch.Tensor  # [n] enqueue-ordered lane ids
    n_live: torch.Tensor  # [] count of enqueued lanes
    prefill: torch.Tensor  # [n,3]
    aov_normal: torch.Tensor
    aov_depth: torch.Tensor
    aov_mat: torch.Tensor


def _primary_rays(camera, cfg, n, seed, cam_sample0, y0, dev):
    lanes = torch.arange(n, dtype=torch.int32, device=dev)
    o, d, _, _ = rays_for_lanes(camera, cfg.width, cfg.height, cfg.spp, seed,
                                cam_sample0, lanes, y0=y0)
    return lanes.to(torch.int64), o, d


def compute_warm_pose(scene: ScenePack, camera: Camera, cfg: RenderConfig,
                      seed, cam_sample0, *, intersector, y0=0, rows=None,
                      chunk: int = DEFAULT_QUEUE) -> WarmPose:
    """Build the pose-frozen warm-start bundle (one intersection pass)."""
    if rows is None:
        rows = cfg.height
    n = rows * cfg.width * cfg.spp
    table, tex = scene.materials, scene.textures
    dev = table.mtype.device
    fh = compute_first_hits(scene, camera, cfg, seed, cam_sample0,
                            intersector=intersector, y0=y0, rows=rows, chunk=chunk)
    _, o, d = _primary_rays(camera, cfg, n, seed, cam_sample0, y0, dev)
    view_dir = vm.normalize(d)
    side = vm.dot(fh.normal, o - fh.point)
    normal = torch.where((side < 0.0)[:, None], -fh.normal, fh.normal)
    view = vm.normalize(fh.point - o)
    # is_light depends only on the material row, and a light's bias is its
    # emission: no uniform reaches either, so zeros are exact here.
    sh0 = mat_mod.shade(table, tex, fh.mat, view, normal, fh.texcoords,
                        torch.zeros((n, 4), dtype=torch.float32, device=dev))
    light_hit = fh.hit & sh0.is_light
    enqueue = fh.hit & ~sh0.is_light
    ids = torch.argsort((~enqueue).to(torch.int8), stable=True)
    sky_rgb = mat_mod.sample_sky(table, tex, scene.sky_mat, view_dir)
    r_light = sh0.bias
    norm2 = torch.sqrt(torch.clamp(vm.dot(r_light, r_light), min=1e-20))
    scale = torch.where(norm2 > cfg.light_clamp, cfg.light_clamp / norm2, 1.0)
    prefill = (torch.where(~fh.hit[:, None], sky_rgb, 0.0)
               + torch.where(light_hit[:, None], r_light * scale[:, None], 0.0))
    return WarmPose(
        first_hits=fh, ids=ids, n_live=enqueue.sum(), prefill=prefill,
        aov_normal=torch.where(fh.hit[:, None], normal, view_dir),
        aov_depth=torch.where(fh.hit, vm.length(fh.point - o), camera.z_far),
        aov_mat=torch.where(fh.hit, fh.mat, scene.sky_mat.to(torch.int32)).to(torch.int32))


def warm_frame(scene: ScenePack, camera: Camera, cfg: RenderConfig,
               pose: WarmPose, seed, sample0, cam_sample0, y0=0, rows=None) -> dict:
    """The per-frame half: depth-0 shading of the frozen hits (the bounce
    stream advances with ``sample0``), packed into the ``warm`` table of
    :func:`render_queued`.  No intersections.  ``state`` rows [n, 22]: o
    0:3, d 3:6, radiance 6:9, throughput 9:12, fog_active 12, fog_from
    13:16, fog_diffuse 16:19, fog_density 19, fog_u 20, alive 21."""
    if rows is None:
        rows = cfg.height
    n = rows * cfg.width * cfg.spp
    table, tex = scene.materials, scene.textures
    dev = table.mtype.device
    fh = pose.first_hits
    lanes, o, d = _primary_rays(camera, cfg, n, seed, cam_sample0, y0, dev)
    pix = ((torch.div(lanes, cfg.width * cfg.spp, rounding_mode="floor") + y0) * cfg.width
           + torch.remainder(torch.div(lanes, cfg.spp, rounding_mode="floor"), cfg.width))
    smp = torch.remainder(lanes, cfg.spp) + int(sample0)
    uniforms = rng.bounce_uniforms(seed, pix, smp, 0, cfg.bounce_slots)
    side = vm.dot(fh.normal, o - fh.point)
    normal = torch.where((side < 0.0)[:, None], -fh.normal, fh.normal)
    view = vm.normalize(fh.point - o)
    sh = mat_mod.shade(table, tex, fh.mat, view, normal, fh.texcoords, uniforms)
    new_o = fh.point + sh.direction * cfg.ray_offset
    new_d = sh.direction * (camera.z_far - cfg.ray_offset)
    enqueue = fh.hit & ~sh.is_light
    alive1 = enqueue & sh.will_indirect
    mark = enqueue & sh.is_fog
    fl = lambda b: b.to(torch.float32)[:, None]
    state = torch.cat([
        new_o, new_d, sh.bias, sh.coef, fl(mark),
        torch.where(mark[:, None], fh.point, 0.0), sh.fog_diffuse,
        sh.fog_density[:, None], uniforms[:, 3:4], fl(alive1)], dim=1)
    # Lanes that end at depth 0 this frame (a non-light hit that does not
    # continue) add their bias to the pose prefill (no clamp: not a light).
    patch = torch.where((enqueue & ~alive1)[:, None], sh.bias, 0.0)
    return dict(ids=pose.ids, n_live=pose.n_live, state=state,
                radiance_init=pose.prefill + patch, aov_normal=pose.aov_normal,
                aov_depth=pose.aov_depth, aov_mat=pose.aov_mat)
