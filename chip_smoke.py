#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fspt_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each announced by one line:

1. card: device name, and name + power limit from nvidia-smi;
2. build: nvcc builds the kernels from fspt_tpu_torch/csrc (seconds,
   registers and spills of each kernel from ``-Xptxas -v``);
3-5. each kernel against its plain PyTorch version on the card
   (fspt_tpu_torch/ops/kernel_check.py): the intersect kernel on 1 M random
   segments; the rays-in and camera-fused path kernels on an
   all-nine-families scene at 256×256, 4 spp, depth 8 (the latter with
   depth of field, on 100 % of values, and a lane0 band split and a second
   launch that must be bit-exact);
6. main path: ``fspt_tpu_torch.cli`` renders scenes/cornell.scene at
   1024×1024, 4 spp, depth 8, 4 frames; the camera-fused kernel's launch
   count must rise by 4 and the image must be lit;
7. the dispatch path (camera-dynamic steps through the intersect kernel)
   and the rays-in path (generate_rays + the rays-in kernel), two frames
   each at 512×512, with their kernels' launch counts checked;
8. timings at the headline size (flagship Cornell, 1024²×4 spp, depth 8)
   with CUDA events, beside the plain versions (each kernel is also held
   against its plain version at these shapes; kernel 2 on 100 % of values
   with its bit-equal share, its band split and a second launch bit for
   bit) and the bound (kernel 1 on 4,194,304 random segments, on the
   flagship and on all_primitives, with its grid); then the CLI's frame
   step end to end, and a profiler window for the device busy share;
8c. the 512-row limit (``samples.flagship_rows``: the flagship and 498
   spheres, 69.6 KB of staged rows): kernels 1 and 7's registers, spill,
   stack and shared memory; kernel 1 against its plain version on the 4 M
   segments, timed beside its bound; kernel 7 against its plain version
   at 128×128, 2 spp, depth 4;
9. kernel 4 (texture-deferred camera-fused, the texel fold in the kernel)
   against the fold of its plain slot planes on the textured all-families
   scene at 256×256, 4 spp, depth 8, with DoF, fast render off and on: on
   100 % of values, the lane0 split and a second launch bit for bit;
10. kernel 7 (affine slot planes) against its plain version on the same
   scene, fast-render off and on, then image and gradients through the
   fold; kernel 8 (fused dual-buffer loss, affine) against its plain version
   on the flagship at 256×256, 4 spp, depth 8, two launches bit for bit;
11. textured main path: ``fspt_tpu_torch.cli`` renders a textured copy of
   scenes/cornell.scene (tests/data/piz_pattern.exr on two walls,
   piz_dome.exr on the sky) at 1024², 4 spp, depth 8, 4 frames; kernel 4's
   launch count must rise by 4 and the image must be lit;
12. training path at full width: ``make_fused_recovery_step`` on the
   flagship at 1920×1080, 4 spp, depth 8 — 5 steps at pool 1 with diffuse
   and emissive (kernel 8 affine, one launch per step) — then 3 steps of
   the texture example at 512² (kernel 7); every loss finite and falling;
13. timings of kernels 4, 7 and 8 at their main-path shapes beside their
   plain versions and bounds: kernel 4 on the textured cornell.scene at
   1024²×4, depth 8, held first against the fold of its plain planes over
   every lane (as phase 9) and then timed, with the textured frame step
   (kernel 4 + accumulate) and its profiler window, which must hold no
   device kernel beside kernel 4 that the untextured frame step does not
   run as often (no fold); kernel 8 affine at 1080p×4 against its plain
   version (two launches bit for bit), beside its bound, 2 × kernel 9 on
   the same lanes (the body's trace floor, on kernel 9's regenerating
   lanes); the pool-1 recovery step end to end (ms, device busy share,
   fwd+bwd segments/s, both buffers counted); kernel 8 affine at 64
   material rows and 16 slots (``samples.many_materials``, 512²×4, depth
   16) against its plain version, timed, with its plan's block; kernel 7,
   each against its plain version and timed beside its bound: at 1080p, on
   its 270-row band (2,073,600 lanes, the reference's affine_image
   operating point), at 64 rows and 16 slots, and at its launch shape, the
   texture example's 512²×4, depth 3 (its device time a launch from the
   profiler, and its wrapper call by CUDA events);
14. kernels 5 (treelet cull) and 6 (treelet sweep) against their plain
   versions on the mesh bench scene (``samples.heightfield``, 99,458
   triangles in 778 treelets): 65,536 camera primaries and one queue
   iteration's bounce rays, fed as the mesh intersector feeds them; every
   output must be equal;
15. the mesh frame at 256×256×1, depth 4, through the queue on the kernel
   path against the plain path (kernels 1, 5, 6 plain);
16. mesh main path: ``fspt_tpu_torch.cli`` renders the heightfield scene
   (written by ``samples.write_heightfield_scene``) at 1024×1024, 4 spp,
   depth 4, 3 frames — the ``heightfield-render`` cell's frame — on kernel
   13 (one launch a frame, no kernel 1, 5 or 6), then again with
   ``--first-hit-cache`` on the queue (kernels 1, 5 and 6 once per queue
   iteration); the images must be lit and their means close; then kernel
   13 against its plain version at that frame (every value, the walk's
   counts, the band split, the build that counts nothing bit for bit),
   timed beside the frozen mesh work count, with its counting build's cost;
17. mesh timings: the frame step (ms/frame, segments/s) through
   ``make_scene_step(queue=)`` at the reference's mesh_100k queue (1 << 17,
   bench.py:155; profiled) and at the port's default (1 << 18), kernels 5
   and 6 per launch on one full default-queue iteration (262,144 rays) of
   primaries and of bounce rays and per frame, the key sort, the post-pass,
   the queue's torch work, beside the plain versions and the bounds (every
   key of kernel 5 bit-equal); kernel 5's live rays and its CTA (threads,
   leaf boxes a thread); the p50 / p90 / p99 / max of kernel 6's leaf
   visits a block, its CTA shape and its shared memory;
18. kernels 9 (grad_forward), 10 (grad_sweep, the sweep of kernel 9's
   record, and grad_backward, remat: reverse mode) and kernel 8's whole
   chain (fused_loss_chain, reverse mode, and remat: the same kernel)
   against their plain versions (the body with run-time table tensors,
   under autograd) at 128×128, 2 spp, depth 4, thin-lens cameras: all
   families with the seven material fields, the flagship with
   diffuse/emissive/param and with the camera (alone and joint), kernel
   10's two routes and two launches of kernel 8 bit for bit; then the
   plain versions' and the kernels' times at that size;
19. training path at full width on the path-body adjoint: 4 steps at pool 1
   with diffuse, emissive, param and the camera (kernel 8 whole chain, one
   launch per step) and 4 at pool 8 with diffuse, emissive, param (kernels
   9 and 10's sweep route, two launches each per step); losses finite and
   falling;
20. the camera example (``examples/recover_camera``) at its default size
   for 40 iterations on kernel 8's whole chain; its loss must fall;
21. kernels 9, 10 and 8's whole chain against their plain versions at the
   full-width shape from the training start: kernel 9 over all 8,294,400
   lanes (every radiance bit and segment count equal), kernels 10 and 8
   (whose plain versions run under autograd) on a band of rows mid-frame,
   and launched twice over all 8,294,400 lanes, equal bit for bit (kernel
   10 by each route); then their timings there beside their bounds, both
   of kernel 10's routes (with kernel 9 with and without its record), the
   record's bytes and the share of the recovery's kernel-10 launches on
   the sweep route, kernel 9's grid and lane
   efficiency (segments / (lanes × depth); a replay of its regenerating
   schedule over the launch's per-lane segments is printed as a model
   estimate), and both adjoint recovery routes end to end;
22. vertex recovery at full width (the reference's ``mesh_grad_100k``
   bench row, bench.py:224-279): ``make_bvh_vertex_recovery_step`` on the
   heightfield (99,458 triangles) at 512×512, 2 spp, depth 2, edge_eps
   0.05, Adam over all vertices: one warm-up step, then 3 timed steps with
   the launches of kernels 1, 5 and 6 (phase 1, the record); then each
   step's phase 1 again on the params that step received, alone (timed)
   and with its rays kept (same winners), which gives the step's segments;
   ms per step and the record / replay + backward + Adam split, fwd+bwd
   segments/s (both buffers), peak memory, the loss;
23. the BVH vertex example (``examples/recover_vertices_bvh``) at its
   defaults; it must pass its own check;
24. on the segments the first timed step's phase 1 gave at depths 0 and 1
   (1,048,576 rays each): kernels 1, 5 and 6 against their plain versions
   on all of them, as the record fed them; kernels 11 (bvh_walk, the
   scene's fine BVH) and 12 (treelet_walk, a tree of 128-triangle leaves
   over the same triangles), seeded as kernel 6 is, against their plain
   versions on a 262,144-ray strided sample (every output bit-equal),
   against kernel 6's recorded winners on every live ray, and timed at the
   full count beside their bounds (from the nodes and triangles each ray
   tested), on the Morton-sorted rays and on the same rays unsorted; then
   the walks against the culled sweep on the same rays, at both depths and
   on phase 17's mid-frame queue iteration: the culled route (kernel 5,
   the key sort, kernel 6, post), kernel 11 and kernel 12 (with the ray
   features and post), each from the sorted, seeded rays to (t, id), the
   two walk routes from the same rays unsorted, and the Morton sort alone,
   by CUDA events, with each walk's ids against kernel 6's winners on the
   live rays;
25. kernel 1's launches on every path (dispatch, mesh frame, vertex
   step); one JSON line of per-kernel numbers, with phase 24's route times
   under ``walk_routes``;
26. the app layer's ``--denoise``: ``fspt_tpu_torch.cli --denoise`` renders
   scenes/cornell.scene at 1024×1024, 4 spp, depth 8, 4 frames; kernel 2
   launches 4 times and no other kernel, and the denoised image is lit;
27. the denoiser (render/denoiser.py, plain torch on the card) on the
   flagship framebuffer after 4 frames at 1024²×4, depth 8: the median of
   7 runs by CUDA events, and its output against the same ``denoise`` of
   the framebuffer copied to the CPU (rtol 1e-4 / atol 1e-6);
28. ``RenderSession`` on the flagship at 1024²×4, depth 8: refine(2) (as
   two one-frame refines, each timed; so below), orbit, focus_at the center (a distance inside (0, z_far)), refine(1),
   fast render refine(1), kernel 1's launches at each refine (one a bounce)
   and ms a frame by host clock with synchronization (FrameTimer);
29. ``RenderSession`` on the heightfield at 1024²×4, depth 4: refine(2)
   uncached, then refine(2), orbit (the pose bundle rebuilt) and refine(1)
   with the first-hit cache; kernels 1, 5 and 6 launch once a queue
   iteration (and a pose-pass chunk); ms a frame;
30. the preview (render/preview.py) on 127.0.0.1: the flagship session at
   400×240, 1 spp, depth 8 (its frames first timed alone); two
   ``/stream`` clients read frames; the
   session's frame count equals the frames committed and published (one
   advance a frame, not one a client); published frames per second over
   2 s; one ``/ctl?yaw=`` answer timed while a frame is in flight, and that
   frame dropped;
31. ``utils/profiling``: ``device_trace`` around one CLI frame step writes a
   Chrome trace that holds device kernels (whether it holds kernel 2 is
   reported: the tracer can lose a window's first records, so a trace
   without it is taken again, three times at most), and
   ``device_memory_stats`` of the card (peak bytes); then one JSON line of the app numbers (``app``);
32. the parallel layer on a world of 1 on NCCL (``multihost.initialize()``,
   ``make_mesh(1)``): ``make_sharded_megakernel_step`` on the flagship at
   1024²×4, depth 8, 4 frames (kernel 2 launches 4 times), the
   framebuffer bit-equal to the CLI frame step's on the same seed, ms a
   frame beside it; through ``step.local`` the 4 bands of a 4-rank world
   stitched bit-equal to one frame; the same on the textured cornell
   (kernel 4);
33. the queued mesh step (``make_sharded_render_step(queue=1 << 17)``) on
   the heightfield at 1024²×4, depth 4 against ``make_scene_step(queue=)``
   (rtol 2e-5 / atol 1e-6, material AOV and segments equal; kernels 1, 5,
   6 once a queue iteration) and its 4 bands; the triangle-sharded step
   (``fast=True``) at the reference's ``scene_sharded`` shape (512²×2,
   depth 3) against the replicated mesh step at the same bars, ms a frame
   for both; the 4-shard decomposition in one process on a mid-frame
   262,144-ray queue iteration: each shard's kernels 5 and 6 against their
   plain versions, the merged hits against the replicated intersector (ids
   equal on ≥ 99.99 % of live rays, t bit-equal where they agree);
34. fused recovery under ``make_mesh(1)`` at 1920×1080×4, depth 8: 2 steps
   at pool 1 (kernel 8) bit-equal to ``mesh=None``, 1 at pool 8 (kernels
   9-10), ms a step beside ``mesh=None``; kernel 8 on the half-frame bands
   ``y0 = 0`` and ``540`` against one full-frame launch (rtol 1e-5);
35. ``multihost.measure_scaling(device_counts=[1], use_megakernel=True)`` at
   the headline size and ``entry.dryrun_multichip(1)``; one JSON line of
   these phases' numbers (``parallel``), the card line; the last line is
   ``{"ok": true, "device": {...}}``.

Any failure raises and the script exits non-zero.  Outputs (images,
profile table) go to build/chip_smoke/.  Without a CUDA card it exits 1
before printing any result.  Each main path runs with every launch count
set to 0 just before it and read just after.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_smoke"

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit).
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def phase(msg):
    print(f"== {msg}", flush=True)


def cuda_time_ms(fn, iters, warmup=1):
    """Mean milliseconds per call, from CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(fn, symbol, iters, warmup=2):
    """Mean device milliseconds of one launch of the CUDA function
    ``symbol`` over ``iters`` calls of ``fn``, from the profiler's trace:
    for a kernel shorter than its wrapper's host work, where CUDA events
    around the calls time the host.  ``warmup`` calls run under the
    profiler unrecorded first (its CUPTI start-up can drop a launch).  A
    trace that misses launches is taken again, three times at most."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(warmup):
                fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            prof.step()
        found = [v for k, v in recorded_kernels(prof)[0].items() if names_kernel(symbol, k)]
        count = sum(n for n, _ in found)
        if count == iters:
            return sum(us for _, us in found) / count / 1e3
        print(f"the trace holds {count} of {iters} {symbol} launches: profiled again",
              flush=True)
    raise AssertionError(f"the trace holds {count} of {iters} {symbol} launches")


def names_kernel(fn, name):
    """Whether the profiler's kernel ``name`` is the CUDA function ``fn``
    (camera_path_kernel is a part of mesh_camera_path_kernel's name)."""
    return re.search(rf"(?<!\w){fn}(?!\w)", name) is not None


def bound_ms(ops, nbytes):
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# kernel → (CUDA function, source); the order of the kernels line.
KERNELS = {
    "intersect": ("intersect_kernel", "fspt_tpu_torch/csrc/fspt_kernels.cu"),
    "camera_path": ("camera_path_kernel", "fspt_tpu_torch/csrc/fspt_kernels.cu"),
    "ray_path": ("ray_path_kernel", "fspt_tpu_torch/csrc/fspt_kernels.cu"),
    "deferred_path": ("deferred_camera_kernel", "fspt_tpu_torch/csrc/fspt_deferred.cu"),
    "affine_planes": ("affine_planes_kernel", "fspt_tpu_torch/csrc/fspt_deferred.cu"),
    "fused_loss": ("fused_loss_kernel", "fspt_tpu_torch/csrc/fspt_grad.cu"),
    "treelet_cull": ("treelet_cull_kernel", "fspt_tpu_torch/csrc/fspt_bvh.cu"),
    "treelet_sweep": ("treelet_sweep_kernel", "fspt_tpu_torch/csrc/fspt_bvh.cu"),
    "grad_forward": ("grad_forward_kernel", "fspt_tpu_torch/csrc/fspt_adjoint.cu"),
    "grad_backward": ("grad_backward_kernel", "fspt_tpu_torch/csrc/fspt_adjoint.cu"),
    "grad_sweep": ("grad_sweep_kernel", "fspt_tpu_torch/csrc/fspt_adjoint.cu"),
    "fused_loss_chain": ("fused_loss_chain_kernel", "fspt_tpu_torch/csrc/fspt_adjoint.cu"),
    "bvh_walk": ("bvh_walk_kernel", "fspt_tpu_torch/csrc/fspt_bvh.cu"),
    "treelet_walk": ("treelet_walk_kernel", "fspt_tpu_torch/csrc/fspt_bvh.cu"),
    "mesh_camera_path": ("mesh_camera_path_kernel", "fspt_tpu_torch/csrc/fspt_kernels.cu"),
}
PTXAS_NAMES = [fn for fn, _ in KERNELS.values()] + ["adjoint_reduce"]

#: Fields of the adjoint phases: every material column (kernel checks on
#: all families), the whole-chain route's and the kernel-9/10 route's.
ADJOINT_FIELDS = ("diffuse", "emissive", "glow", "param", "ior", "reflectivity", "frost")
CHAIN_FIELDS = ("diffuse", "emissive", "param", "camera")
PAIR_FIELDS = ("diffuse", "emissive", "param")
#: Rows of the mid-frame band on which kernels 10 and 8's whole chain are held
#: against their plain versions (under autograd) at the full-width shape.
BAND_ROWS = 4
#: The ray queue of the mesh frame-step timing: the reference's mesh_100k
#: row (bench.py:155).
MESH_QUEUE = 1 << 17
#: Rays of the strided sample on which kernels 11 and 12 are held against
#: their plain versions (per-iteration torch walks) at the full-width shape.
WALK_SAMPLE = 262144


def ptxas_report(log):
    """CUDA function → registers, (spill stores, spill loads), stack frame
    and static shared memory bytes, from ``-Xptxas -v``; a template
    instantiation also under ``name<args>`` (its integer or bool arguments,
    as 0 / 1)."""
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            current = next((k for k in PTXAS_NAMES if f"{len(k)}{k}" in mangled), None)
            if current is not None:
                args = re.match(r"I((?:L[ib]\d+E)+)E", mangled.split(current, 1)[1])
                if args:
                    current += "<" + ",".join(re.findall(r"L[ib](\d+)E", args.group(1))) + ">"
            continue
        if current is None:
            continue
        for key in {current, current.split("<")[0]}:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                out.setdefault(key, {})["stack"] = int(m.group(1))
                out.setdefault(key, {})["spill"] = (int(m.group(2)), int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out.setdefault(key, {})["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                out.setdefault(key, {})["smem"] = int(m.group(1))
    return out


def recorded_kernels(prof):
    """The device kernels of a profile's recorded step, ``{name: (launches,
    device us)}``, and how many earlier ones it left out: a kernel counts
    where it starts after the step does.  A kernel of a warm-up call ended
    before that (the calls are synchronized), but its record can reach the
    profiler late and land in the recorded step.  Device-side spans of
    annotations (the schedule's ProfilerStep*, the optimizer's step) cover
    kernels that are counted on their own."""
    from torch.autograd import DeviceType

    recorded = prof.events()
    t_step = min((e.time_range.start for e in recorded if e.name.startswith("ProfilerStep")
                  and e.device_type == DeviceType.CPU), default=float("-inf"))
    dev, late = {}, 0
    for e in recorded:
        if (e.device_type != DeviceType.CUDA or e.is_user_annotation
                or e.name.startswith("ProfilerStep")):
            continue
        if e.time_range.start < t_step:
            late += 1
            continue
        count, us = dev.get(e.name, (0, 0.0))
        dev[e.name] = (count + 1, us + e.time_range.elapsed_us())
    return dev, late


def profile_window(fn, label, counters, top=6, kernels=None):
    """Profile ``fn()`` once on the card, after one unrecorded warm-up call
    of ``fn`` under the profiler (its CUPTI start-up); print how many of the
    window's launches of each port kernel the trace holds, the device busy
    share of the window (read from the trace only where it holds every
    launch) and the kernels taking the most device time, and keep the table
    in build/chip_smoke/profile_<label>.txt.  A trace that misses a launch
    (the tracer can lose a whole window's device records) is taken again,
    three times at most.  Returns the busy share, or None where every trace
    misses a launch; fills ``kernels`` (a dict), where given, with the last
    window's device kernels and their launch counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            before = {k: c.launches for k, c in counters.items()}
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
            prof.step()
        events = prof.key_averages()
        dev, late = recorded_kernels(prof)
        if late:
            print(f"profile {label}: {late} device kernels of the warm-up call left out")
        complete = True
        for key, c in counters.items():
            launched = c.launches - before[key]
            if launched:
                traced = sum(n for k, (n, _) in dev.items()
                             if names_kernel(KERNELS[key][0], k))
                complete = complete and traced == launched
                print(f"profile {label}: the trace holds {traced} of {launched} {key} launches")
        if complete:
            break
        print(f"profile {label}: the trace misses launches (attempt {attempt + 1} of 3)",
              flush=True)
    if kernels is not None:
        kernels.update({k: n for k, (n, _) in dev.items()})
    dev_us = sorted(((us, k) for k, (_, us) in dev.items()), reverse=True)
    busy_us = sum(us for us, _ in dev_us)
    share = busy_us / window_us if complete else None
    print(f"profile {label}: window {window_us:.0f} us, device busy {busy_us:.0f} us "
          f"({'not read: launches missing' if share is None else f'{share:.1%}'}); top "
          f"kernels by device time:")
    for us, key in dev_us[:top]:
        print(f"  {us:10.0f} us  {key[:90]}")
    (OUT / f"profile_{label}.txt").write_text(
        events.table(sort_by="self_device_time_total", row_limit=25))
    return share


def regenerating_schedule(segcnt, grid, refill, warps_per_block=4):
    """Replay kernel 9's schedule (csrc/fspt_adjoint.cu grad_forward_kernel)
    on the per-lane segment counts of its launch: warp w of the grid's W
    takes the 32-lane chunks r·W + (w + r) mod W, r = 0, 1, ..., in turn
    (while they are in the band); a thread traces one bounce of its lane a
    step, ``segcnt`` of them, and takes the next lane of the chunk once
    ``refill`` threads of its warp are idle.  Returns the live share of the
    warps' thread-steps and the warps' steps (mean, max): a model estimate
    from the run's data, not a device measurement."""
    import torch

    dev = segcnt.device
    s = segcnt.reshape(-1).to(torch.int32)
    n = s.numel()
    assert int(s.min()) >= 1, "a lane bounces at least once at depth >= 1"
    W = grid * warps_per_block
    n_chunks = -(-n // 32)
    warp = torch.arange(W, device=dev)
    chunk, rnd = warp.clone(), torch.zeros_like(warp)
    taken = torch.zeros(W, dtype=torch.int64, device=dev)
    rem = torch.zeros((W, 32), dtype=torch.int32, device=dev)  # bounces left; 0 idle
    steps = torch.zeros(W, dtype=torch.int64, device=dev)
    given = 0
    while True:
        idle = rem == 0
        can = idle.sum(1) >= refill
        while True:
            act = can & idle.any(1) & (chunk < n_chunks)
            if not bool(act.any()):
                break
            length = torch.clamp(n - chunk * 32, max=32)
            idle_i = idle.to(torch.int64)
            at = taken[:, None] + torch.cumsum(idle_i, 1) - idle_i
            take = idle & act[:, None] & (at < length[:, None])
            rem[take] = s[(chunk[:, None] * 32 + at)[take]]
            given += int(take.sum())
            taken = torch.where(act, taken + idle_i.sum(1), taken)
            adv = act & (taken >= length)
            rnd = torch.where(adv, rnd + 1, rnd)
            chunk = torch.where(adv, rnd * W + (warp + rnd) % W, chunk)
            taken = torch.where(adv, torch.zeros_like(taken), taken)
            idle = rem == 0
        busy = rem > 0
        if not bool(busy.any()):
            break
        steps += busy.any(1)
        rem -= busy.to(torch.int32)
    assert given == n and bool((chunk >= n_chunks).all()), (given, n)
    live = float(s.sum()) / (32.0 * float(steps.sum()))
    return live, float(steps.float().mean()), int(steps.max())


def check_launches(launches, want, label):
    """Every kernel in ``want`` launched exactly that often, no other."""
    print(f"{label} launches {launches}", flush=True)
    for key, count in launches.items():
        assert count == want.get(key, 0), (label, key, launches, want)


def mesh_phase(hf_scene, hf_cam, cfg, report, regs):
    """Kernel 13 at ``cfg``, the ``heightfield-render`` cell's frame
    (1024²×4, depth 4, the thin lens): held against its plain version
    (``kernel_check.check_mesh_camera_tracer``), its device time a launch
    (the build that counts nothing, which the main path runs, and the
    counting build, from the profiler), the counting build's cost by CUDA
    events in five rounds of the two in turns, its counts a segment (node
    steps, triangle tests) and of its warp-wide walk (leaves a leaf phase,
    lanes a warp walk), the plain version's time, and the bound of the
    frozen mesh work count
    (``benchmark/harness/meshwork.py``: the rows, 2·⌈log2(T/4)⌉ box tests
    and 4 triangle tests a segment).  Fills ``report`` and returns the
    kernels line's ``timings`` entry."""
    import statistics

    import torch

    from benchmark.harness import meshwork, workcount
    from fspt_tpu_torch.ops import cuda_path, cuda_trace, kernel_check

    seed, sample0 = 1_234_567, 8
    phase(f"kernel 13 (mesh_camera_path) vs plain at the heightfield-render cell's frame: "
          f"heightfield {cfg.width}x{cfg.height}x{cfg.spp}, depth {cfg.max_depth}, thin lens; "
          f"timed, counting and not")
    t0 = time.time()
    rep = kernel_check.check_mesh_camera_tracer(hf_scene, hf_cam, cfg, seed=seed,
                                                sample0=sample0)
    print(f"kernel 13 vs plain ({time.time() - t0:.1f} s): {json.dumps(rep)}", flush=True)
    report["mesh_camera_path"] = {"max_abs_err": rep["max_abs_err"]}
    tracer = cuda_path.make_camera_path_tracer(hf_scene, hf_cam, cfg)
    n = cfg.width * cfg.height * cfg.spp
    segments = rep["segments"]
    nodes, tris = rep["walk"]
    leaf_phases, leaves, warp_walks = rep["phases"]
    symbol = KERNELS["mesh_camera_path"][0]
    ms = kernel_device_ms(lambda: tracer(seed, sample0), symbol, iters=10)
    ms_counted = kernel_device_ms(lambda: tracer.counted(seed, sample0), symbol, iters=10)
    rounds = []
    for _ in range(5):
        rounds.append((cuda_time_ms(lambda: tracer(seed, sample0), iters=10),
                       cuda_time_ms(lambda: tracer.counted(seed, sample0), iters=10)))
    cost = statistics.median(c / u - 1.0 for u, c in rounds)
    plain = cuda_time_ms(lambda: tracer.plain(seed, sample0, 0, n), iters=1, warmup=0)
    torch.cuda.synchronize()
    n_tris = hf_scene.tri_shade.mat.shape[0]
    seg_ops = (cuda_trace.HostScene(hf_scene.geometry).segment_ops()
               + meshwork.box_tests(n_tris) * meshwork.OPS_PER_BOX_TEST
               + meshwork.TRIANGLE_TESTS_PER_SEGMENT * workcount.OPS_PER_TEST["triangle"])
    b, by = bound_ms(segments * seg_ops, n * 36)
    counting = regs.get(symbol + "<1>", {})
    print(f"mesh_camera_path: {ms:.3f} ms/frame ({segments} segments, "
          f"{segments / (ms * 1e-3):.4g} segments/s), counting build {ms_counted:.3f} ms; "
          f"the counts cost {100 * cost:.2f} % by CUDA events (rounds {rounds}); "
          f"{nodes / segments:.2f} node steps and {tris / segments:.2f} triangle tests a "
          f"segment; {leaves / leaf_phases:.2f} leaves a leaf phase ({leaf_phases} phases), "
          f"{segments / warp_walks:.2f} lanes a warp walk ({warp_walks} walks); "
          f"plain {plain:.1f} ms; bound {b:.4f} ms ({by}: {seg_ops} ops/segment, "
          f"frozen); counting build ptxas {counting}", flush=True)
    return {"mesh_camera_path": dict(
        ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, max_abs_err=rep["max_abs_err"],
        ms_counted=ms_counted, counter_cost=cost, segments=segments,
        nodes_per_segment=nodes / segments, triangles_per_segment=tris / segments,
        leaves_per_phase=leaves / leaf_phases, lanes_per_walk=segments / warp_walks,
        registers_counting=counting.get("registers"), spill_bytes_counting=counting.get("spill"),
        stack_bytes_counting=counting.get("stack"))}


def adjoint_phases(dev, counters, reset_counts, cfg_chk, cfg_t, train_scene, train_cam,
                   target_t, start, seg_ops, camera_argv):
    """Phases 18-21: the path-body adjoint (kernels 9, 10 and kernel 8's
    whole chain; 10 and 8 in reverse mode) — checks at ``cfg_chk``, the two
    recovery routes at ``cfg_t`` on ``train_scene`` from the perturbed
    ``start`` (diffuse, emissive), the camera example with ``camera_argv``,
    the full-width relaunch checks and timings.  Returns ``(report,
    timings, launches)`` entries of the kernels line."""
    import numpy as np
    import torch

    from fspt_tpu_torch.examples import recover_camera
    from fspt_tpu_torch.ops import cuda_grad, cuda_path, kernel_check
    from fspt_tpu_torch.parallel import train
    from fspt_tpu_torch.scene import samples

    report = {k: {"max_abs_err": 0.0} for k in ("grad_forward", "grad_backward", "grad_sweep",
                                                 "fused_loss_chain")}

    def worst(key, err):
        report[key]["max_abs_err"] = max(report[key]["max_abs_err"], err)

    timings, path_launches = {}, {}

    # 18. kernels 9, 10 and 8's whole chain against their plain versions
    H, W, spp = cfg_chk.height, cfg_chk.width, cfg_chk.spp
    size = f"{W}x{H}x{spp}, depth {cfg_chk.max_depth}"
    n_c = H * W * spp
    target_c = torch.from_numpy(np.random.default_rng(1).random(
        (H, W, 3), dtype=np.float32)).to(dev)
    scenes = {}
    for name in ("all_families", "flagship"):
        b = samples.build(name, device=dev, aperture=1.5, focal_depth=120.0)
        scenes[name] = (b.compile(device=dev), b.cameras[0])
    for name, fields in (("all_families", ADJOINT_FIELDS), ("flagship", PAIR_FIELDS)):
        phase(f"kernels 9 (grad_forward) and 10 (grad_sweep and grad_backward) vs plain: "
              f"{name} + DoF, {size}, fields {fields}")
        rep = kernel_check.check_grad_path_tracer(*scenes[name], cfg_chk, fields, seed=3,
                                                  sample0=1)
        print(json.dumps(rep), flush=True)
        print(f"lanes with a zeroed non-finite contribution (kernel 10): "
              f"{rep['nonfinite_lanes']}")
        worst("grad_forward", rep["max_abs_err"])
        worst("grad_backward", rep["grad_max_abs_err"])
        worst("grad_sweep", rep["grad_max_abs_err"])
    for name, fields in (("all_families", ADJOINT_FIELDS), ("flagship", ("camera",)),
                         ("flagship", CHAIN_FIELDS)):
        phase(f"kernel 8 whole chain (fused_loss_chain, reverse mode) and remat vs plain: "
              f"{name} + DoF, {size}, fields {fields}")
        rep = kernel_check.check_fused_loss_chain(*scenes[name], cfg_chk, target_c, fields,
                                                  seed=4, frame_idx=2)
        print(json.dumps(rep), flush=True)
        print(f"lanes with a zeroed non-finite contribution (kernel 8 whole chain): "
              f"{rep['nonfinite_lanes']}")
        worst("fused_loss_chain", rep["max_abs_err"])

    fam_scene, fam_cam = scenes["all_families"]
    params_c = {f: getattr(fam_scene.materials, f) for f in ADJOINT_FIELDS}
    tracer_c = cuda_grad.make_grad_path_tracer(fam_scene, fam_cam, cfg_chk,
                                               fields=ADJOINT_FIELDS)
    pv_c = cuda_grad.pack_params(params_c, tracer_c.fields)
    cot_c = torch.from_numpy(np.random.default_rng(3).normal(size=(3, n_c)).astype(
        np.float32)).to(dev)
    chain_c = cuda_grad.make_fused_loss_grad_fn(fam_scene, fam_cam, cfg_chk,
                                                fields=ADJOINT_FIELDS)
    rec_c = tracer_c.new_record(n_c)
    tracer_c.kernel_forward(pv_c, 3, 1, 0, n_c, record=rec_c)
    phase(f"plain versions, kernels 9, 10 and 8 whole chain: all families, {size}, "
          f"{len(ADJOINT_FIELDS)} fields")
    small = {
        "grad_forward": (lambda: tracer_c.kernel_forward(pv_c, 3, 1, 0, n_c),
                         lambda: tracer_c.plain(pv_c, 3, 1, 0, n_c)),
        "grad_backward": (lambda: tracer_c.kernel_backward(pv_c, cot_c, 3, 1, 0, n_c),
                          lambda: tracer_c.plain_grad(pv_c, cot_c, 3, 1, 0, n_c)),
        "grad_sweep": (lambda: tracer_c.kernel_backward(pv_c, cot_c, 3, 1, 0, n_c,
                                                        record=rec_c),
                       lambda: tracer_c.plain_grad(pv_c, cot_c, 3, 1, 0, n_c)),
        "fused_loss_chain": (lambda: chain_c(params_c, target_c, 4, 2, 0, H),
                             lambda: chain_c.plain(params_c, target_c, 4, 2, 0, H)),
    }
    for key, (kern, plain) in small.items():
        timings[key] = dict(check_ms=cuda_time_ms(kern, iters=3),
                            plain_ms=cuda_time_ms(plain, iters=1),
                            plain_shape=f"all_families {size}, P={tracer_c.n_params}")
        print(f"{key} at {size}: kernel {timings[key]['check_ms']:.3f} ms, plain "
              f"{timings[key]['plain_ms']:.1f} ms", flush=True)

    # 19. training path at full width on the path-body adjoint
    Ht, Wt = cfg_t.height, cfg_t.width
    n_t = Ht * Wt * cfg_t.spp
    phase(f"training path: make_fused_recovery_step, flagship {Wt}x{Ht}x{cfg_t.spp}, depth "
          f"{cfg_t.max_depth}: whole chain (pool 1) and kernels 9-10 (pool 8), reverse mode")
    offset = torch.tensor([1.0, -0.5, -2.0] + [0.0] * 6, device=dev)
    params0 = dict(start, param=train_scene.materials.param * 0.6,
                   camera=cuda_path.camera_pvec(train_cam).to(dev) + offset)
    adam = lambda ps: torch.optim.Adam(ps, lr=0.02)  # noqa: E731
    routes = {"chain": (CHAIN_FIELDS, 1, {"fused_loss_chain": 1}),
              "pair": (PAIR_FIELDS, 8, {"grad_forward": 2, "grad_sweep": 2})}
    step_times = {}
    steps = 4
    for label, (fields, pool, per_step) in routes.items():
        step = train.make_fused_recovery_step(None, train_scene, train_cam, cfg_t,
                                              fields=fields, pool=pool, optimizer=adam)
        params = {f: params0[f] for f in fields}
        state = step.init(params)
        reset_counts()
        times, losses = [], []
        for it in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, loss = step(params, state, train_scene, train_cam, target_t, 9,
                                       it)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
            print(f"{label} pool={pool} step {it}: loss {losses[-1]:.6g} ({times[-1]:.1f} ms)",
                  flush=True)
            assert np.isfinite(losses[-1]) and all(
                bool(torch.isfinite(v).all()) for v in params.values()), (label, it)
        launches = {k: c.launches for k, c in counters.items()}
        # Every other count must be 0.
        check_launches(launches, {k: v * steps for k, v in per_step.items()},
                       f"{label} pool={pool}")
        assert losses[-1] < losses[0], (label, losses)
        path_launches.update({k: launches[k] for k in per_step})
        step_times[label] = times

        def two_steps():
            for it in range(steps, steps + 2):
                step(params, state, train_scene, train_cam, target_t, 9, it)

        profile_window(two_steps, f"recovery_{label}", counters)

    # 20. the camera example
    args = recover_camera.parse_args(camera_argv)
    phase(f"camera example: recover_camera {' '.join(camera_argv)}")
    reset_counts()
    res = recover_camera.run(camera_argv)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    print(f"camera example: {json.dumps(res)}", flush=True)
    # One whole-chain launch per gradient frame of every iteration and of
    # the two evaluations; kernel 2 renders the targets and the images.
    check_launches(launches, {"fused_loss_chain": (args.iters + 2) * args.grad_frames,
                              "camera_path": launches["camera_path"]}, "camera example")
    assert res["loss_end"] < res["loss_start"], res

    # 21. the kernels against their plain versions at the main path's shape
    # (kernel 9 over the whole frame; kernels 10 and 8's whole chain, whose
    # plain versions run under autograd, on a band of rows mid-frame, and
    # launched twice over the whole frame, equal bit for bit), from the
    # training start; then their timings
    y0, rows = Ht // 2, BAND_ROWS
    phase(f"kernels 9, 10 and 8 whole chain vs plain at the main path's shape: flagship "
          f"{Wt}x{Ht}x{cfg_t.spp}, depth {cfg_t.max_depth}; kernel 9 on all {n_t} lanes, "
          f"10 and 8 on rows {y0}..{y0 + rows - 1}")
    pair = cuda_grad.make_grad_path_tracer(train_scene, train_cam, cfg_t, fields=PAIR_FIELDS)
    pv_t = cuda_grad.pack_params({f: params0[f] for f in PAIR_FIELDS}, pair.fields)
    rep = kernel_check.check_grad_forward(pair, pv_t, 9, 0, 0, n_t)
    print(f"grad_forward, whole frame: {json.dumps(rep)}", flush=True)
    # A lane's path depends only on its index and the kernel runs the plain
    # version's operations in its order: every radiance bit and segment.
    assert rep["radiance_bits_equal"] == 1.0 and rep["segments_equal"] == 1.0, rep
    worst("grad_forward", rep["max_abs_err"])
    rep = kernel_check.check_grad_path_tracer(
        train_scene, train_cam, cfg_t, PAIR_FIELDS, seed=9, sample0=cfg_t.spp,
        params={f: params0[f] for f in PAIR_FIELDS}, y0=y0, rows=rows)
    print(f"grad_forward and grad_sweep (equal to grad_backward bit for bit), band: "
          f"{json.dumps(rep)}", flush=True)
    worst("grad_forward", rep["max_abs_err"])
    worst("grad_backward", rep["grad_max_abs_err"])
    worst("grad_sweep", rep["grad_max_abs_err"])
    rep = kernel_check.check_fused_loss_chain(
        train_scene, train_cam, cfg_t, target_t[y0:y0 + rows], CHAIN_FIELDS, seed=9,
        frame_idx=1, params={f: params0[f] for f in CHAIN_FIELDS}, y0=y0, rows=rows)
    print(f"fused_loss_chain and remat, band: {json.dumps(rep)}", flush=True)
    worst("fused_loss_chain", rep["max_abs_err"])

    phase(f"kernels 10 (P = {pair.n_params}) and 8 whole chain with the camera, twice on all "
          f"{n_t} lanes: equal bit for bit")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cot_t = torch.randn((3, n_t), generator=gen, device=dev)
    chain_t = cuda_grad.make_fused_loss_grad_fn(train_scene, train_cam, cfg_t,
                                                fields=CHAIN_FIELDS)
    params_t = {f: params0[f] for f in CHAIN_FIELDS}
    g10 = pair.kernel_backward(pv_t, cot_t, 9, 0, 0, n_t)
    print(f"kernel 10 at full width: lanes with a zeroed non-finite contribution "
          f"{int(pair.nonfinite)} of {n_t}")
    loss8, g8, seg8 = chain_t(params_t, target_t, 7, 1, 0, Ht)
    print(f"kernel 8 whole chain at full width: lanes with a zeroed non-finite contribution "
          f"{int(chain_t.nonfinite)} of {n_t}")
    again10 = pair.kernel_backward(pv_t, cot_t, 9, 0, 0, n_t)
    again8 = chain_t(params_t, target_t, 7, 1, 0, Ht)
    # Kernel 10's sweep route on kernel 9's record of the same lanes.
    rec_t = pair.new_record(n_t)
    pair.kernel_forward(pv_t, 9, 0, 0, n_t, record=rec_t)
    sweep10 = pair.kernel_backward(pv_t, cot_t, 9, 0, 0, n_t, record=rec_t)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(g10).all()) and bool(torch.isfinite(loss8)) and all(
        bool(torch.isfinite(g).all()) for g in g8.values())
    equal = dict(grad_backward=bool(torch.equal(g10, again10)),
                 grad_sweep=bool(torch.equal(g10, sweep10)), fused_loss_chain=bool(
        float(again8[0]) == float(loss8) and int(again8[2]) == int(seg8)
        and all(torch.equal(again8[1][f], g8[f]) for f in g8)))
    print(f"two launches on all {n_t} lanes equal bit for bit (grad_sweep: the sweep route "
          f"against the remat route): {json.dumps(equal)}", flush=True)
    assert all(equal.values()), equal

    phase(f"timing: kernels 9, 10 and 8 whole chain (reverse mode), flagship "
          f"{Wt}x{Ht}x{cfg_t.spp}, depth {cfg_t.max_depth}")
    _, segcnt = pair.kernel_forward(pv_t, 9, 0, 0, n_t)
    seg9, seg8 = int(segcnt.sum()), int(seg8)
    grid9, refill9 = cuda_grad.forward_plan(pair.mats.count, n_t)
    live9, steps_mean, steps_max = regenerating_schedule(segcnt, grid9, refill9)
    share_fixed = seg9 / (n_t * cfg_t.effective_depth)
    # One lane a thread: a warp steps while any of its 32 lanes lives.
    chunks9 = -(-n_t // 32)
    lane_segs = torch.zeros(chunks9 * 32, dtype=segcnt.dtype, device=dev)
    lane_segs[:n_t] = segcnt
    steps_fixed = int(lane_segs.view(-1, 32).max(1).values.sum()) / chunks9
    print(f"grad_forward schedule: grid {grid9} blocks x 128 threads ({grid9 * 4} warps), "
          f"refill at {refill9} idle threads a warp; lane efficiency (segments / (lanes x "
          f"depth), one lane a thread for all depths) {share_fixed:.1%}", flush=True)
    print(f"grad_forward schedule, model estimate (not measured on the card: a replay of "
          f"the two schedules over this launch's per-lane segments): live share of the "
          f"regenerating schedule's thread-steps {live9:.1%}, steps a warp mean "
          f"{steps_mean:.1f} max {steps_max}; steps a 32-lane chunk: one lane a thread "
          f"{steps_fixed:.3f} (a warp with no live lane skips its step), regenerating "
          f"{steps_mean * grid9 * 4 / chunks9:.3f}", flush=True)
    ms9_bare = cuda_time_ms(lambda: pair.kernel_forward(pv_t, 9, 0, 0, n_t), iters=3)
    ms9 = cuda_time_ms(lambda: pair.kernel_forward(pv_t, 9, 0, 0, n_t, record=rec_t), iters=3)
    ms10 = cuda_time_ms(lambda: pair.kernel_backward(pv_t, cot_t, 9, 0, 0, n_t), iters=2)
    ms_sweep = cuda_time_ms(lambda: pair.kernel_backward(pv_t, cot_t, 9, 0, 0, n_t,
                                                         record=rec_t), iters=2)
    swept = path_launches["grad_sweep"] / (path_launches["grad_sweep"]
                                           + path_launches.get("grad_backward", 0))
    print(f"kernel 10's routes at {Wt}x{Ht}x{cfg_t.spp}, depth {cfg_t.max_depth}: sweep "
          f"{ms_sweep:.3f} ms after kernel 9 with its record {ms9:.3f} ms, against remat "
          f"{ms10:.3f} ms after kernel 9 alone {ms9_bare:.3f} ms; the record "
          f"{pair.record_bytes} bytes a buffer ({pair.record_bytes / 2 ** 30:.2f} GiB); share "
          f"of the pool-8 recovery's kernel-10 launches on the sweep route {swept:.0%}",
          flush=True)
    ms8 = cuda_time_ms(lambda: chain_t(params_t, target_t, 7, 1, 0, Ht), iters=2)
    mats_t = cuda_path.HostMaterials(train_scene.materials)
    P_pair = cuda_grad.param_count(mats_t, PAIR_FIELDS)
    P_chain = cuda_grad.param_count(mats_t, CHAIN_FIELDS)
    # Kernel 9 is kernel 2's work; an adjoint costs at least ~4x the forward
    # operations of its traces (the cheap-gradient bound of reverse mode).
    b9 = bound_ms(seg9 * seg_ops, n_t * (16 + 16) + seg9 * 48 + P_pair * 4)  # with its record
    b10 = bound_ms(4 * seg9 * seg_ops, n_t * 12 + P_pair * 8)
    # The sweep alone: that bound less the forward trace it no longer runs,
    # or the live record it reads (48 bytes a segment, 16 a lane).
    b_sweep = bound_ms(3 * seg9 * seg_ops, seg9 * 48 + n_t * (16 + 12) + P_pair * 8)
    b8 = bound_ms(4 * seg8 * seg_ops, target_t.numel() * 4 + P_chain * 8)
    full = {
        "grad_forward": (ms9, b9, seg9, P_pair, "float, 1 trace, its record written"),
        "grad_backward": (ms10, b10, seg9, P_pair, "reverse, 1 forward + 1 sweep"),
        "grad_sweep": (ms_sweep, b_sweep, seg9, P_pair, "reverse, 1 sweep of a record"),
        "fused_loss_chain": (ms8, b8, seg8, P_chain, "reverse, 1 forward + 1 sweep a buffer"),
    }
    timings["grad_forward"].update(grid=grid9, lane_efficiency_fixed=share_fixed,
                                   ms_without_record=ms9_bare,
                                   record_bytes=pair.record_bytes)
    timings["grad_sweep"].update(route_share=swept)
    for key, (ms, (b, by), segs, P, passes) in full.items():
        timings[key].update(ms=ms, bound_ms=b, bound_by=by, max_abs_err=0.0, params=P,
                            passes=passes)
        print(f"{key}: {ms:.3f} ms/launch, {segs} segments, P={P}, {passes}; "
              f"{segs / (ms * 1e-3):.4g} segments/s; bound {b:.4f} ms ({by}); "
              f"plain {timings[key]['plain_ms']:.1f} ms at the check size", flush=True)
    for label, segs_step, kernel_ms in (("chain", seg8, ms8), ("pair", 2 * seg9,
                                                               2 * (ms9 + ms_sweep))):
        steady = step_times[label][1:]
        ms_step = sum(steady) / len(steady)
        print(f"recovery step {label} (pool={routes[label][1]}): {ms_step:.2f} ms/step (mean "
              f"of steps 1.., host clock), fwd+bwd {segs_step / (ms_step * 1e-3):.4g} "
              f"segments/s (~{segs_step} segments per step, both buffers); kernel share "
              f"of step time {kernel_ms / ms_step:.1%} (the step's kernels {kernel_ms:.2f} ms "
              f"by CUDA events over the step's host time)",
              flush=True)
    return report, timings, path_launches


def vertex_phases(dev, counters, reset_counts, hf_scene, hf_cam, inter, cfg_v, example_argv,
                  frame_rays):
    """Phases 22-24: vertex recovery at ``cfg_v`` on the heightfield (the
    mesh intersector ``inter`` serves phase 1), the BVH vertex example with
    ``example_argv``, and kernels 11 and 12 on the recorded segments, then
    against the culled sweep on those and on ``frame_rays``, the ``(o, d,
    alive)`` of one mid-frame mesh queue iteration.
    Returns ``(report, timings, launches)`` entries of the kernels line,
    the launches of each kernel in one vertex step, and the routes' times
    on each ray set (the kernels line's ``walk_routes``)."""
    import dataclasses

    import numpy as np
    import torch

    from fspt_tpu_torch.examples import recover_vertices_bvh
    from fspt_tpu_torch.ops import bvh, cuda_bvh, kernel_check
    from fspt_tpu_torch.ops.diff_intersect import (flat_normals, make_diff_mesh_intersector,
                                                   tris_from_scene)
    from fspt_tpu_torch.parallel import train
    from fspt_tpu_torch.render import integrator

    # 22. the vertex-recovery step at full width
    cfg2 = dataclasses.replace(cfg_v, spp=2 * cfg_v.spp)
    H, W = cfg_v.height, cfg_v.width
    tris = tris_from_scene(hf_scene)
    n_tris = tris["v0"].shape[0]
    phase(f"vertex recovery: make_bvh_vertex_recovery_step, heightfield ({n_tris} "
          f"triangles) {W}x{H}x{cfg_v.spp}, depth {cfg_v.max_depth}, edge_eps "
          f"{cfg_v.edge_eps}, Adam over {3 * n_tris * 3} vertex coordinates")
    diff = make_diff_mesh_intersector(hf_scene)
    with torch.no_grad():
        target = train.render_image_rows(hf_scene, hf_cam, cfg_v, 5, 0, 0, H, intersector=diff)
    shift = torch.tensor([0.0, 0.5, 0.0], device=dev)
    params = {k: tris[k] + shift for k in train.VERTICES}
    seed, frame0 = 11, 1

    def side_record(ps, it):
        """Phase 1 of the step that receives ``ps`` at frame ``it``, run
        again with its intersector's inputs kept: the segments, and per
        depth ``(o, d, alive, winner ids)``."""
        rec = []
        tr = dict(tris, **{k: ps[k].detach() for k in train.VERTICES})
        tr["n0"] = tr["n1"] = tr["n2"] = flat_normals(tr["v0"], tr["v1"], tr["v2"])
        inner = diff.bind(tr)

        def recorder(o, d, alive=None):
            h = inner(o, d, alive)
            rec.append((o, d, alive, h.prim_id))
            return h

        recorder.accepts_alive = True
        with torch.no_grad():
            out = integrator.render_wavefront(hf_scene, hf_cam, cfg2, seed, it * cfg2.spp,
                                              intersector=recorder)
        return int(out.segments), rec

    step = train.make_bvh_vertex_recovery_step(None, cfg_v, hf_scene, pool=1,
                                               optimizer=lambda ps: torch.optim.Adam(ps, lr=0.05))
    state = step.init(params)
    params, state, loss = step(params, state, hf_scene, hf_cam, target, seed, 0)  # warm-up
    torch.cuda.synchronize()
    steps, times, losses, peak, received = 3, [], [], 0, []
    launches = {k: 0 for k in counters}
    for it in range(frame0, frame0 + steps):
        received.append({k: params[k].clone() for k in train.VERTICES})
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, hf_scene, hf_cam, target, seed, it)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        peak = max(peak, torch.cuda.max_memory_allocated())
        for k, c in counters.items():
            launches[k] += c.launches
        losses.append(float(loss))
        print(f"vertex step {it}: loss {losses[-1]:.6g} ({times[-1]:.1f} ms)", flush=True)
    # Each timed step's phase 1 again, on the params it received: alone
    # (timed), and with its rays kept, which must give the same winners.
    # Kernels 11 and 12 run on the first step's rays.
    record_ms, segs = [], 0
    for it, ps in zip(range(frame0, frame0 + steps), received):
        segs_it, rec = side_record(ps, it)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, _ = step.record(ps, hf_scene, hf_cam, seed, it, 0, H)
        torch.cuda.synchronize()
        record_ms.append((time.perf_counter() - t0) * 1e3)
        assert ids.shape[1] == len(rec) and all(
            torch.equal(ids[:, k], rec[k][3]) for k in range(len(rec))), "records differ"
        print(f"vertex step {it}: its phase 1 alone {record_ms[-1]:.1f} ms, {segs_it} "
              f"segments", flush=True)
        if it == frame0:
            recorded = rec
        segs += segs_it
    check_launches(launches, {k: 2 * steps for k in ("intersect", "treelet_cull",
                                                     "treelet_sweep")}, "vertex recovery")
    step_launches = {k: v / steps for k, v in launches.items()}
    assert all(np.isfinite(v) for v in losses) and all(
        bool(torch.isfinite(v).all()) for v in params.values())
    segs /= steps
    ms_step, ms_rec = sum(times) / steps, sum(record_ms) / steps
    print(f"vertex recovery step: {ms_step:.2f} ms/step (mean of {steps}, host clock); phase 1 "
          f"record {ms_rec:.2f} ms (timed alone on each step's frame and params), replay + "
          f"backward + Adam {ms_step - ms_rec:.2f} ms (the difference); {segs:.1f} segments a "
          f"step (mean of the steps' own phase 1, both "
          f"buffers), fwd+bwd {segs / (ms_step * 1e-3):.4g} segments/s; peak memory "
          f"{peak / 2**30:.2f} GiB; launches per step: intersect "
          f"{launches['intersect'] / steps:g}, treelet_cull {launches['treelet_cull'] / steps:g}, "
          f"treelet_sweep {launches['treelet_sweep'] / steps:g}; losses {losses}", flush=True)
    profile_window(lambda: step(params, state, hf_scene, hf_cam, target, seed, frame0 + steps),
                   "vertex_step", counters, top=12)

    # 23. the BVH vertex example at its defaults
    phase(f"BVH vertex example: recover_vertices_bvh {' '.join(example_argv)}")
    reset_counts()
    args = recover_vertices_bvh.parse_args(example_argv)
    assert recover_vertices_bvh.main(example_argv) == 0, "the example failed its check"
    launches = {k: c.launches for k, c in counters.items()}
    # Two mesh-intersector calls (depth 2) per render: 4 target frames, one
    # record per step.
    check_launches(launches, {k: 2 * (4 + args.iters) for k in (
        "intersect", "treelet_cull", "treelet_sweep")}, "BVH vertex example")

    # 24. kernels 1, 5 and 6 against their plain versions, and kernels 11 and
    # 12, on the recorded segments
    report = {k: {"max_abs_err": 0.0} for k in ("intersect", "treelet_cull", "treelet_sweep",
                                                "bvh_walk", "treelet_walk")}
    k11 = cuda_bvh.make_bvh_traverser(hf_scene.bvh, bvh.MAX_LEAF_TRIS)
    coarse = bvh.build_bvh(*(tris[k].cpu().numpy() for k in train.VERTICES),
                           max_leaf=cuda_bvh.TREELET, device=dev)
    k12 = cuda_bvh.make_treelet_traverser(coarse)
    wt = k12.walk_tables
    print(f"kernel 11 tree: {hf_scene.bvh.n_nodes} nodes, max leaf "
          f"{int(hf_scene.bvh.count.max())}; kernel 12 tree: {coarse.n_nodes} nodes, "
          f"{wt.tables.n_leaves} leaves of at most {cuda_bvh.TREELET}", flush=True)
    # The records the kernels read: packed nodes (32 bytes), kernel 11's
    # triangles (48), kernel 12's leaf weights.
    fine_bytes = (k11.tables.nodes.numel() + k11.tables.tris.numel()) * 4
    coarse_bytes = (wt.nodes.numel() + wt.tables.weights.numel()) * 4
    timings, path_launches, routes = {}, {}, {}
    for depth in (0, 1):
        o, d, alive, ids = recorded[depth]
        start, seg, t_init, perm = inter.sweep_inputs(o, d, alive)
        n = start.shape[0]
        live = t_init > 0
        phase(f"kernels 1, 5, 6 vs plain and kernels 11 (bvh_walk) and 12 (treelet_walk): the "
              f"depth-{depth} segments of phase 1, {n} rays ({int(live.sum())} live)")
        # Kernels 1, 5 and 6 at the full count, on the inputs the record gave
        # them: kernel 1 the raw segments, kernels 5 and 6 the sorted, seeded
        # rays with the record's alive mask.
        for keys, rep in ((("intersect",), kernel_check.check_intersect(hf_scene.geometry, o, d)),
                          (("treelet_cull", "treelet_sweep"), kernel_check.check_treelet_kernels(
                              inter.traverser, start, seg, t_init))):
            print(f"{'/'.join(keys)} vs plain, all {n} rays: {json.dumps(rep)}", flush=True)
            for key in keys:
                report[key]["max_abs_err"] = max(report[key]["max_abs_err"], rep["max_abs_err"])
        idx = torch.arange(0, n, max(1, n // WALK_SAMPLE), device=dev)[:WALK_SAMPLE]
        sample = (start[idx], seg[idx], t_init[idx])
        for key, check, trav in (("bvh_walk", kernel_check.check_bvh_walk, k11),
                                 ("treelet_walk", kernel_check.check_treelet_walk, k12)):
            rep = check(trav, *sample)
            print(f"{key} vs plain, {idx.numel()}-ray sample: {json.dumps(rep)}", flush=True)
            report[key]["max_abs_err"] = max(report[key]["max_abs_err"], rep["max_abs_err"])
        # Kernel 6's winners (the recorded ids, in the sorted order).
        k6_ids = ids[perm]
        reset_counts()
        _, id11, _, _, vis11, tst11 = k11.walk(start, seg, t_init)
        t_raw, best, vis12, tst12 = k12.walk(start, seg, t_init)
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        check_launches(launches, {"bvh_walk": 1, "treelet_walk": 1}, f"walks at depth {depth}")
        id12 = cuda_bvh.post(wt.tables, start, seg, torch.where(best[:n] >= 0, t_raw[:n], t_init),
                             best[:n])[1]
        for key, got in (("bvh_walk", id11), ("treelet_walk", id12)):
            agree = int((got[live] == k6_ids[live]).sum()) / max(1, int(live.sum()))
            print(f"{key}: ids equal to kernel 6's recorded winners on {agree:.6f} of "
                  f"{int(live.sum())} live rays", flush=True)
            assert agree >= 0.999, (key, depth, agree)
            path_launches[key] = path_launches.get(key, 0) + launches[key]
        ms11 = cuda_time_ms(lambda: k11.walk(start, seg, t_init), iters=5)
        F = cuda_bvh.ray_features(start, seg, t_init)
        ms12 = cuda_time_ms(lambda: cuda_bvh.launch_treelet_walk(F, wt), iters=5)
        # The same rays in their recorded order, before the Morton sort.
        t_rec = torch.empty_like(t_init)
        t_rec[perm] = t_init
        o_rec, d_rec = o.contiguous(), d.contiguous()
        ms11_u = cuda_time_ms(lambda: k11.walk(o_rec, d_rec, t_rec), iters=5)
        F_rec = cuda_bvh.ray_features(o_rec, d_rec, t_rec)
        ms12_u = cuda_time_ms(lambda: cuda_bvh.launch_treelet_walk(F_rec, wt), iters=5)
        p11 = cuda_time_ms(lambda: bvh.walk_bvh(hf_scene.bvh, *sample, bvh.MAX_LEAF_TRIS),
                           iters=1, warmup=0)
        p12 = cuda_time_ms(lambda: cuda_bvh.plain_treelet_walk(
            cuda_bvh.ray_features(*sample), wt), iters=1, warmup=0)
        b11, by11 = bound_ms(int(vis11.long().sum()) * cuda_bvh.OPS_PER_NODE
                             + int(tst11.long().sum()) * cuda_bvh.OPS_PER_MT_TRIANGLE,
                             n * (12 + 12 + 4 + 6 * 4) + fine_bytes)
        b12, by12 = bound_ms(int(vis12.long().sum()) * cuda_bvh.OPS_PER_NODE
                             + int(tst12.long().sum()) * cuda_bvh.OPS_PER_TRIANGLE,
                             F.numel() * 4 + F.shape[0] * 16 + coarse_bytes)
        print(f"depth {depth}: bvh_walk {ms11:.4f} ms ({n} rays; nodes/ray "
              f"{vis11.float().mean().item():.1f}, triangles/ray "
              f"{tst11.float().mean().item():.1f}; bound {b11:.4f} ms {by11}; plain "
              f"{p11:.1f} ms on the {idx.numel()}-ray sample); treelet_walk {ms12:.4f} ms "
              f"(nodes/ray {vis12.float().mean().item():.1f}, triangles/ray "
              f"{tst12.float().mean().item():.1f}; bound {b12:.4f} ms {by12}; plain {p12:.1f} "
              f"ms on the sample); the same rays unsorted (recorded order): bvh_walk "
              f"{ms11_u:.4f} ms, treelet_walk {ms12_u:.4f} ms", flush=True)
        if depth == 0:  # the full count: the kernels line
            timings["bvh_walk"] = dict(ms=ms11, plain_ms=p11, bound_ms=b11, bound_by=by11,
                                       max_abs_err=0.0, plain_shape=f"{idx.numel()}-ray sample",
                                       unsorted_ms=ms11_u)
            timings["treelet_walk"] = dict(ms=ms12, plain_ms=p12, bound_ms=b12, bound_by=by12,
                                           max_abs_err=0.0,
                                           plain_shape=f"{idx.numel()}-ray sample",
                                           unsorted_ms=ms12_u)
        routes[f"depth {depth}"] = walk_against_sweep(inter, k11, k12, o, d, alive)

    # The walks against the culled sweep on one mid-frame iteration of the
    # mesh frame, and the table of all three ray sets.
    routes["mesh frame iteration"] = walk_against_sweep(inter, k11, k12, *frame_rays)
    phase("the walks against the culled sweep, from the sorted, seeded rays to (t, id), ms by "
          "CUDA events")
    for label, r in routes.items():
        print(f"{label}: {r['rays']} rays ({r['live']} live): culled route (kernel 5, key "
              f"sort, kernel 6, post) {r['culled']:.4f} ms; bvh_walk route {r['bvh_walk']:.4f} "
              f"ms; treelet_walk route (features, kernel 12, post) {r['treelet_walk']:.4f} ms; "
              f"Morton sort alone {r['morton_sort']:.4f} ms; the walk routes from the same "
              f"rays unsorted (recorded order, seeded): bvh_walk {r['bvh_walk_unsorted']:.4f} "
              f"ms, treelet_walk {r['treelet_walk_unsorted']:.4f} ms; ids equal to kernel 6's "
              f"winners on the live rays: bvh_walk {r['agree_bvh_walk']:.6f}, treelet_walk "
              f"{r['agree_treelet_walk']:.6f}", flush=True)
    return report, timings, path_launches, step_launches, routes


def walk_against_sweep(inter, k11, k12, o, d, alive):
    """Three routes from the same sorted, seeded rays (``inter.sweep_inputs``)
    to ``(t, id)``, each timed by CUDA events: the culled route (kernel 5,
    the key sort, kernel 6, then ``post``), kernel 11 on the scene's fine
    BVH, and kernel 12 on its tree of 128-triangle leaves with
    ``ray_features`` and ``post``; both walk routes again from the same
    rays unsorted (recorded order, same seeds); the Morton sort alone; and
    each walk's ids against kernel 6's winners on the live rays (at least
    0.999)."""
    import torch

    from fspt_tpu_torch.ops import cuda_bvh

    start, seg, t_init, perm0 = inter.sweep_inputs(o, d, alive)
    trav, live = inter.traverser, t_init > 0
    t_rec = torch.empty_like(t_init)  # the seeds in the recorded order
    t_rec[perm0] = t_init
    o_rec, d_rec = o.contiguous(), d.contiguous()
    fns = {"culled": lambda: trav.post(start, seg, *trav.raw(start, seg, t_init))[:2],
           "bvh_walk": lambda: k11(start, seg, t_init)[:2],
           "treelet_walk": lambda: k12(start, seg, t_init)[:2],
           "bvh_walk_unsorted": lambda: k11(o_rec, d_rec, t_rec)[:2],
           "treelet_walk_unsorted": lambda: k12(o_rec, d_rec, t_rec)[:2]}
    out = {"rays": start.shape[0], "live": int(live.sum())}
    ids6 = fns["culled"]()[1]
    for key in ("bvh_walk", "treelet_walk"):
        ids = fns[key]()[1]
        out[f"agree_{key}"] = int((ids[live] == ids6[live]).sum()) / max(1, out["live"])
        assert out[f"agree_{key}"] >= 0.999, (key, out)
    for key, fn in fns.items():
        out[key] = cuda_time_ms(fn, iters=5)

    def morton_sort():
        perm = torch.argsort(cuda_bvh.morton_keys(o, d, alive, *inter.box), stable=True)
        return o[perm], d[perm], t_rec[perm]

    out["morton_sort"] = cuda_time_ms(morton_sort, iters=5)
    return out


def read_part(r):
    """The next ``(X-Frame, png)`` part of the preview's multipart stream,
    or None where the stream ends."""
    from fspt_tpu_torch.render.preview import BOUNDARY

    line = r.readline()
    while line.strip() != b"--" + BOUNDARY:
        if not line:
            return None
        line = r.readline()
    headers = {}
    for line in iter(r.readline, b"\r\n"):
        key, value = line.split(b":", 1)
        headers[key.strip().lower()] = value.strip()
    return int(headers[b"x-frame"]), r.read(int(headers[b"content-length"]))


def app_phases(dev, counters, reset_counts, cfg, cfg_mesh, hf_builder, cfg_preview,
               cli_frames=4, preview_window_s=2.0):
    """Phases 26-31: the app layer on the card — the CLI with ``--denoise``
    (scenes/cornell.scene at ``cfg``), the denoiser timed on the flagship
    framebuffer and held against the CPU, ``RenderSession`` on the flagship
    at ``cfg`` and on ``hf_builder`` at ``cfg_mesh``, the preview server on
    localhost at ``cfg_preview`` with two stream clients, and the profiling
    helpers.  Returns the numbers of the ``app`` line."""
    import statistics
    import threading
    import urllib.request

    import torch

    from fspt_tpu_torch import cli
    from fspt_tpu_torch.interactive import RenderSession
    from fspt_tpu_torch.ops import cuda_path
    from fspt_tpu_torch.render import framebuffer as fb_mod
    from fspt_tpu_torch.render.denoiser import denoise
    from fspt_tpu_torch.render.preview import PreviewServer
    from fspt_tpu_torch.scene import samples
    from fspt_tpu_torch.utils import checkpoint, profiling

    OUT.mkdir(parents=True, exist_ok=True)
    app = {}
    launches = lambda: {k: c.launches for k, c in counters.items()}

    def frames_ms(session, frames):
        """Host-clock ms (FrameTimer: synchronized at both ends) and
        segments of each of ``frames`` one-frame refines."""
        out = []
        for _ in range(frames):
            timer = profiling.FrameTimer(session.device)
            with timer.frame():
                timer.add_segments(session.refine(1))
            out.append((timer.seconds * 1e3, timer.segments))
        return out

    # 26. the CLI with --denoise
    size = f"{cfg.width}x{cfg.height}, {cfg.spp} spp, depth {cfg.max_depth}"
    phase(f"--denoise: fspt_tpu_torch.cli --denoise, scenes/cornell.scene {size}, "
          f"{cli_frames} frames")
    image = OUT / f"cornell_{cfg.width}_denoised.png"
    ckpt_path = OUT / f"cornell_{cfg.width}_denoised.npz"
    image.unlink(missing_ok=True)
    ckpt_path.unlink(missing_ok=True)
    reset_counts()
    rc = cli.main(["--file", str(ROOT / "scenes" / "cornell.scene"),
                   "--width", str(cfg.width), "--height", str(cfg.height),
                   "--spp", str(cfg.spp), "--depth", str(cfg.max_depth),
                   "--frames", str(cli_frames), "--seed", "0", "--denoise",
                   "--output", str(image), "--checkpoint", str(ckpt_path)])
    torch.cuda.synchronize()
    assert rc == 0
    check_launches(launches(), {"camera_path": cli_frames}, "--denoise CLI")
    assert image.exists() and image.stat().st_size > 0
    fb, frame = checkpoint.load(str(ckpt_path), device=dev)
    ckpt_path.unlink()
    assert frame == cli_frames
    den = denoise(fb)
    assert bool(torch.isfinite(den).all())
    app["denoise_cli_display_mean"] = fb_mod.to_display(den).float().mean().item()
    print(f"denoised display mean {app['denoise_cli_display_mean']:.2f} (noisy "
          f"{fb_mod.to_display(fb.mean).float().mean().item():.2f}; below 15 means a broken "
          f"render)", flush=True)
    assert app["denoise_cli_display_mean"] > 15.0

    # 27. the denoiser timed on the flagship framebuffer, held against the CPU
    phase(f"denoiser: flagship framebuffer {size} after {cli_frames} frames, CUDA events, "
          f"against the same denoise on the CPU")
    flag = samples.build("flagship", device=dev)
    flag_scene, flag_cam = flag.compile(device=dev), flag.cameras[0]
    tracer = cuda_path.make_camera_path_tracer(flag_scene, flag_cam, cfg)

    def frame_step(fb, frame):
        out = tracer(0, frame * cfg.spp)
        return fb_mod.accumulate(fb, out.radiance, out.aov_normal, out.aov_depth,
                                 out.aov_mat, cfg.height, cfg.width, cfg.spp)

    fb = fb_mod.create(cfg.height, cfg.width, device=dev)
    for f in range(cli_frames):
        fb = frame_step(fb, f)
    denoise(fb)  # warm-up
    runs = []
    for _ in range(7):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        den = denoise(fb)
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end))
    want = denoise(fb_mod.Framebuffer(*(t.cpu() for t in fb)))
    err = (den.cpu() - want).abs()
    torch.testing.assert_close(den.cpu(), want, rtol=1e-4, atol=1e-6)
    app.update(denoise_ms=statistics.median(runs), denoise_ms_runs=runs,
               denoise_max_abs_err=float(err.max()))
    print(f"denoise: median {app['denoise_ms']:.3f} ms of {len(runs)} runs ({runs}); against "
          f"the CPU: max abs err {app['denoise_max_abs_err']:.3g}", flush=True)

    # 28. RenderSession on the flagship
    phase(f"RenderSession: flagship {size}: refine(2), orbit, focus_at the center, "
          f"refine(1), fast render refine(1)")
    s = RenderSession(flag, cfg, seed=0, device=dev)
    reset_counts()
    first = frames_ms(s, 2)
    check_launches(launches(), {"intersect": 2 * cfg.max_depth}, "session refine(2)")
    s.orbit(0.3, 0.1)
    dist = s.focus_at(cfg.width // 2, cfg.height // 2)
    z_far = float(s.camera.z_far)
    print(f"path {s.path_name}; focus distance {dist:.3f} (z_far {z_far})", flush=True)
    assert 0.0 < dist < z_far, dist
    fd = s.camera.focal_depth
    assert fd.shape == () and fd.dtype == torch.float32 and fd.device.type == "cuda"
    reset_counts()
    after = frames_ms(s, 1)
    check_launches(launches(), {"intersect": cfg.max_depth}, "session refine(1) after focus")
    s.set_fast_render(True)
    reset_counts()
    fast = frames_ms(s, 1)
    check_launches(launches(), {"intersect": 2}, "session fast render refine(1)")
    fb = s.framebuffer
    assert fb.mean.device.type == "cuda" and bool(torch.isfinite(fb.mean).all())
    assert float(fb.count.min()) == float(cfg.spp) and s.frame == 1
    snap = s.snapshot(denoise=True)
    assert snap.shape == (cfg.height, cfg.width, 3) and str(snap.dtype) == "uint8"
    app.update(session_flagship_ms_per_frame=first[1][0],
               session_flagship_first_frame_ms=first[0][0],
               session_flagship_after_focus_ms=after[0][0],
               session_flagship_fast_ms=fast[0][0],
               session_flagship_segments_per_s=first[1][1] / (first[1][0] * 1e-3))
    print(f"session flagship: frames {[round(m, 3) for m, _ in first]} ms (the first builds "
          f"the step), after focus {after[0][0]:.3f} ms, fast render {fast[0][0]:.3f} ms; "
          f"{app['session_flagship_segments_per_s']:.4g} segments/s", flush=True)
    del s

    # 29. RenderSession on the mesh scene, uncached and with the first-hit cache
    from fspt_tpu_torch.render.queue import DEFAULT_QUEUE

    msize = f"{cfg_mesh.width}x{cfg_mesh.height}, {cfg_mesh.spp} spp, depth {cfg_mesh.max_depth}"
    min_iters = -(-cfg_mesh.width * cfg_mesh.height * cfg_mesh.spp // DEFAULT_QUEUE)
    for cached in (False, True):
        label = "first-hit cache" if cached else "uncached"
        phase(f"RenderSession: heightfield {msize}, {label}: refine(2)"
              + (", orbit, refine(1)" if cached else ""))
        s = RenderSession(hf_builder, cfg_mesh, seed=0, first_hit_cache=cached, device=dev)
        reset_counts()
        ms = frames_ms(s, 2)
        got = launches()
        print(f"path {s.path_name}; frames {[round(m, 2) for m, _ in ms]} ms; launches {got}",
              flush=True)
        pose = min_iters if cached else 0  # the pose pass: one call a queue-sized chunk
        assert got["intersect"] == got["treelet_cull"] == got["treelet_sweep"] >= \
            2 * min_iters + pose, got
        key = "session_mesh_cached" if cached else "session_mesh"
        app[key + "_ms_per_frame"] = ms[1][0]
        app[key + "_first_frame_ms"] = ms[0][0]
        app[key + "_launches"] = got["treelet_sweep"]
        if cached:
            fh_key = s._fh_key
            s.orbit(0.2, 0.0)
            reset_counts()
            orbit_ms = frames_ms(s, 1)
            got = launches()
            assert s._fh_key != fh_key, "the pose bundle was not rebuilt after the orbit"
            assert got["intersect"] == got["treelet_cull"] == got["treelet_sweep"] >= \
                min_iters + pose, got
            app["session_mesh_cached_after_orbit_ms"] = orbit_ms[0][0]
            print(f"after the orbit: {orbit_ms[0][0]:.2f} ms (pose pass + frame); launches "
                  f"{got}", flush=True)
        fb = s.framebuffer
        assert bool(torch.isfinite(fb.mean).all()) and fb.mean.device.type == "cuda"
        del s

    # 30. the preview on localhost: two stream clients, /ctl during a frame
    phase(f"preview: flagship {cfg_preview.width}x{cfg_preview.height}, {cfg_preview.spp} spp, "
          f"depth {cfg_preview.max_depth} on 127.0.0.1, two /stream clients")
    ps = RenderSession(flag, cfg_preview, seed=0, device=dev)
    alone = frames_ms(ps, 3)  # the session's frames without the server
    ps.reset()
    app["preview_session_ms_per_frame"] = alone[-1][0]
    print(f"session frames alone: {[round(m, 3) for m, _ in alone]} ms", flush=True)
    entered = threading.Event()
    render = ps._render

    def marked(*args, **kwargs):  # marks a frame in flight
        entered.set()
        return render(*args, **kwargs)

    ps._render = marked
    srv = PreviewServer(ps, host="127.0.0.1", port=0)
    server = threading.Thread(target=srv.httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://{srv.host}:{srv.port}"
    seen, stop = ([], []), threading.Event()

    def client(i):
        with urllib.request.urlopen(f"{base}/stream", timeout=120) as r:
            while not stop.is_set():
                part = read_part(r)
                if part is None:
                    return
                seen[i].append(part[0])

    clients = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(2)]
    try:
        for c in clients:
            c.start()
        deadline = time.time() + 120
        while min(len(x) for x in seen) < 3:
            assert time.time() < deadline, f"the clients saw {[len(x) for x in seen]} frames"
            assert all(c.is_alive() for c in clients), "a stream client ended"
            time.sleep(0.01)
        pub0, t0 = srv.published, time.perf_counter()
        time.sleep(preview_window_s)
        pub1, t1 = srv.published, time.perf_counter()
        with srv.lock:
            frame, committed = ps.frame, srv.frames_committed
        snapshot = [list(x) for x in seen]
        published = srv.published
        print(f"clients saw frames {snapshot[0][:8]}... and {snapshot[1][:8]}...; session "
              f"frame {frame}, committed {committed}, published {published}", flush=True)
        # One advance a committed frame, however many clients watch; a frame
        # is published after its commit, outside the session's lock.
        n = srv.frames_per_update
        assert frame == committed and committed - n <= published * n <= committed + n, \
            (frame, committed, published)
        for x in snapshot:
            assert x == sorted(set(x)) and x[-1] <= published, x
        app["preview_fps"] = (pub1 - pub0) / (t1 - t0)
        with srv.lock:
            committed_before = srv.frames_committed
        entered.clear()
        assert entered.wait(timeout=60)  # a frame is in flight
        t_ctl = time.perf_counter()
        msg = urllib.request.urlopen(f"{base}/ctl?yaw=0.3", timeout=60).read()
        app["ctl_ms_in_flight"] = (time.perf_counter() - t_ctl) * 1e3
        assert b"camera origin" in msg
        pub_orbit, deadline = srv.published, time.time() + 60
        while srv.published < pub_orbit + 2:  # at least one frame of the new camera
            assert time.time() < deadline, "no frame published after the orbit"
            time.sleep(0.01)
        with srv.lock:
            frame, committed = ps.frame, srv.frames_committed
            count = float(ps.framebuffer.count.max())
        # The accumulation holds only frames committed after the orbit: a
        # frame rendered for the old camera was dropped, not folded in.
        assert 1 <= frame <= committed - committed_before, (frame, committed, committed_before)
        assert count == frame * cfg_preview.spp, (count, frame)
        app["preview_dropped"] = srv.dropped
        print(f"preview: {app['preview_fps']:.2f} published frames/s over "
              f"{t1 - t0:.2f} s with 2 clients; /ctl?yaw answered in "
              f"{app['ctl_ms_in_flight']:.2f} ms during a frame; dropped {srv.dropped}",
              flush=True)
    finally:
        stop.set()
        srv.shutdown()
        for t in (*clients, server):
            t.join(timeout=60)
    assert not any(t.is_alive() for t in (*clients, server))

    # 31. profiling: a device trace of one frame step, the memory counters
    phase(f"profiling: device_trace of one CLI frame step ({size}), device_memory_stats")
    trace_dir = OUT / "trace"
    fb = fb_mod.create(cfg.height, cfg.width, device=dev)
    for attempt in range(3):  # the tracer can lose a window's device records
        with profiling.device_trace(str(trace_dir), device=dev) as trace_path:
            fb = frame_step(fb, attempt)
        trace = Path(trace_path)
        events = json.loads(trace.read_text())["traceEvents"]
        device_kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        holds_k2 = any("camera_path_kernel" in k for k in device_kernels)
        print(f"trace: {len(events)} events, {len(device_kernels)} device kernels, kernel 2 "
              f"{'held' if holds_k2 else 'missing'}", flush=True)
        if holds_k2:
            break
    assert device_kernels, "the trace holds no device kernel"
    app.update(trace_device_kernels=len(device_kernels), trace_holds_kernel_2=holds_k2,
               trace_attempts=attempt + 1)
    stats = profiling.device_memory_stats(dev)
    assert stats and profiling.device_memory_stats("cpu") == {}
    app.update(trace_bytes=trace.stat().st_size,
               peak_allocated_bytes=stats["allocated_bytes.all.peak"],
               peak_reserved_bytes=stats["reserved_bytes.all.peak"])
    print(f"trace {trace} ({app['trace_bytes']} bytes); memory "
          f"stats: {len(stats)} counters, peak allocated {app['peak_allocated_bytes']} bytes, "
          f"peak reserved {app['peak_reserved_bytes']} bytes", flush=True)
    profiling.log_event("chip_smoke_app", **{k: v for k, v in app.items()
                                            if not isinstance(v, list)})
    trace.unlink()
    return app


def parallel_phases(dev, counters, reset_counts, flag_scene, flag_cam, cfg, tex_scene, tex_cam,
                    hf_scene, hf_cam, inter, cfg_hf, cfg_ss, mid_rays, train_scene, train_cam,
                    cfg_t, target_t, start, frames=4, mesh_queue=MESH_QUEUE):
    """Phases 32-35: the parallel layer on a world of 1 (NCCL on the card)
    — the sharded camera-fused step on the flagship and the textured
    Cornell box at ``cfg`` against the CLI's frame step, and every band of
    a 4-rank world through ``step.local``; the queued mesh step on the
    heightfield at ``cfg_hf`` against ``dispatch.make_scene_step``, and its
    bands; the triangle-sharded fast step at ``cfg_ss`` against the
    replicated mesh step, and the 4-shard decomposition in one process on
    the mid-frame queue iteration ``mid_rays``; fused recovery under
    ``make_mesh(1)`` at ``cfg_t`` against ``mesh=None``, and kernel 8 on two
    half-frame bands against the full frame; the scaling harness and the
    dry run.  Returns the numbers of the ``parallel`` line."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from fspt_tpu_torch import entry
    from fspt_tpu_torch.ops import cuda_grad, kernel_check
    from fspt_tpu_torch.parallel import (make_fused_recovery_step, make_mesh,
                                         make_scene_sharded_render_step,
                                         make_sharded_megakernel_step, make_sharded_render_step,
                                         multihost, sharded_framebuffer)
    from fspt_tpu_torch.parallel.mesh import Mesh
    from fspt_tpu_torch.parallel.scene_shard import (make_shard_intersector,
                                                     merge_stacked_hits, shard_scene_triangles)
    from fspt_tpu_torch.render import framebuffer as fb_mod
    from fspt_tpu_torch.render.dispatch import make_scene_step

    t_start = time.time()
    par = {}
    launches = lambda: {k: c.launches for k, c in counters.items()}  # noqa: E731
    H, W, S = cfg.height, cfg.width, cfg.spp
    size = f"{W}x{H}x{S}, depth {cfg.max_depth}"

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def stitch(bands):
        return fb_mod.Framebuffer(*(torch.cat([getattr(b, k) for b in bands])
                                    for k in fb_mod.Framebuffer._fields))

    def assert_fb_equal(a, b, label):
        for k in fb_mod.Framebuffer._fields:
            assert torch.equal(getattr(a, k), getattr(b, k)), (label, k)

    def abba(fa, fb):
        """Mean ms of two host-bound frames timed alternately, a b b a (one
        call each by CUDA events), so that a drift of the host's pace
        falls on both."""
        a1, b1, b2, a2 = (cuda_time_ms(f, iters=1, warmup=0) for f in (fa, fb, fb, fa))
        return (a1 + a2) / 2, (b1 + b2) / 2

    def assert_fb_close(a, b, label):
        torch.testing.assert_close(a.mean, b.mean, rtol=2e-5, atol=1e-6, msg=label)
        assert torch.equal(a.mat, b.mat), label

    # 32. a world of 1 on NCCL: the camera-fused band step
    multihost.initialize(device=dev)
    backend = str(dist.get_backend())
    mesh = make_mesh(1, device=dev)
    mesh4 = Mesh(group=None, rank=0, size=4, device=mesh.device)  # bands only, no collective
    print(f"world: {dist.get_world_size()} rank on {backend}, mesh of {mesh.size} on "
          f"{mesh.device}", flush=True)
    assert backend == ("nccl" if dev.type == "cuda" else "gloo")
    for label, scene, cam, key in (("flagship", flag_scene, flag_cam, "camera_path"),
                                   ("textured cornell", tex_scene, tex_cam, "deferred_path")):
        phase(f"parallel: sharded megakernel step (world of 1, {backend}), {label} {size}, "
              f"{frames} frames, against the CLI frame step; the 4 bands of a 4-rank world")
        step = make_sharded_megakernel_step(mesh, scene, cam, cfg)
        tracer = step.tracer

        def cli_frame(st):
            out = tracer(0, st["f"] * S)
            st["fb"] = fb_mod.accumulate(st["fb"], out.radiance, out.aov_normal, out.aov_depth,
                                         out.aov_mat, H, W, S)
            st["f"] += 1
            return out.segments

        reset_counts()
        fb = sharded_framebuffer(mesh, H, W)
        for f in range(frames):
            fb, segs = step(fb, 0, f)
        sync()
        got = launches()
        check_launches(got, {key: frames}, f"sharded megakernel step, {label}")
        cli = {"fb": fb_mod.create(H, W, device=dev), "f": 0}
        for _ in range(frames):
            cli_segs = cli_frame(cli)
        assert_fb_equal(fb, cli["fb"], f"sharded step vs CLI frame step, {label}")
        assert int(segs) == int(cli_segs), (int(segs), int(cli_segs))
        st = {"fb": fb, "f": frames}

        def sharded_frame():
            st["fb"], _ = step(st["fb"], 0, st["f"])
            st["f"] += 1

        ms_sharded = cuda_time_ms(sharded_frame, iters=5, warmup=1)
        ms_cli = cuda_time_ms(lambda: cli_frame(cli), iters=5, warmup=1)
        print(f"{label}: sharded step {ms_sharded:.3f} ms/frame (kernel + accumulate + the "
              f"segments' all_reduce) vs CLI frame step {ms_cli:.3f} ms/frame; framebuffer "
              f"bit-equal after {frames} frames; {int(segs)} segments a frame", flush=True)
        step4 = make_sharded_megakernel_step(mesh4, scene, cam, cfg)
        reset_counts()
        bands = [step4.local(b, fb_mod.create(H // 4, W, device=dev), 0, 0) for b in range(4)]
        sync()
        check_launches(launches(), {key: 4}, f"4 bands, {label}")
        one = {"fb": fb_mod.create(H, W, device=dev), "f": 0}
        one_segs = cli_frame(one)
        assert_fb_equal(stitch([b for b, _ in bands]), one["fb"], f"4 bands, {label}")
        assert sum(int(s) for _, s in bands) == int(one_segs)
        print(f"{label}: 4 bands of {H // 4} rows stitched bit-equal to the full frame",
              flush=True)
        par[key] = dict(sharded_ms=ms_sharded, cli_frame_ms=ms_cli, launches=got[key],
                        bit_equal=True, bands_bit_equal=True)

    # 33. the queued mesh step, its bands, and the triangle-sharded step
    Hq, Wq, Sq = cfg_hf.height, cfg_hf.width, cfg_hf.spp
    phase(f"parallel: queued mesh step, make_sharded_render_step(queue={mesh_queue}), "
          f"heightfield {Wq}x{Hq}x{Sq}, depth {cfg_hf.max_depth}, against "
          f"make_scene_step(queue={mesh_queue}); its 4 bands")
    qstep = make_sharded_render_step(mesh, cfg_hf, intersector=inter, queue=mesh_queue)
    _, dstep = make_scene_step(hf_scene, cfg_hf, queue=mesh_queue)
    reset_counts()
    fb_q, segs_q = qstep(hf_scene, hf_cam, sharded_framebuffer(mesh, Hq, Wq), 0, 0)
    sync()
    got = launches()
    iters = got["treelet_sweep"]
    check_launches(got, {"intersect": iters, "treelet_cull": iters, "treelet_sweep": iters},
                   "queued mesh step")
    assert iters > 0
    fb_d, segs_d = dstep(hf_scene, hf_cam, fb_mod.create(Hq, Wq, device=dev), 0, 0)
    assert_fb_close(fb_q, fb_d, "queued mesh step vs make_scene_step")
    assert int(segs_q) == int(segs_d), (int(segs_q), int(segs_d))
    qs = {"fb": fb_q, "f": 1}
    ds = {"fb": fb_d, "f": 1}

    def q_frame(stp, st):
        st["fb"], _ = stp(hf_scene, hf_cam, st["fb"], 0, st["f"])
        st["f"] += 1

    ms_q, ms_d = abba(lambda: q_frame(qstep, qs), lambda: q_frame(dstep, ds))
    q4 = make_sharded_render_step(mesh4, cfg_hf, intersector=inter, queue=mesh_queue)
    bands = [q4.local(b, hf_scene, hf_cam, fb_mod.create(Hq // 4, Wq, device=dev), 0, 0)
             for b in range(4)]
    sync()
    assert_fb_close(stitch([b for b, _ in bands]), fb_q, "4 queued bands")
    assert sum(int(s) for _, s in bands) == int(segs_q)
    print(f"queued mesh step {ms_q:.2f} ms/frame vs make_scene_step {ms_d:.2f} ms/frame; "
          f"{iters} queue iterations (kernels 1, 5, 6 once each); {int(segs_q)} segments; "
          f"4 bands stitched within rtol 2e-5 / atol 1e-6, material AOV equal", flush=True)
    par["queued_mesh"] = dict(sharded_ms=ms_q, scene_step_ms=ms_d, iterations=iters,
                              segments=int(segs_q))

    Hs, Ws, Ss = cfg_ss.height, cfg_ss.width, cfg_ss.spp
    phase(f"parallel: triangle-sharded step (fast=True, world of 1), heightfield "
          f"{Ws}x{Hs}x{Ss}, depth {cfg_ss.max_depth}, against the replicated mesh step")
    ss = make_scene_sharded_render_step(mesh, cfg_ss, hf_scene, fast=True, queue=mesh_queue)
    rep_step = make_sharded_render_step(mesh, cfg_ss, intersector=inter, queue=mesh_queue)
    reset_counts()
    fb_s, segs_s = ss(hf_scene, hf_cam, fb_mod.create(Hs, Ws, device=dev), 0, 0)
    sync()
    got = launches()
    iters_s = got["treelet_sweep"]
    check_launches(got, {"intersect": iters_s, "treelet_cull": iters_s,
                         "treelet_sweep": iters_s}, "triangle-sharded step")
    assert iters_s > 0
    fb_r, segs_r = rep_step(hf_scene, hf_cam, sharded_framebuffer(mesh, Hs, Ws), 0, 0)
    assert_fb_close(fb_s, fb_r, "triangle-sharded vs replicated")
    assert int(segs_s) == int(segs_r), (int(segs_s), int(segs_r))
    ss_st = {"fb": fb_s, "f": 1}
    rp_st = {"fb": fb_r, "f": 1}
    ms_ss, ms_rp = abba(lambda: q_frame(ss, ss_st), lambda: q_frame(rep_step, rp_st))
    print(f"triangle-sharded step {ms_ss:.2f} ms/frame vs replicated mesh step "
          f"{ms_rp:.2f} ms/frame; {iters_s} queue iterations, kernels 1, 5 and 6 once each",
          flush=True)
    par["scene_sharded"] = dict(sharded_ms=ms_ss, replicated_ms=ms_rp, iterations=iters_s,
                                launches=dict(intersect=iters_s, treelet_cull=iters_s,
                                              treelet_sweep=iters_s))

    o, d, alive = mid_rays
    phase(f"parallel: the 4-shard decomposition in one process on the mid-frame queue "
          f"iteration ({o.shape[0]} rays, {int(alive.sum())} live): each shard's kernels 5, 6 "
          f"vs plain, the merge against the replicated intersector")
    built, _, bounds = shard_scene_triangles(hf_scene, 4)
    hits = []
    for s in range(4):
        bind = make_shard_intersector(hf_scene, built[s], fast=True)
        local = bind(hf_scene)
        if dev.type == "cuda":
            rep = kernel_check.check_treelet_kernels(
                bind.traverser, *local.sweep_inputs(o, d, alive)[:3])
            print(f"shard {s} ({int(bounds[s + 1] - bounds[s])} triangles, "
                  f"{bind.traverser.tables.n_leaves} treelets): kernels 5, 6 vs plain "
                  f"{json.dumps(rep)}", flush=True)
        hits.append(local(o, d, alive))
    merged = merge_stacked_hits(hits)
    ref = inter(o, d, alive)
    sync()
    n_live = int(alive.sum())
    agree = alive & (merged.prim_id == ref.prim_id)
    n_agree = int(agree.sum())
    t_equal = bool(torch.equal(merged.t[agree], ref.t[agree]))
    rest = alive & ~agree
    dt = (merged.t[rest] - ref.t[rest]).abs()
    print(f"merged 4-shard hits vs replicated: ids equal on {n_agree} of {n_live} live rays "
          f"({n_agree / max(n_live, 1):.6f}), t bit-equal where they agree: {t_equal}; "
          f"{n_live - n_agree} rays differ (max |dt| {float(dt.max()) if dt.numel() else 0:.3g})",
          flush=True)
    assert n_agree >= 0.9999 * n_live and t_equal
    par["four_shards"] = dict(live=n_live, ids_equal=n_agree, differ=n_live - n_agree,
                              t_bit_equal_where_ids_agree=t_equal)

    # 34. recovery under a mesh
    Ht, Wt = cfg_t.height, cfg_t.width
    phase(f"parallel: fused recovery under make_mesh(1), flagship {Wt}x{Ht}x{cfg_t.spp}, "
          f"depth {cfg_t.max_depth}: pool 1 (kernel 8) against mesh=None, pool 8 (kernels "
          f"9-10); kernel 8 on two half-frame bands against the full frame")
    params0 = {k: start[k] for k in ("diffuse", "emissive")}
    runs = {}
    for label, m in (("mesh", mesh), ("none", None)):
        step = make_fused_recovery_step(m, train_scene, train_cam, cfg_t, pool=1, lr=0.5)
        params = dict(params0)
        reset_counts()
        losses = []
        for it in range(2):
            params, loss = step(params, train_scene, train_cam, target_t, 9, it)
            losses.append(loss)
        sync()
        check_launches(launches(), {"fused_loss": 2}, f"pool 1, mesh {label}")
        runs[label] = (params, losses, step)
    for k in params0:
        assert torch.equal(runs["mesh"][0][k], runs["none"][0][k]), k
    assert all(torch.equal(a, b) for a, b in zip(runs["mesh"][1], runs["none"][1]))
    ms_mesh = cuda_time_ms(lambda: runs["mesh"][2](params0, train_scene, train_cam, target_t,
                                                   9, 0), iters=3, warmup=1)
    ms_none = cuda_time_ms(lambda: runs["none"][2](params0, train_scene, train_cam, target_t,
                                                   9, 0), iters=3, warmup=1)
    step8 = make_fused_recovery_step(mesh, train_scene, train_cam, cfg_t, pool=8, lr=0.5)
    reset_counts()
    p8, loss8 = step8(dict(params0), train_scene, train_cam, target_t, 9, 0)
    sync()
    check_launches(launches(), {"grad_forward": 2, "grad_sweep": 2}, "pool 8 under a mesh")
    assert np.isfinite(float(loss8)) and all(bool(torch.isfinite(v).all()) for v in p8.values())
    ms_8 = cuda_time_ms(lambda: step8(params0, train_scene, train_cam, target_t, 9, 0),
                        iters=2, warmup=0)
    fused = cuda_grad.make_fused_loss_grad_fn(train_scene, train_cam, cfg_t)
    half = Ht // 2
    reset_counts()
    loss_f, g_f, seg_f = fused(params0, target_t, 9, 0, 0, Ht)
    parts = [fused(params0, target_t[y0:y0 + half], 9, 0, y0, half) for y0 in (0, half)]
    sync()
    check_launches(launches(), {"fused_loss": 3}, "kernel 8 on the frame and two bands")
    loss_b = (parts[0][0] + parts[1][0]) / 2
    torch.testing.assert_close(loss_b, loss_f, rtol=1e-5, atol=0.0)
    for k in g_f:
        torch.testing.assert_close((parts[0][1][k] + parts[1][1][k]) / 2, g_f[k], rtol=1e-5,
                                   atol=1e-5 * float(g_f[k].abs().max()))
    assert int(parts[0][2]) + int(parts[1][2]) == int(seg_f)
    print(f"pool 1 under make_mesh(1): 2 steps bit-equal to mesh=None; {ms_mesh:.2f} ms/step "
          f"vs {ms_none:.2f} ms/step with mesh=None; pool 8 {ms_8:.2f} ms/step; kernel 8 on "
          f"bands y0 = 0 and {half}: mean loss {float(loss_b):.8g} vs full frame "
          f"{float(loss_f):.8g} (rel {abs(float(loss_b / loss_f) - 1):.3g})", flush=True)
    par["recovery"] = dict(pool1_mesh_ms=ms_mesh, pool1_none_ms=ms_none, pool8_mesh_ms=ms_8,
                           bit_equal=True, band_loss_rel_err=abs(float(loss_b / loss_f) - 1))

    # 35. the scaling harness and the dry run
    phase(f"parallel: multihost.measure_scaling(device_counts=[1], use_megakernel=True), "
          f"flagship {size}; entry.dryrun_multichip(1)")
    rows = multihost.measure_scaling(flag_scene, flag_cam, cfg, device_counts=[1], frames=3,
                                     use_megakernel=True)
    print(f"scaling: {json.dumps(rows)}", flush=True)
    assert [r["devices"] for r in rows] == [1] and rows[0]["rays_per_sec"] > 0
    dry = entry.dryrun_multichip(1, device=dev)
    print(f"dryrun_multichip(1): {json.dumps(dry)}", flush=True)
    assert dry["queued_segments"] == dry["bvh_segments"] > 0
    par["scaling"] = rows
    par["dryrun"] = dry
    dist.destroy_process_group()
    par["phases_s"] = time.time() - t_start
    print(f"phases 32-35: {par['phases_s']:.1f} s", flush=True)
    return par


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1

    from fspt_tpu_torch import cli
    from fspt_tpu_torch.camera import generate_rays, rays_for_lanes
    from fspt_tpu_torch.config import RenderConfig
    import numpy as np

    from fspt_tpu_torch.ops import (_build, cuda_bvh, cuda_grad, cuda_path, cuda_trace,
                                    kernel_check, rng)
    from fspt_tpu_torch.parallel import train
    from fspt_tpu_torch.render import framebuffer as fb_mod
    from fspt_tpu_torch.render.dispatch import make_scene_step
    from fspt_tpu_torch.scene import samples
    from fspt_tpu_torch.utils import checkpoint

    dev = torch.device("cuda")
    counters = {"intersect": cuda_trace.INTERSECT,
                "camera_path": cuda_path.CAMERA_PATH,
                "ray_path": cuda_path.RAY_PATH,
                "deferred_path": cuda_path.DEFERRED_PATH,
                "affine_planes": cuda_grad.AFFINE_PLANES,
                "fused_loss": cuda_grad.FUSED_LOSS,
                "treelet_cull": cuda_bvh.TREELET_CULL,
                "treelet_sweep": cuda_bvh.TREELET_SWEEP,
                "grad_forward": cuda_grad.GRAD_FORWARD,
                "grad_backward": cuda_grad.GRAD_BACKWARD,
                "grad_sweep": cuda_grad.GRAD_SWEEP,
                "fused_loss_chain": cuda_grad.FUSED_LOSS_CHAIN,
                "bvh_walk": cuda_bvh.BVH_WALK,
                "treelet_walk": cuda_bvh.TREELET_WALK,
                "mesh_camera_path": cuda_path.MESH_CAMERA_PATH}

    def reset_counts():
        for c in counters.values():
            c.launches = 0

    # 1. card
    phase("card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    smi = smi[0] if smi else "nvidia-smi gave nothing"
    print(f"device: {name}; nvidia-smi: {smi}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    # 2. build
    phase("build (nvcc, sm_90a, one nvcc per library, all at once)")
    t0 = time.time()
    _build.build_all()
    for lib in _build.LIBRARIES:
        _build.library(lib)
    build_s = time.time() - t0
    regs = ptxas_report(_build.ptxas_log())
    print(f"build: {build_s:.1f} s (0 if the libraries for these sources existed)")
    for k, v in regs.items():
        print(f"ptxas {k}: {v.get('registers')} registers, spill stores/loads "
              f"{v.get('spill')} bytes, stack frame {v.get('stack')} bytes, static shared "
              f"memory {v.get('smem', 0)} bytes")
    for k in PTXAS_NAMES:
        assert k in regs, f"no ptxas report for {k}"

    report = {}

    # 3. kernel 1 against its plain version
    phase("kernel 1 (intersect) vs plain: 1M random segments, all-primitive scene")
    prim = samples.build("all_primitives", device=dev).compile(device=dev)
    start, seg = kernel_check.random_segments(1 << 20, seed=1, device=dev)
    report["intersect"] = kernel_check.check_intersect(prim.geometry, start, seg)
    print(json.dumps(report["intersect"]), flush=True)

    # 4. kernel 3 against its plain version
    cfg256 = RenderConfig(width=256, height=256, spp=4, max_depth=8)
    phase("kernel 3 (ray_path) vs plain: all families, 256x256x4, depth 8")
    fam = samples.build("all_families", device=dev)
    report["ray_path"] = kernel_check.check_path_tracer(
        fam.compile(device=dev), fam.cameras[0], cfg256, seed=4)
    print(json.dumps(report["ray_path"]), flush=True)

    # 5. kernel 2 against its plain version, with DoF and the band split
    phase("kernel 2 (camera_path) vs plain: all families + DoF, 256x256x4, depth 8")
    famd = samples.build("all_families", device=dev, aperture=1.5, focal_depth=120.0)
    report["camera_path"] = kernel_check.check_camera_tracer(
        famd.compile(device=dev), famd.cameras[0], cfg256, seed=5, sample0=2)
    print(json.dumps(report["camera_path"]), flush=True)

    # 6. main path: the CLI
    phase("main path: fspt_tpu_torch.cli, scenes/cornell.scene 1024x1024, 4 spp, "
          "depth 8, 4 frames")
    OUT.mkdir(parents=True, exist_ok=True)
    image = OUT / "cornell_1024.png"
    ckpt_path = OUT / "cornell_1024.npz"
    image.unlink(missing_ok=True)
    ckpt_path.unlink(missing_ok=True)
    reset_counts()
    rc = cli.main(["--file", str(ROOT / "scenes" / "cornell.scene"),
                   "--width", "1024", "--height", "1024", "--spp", "4",
                   "--depth", "8", "--frames", "4", "--seed", "0",
                   "--output", str(image), "--checkpoint", str(ckpt_path)])
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    print(f"main path launches: {launches}")
    assert rc == 0
    assert launches["camera_path"] == 4, launches
    assert image.exists() and image.stat().st_size > 0
    fb, frame = checkpoint.load(str(ckpt_path), device=dev)
    ckpt_path.unlink()  # 50 MB at this size: keep only the image
    assert frame == 4 and torch.isfinite(fb.mean).all()
    display_mean = fb_mod.to_display(fb.mean).float().mean().item()
    print(f"display mean {display_mean:.2f} (below 15 means a broken render)")
    assert display_mean > 15.0, display_mean
    path_launches = {"camera_path": launches["camera_path"]}

    # 7. dispatch path and rays-in path
    cfg512 = RenderConfig(width=512, height=512, spp=1, max_depth=8)
    corn = samples.build("flagship", device=dev)
    flag_scene, flag_cam = corn.compile(device=dev), corn.cameras[0]
    phase("dispatch path: make_scene_step, flagship 512x512x1, depth 8, 2 frames")
    name_d, step = make_scene_step(flag_scene, cfg512)
    reset_counts()
    fb = fb_mod.create(512, 512, device=dev)
    for f in range(2):
        fb, segs = step(flag_scene, flag_cam, fb, 0, f)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    print(f"{name_d}: launches {launches}, last-frame segments {int(segs)}")
    assert launches["intersect"] == cfg512.max_depth * 2, launches
    assert torch.isfinite(fb.mean).all()
    path_launches["intersect"] = launches["intersect"]
    dispatch_mean = fb.mean.mean().item()

    phase("rays-in path: generate_rays + make_path_tracer, flagship 512x512x1, "
          "depth 8, 2 frames")
    tracer3 = cuda_path.make_path_tracer(flag_scene, cfg512, z_far=float(flag_cam.z_far))
    reset_counts()
    fb = fb_mod.create(512, 512, device=dev)
    for f in range(2):
        r = generate_rays(flag_cam, 512, 512, 1, 0, f)
        out = tracer3(*r, 0)
        fb = fb_mod.accumulate(fb, out.radiance, out.aov_normal, out.aov_depth,
                               out.aov_mat, 512, 512, 1)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    print(f"rays-in launches {launches}; mean {fb.mean.mean().item():.5f} vs "
          f"dispatch path {dispatch_mean:.5f}")
    assert launches["ray_path"] == 2, launches
    # Same estimator, same streams: the two paths agree to float noise.
    assert abs(fb.mean.mean().item() - dispatch_mean) <= 1e-2 * max(dispatch_mean, 1e-6)
    path_launches["ray_path"] = launches["ray_path"]

    # 8. timing at the headline size, each kernel also held against its
    # plain version at these shapes
    phase("timing: flagship Cornell 1024x1024x4, depth 8 (CUDA events)")
    cfg = RenderConfig(width=1024, height=1024, spp=4, max_depth=8)
    n = cfg.width * cfg.height * cfg.spp
    hs = cuda_trace.HostScene(flag_scene.geometry)
    mats = cuda_path.HostMaterials(flag_scene.materials)
    seg_ops = hs.segment_ops()
    timings = {}

    tracer2 = cuda_path.make_camera_path_tracer(flag_scene, flag_cam, cfg)
    cam = cuda_path.HostCamera(flag_cam, cfg.width, cfg.height)
    raygen = cuda_path.build_fused_raygen(cam, cfg)
    core = cuda_path.build_path_core(hs, mats, cfg, int(flag_scene.sky_mat), cam.z_far)
    h0 = rng.seed_hash(0)
    out2 = tracer2(0, 0)
    full = kernel_check.compare_paths(
        out2, cuda_path.planes_to_output(core(h0, *raygen(h0, 0, 0, n, dev))), every=True)
    full.update(kernel_check.check_lane_independence(tracer2, 0, 0, n, out2))
    del out2
    segments = full["segments"]
    print(f"camera_path vs plain at 1024x1024x4 (radiance bit-equal on "
          f"{full['radiance_bits_equal']:.6f} of values): {json.dumps(full)}")
    ms2 = cuda_time_ms(lambda: tracer2(0, 0), iters=10, warmup=2)
    plain2 = cuda_time_ms(lambda: core(h0, *raygen(h0, 0, 0, n, dev)), iters=1)
    b2, by2 = bound_ms(segments * seg_ops, n * 36)
    timings["camera_path"] = dict(ms=ms2, plain_ms=plain2, bound_ms=b2, bound_by=by2,
                                  max_abs_err=full["max_abs_err"])
    print(f"camera_path: {ms2:.3f} ms/frame, {segments} segments/frame, "
          f"{segments / (ms2 * 1e-3):.4g} segments/s; plain {plain2:.1f} ms; "
          f"bound {b2:.4f} ms ({by2}: {seg_ops} ops/segment lower bound)", flush=True)

    start, seg, pix, smp = generate_rays(flag_cam, cfg.width, cfg.height, cfg.spp, 0, 0)
    tracer3 = cuda_path.make_path_tracer(flag_scene, cfg, z_far=float(flag_cam.z_far))

    def plain3_fn():
        return core(h0, start[:, 0], start[:, 1], start[:, 2],
                    seg[:, 0], seg[:, 1], seg[:, 2], pix, smp)

    full3 = kernel_check.compare_paths(tracer3(start, seg, pix, smp, 0),
                                       cuda_path.planes_to_output(plain3_fn()))
    seg3 = full3["segments"]
    print(f"ray_path vs plain at 1024x1024x4: {json.dumps(full3)}")
    ms3 = cuda_time_ms(lambda: tracer3(start, seg, pix, smp, 0), iters=10, warmup=2)
    plain3 = cuda_time_ms(plain3_fn, iters=1)
    b3, by3 = bound_ms(seg3 * seg_ops, n * (24 + 8 + 36))
    timings["ray_path"] = dict(ms=ms3, plain_ms=plain3, bound_ms=b3, bound_by=by3,
                               max_abs_err=full3["max_abs_err"])
    print(f"ray_path: {ms3:.3f} ms/frame, {seg3} segments, "
          f"{seg3 / (ms3 * 1e-3):.4g} segments/s; plain {plain3:.1f} ms; "
          f"bound {b3:.4f} ms ({by3})", flush=True)

    n1 = 1 << 22
    s1, d1 = kernel_check.random_segments(n1, seed=2, device=dev)

    def intersect_timing(label, geometry):
        """Kernel 1 against its plain version on the 4M segments, then both
        timed beside the bound (24 B in and 32 B out a segment; the walk's
        operations)."""
        hs1 = cuda_trace.HostScene(geometry)
        full1 = kernel_check.check_intersect(geometry, s1, d1)
        print(f"intersect vs plain at 4M segments, {label} ({hs1.prim_count} rows): "
              f"{json.dumps(full1)}")
        ms1 = cuda_time_ms(lambda: cuda_trace.launch_intersect(hs1, s1, d1), iters=20, warmup=2)
        plain1 = cuda_time_ms(lambda: cuda_trace.plain_intersect(hs1, s1, d1), iters=2)
        b1, by1 = bound_ms(n1 * hs1.segment_ops(), n1 * (24 + 32))
        grid1, tile1 = cuda_trace.intersect_plan(hs1.prim_count, n1)
        print(f"intersect, {label}: {ms1:.4f} ms for {n1} segments, {n1 / (ms1 * 1e-3):.4g} "
              f"segments/s; plain {plain1:.1f} ms; bound {b1:.4f} ms ({by1}: "
              f"{hs1.segment_ops()} ops/segment); grid {grid1} blocks x {tile1} segments a "
              f"stride; card {smi}", flush=True)
        return dict(ms=ms1, plain_ms=plain1, bound_ms=b1, bound_by=by1,
                    max_abs_err=full1["max_abs_err"], t_close=full1["t_close"],
                    normal_close=full1["normal_close"], uv_close=full1["uv_close"])

    timings["intersect"] = intersect_timing("flagship", flag_scene.geometry)
    k1_prim = intersect_timing("all_primitives", prim.geometry)
    timings["intersect"].update({f"{k}_all_primitives": v for k, v in k1_prim.items()})

    # 8b. the CLI's frame step end to end: kernel 2 + framebuffer.accumulate
    phase("end to end: CLI frame step (camera_path + accumulate), flagship 1024x1024x4")
    state = {"fb": fb_mod.create(cfg.height, cfg.width, device=dev), "frame": 0}

    def cli_step():
        out = tracer2(0, state["frame"] * cfg.spp)
        state["fb"] = fb_mod.accumulate(state["fb"], out.radiance, out.aov_normal,
                                        out.aov_depth, out.aov_mat,
                                        cfg.height, cfg.width, cfg.spp)
        state["frame"] += 1

    step_ms = cuda_time_ms(cli_step, iters=10, warmup=2)
    print(f"frame step: {step_ms:.3f} ms, {segments / (step_ms * 1e-3):.4g} segments/s "
          f"end to end", flush=True)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            cli_step()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    # Kernel-level events only: an aten op's device time repeats its kernels'.
    dev_us = {e.key: e.self_device_time_total for e in events
              if e.device_type == DeviceType.CUDA}
    busy_us = sum(dev_us.values())
    kernel_us = sum(v for k, v in dev_us.items() if "camera_path_kernel" in k)
    print(f"profile of 5 frame steps: window {window_us:.0f} us, device busy "
          f"{busy_us:.0f} us ({busy_us / window_us:.1%}), camera_path_kernel "
          f"{kernel_us:.0f} us ({kernel_us / max(busy_us, 1e-9):.1%} of device time)")
    (OUT / "profile_frame_step.txt").write_text(
        events.table(sort_by="self_device_time_total", row_limit=15))
    assert kernel_us > 0, "the profiler saw no camera_path_kernel time"

    # 8c. kernels 1 and 7 at the 512-row limit
    phase("kernels 1 and 7 vs plain at the 512-row limit: the flagship and 498 spheres")
    rows512 = samples.build("flagship_rows", device=dev, rows=512)
    scene512 = rows512.compile(device=dev)
    n512 = cuda_trace.HostScene(scene512.geometry).prim_count
    assert n512 == cuda_trace.MAX_SPECIALIZED_PRIMS, n512
    # csrc rows_smem: the rows, their (kind, material) pairs, the first row
    # of each of the 6 kinds and the end.
    staged = n512 * (4 * cuda_trace.PRIM_STRIDE + 8) + 7 * 4
    for fn in (KERNELS["intersect"][0], KERNELS["affine_planes"][0]):
        r = regs[fn]
        print(f"ptxas {fn}: {r.get('registers')} registers, spill stores/loads "
              f"{r.get('spill')} bytes, stack frame {r.get('stack')} bytes, static shared "
              f"memory {r.get('smem', 0)} bytes; dynamic shared memory at {n512} rows "
              f"{staged} bytes")
    k1_512 = intersect_timing("512 rows", scene512.geometry)
    timings["intersect"].update({f"{k}_512_rows": v for k, v in k1_512.items()})
    cfg_r512 = RenderConfig(width=128, height=128, spp=2, max_depth=4)
    report["affine_planes"] = kernel_check.check_affine_planes(scene512, rows512.cameras[0],
                                                               cfg_r512, seed=7)
    print(f"affine_planes vs plain at 512 rows, 128x128x2, depth 4: "
          f"{json.dumps(report['affine_planes'])}", flush=True)
    del scene512

    # 9. kernel 4 against its plain version
    famt = samples.build("all_families_textured", device=dev, aperture=1.5,
                         focal_depth=120.0)
    famt_scene = famt.compile(device=dev)
    for fast in (False, True):
        phase(f"kernel 4 (deferred_path) vs the fold of its plain planes: textured all "
              f"families + DoF, 256x256x4, depth 8, fast_render={fast}")
        cfg_f = RenderConfig(width=256, height=256, spp=4, max_depth=8, fast_render=fast)
        rep4 = kernel_check.check_deferred_tracer(famt_scene, famt.cameras[0], cfg_f,
                                                  seed=6, sample0=2)
        print(json.dumps(rep4), flush=True)
        report["deferred_path"] = max(report.get("deferred_path", rep4), rep4,
                                      key=lambda r: r["max_abs_err"])

    # 10. kernels 7 and 8 against their plain versions
    for fast in (False, True):
        phase(f"kernel 7 (affine_planes) vs plain: textured all families + DoF, "
              f"256x256x4, depth 8, fast_render={fast}")
        cfg_f = RenderConfig(width=256, height=256, spp=4, max_depth=8, fast_render=fast)
        rep7 = kernel_check.check_affine_planes(famt_scene, famt.cameras[0], cfg_f, seed=7)
        print(json.dumps(rep7), flush=True)
        report["affine_planes"] = max(report.get("affine_planes", rep7), rep7,
                                      key=lambda r: r["max_abs_err"])
    phase("kernel 8 (fused_loss) vs plain: flagship 256x256x4, depth 8")
    rng_np = np.random.default_rng(0)
    target256 = torch.from_numpy(rng_np.random((256, 256, 3), dtype=np.float32)).to(dev)
    report["fused_loss"] = kernel_check.check_fused_loss(
        flag_scene, flag_cam, cfg256, target256, seed=8, frame_idx=3)
    print(json.dumps(report["fused_loss"]), flush=True)

    # 11. textured main path: the CLI on a textured copy of cornell.scene
    phase("textured main path: fspt_tpu_torch.cli, textured cornell.scene 1024x1024, "
          "4 spp, depth 8, 4 frames")
    tex_scene_file = samples.write_textured_cornell(
        ROOT / "scenes" / "cornell.scene", OUT / "cornell_textured.scene",
        ROOT / "tests" / "data" / "piz_pattern.exr", ROOT / "tests" / "data" / "piz_dome.exr")
    tex_image = OUT / "cornell_textured_1024.png"
    tex_ckpt = OUT / "cornell_textured_1024.npz"
    tex_image.unlink(missing_ok=True)
    tex_ckpt.unlink(missing_ok=True)
    reset_counts()
    rc = cli.main(["--file", str(tex_scene_file), "--width", "1024", "--height", "1024",
                   "--spp", "4", "--depth", "8", "--frames", "4", "--seed", "0",
                   "--output", str(tex_image), "--checkpoint", str(tex_ckpt)])
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    print(f"textured main path launches: {launches}")
    assert rc == 0
    assert launches["deferred_path"] == 4 and launches["camera_path"] == 0, launches
    fb, frame = checkpoint.load(str(tex_ckpt), device=dev)
    tex_ckpt.unlink()
    assert frame == 4 and torch.isfinite(fb.mean).all()
    display_mean = fb_mod.to_display(fb.mean).float().mean().item()
    print(f"display mean {display_mean:.2f} (below 15 means a broken render)")
    assert display_mean > 15.0, display_mean
    path_launches["deferred_path"] = launches["deferred_path"]

    # 12. training path at full width
    cfg_t = RenderConfig(width=1920, height=1080, spp=4, max_depth=8)
    n_t = cfg_t.width * cfg_t.height * cfg_t.spp
    phase("training path: make_fused_recovery_step, flagship 1920x1080x4, depth 8")
    trainer = samples.build("flagship", device=dev)
    train_scene, train_cam = trainer.compile(device=dev), trainer.cameras[0]
    tracer_t = cuda_path.make_camera_path_tracer(train_scene, train_cam, cfg_t)
    fb = fb_mod.create(cfg_t.height, cfg_t.width, device=dev)
    for f in range(2):
        out = tracer_t(0, f * cfg_t.spp)
        fb = fb_mod.accumulate(fb, out.radiance, out.aov_normal, out.aov_depth,
                               out.aov_mat, cfg_t.height, cfg_t.width, cfg_t.spp)
    target_t = fb.mean
    true = {k: getattr(train_scene.materials, k) for k in ("diffuse", "emissive")}
    start = {"diffuse": (true["diffuse"] * torch.from_numpy(rng_np.uniform(
                 0.6, 1.4, tuple(true["diffuse"].shape)).astype(np.float32)).to(dev)
                 ).clamp(0.0, 1.0),
             "emissive": true["emissive"] * 0.7}
    adam = lambda ps: torch.optim.Adam(ps, lr=0.02)  # noqa: E731
    # Radiometric fields at pool 1 take kernel 8's affine construction; at
    # pool 8 an untextured scene takes kernels 9-10 (phase 19).
    steps = 5
    step = train.make_fused_recovery_step(None, train_scene, train_cam, cfg_t, pool=1,
                                          optimizer=adam)
    params = dict(start)
    state = step.init(params)
    reset_counts()
    step_times, losses = [], []
    for it in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, train_scene, train_cam, target_t, 9, it)
        torch.cuda.synchronize()
        step_times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        finite = np.isfinite(losses[-1]) and all(
            bool(torch.isfinite(v).all()) for v in params.values())
        print(f"pool=1 step {it}: loss {losses[-1]:.6g} ({step_times[-1]:.1f} ms)",
              flush=True)
        assert finite, it
    launches = {k: c.launches for k, c in counters.items()}
    check_launches(launches, {"fused_loss": steps}, "pool=1")
    assert losses[-1] < losses[0], losses
    path_launches["fused_loss"] = launches["fused_loss"]
    busy1 = profile_window(
        lambda: step(params, state, train_scene, train_cam, target_t, 9, steps),
        "recovery_pool1", counters)
    phase("texture example: recover_texture at 512x512, 3 iterations")
    reset_counts()
    from fspt_tpu_torch.examples import recover_texture

    assert recover_texture.main(["--iters", "3", "--width", "512", "--height", "512",
                                 "--out", str(OUT / "recover_tex")]) == 0
    torch.cuda.synchronize()
    # Kernel 7 (the textured scene's construction 3): 6 target frames, two
    # renders per step, 12 frames of the two final images.
    launches = {k: c.launches for k, c in counters.items()}
    check_launches(launches, {"affine_planes": 6 + 2 * 3 + 12}, "texture example")
    path_launches["affine_planes"] = launches["affine_planes"]

    # 13. timings of kernels 4, 7 and 8 at their main-path shapes
    phase("timing: kernel 4 on the textured cornell.scene 1024x1024x4, depth 8")
    from fspt_tpu_torch.scene.parser import load_scene

    tb = load_scene(str(tex_scene_file), device=dev)
    tex_scene = tb.compile(device=dev)
    tracer4 = cuda_path.make_camera_path_tracer(tex_scene, tb.cameras[0], cfg)
    out4 = tracer4(0, 0)
    full4 = kernel_check.compare_paths(
        out4, tracer4.fold(tracer4.plain_planes(0, 0, 0, n)), every=True)
    full4.update(kernel_check.check_lane_independence(tracer4, 0, 0, n, out4))
    del out4
    seg4 = full4["segments"]
    print(f"deferred_path vs the fold of its plain planes at 1024x1024x4 (radiance "
          f"bit-equal on {full4['radiance_bits_equal']:.6f} of values): {json.dumps(full4)}")
    ms4 = cuda_time_ms(lambda: tracer4(0, 0), iters=10, warmup=2)
    plain4 = cuda_time_ms(lambda: tracer4.fold(tracer4.plain_planes(0, 0, 0, n)), iters=1)
    S = cuda_path.n_slots(cfg)
    hs4 = cuda_trace.HostScene(tex_scene.geometry)
    # The body's walk of every primitive row per segment, and the fold's 21
    # float operations a slot and lane (L += T·(t·se + ke), T *= t·s + k).
    b4, by4 = bound_ms(seg4 * hs4.segment_ops() + n * S * 21, n * 36)
    timings["deferred_path"] = dict(ms=ms4, plain_ms=plain4, bound_ms=b4, bound_by=by4,
                                    max_abs_err=full4["max_abs_err"])
    print(f"deferred_path: {ms4:.3f} ms/frame (the trace and its texel fold), {seg4} "
          f"segments, {seg4 / (ms4 * 1e-3):.4g} segments/s; plain {plain4:.1f} ms; bound "
          f"{b4:.4f} ms ({by4}: {hs4.segment_ops()} ops/segment, {S} slots x 21 ops and "
          f"36 B a lane)", flush=True)
    state4 = {"fb": fb_mod.create(cfg.height, cfg.width, device=dev), "frame": 0}

    def textured_step():
        out = tracer4(0, state4["frame"] * cfg.spp)
        state4["fb"] = fb_mod.accumulate(state4["fb"], out.radiance, out.aov_normal,
                                         out.aov_depth, out.aov_mat, cfg.height,
                                         cfg.width, cfg.spp)
        state4["frame"] += 1

    tstep_ms = cuda_time_ms(textured_step, iters=10, warmup=2)
    print(f"textured frame step (kernel 4 + accumulate): {tstep_ms:.3f} ms, "
          f"{seg4 / (tstep_ms * 1e-3):.4g} segments/s end to end", flush=True)
    # No fold runs after kernel 4: beside it the step launches the device
    # kernels of the untextured frame step (phase 8b) beside kernel 2, the
    # accumulate's, as often.
    state2 = {"fb": fb_mod.create(cfg.height, cfg.width, device=dev), "frame": 0}

    def flagship_step():
        out = tracer2(0, state2["frame"] * cfg.spp)
        state2["fb"] = fb_mod.accumulate(state2["fb"], out.radiance, out.aov_normal,
                                         out.aov_depth, out.aov_mat, cfg.height,
                                         cfg.width, cfg.spp)
        state2["frame"] += 1

    tex_kernels, flag_kernels = {}, {}
    busy4 = profile_window(textured_step, "textured_step", counters, kernels=tex_kernels)
    profile_window(flagship_step, "frame_step", counters, kernels=flag_kernels)
    k4 = {k: c for k, c in tex_kernels.items() if KERNELS["deferred_path"][0] in k}
    rest4 = {k: c for k, c in tex_kernels.items() if k not in k4}
    rest2 = {k: c for k, c in flag_kernels.items() if KERNELS["camera_path"][0] not in k}
    print(f"textured frame step: device busy {busy4}; kernel 4 {k4}; other device "
          f"kernels {rest4} (untextured step: {rest2})")
    assert busy4 is not None and list(k4.values()) == [1] and rest4 == rest2, (k4, rest4)

    def affine_bound(planes, segments, n_x, cfg_x):
        """Kernel 7's bound: the walk's operations, or the bytes it writes a
        lane (each slot's field planes, mat and mat_e; p_light's byte and the
        segment count)."""
        slot_bytes = 4 * ((5 if planes.mats.any_textured else 3) + 2)
        S_x = cuda_path.n_slots(cfg_x)
        b7, by7 = bound_ms(segments * planes.scene.segment_ops(), n_x * (S_x * slot_bytes + 5))
        return b7, by7, f"{S_x} slots x {slot_bytes} B + 5 B a lane"

    phase("timing: kernels 7 and 8 on the flagship 1920x1080x4, depth 8, and kernel 7 on a "
          "270-row band of it")
    planes7 = cuda_grad.make_affine_planes(train_scene, train_cam, cfg_t)
    full7 = kernel_check.check_affine_planes(train_scene, train_cam, cfg_t, seed=9)
    print(f"affine_planes vs plain at 1920x1080x4: {json.dumps(full7)}")
    ms7_1080 = cuda_time_ms(lambda: planes7(9, 0, 0, n_t), iters=10, warmup=2)
    b7_1080, by7_1080, how7 = affine_bound(planes7, full7["segments"], n_t, cfg_t)
    hs_t = cuda_trace.HostScene(train_scene.geometry)
    print(f"affine_planes: {ms7_1080:.3f} ms/frame at 1920x1080x4, {full7['segments']} "
          f"segments; bound {b7_1080:.4f} ms ({by7_1080}: {how7}); card {smi}", flush=True)
    # The reference's affine_image operating point (bench.py:321-331): one
    # band of 270 rows, 2,073,600 lanes.
    band_rows, band_y0 = 270, 270
    n_band = band_rows * cfg_t.width * cfg_t.spp
    rep7_band = kernel_check.check_affine_planes(train_scene, train_cam, cfg_t, seed=9,
                                                 y0=band_y0, rows=band_rows)
    print(f"affine_planes vs plain on rows {band_y0}-{band_y0 + band_rows - 1} of 1920x1080x4: "
          f"{json.dumps(rep7_band)}")
    ms7_band = cuda_time_ms(lambda: planes7(9, 0, band_y0 * cfg_t.width * cfg_t.spp, n_band),
                            iters=10, warmup=2)
    b7_band, by7_band, how7 = affine_bound(planes7, rep7_band["segments"], n_band, cfg_t)
    print(f"affine_planes: {ms7_band:.4f} ms on the {band_rows}-row band ({n_band} lanes, "
          f"{rep7_band['segments']} segments); bound {b7_band:.4f} ms ({by7_band}: {how7}); "
          f"card {smi}", flush=True)

    fused = cuda_grad.make_fused_loss_grad_fn(train_scene, train_cam, cfg_t)
    full8 = kernel_check.check_fused_loss(train_scene, train_cam, cfg_t, target_t,
                                          seed=7, frame_idx=1, params=start)
    seg8 = full8["segments"]
    print(f"fused_loss vs plain at 1920x1080x4 (two launches bit for bit: "
          f"{full8['bit_equal']}): {json.dumps(full8)}")
    calls = {"f": 2}

    def fused_call():
        out = fused(start, target_t, 7, calls["f"], 0, cfg_t.height)
        calls["f"] += 1
        return out

    ms8 = cuda_time_ms(fused_call, iters=10, warmup=2)
    _, grads8, _ = fused_call()
    assert all(bool(torch.isfinite(g).all()) for g in grads8.values())
    ms8_again = cuda_time_ms(fused_call, iters=10, warmup=1)
    plain8 = cuda_time_ms(lambda: fused.plain(start, target_t, 7, 1, 0, cfg_t.height),
                          iters=1)
    b8, by8 = bound_ms(seg8 * hs_t.segment_ops(), target_t.numel() * 4)
    # A trace floor: kernel 9 over the lanes of both buffers (the same float
    # body in direct mode, without the fold and its adjoint).  Kernel 9 runs
    # regenerating lanes, a schedule kernel 8 affine (one lane a thread for
    # all depths) does not share: a floor of the body, not of its schedule.
    pair8 = cuda_grad.make_grad_path_tracer(train_scene, train_cam, cfg_t)
    pv8 = cuda_grad.pack_params(start, pair8.fields)
    spp_t = cfg_t.spp

    def two_traces():
        pair8.kernel_forward(pv8, 7, 2 * spp_t, 0, n_t)
        pair8.kernel_forward(pv8, 7, (2 + 10007) * spp_t, 0, n_t)

    floor8 = cuda_time_ms(two_traces, iters=5)
    block8, grid8 = cuda_grad.loss_plan(cuda_path.HostMaterials(train_scene.materials).count,
                                        cuda_path.n_slots(cfg_t), n_t)
    timings["fused_loss"] = dict(ms=ms8, plain_ms=plain8, bound_ms=b8, bound_by=by8,
                                 max_abs_err=full8["max_abs_err"], ms_again=ms8_again,
                                 two_kernel9_ms=floor8, block=block8, grid=grid8)
    steady = step_times[1:]
    ms_step = sum(steady) / len(steady)
    print(f"fused_loss: {ms8:.3f} ms/call ({ms8_again:.3f} again), {seg8} segments (both "
          f"buffers), fwd+bwd {seg8 / (ms8 * 1e-3):.4g} segments/s; block {block8}, grid "
          f"{grid8}; plain {plain8:.1f} ms; bound {b8:.4f} ms ({by8}); 2 x kernel 9 on the "
          f"same lanes {floor8:.3f} ms (the body's trace floor on regenerating lanes, not "
          f"on kernel 8's one-lane-a-thread schedule; beside the bound); card {smi}",
          flush=True)
    print(f"recovery step pool=1 (affine): {ms_step:.2f} ms/step (mean of steps 1.., host "
          f"clock), device busy {'not read' if busy1 is None else f'{busy1:.1%}'} of a "
          f"profiled step, fwd+bwd {seg8 / (ms_step * 1e-3):.4g} segments/s (~{seg8} "
          f"segments per step, both buffers); card {smi}", flush=True)

    # Kernel 8 affine at the widest table it takes: 64 material rows, 16
    # slots (the plan's smaller block).
    cfg_mm = RenderConfig(width=512, height=512, spp=4, max_depth=16)
    n_mm = cfg_mm.width * cfg_mm.height * cfg_mm.spp
    phase(f"kernel 8 affine at 64 material rows and 16 slots: many_materials "
          f"{cfg_mm.width}x{cfg_mm.height}x{cfg_mm.spp}, depth {cfg_mm.max_depth}")
    mmb = samples.build("many_materials", device=dev, rows=64)
    mm_scene, mm_cam = mmb.compile(device=dev), mmb.cameras[0]
    target_mm = torch.from_numpy(np.random.default_rng(2).random(
        (cfg_mm.height, cfg_mm.width, 3), dtype=np.float32)).to(dev)
    rep_mm = kernel_check.check_fused_loss(mm_scene, mm_cam, cfg_mm, target_mm, seed=5,
                                           frame_idx=1)
    print(f"fused_loss vs plain at 64 rows, 16 slots: {json.dumps(rep_mm)}", flush=True)
    fused_mm = cuda_grad.make_fused_loss_grad_fn(mm_scene, mm_cam, cfg_mm)
    params_mm = {f: getattr(mm_scene.materials, f) for f in ("diffuse", "emissive")}
    ms_mm = cuda_time_ms(lambda: fused_mm(params_mm, target_mm, 5, 2, 0, cfg_mm.height),
                         iters=3)
    block_mm, grid_mm = cuda_grad.loss_plan(64, cuda_path.n_slots(cfg_mm), n_mm)
    print(f"fused_loss at 64 rows, 16 slots: {ms_mm:.3f} ms/call, {rep_mm['segments']} "
          f"segments, {rep_mm['segments'] / (ms_mm * 1e-3):.4g} segments/s; block {block_mm}, "
          f"grid {grid_mm}; card {smi}", flush=True)
    timings["fused_loss"].update(ms_64_rows_16_slots=ms_mm, block_64_rows_16_slots=block_mm)
    # Kernel 7 on the same table, where a walk code once cost kernel 8.
    rep7_mm = kernel_check.check_affine_planes(mm_scene, mm_cam, cfg_mm, seed=5)
    print(f"affine_planes vs plain at 64 rows, 16 slots: {json.dumps(rep7_mm)}", flush=True)
    planes_mm = cuda_grad.make_affine_planes(mm_scene, mm_cam, cfg_mm)
    ms7_mm = cuda_time_ms(lambda: planes_mm(5, 0, 0, n_mm), iters=10, warmup=2)
    b7_mm, by7_mm, how7 = affine_bound(planes_mm, rep7_mm["segments"], n_mm, cfg_mm)
    print(f"affine_planes at 64 rows, 16 slots: {ms7_mm:.4f} ms, {rep7_mm['segments']} "
          f"segments; bound {b7_mm:.4f} ms ({by7_mm}: {how7}); card {smi}", flush=True)
    report["fused_loss"]["max_abs_err"] = max(report["fused_loss"]["max_abs_err"],
                                              rep_mm["max_abs_err"])

    # Kernel 7 at its launch shape on the main path: the texture example's
    # scene at 512x512x4, depth 3 (5 float planes and 2 rows: 28 B a slot).
    from fspt_tpu_torch.examples import recover_texture

    cfg_tx = RenderConfig(width=512, height=512, spp=4, max_depth=3)
    n_tx = cfg_tx.width * cfg_tx.height * cfg_tx.spp
    phase(f"timing: kernel 7 at the texture example's shape, {cfg_tx.width}x{cfg_tx.height}"
          f"x{cfg_tx.spp}, depth {cfg_tx.max_depth}, textured")
    txb = recover_texture.build_scene(dev)
    tx_scene, tx_cam = txb.compile(device=dev), txb.cameras[0]
    rep_tx = kernel_check.check_affine_planes(tx_scene, tx_cam, cfg_tx, seed=9)
    print(f"affine_planes vs plain at the texture example's shape: {json.dumps(rep_tx)}")
    planes_tx = cuda_grad.make_affine_planes(tx_scene, tx_cam, cfg_tx)
    # The wrapper's host work takes about as long as this launch, so the
    # kernel's own time comes from the trace.
    ms7 = kernel_device_ms(lambda: planes_tx(9, 0, 0, n_tx), KERNELS["affine_planes"][0],
                           iters=100)
    ms7_call = cuda_time_ms(lambda: planes_tx(9, 0, 0, n_tx), iters=100, warmup=2)
    plain7 = cuda_time_ms(lambda: planes_tx.plain(9, 0, 0, n_tx), iters=1)
    b7, by7, how7 = affine_bound(planes_tx, rep_tx["segments"], n_tx, cfg_tx)
    timings["affine_planes"] = dict(
        ms=ms7, plain_ms=plain7, bound_ms=b7, bound_by=by7,
        max_abs_err=max(full7["max_abs_err"], rep_tx["max_abs_err"],
                        rep7_band["max_abs_err"], rep7_mm["max_abs_err"]),
        ms_call=ms7_call, ms_1080p_flagship=ms7_1080, bound_ms_1080p_flagship=b7_1080,
        ms_band_270_rows=ms7_band, bound_ms_band_270_rows=b7_band, ms_64_rows_16_slots=ms7_mm,
        bound_ms_64_rows_16_slots=b7_mm)
    print(f"affine_planes: {ms7:.4f} ms/frame at the texture example's shape (device time "
          f"a launch from the profiler, 100 launches; {ms7_call:.4f} ms a wrapper call by "
          f"CUDA events), {rep_tx['segments']} segments, "
          f"{rep_tx['segments'] / (ms7 * 1e-3):.4g} segments/s; "
          f"plain {plain7:.1f} ms; bound {b7:.4f} ms ({by7}: {how7}); "
          f"{ms7_1080:.3f} ms at 1920x1080x4 on the flagship (bound {b7_1080:.4f}), "
          f"{ms7_band:.4f} on its 270-row band (bound {b7_band:.4f}), {ms7_mm:.4f} at 64 rows "
          f"(bound {b7_mm:.4f}); card {smi}", flush=True)

    # 14. kernels 5 and 6 against their plain versions on the mesh scene
    from fspt_tpu_torch.render.queue import DEFAULT_QUEUE, render_queued

    phase("kernels 5 (treelet_cull) and 6 (treelet_sweep) vs plain: heightfield, "
          "65,536 primaries and one queue iteration's bounce rays")
    hfb = samples.build("heightfield", device=dev)
    hf_scene, hf_cam = hfb.compile(device=dev), hfb.cameras[0]
    inter = cuda_bvh.make_mesh_intersector(hf_scene)
    trav = inter.traverser
    n_tris = hf_scene.tri_shade.mat.shape[0]
    print(f"heightfield: {n_tris} triangles, {trav.tables.n_leaves} treelets", flush=True)
    assert n_tris == 99458 and trav.tables.n_leaves == 778

    def recorded_iterations(cfg_r, keep):
        """Run one queued heightfield frame; the intersector's inputs of the
        calls in ``keep`` (queue iterations) and the number of calls."""
        calls = {}

        def recording(o, d, alive):
            idx = recording.n
            recording.n += 1
            if idx in keep:
                calls[idx] = (o.clone(), d.clone(), alive.clone())
            return inter(o, d, alive)

        recording.n = 0
        recording.accepts_alive = True
        render_queued(hf_scene, hf_cam, cfg_r, 0, 0, intersector=recording,
                      queue=DEFAULT_QUEUE)
        return calls, recording.n

    cfg_hf256 = RenderConfig(width=256, height=256, spp=1, max_depth=4)
    prim = generate_rays(hf_cam, 256, 256, 1, 0, 0)[:2]
    calls, _ = recorded_iterations(cfg_hf256, {1})
    for kind, (o, d, alive) in (("primaries", (*prim, None)), ("bounces", calls[1])):
        rep = kernel_check.check_treelet_kernels(trav, *inter.sweep_inputs(o, d, alive)[:3])
        print(f"{kind}: {json.dumps(rep)}", flush=True)
        for key in ("treelet_cull", "treelet_sweep"):
            report.setdefault(key, {"max_abs_err": 0.0})
            report[key]["max_abs_err"] = max(report[key]["max_abs_err"], rep["max_abs_err"])

    # 15. the mesh frame, kernel path against plain path
    phase("mesh frame vs plain: heightfield 256x256x1, depth 4, queued (kernels 1, 5, 6)")
    rep = kernel_check.check_mesh_frame(hf_scene, hf_cam, cfg_hf256, seed=2)
    print(json.dumps(rep), flush=True)

    # 16. mesh main path: the CLI on the heightfield scene, on kernel 13 (the
    # heightfield-render cell's frame) and cached on the queue
    hf_file = samples.write_heightfield_scene(OUT / "heightfield")
    n_hf = 1024 * 1024 * 4
    min_iters = -(-n_hf // DEFAULT_QUEUE)  # every lane passes through the queue
    mesh_frames = 3
    for cached in (False, True):
        label = "with --first-hit-cache (queue)" if cached else "uncached (kernel 13)"
        phase(f"mesh main path: fspt_tpu_torch.cli, heightfield 1024x1024, 4 spp, depth 4, "
              f"{mesh_frames} frames, {label}")
        hf_image = OUT / f"heightfield_1024{'_cached' if cached else ''}.png"
        hf_ckpt = OUT / "heightfield_1024.npz"
        hf_image.unlink(missing_ok=True)
        hf_ckpt.unlink(missing_ok=True)
        reset_counts()
        t0 = time.time()
        rc = cli.main(["--file", str(hf_file), "--width", "1024", "--height", "1024",
                       "--spp", "4", "--depth", "4", "--frames", str(mesh_frames),
                       "--seed", "0", "--output", str(hf_image), "--checkpoint", str(hf_ckpt)]
                      + (["--first-hit-cache"] if cached else []))
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {k: c.launches for k, c in counters.items()}
        k13 = launches["mesh_camera_path"]
        assert rc == 0
        if not cached:
            print(f"mesh CLI {label}: {wall:.1f} s; kernel 13 launches {k13}; launches "
                  f"{launches}", flush=True)
            check_launches(launches, {"mesh_camera_path": mesh_frames}, "mesh CLI, kernel 13")
            path_launches["mesh_camera_path"] = k13
        else:
            # One launch of each of kernels 1, 5 and 6 per queue iteration,
            # and one per chunk of the pose pass.
            pose_calls = min_iters
            iters = launches["treelet_sweep"] - pose_calls
            print(f"mesh CLI {label}: {wall:.1f} s; launches {launches}; queue iterations "
                  f"per frame {iters / mesh_frames:.1f}; per frame: intersect "
                  f"{(launches['intersect'] - pose_calls) / mesh_frames:.1f}, treelet_cull "
                  f"{(launches['treelet_cull'] - pose_calls) / mesh_frames:.1f}, "
                  f"treelet_sweep {iters / mesh_frames:.1f}", flush=True)
            assert k13 == 0
            assert launches["intersect"] == launches["treelet_cull"] == launches["treelet_sweep"]
            assert iters >= mesh_frames * min_iters, launches
        fb, frame, extra = checkpoint.load(str(hf_ckpt), device=dev, with_extra=True)
        hf_ckpt.unlink()
        assert frame == mesh_frames and bool(extra["first_hit_cache"]) == cached
        assert torch.isfinite(fb.mean).all()
        display_mean = fb_mod.to_display(fb.mean).float().mean().item()
        print(f"display mean {display_mean:.2f} (below 15 means a broken render)")
        assert display_mean > 15.0, display_mean
        if not cached:
            uncached_mean = fb.mean.mean().item()
        else:
            for key in ("treelet_cull", "treelet_sweep"):
                path_launches[key] = launches[key]
            k1_mesh = launches["intersect"]
            # Same scene, another estimator (frozen jitter): close means.
            print(f"mean radiance cached {fb.mean.mean().item():.5f} vs uncached "
                  f"{uncached_mean:.5f}")
            assert abs(fb.mean.mean().item() - uncached_mean) <= 0.05 * uncached_mean

    # 16. (cont.) kernel 13 at the cell's frame against its plain version,
    # timed beside the frozen mesh work count, with the counting build's cost
    timings.update(mesh_phase(hf_scene, hf_cam, RenderConfig(width=1024, height=1024, spp=4,
                                                             max_depth=4), report, regs))

    # 17. mesh timings: the frame step at the reference's mesh_100k queue
    # (bench.py:155), and at the port's default queue for comparison
    phase(f"timing: mesh frame step (heightfield 1024x1024x4, depth 4) at queue {MESH_QUEUE} "
          f"and {DEFAULT_QUEUE}, and kernels 5, 6")
    cfg_hf = RenderConfig(width=1024, height=1024, spp=4, max_depth=4)
    mstate = {"fb": fb_mod.create(1024, 1024, device=dev), "frame": 0, "segs": 0}
    for q in (MESH_QUEUE, DEFAULT_QUEUE):
        name_m, mesh_step = make_scene_step(hf_scene, cfg_hf, queue=q)
        assert name_m.startswith("queued wavefront + cuda treelet BVH"), name_m

        def mesh_frame(step=mesh_step):
            mstate["fb"], segs = step(hf_scene, hf_cam, mstate["fb"], 0, mstate["frame"])
            mstate["frame"] += 1
            mstate["segs"] = segs

        mesh_ms = cuda_time_ms(mesh_frame, iters=3, warmup=1)
        mesh_segs = int(mstate["segs"])
        print(f"mesh frame step, queue {q}: {mesh_ms:.2f} ms/frame, {mesh_segs} "
              f"segments/frame, {mesh_segs / (mesh_ms * 1e-3):.4g} segments/s end to end",
              flush=True)
    _, mesh_step = make_scene_step(hf_scene, cfg_hf, queue=MESH_QUEUE)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            mesh_frame(mesh_step)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    dev_ev = {e.key: (e.self_device_time_total, e.count) for e in events
              if e.device_type == DeviceType.CUDA}
    busy_us = sum(us for us, _ in dev_ev.values())

    def dev_ms(pred):
        return sum(us for k, (us, _) in dev_ev.items() if pred(k)) / 2 / 1e3

    stage_ms = {
        "treelet_cull": dev_ms(lambda k: "treelet_cull_kernel" in k),
        "treelet_sweep": dev_ms(lambda k: "treelet_sweep_kernel" in k),
        "intersect": dev_ms(lambda k: "intersect_kernel" in k),
        "sorts": dev_ms(lambda k: "sort" in k.lower() or "radix" in k.lower()),
    }
    stage_ms["other torch (queue, post, gathers)"] = busy_us / 2 / 1e3 - sum(stage_ms.values())
    print(f"profile of 2 mesh frames at queue {MESH_QUEUE}: window {window_us:.0f} us, device busy {busy_us:.0f} us "
          f"({busy_us / window_us:.1%}); device ms per frame by stage: "
          f"{json.dumps({k: round(v, 4) for k, v in stage_ms.items()})}", flush=True)
    (OUT / "profile_mesh_frame.txt").write_text(
        events.table(sort_by="self_device_time_total", row_limit=30))
    assert stage_ms["treelet_sweep"] > 0 and stage_ms["treelet_cull"] > 0

    # Per-launch timings on full queues of 262,144 rays: the primaries of
    # image rows 512-575 (the queue's first iterations start at the bottom
    # rows, which see only the floor) and the rays of a mid-frame queue
    # iteration (bounces).
    mid = min_iters + 2
    calls, n_calls = recorded_iterations(cfg_hf, {mid})
    lanes = torch.arange(8 * DEFAULT_QUEUE, 9 * DEFAULT_QUEUE, dtype=torch.int32, device=dev)
    prim = rays_for_lanes(hf_cam, 1024, 1024, 4, 0, 0, lanes)[:2]
    mesh_t = {}
    for kind, (o, d, alive) in (("primaries", (*prim, None)), ("bounces", calls[mid])):
        start_s, seg_s, t_init_s, _ = inter.sweep_inputs(o, d, alive)
        full = kernel_check.check_treelet_kernels(trav, start_s, seg_s, t_init_s)
        print(f"{kind} at the main path's shape, kernels vs plain: {json.dumps(full)}")
        live = int((t_init_s > 0).sum())
        F = cuda_bvh.ray_features(start_s, seg_s, t_init_s)
        tables = trav.tables
        L = tables.n_leaves
        key = cuda_bvh.launch_cull(F, tables)
        counts, order, tlo = cuda_bvh.order_from_key(key)
        t_k, best_k, visits = cuda_bvh.launch_sweep(counts, order, tlo, F, tables)
        n_pad, B = F.shape[0], F.shape[0] // cuda_bvh.BLOCK_RAYS
        ms5 = cuda_time_ms(lambda: cuda_bvh.launch_cull(F, tables), iters=20, warmup=2)
        plain5 = cuda_time_ms(lambda: cuda_bvh.plain_cull(F, tables), iters=1)
        ms_sort = cuda_time_ms(lambda: cuda_bvh.order_from_key(key), iters=20, warmup=2)
        ms6 = cuda_time_ms(lambda: cuda_bvh.launch_sweep(counts, order, tlo, F, tables),
                           iters=20, warmup=2)
        plain6 = cuda_time_ms(lambda: cuda_bvh.plain_sweep(counts, order, tlo, F, tables),
                              iters=1)
        ms_post = cuda_time_ms(lambda: trav.post(start_s, seg_s, t_k[:start_s.shape[0]],
                                                 best_k[:start_s.shape[0]]), iters=20, warmup=2)
        vis_sum = int(visits.long().sum())
        b5, by5 = bound_ms(live * L * cuda_bvh.OPS_PER_SLAB,
                           n_pad * cuda_bvh.N_FEATURES * 4 + L * 24 + B * L * 4)
        b6, by6 = bound_ms(vis_sum * cuda_bvh.BLOCK_RAYS * cuda_bvh.TREELET
                           * cuda_bvh.OPS_PER_TRIANGLE,
                           n_pad * cuda_bvh.N_FEATURES * 4 + tables.weights.numel() * 4
                           + B * (4 + 8 * L) + n_pad * 8 + B * 4)
        mesh_t[kind] = {
            "treelet_cull": dict(ms=ms5, plain_ms=plain5, bound_ms=b5, bound_by=by5,
                                 max_abs_err=full["max_abs_err"]),
            "treelet_sweep": dict(ms=ms6, plain_ms=plain6, bound_ms=b6, bound_by=by6,
                                  max_abs_err=full["max_abs_err"])}
        print(f"{kind} iteration: {n_pad} rays ({live} live), {B} blocks; survivors/block "
              f"{counts.float().mean().item():.1f}; leaf visits/block mean "
              f"{visits.float().mean().item():.2f} max {int(visits.max())} (sum {vis_sum}); "
              f"treelet_cull {ms5:.4f} ms (plain {plain5:.2f}, bound {b5:.4f} {by5}); "
              f"key sort {ms_sort:.4f} ms; treelet_sweep {ms6:.4f} ms (plain {plain6:.2f}, "
              f"bound {b6:.4f} {by6}); post {ms_post:.4f} ms", flush=True)
        threads5, leaves5 = cuda_bvh.cull_shape(L)
        live_blk = (F[:, 10] > 0).view(B, -1).sum(1).float()
        print(f"{kind} treelet_cull: live rays {live} of {n_pad} ({live / n_pad:.1%}), a block "
              f"mean {live_blk.mean().item():.1f}, blocks with none "
              f"{int((live_blk == 0).sum())} of {B}; CTA {threads5} threads ({leaves5} leaf "
              f"boxes a thread, {L} leaves), {regs['treelet_cull_kernel'].get('registers')} "
              f"registers; every key bit-equal: {full['key_equal']}", flush=True)
        mesh_t[kind]["treelet_cull"].update(threads=threads5, leaves_a_thread=leaves5,
                                            live_rays=live)
        vq = torch.quantile(visits.float(), torch.tensor([0.5, 0.9, 0.99], device=dev)).tolist()
        sw, (threads, rays, slices) = regs["treelet_sweep_kernel"], cuda_bvh.sweep_shape()
        print(f"{kind} leaf visits a block p50/p90/p99/max {vq[0]:g}/{vq[1]:g}/{vq[2]:g}/"
              f"{int(visits.max())}; treelet_sweep CTA {threads} threads "
              f"({rays} rays a thread, {slices} threads a ray), "
              f"{sw.get('smem', 0)} bytes static shared memory, {sw.get('registers')} "
              f"registers, blocks heaviest first", flush=True)
    print(f"queue iterations per frame: {n_calls}")
    timings.update(mesh_t["bounces"])  # a mid-frame iteration: the kernels line

    # 18-21. the path-body adjoint: kernels 9, 10 and 8's whole chain
    rep_adj, t_adj, launches_adj = adjoint_phases(
        dev, counters, reset_counts, RenderConfig(width=128, height=128, spp=2, max_depth=4),
        cfg_t, train_scene, train_cam, target_t, start, hs_t.segment_ops(),
        ["--iters", "40", "--out", str(OUT / "recover_cam")])
    report.update(rep_adj)
    timings.update(t_adj)
    path_launches.update(launches_adj)

    # 22-24. vertex recovery and kernels 11 and 12
    rep_v, t_v, launches_v, step_v, walk_routes = vertex_phases(
        dev, counters, reset_counts, hf_scene, hf_cam, inter,
        RenderConfig(width=512, height=512, spp=2, max_depth=2, edge_eps=0.05), [],
        calls[mid])
    for key, rep in rep_v.items():
        report[key] = {"max_abs_err": max(report.get(key, rep)["max_abs_err"],
                                          rep["max_abs_err"])}
    timings.update(t_v)
    path_launches.update(launches_v)

    # 25. the kernels line, the card line, the result
    phase("kernels")
    # Kernel 1 on each path: the dispatch path's camera-dynamic frames (the
    # kernels line's count), the mesh frame's queue seeds, the vertex step's
    # record.
    print(f"kernel 1 launches: dispatch path {path_launches['intersect']} (2 frames x depth "
          f"{cfg512.max_depth}); mesh CLI {k1_mesh} (first-hit cache: one a queue iteration "
          f"and one a pose chunk, {mesh_frames} frames); vertex step "
          f"{step_v['intersect']:g} a step (its record, one a depth)", flush=True)
    timings["intersect"].update(launches_mesh_cli=k1_mesh,
                                launches_vertex_step=step_v["intersect"])
    # The ptxas lines of the reverse kernels' instantiations at the timed depth:
    # <0> with the per-thread record, <1> with the device scratch.
    record = int(cuda_grad.adjoint_plan(1, 1, cfg_t.effective_depth)[1] > 0)
    variant = {"grad_backward": f"<{record}>", "fused_loss_chain": f"<{record}>",
               "grad_forward": "<1>",  # kernel 9 as the pool-8 route runs it, recording
               "mesh_camera_path": "<0>",  # kernel 13 as the main path runs it, counting nothing
               "deferred_path": "<0>"}  # kernel 4 likewise
    kernels = []
    for key, c in counters.items():
        t = timings[key]
        fn, source = KERNELS[key]
        reg = regs[fn + variant.get(key, "")]
        extra = {k: v for k, v in t.items() if k not in (
            "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
        kernels.append(dict(
            name=key, route="cuda", source=f"{source} ({fn})",
            replaces=c.replaces, launches=path_launches.get(key, 0),
            max_abs_err=max(report[key]["max_abs_err"], t["max_abs_err"]), ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=None, ported=True, registers=reg.get("registers"),
            spill_bytes=reg.get("spill"), stack_bytes=reg.get("stack"), **extra))
    # The routes of phase 24: ms from the same rays to (t, id), a ray set each.
    routes = {label: {m: r[m] for m in ("culled", "bvh_walk", "treelet_walk", "morton_sort",
                                        "bvh_walk_unsorted", "treelet_walk_unsorted")}
              for label, r in walk_routes.items()}
    print(json.dumps({"kernels": kernels, "walk_routes": routes}))

    # 26-31. the app layer
    app = app_phases(dev, counters, reset_counts, cfg,
                     RenderConfig(width=1024, height=1024, spp=4, max_depth=4), hfb,
                     RenderConfig(width=400, height=240, spp=1))
    print(json.dumps({"app": app}))

    # 32-35. the parallel layer on a world of 1
    par = parallel_phases(dev, counters, reset_counts, flag_scene, flag_cam, cfg, tex_scene,
                          tb.cameras[0], hf_scene, hf_cam, inter, cfg_hf,
                          RenderConfig(width=512, height=512, spp=2, max_depth=3), calls[mid],
                          train_scene, train_cam, cfg_t, target_t, start)
    par["card"] = smi
    print(json.dumps({"parallel": par}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
