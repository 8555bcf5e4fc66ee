"""Multi-process and multi-host rendering on torch.distributed.

Port of fspt_tpu/parallel/multihost.py.  Multi-host is the same code as one
process: a world of ranks (one a card, NCCL; or CPU ranks on gloo) and a
mesh over them; the band sharding (parallel/render.py) and the mean-reduced
gradients (parallel/train.py) run over its collectives unchanged, and the
images stay bit-identical to one device's because the RNG streams key on
global pixel ids.

A single process gets its world of 1 from :func:`initialize` without
arguments (an in-process store, no network); ``torchrun`` processes get
theirs from its environment.  :func:`parallel.mesh.make_mesh` needs the
world up and says so otherwise.

Scaling-efficiency harness per the driver metric (BASELINE.md: ≥85% rays/s
efficiency 1 chip → 1 host → N hosts): :func:`measure_scaling`.
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist

from fspt_tpu_torch.config import resolve_device
from fspt_tpu_torch.parallel.mesh import BACKENDS, _rank_device, make_mesh
from fspt_tpu_torch.parallel.render import (gather_framebuffer, make_sharded_render_step,
                                            sharded_framebuffer)


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device=None):
    """Bring up the torch.distributed world; a no-op when one is up.

    ``coordinator_address`` is ``host:port`` (or any ``init_method`` URL:
    ``tcp://…``, ``file://…``) of rank 0, with ``num_processes`` and this
    process's ``process_id``.  Without arguments it reads the ``torchrun``
    environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``) where it is set, and otherwise makes a world
    of 1 on an in-process store.  The backend is the device's: NCCL on the
    card (the default), gloo on ``device="cpu"``.  On the card each rank
    then takes the card of its place among the ranks on its host
    (``LOCAL_RANK`` under ``torchrun``, else counted from the world's host
    names), and a host with more ranks than cards is refused.
    """
    dev = resolve_device(device)
    if dist.is_initialized():
        return
    backend = BACKENDS[dev.type]
    env = os.environ
    if coordinator_address is None and num_processes is None and "WORLD_SIZE" in env:
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
        coordinator_address = "env://"
    if dev.type == "cuda" and "LOCAL_RANK" in env:
        torch.cuda.set_device(int(env["LOCAL_RANK"]))
    if coordinator_address is None and num_processes is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    elif coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize needs coordinator_address, num_processes and "
                         "process_id together")
    else:
        url = coordinator_address
        if "://" not in url:
            url = f"tcp://{url}"
        dist.init_process_group(backend, init_method=url, world_size=int(num_processes),
                                rank=int(process_id))
    if dev.type == "cuda":
        torch.cuda.set_device(_rank_device(dev))


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def measure_scaling(scene, camera, cfg, device_counts=None, frames: int = 5, seed: int = 7,
                    use_megakernel: bool = False, work_conserving: bool = False):
    """Rays/s at several mesh sizes → scaling-efficiency table.

    Collective: every rank of the world calls it.  Each size ``n`` runs on
    the mesh of the first ``n`` ranks (the others wait), on the device of
    ``scene``; every rank returns rank 0's table.  ``use_megakernel``
    measures the camera-fused kernel's band step (kernel 2, or 4 on a
    textured scene) instead of the torch integrator.

    ``work_conserving``: efficiency mode for ranks that share one set of
    cores (CPU worlds in tests): every size renders the same full frame
    split n ways, so ideal sharding costs constant wall time and
    ``efficiency = t_1 / t_n`` isolates the sharding overhead.  On real
    cards leave False: each rank adds capacity and efficiency is rays/s
    against linear.
    """
    from fspt_tpu_torch.parallel.render import make_sharded_megakernel_step

    dev = scene.device
    world = dist.get_world_size() if dist.is_initialized() else 1
    if device_counts is None:
        device_counts = sorted({1, max(1, world // 2), world})
    results = []
    for n_dev in device_counts:
        if cfg.height % n_dev:
            continue
        mesh = make_mesh(n_dev, device=dev)
        if mesh.member:
            fb = sharded_framebuffer(mesh, cfg.height, cfg.width)
            if use_megakernel:
                mk = make_sharded_megakernel_step(mesh, scene, camera, cfg)
                if mk is None:
                    raise ValueError("scene can't use the megakernel")
                step = lambda sc, cam, fb_, sd, fr: mk(fb_, sd, fr)  # noqa: E731
            else:
                step = make_sharded_render_step(mesh, cfg)
            fb, segs = step(scene, camera, fb, seed, 0)  # warm
            _sync(dev)
            t0 = time.perf_counter()
            for f in range(frames):
                fb, segs = step(scene, camera, fb, seed, f + 1)
            _sync(dev)
            dt = (time.perf_counter() - t0) / frames
            # Every band finished: the slowest rank sets the frame time.
            dt = float(mesh.all_reduce(torch.tensor([dt], dtype=torch.float64,
                                                    device=mesh.device),
                                       dist.ReduceOp.MAX))
            gather_framebuffer(mesh, fb)  # the global array, as the reference reads it
            results.append(dict(devices=n_dev, rays_per_sec=int(segs) / dt, wall_s=dt))
        if world > 1:
            dist.barrier()
    if world > 1:
        box = [results]
        dist.broadcast_object_list(box, src=0)
        results = box[0]
    if not results:
        return results
    if work_conserving:
        base_t = results[0]["wall_s"]
        for r in results:
            r["efficiency"] = base_t / r["wall_s"]
    else:
        base = results[0]["rays_per_sec"]
        for r in results:
            ideal = base * r["devices"] / results[0]["devices"]
            r["efficiency"] = r["rays_per_sec"] / ideal
    return results


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
