"""The port's device mesh: ranks of a ``torch.distributed`` world.

Port of fspt_tpu/parallel/mesh.py.  One logical axis, ``"rays"``,
data-parallels the pixel and ray batch; the scene and the camera are
replicated and the framebuffer is band-sharded.  The reference's JAX
constructs map onto torch.distributed as follows:

==========================================  ====================================================
JAX (reference)                              port
==========================================  ====================================================
1-D ``Mesh`` over axis ``"rays"``            :class:`Mesh`: process group, rank, world size, this
                                             rank's device
``shard_map`` with ``P(RAY_AXIS)``           each rank runs the local step on its band:
                                             ``y0 = rank · rows_local``
``P()``, replicated                          every rank holds its own copy
``psum``                                     ``all_reduce(SUM)``
``pmean``                                    ``all_reduce(SUM) / world``
``pmin`` / ``pmax``                          ``all_reduce(MIN / MAX)``
``axis_index``                               ``rank``
reading a global sharded array               ``all_gather`` of the bands
==========================================  ====================================================

Backends: NCCL for ``cuda``, gloo for ``cpu``; one rank per card.  A world
comes up through :func:`parallel.multihost.initialize` (or ``torchrun``);
:func:`make_mesh` takes the first ``n`` ranks of it.  Boolean flags are
reduced as ``int32``, which both backends take (``scene_shard.merge_hits``
casts its hit flag so).
"""

from __future__ import annotations

import dataclasses
import os
import socket

import torch
import torch.distributed as dist

from fspt_tpu_torch.config import resolve_device

RAY_AXIS = "rays"

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _world():
    if not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed world is up: call "
            "fspt_tpu_torch.parallel.multihost.initialize() first (a world of 1 "
            "without arguments, or the torchrun environment)")
    return dist.get_world_size(), dist.get_rank()


def _host_ranks(world: int, rank: int) -> tuple[int, int]:
    """(ranks on this host, this rank's place among them): ``torchrun``'s
    ``LOCAL_WORLD_SIZE`` and ``LOCAL_RANK`` where it set them, else counted
    from the world's host names (collective; over gloo, since NCCL needs
    each rank's card first)."""
    env = os.environ
    if "LOCAL_WORLD_SIZE" in env and "LOCAL_RANK" in env:
        return int(env["LOCAL_WORLD_SIZE"]), int(env["LOCAL_RANK"])
    if world == 1:
        return 1, 0
    group = None if str(dist.get_backend()).lower() == "gloo" else dist.new_group(backend="gloo")
    hosts = [None] * world
    dist.all_gather_object(hosts, socket.gethostname(), group=group)
    return hosts.count(hosts[rank]), hosts[:rank].count(hosts[rank])


def _local_card() -> int:
    """This rank's card: its place among the ranks on its host.  Raises
    where the host runs more ranks than it has cards, since NCCL refuses
    two ranks on one card."""
    local_world, local_rank = _host_ranks(*_world())
    cards = torch.cuda.device_count()
    if local_world > cards:
        raise RuntimeError(f"{local_world} ranks on this host but {cards} visible CUDA "
                           "cards: NCCL takes one rank per card")
    return local_rank


def _rank_device(device=None) -> torch.device:
    """This rank's device: the CPU, or its card (:func:`_local_card`)."""
    dev = resolve_device(device)
    return dev if dev.type != "cuda" else torch.device("cuda", _local_card())


def mesh_devices(n_devices: int | None = None, device=None):
    """The devices of the first ``n_devices`` ranks (all ranks by default):
    the CPU for each on ``device="cpu"``, else each rank's card."""
    dev = resolve_device(device)
    world, _ = _world()
    if n_devices is not None:
        if world < n_devices:
            raise ValueError(f"requested {n_devices} devices, have {world}")
        world = n_devices
    if dev.type != "cuda":
        return [dev] * world
    cards = torch.cuda.device_count()
    return [torch.device("cuda", r % cards) for r in range(world)]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The first ``size`` ranks of the world along :data:`RAY_AXIS`.

    ``rank`` is this process's place in the mesh, −1 on a rank outside it
    (``member`` is False there and the mesh's steps must not be called);
    ``group`` is the process group of the mesh's ranks, ``device`` this
    rank's device.
    """

    group: object
    rank: int
    size: int
    device: torch.device

    @property
    def member(self) -> bool:
        return self.rank >= 0

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """The ``op``-reduction of ``x`` over the mesh (a new tensor)."""
        if not self.member:
            raise RuntimeError("this rank is outside the mesh")
        out = x.clone()
        dist.all_reduce(out, op=op, group=self.group)
        return out

    def pmean(self, tensors: list) -> list:
        """Each tensor's mean over the mesh, from one ``all_reduce`` of a
        flat buffer per dtype."""
        out = [None] * len(tensors)
        for dtype in dict.fromkeys(t.dtype for t in tensors):
            idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
            flat = self.all_reduce(torch.cat([tensors[i].detach().reshape(-1) for i in idx]))
            flat = flat / self.size
            at = 0
            for i in idx:
                n = tensors[i].numel()
                out[i] = flat[at:at + n].reshape(tensors[i].shape)
                at += n
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The mesh's bands of ``x`` concatenated along dim 0, rank order."""
        if not self.member:
            raise RuntimeError("this rank is outside the mesh")
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts)


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` ranks of the world (all by
    default), on ``device`` (the card unless ``device="cpu"``).

    Collective: every rank of the world calls it (``dist.new_group``), and
    a rank past ``n_devices`` gets a mesh with ``member`` False.  The
    world's backend must be the device's (NCCL for ``cuda``, gloo for
    ``cpu``).
    """
    dev = resolve_device(device)
    world, rank = _world()
    backend = str(dist.get_backend()).lower()
    if backend != BACKENDS[dev.type]:
        raise RuntimeError(f"a {dev.type} mesh needs the {BACKENDS[dev.type]} backend; "
                           f"the world runs {backend}")
    n = world if n_devices is None else n_devices
    mesh_devices(n, device=dev)  # the reference's "requested n devices, have m"
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    return Mesh(group=group, rank=rank if rank < n else -1, size=n,
                device=_rank_device(dev))
