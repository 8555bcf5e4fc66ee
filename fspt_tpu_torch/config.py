"""Static render configuration and device selection.

``RenderConfig`` is the reference's configuration dataclass unchanged
(fspt_tpu/config.py): the reference's compile-time knobs, depth cap
(engine.cpp:16-17), fast-render mode (engine.cpp:67-70), gamma and tone
clamp.

``resolve_device`` is the port's one rule for where work runs: on the CUDA
card unless the caller names the CPU.  A missing card raises; nothing falls
back to the CPU silently.
"""

from __future__ import annotations

import dataclasses

import torch

DEFAULT_DEVICE = "cuda"


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration for a render step."""

    width: int = 800
    height: int = 480
    spp: int = 1
    # Maximum path depth; reference engine.cpp:16 (kMaximumTraceDepth = 8).
    max_depth: int = 8
    # Epsilon offset applied along the bounce direction so the continuation
    # ray does not re-hit its origin object; reference engine.cpp:17.
    ray_offset: float = 0.03
    # One-bounce interactive preview returning white sky; engine.cpp:67-70.
    fast_render: bool = False
    # Gamma-correct the display buffer (frame.cpp:4, frame.cpp:66-69).
    gamma_correct: bool = True
    # Light tone clamp threshold at the primary hit; engine.cpp:148-151.
    light_clamp: float = 10.0
    # Number of uniforms drawn per bounce from the per-sample RNG stream.
    bounce_slots: int = 4
    # Edge-reparameterization bandwidth (silhouette gradients): > 0 smooths
    # triangle coverage over this world distance from an edge in the torch
    # integrator and the queue (render/integrator.edge_reparameterize).
    edge_eps: float = 0.0

    @property
    def effective_depth(self) -> int:
        # In fast-render mode every path terminates with white sky at depth 2
        # (engine.cpp:67-70), so only bounces 0 and 1 are ever traced.
        return min(self.max_depth, 2) if self.fast_render else self.max_depth


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no card is present.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fspt_tpu_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
