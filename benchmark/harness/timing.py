"""Synchronizing, spans and the card's identity."""

from __future__ import annotations

import contextlib
import subprocess


def synchronize(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def spans(enabled: bool):
    """``span(name)``: a profiler range named ``name`` where tracing is on,
    nothing otherwise."""
    if not enabled:
        return lambda name: contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function


def card() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        return {"nvidia_smi": f"not read: {e}"}
    return {"nvidia_smi": out[0] if out else "not read: no output"}
