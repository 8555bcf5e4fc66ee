"""Checkpoint / resume for progressive renders.

Port of fspt_tpu/utils/checkpoint.py with the same ``.npz`` layout
(``fb_<field>`` for each Framebuffer field, ``frame``), so a checkpoint
written by either package resumes in the other (the reference's optional
``extra_<key>`` entries are ignored).  The RNG is counter-based, so
resuming at frame k reproduces the uninterrupted run.
"""

from __future__ import annotations

import os
import tempfile
import zipfile

import numpy as np
import torch

from fspt_tpu_torch.config import resolve_device
from fspt_tpu_torch.render.framebuffer import Framebuffer

_FB_FIELDS = Framebuffer._fields


def save(path: str, fb: Framebuffer, frame: int):
    """Atomically write the render state (tmp file + rename)."""
    payload = {f"fb_{k}": getattr(fb, k).detach().cpu().numpy() for k in _FB_FIELDS}
    payload["frame"] = np.asarray(frame, np.int64)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(path: str, device=None):
    """Returns (fb, frame) with the framebuffer on ``device``; None if the
    file is absent or unreadable."""
    dev = resolve_device(device)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            fb = Framebuffer(**{k: torch.from_numpy(np.array(z[f"fb_{k}"])).to(dev)
                                for k in _FB_FIELDS})
            frame = int(z["frame"])
    except (OSError, KeyError, ValueError, zipfile.BadZipFile):
        return None
    return fb, frame
