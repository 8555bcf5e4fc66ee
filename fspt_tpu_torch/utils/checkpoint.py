"""Checkpoint / resume for progressive renders.

Port of fspt_tpu/utils/checkpoint.py with the same ``.npz`` layout
(``fb_<field>`` for each Framebuffer field, ``frame``, optional
``extra_<key>`` entries), so a checkpoint written by either package resumes
in the other.  The RNG is counter-based, so resuming at frame k reproduces
the uninterrupted run.

The CLI records its estimator as ``extra_first_hit_cache``: a render with
the first-hit cache freezes the camera jitter, one without it does not, and
a resumed render must not average the two (:func:`estimator_mismatch`).
The reference's loader ignores ``extra_*`` entries, so the layout stays
compatible.
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


def save(path: str, fb: Framebuffer, frame: int, extra: dict | None = None):
    """Atomically write the render state (tmp file + rename); ``extra``
    values land as ``extra_<key>`` entries."""
    payload = {f"fb_{k}": getattr(fb, k).detach().cpu().numpy() for k in _FB_FIELDS}
    payload["frame"] = np.asarray(frame, np.int64)
    for key, val in (extra or {}).items():
        payload[f"extra_{key}"] = np.asarray(val)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(path: str, device=None, with_extra: bool = False):
    """Returns ``(fb, frame)``, or ``(fb, frame, extra)`` with
    ``with_extra``, the framebuffer on ``device``; None if the file is
    absent or unreadable."""
    dev = resolve_device(device)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            fb = Framebuffer(**{k: torch.from_numpy(np.array(z[f"fb_{k}"])).to(dev)
                                for k in _FB_FIELDS})
            frame = int(z["frame"])
            extra = {k[len("extra_"):]: np.array(z[k]) for k in z.files
                     if k.startswith("extra_")}
    except (OSError, KeyError, ValueError, zipfile.BadZipFile):
        return None
    return (fb, frame, extra) if with_extra else (fb, frame)


def estimator_mismatch(extra: dict, first_hit_cache: bool):
    """Why a checkpoint with entries ``extra`` cannot resume a render with
    (or without) the first-hit cache, or None if it can.  A checkpoint that
    records no mode (the reference's) counts as one without the cache."""
    recorded = bool(extra.get("first_hit_cache", False))
    if recorded == first_hit_cache:
        return None
    with_ = lambda b: "with" if b else "without"
    return (f"the checkpoint was rendered {with_(recorded)} the first-hit cache and "
            f"this run renders {with_(first_hit_cache)} it: the two estimators differ "
            "(the cache freezes the camera jitter), so their frames cannot be "
            "averaged; resume with the same --first-hit-cache setting or start anew")
