"""The texels of a textured configuration, made from the run's seed.

:func:`make_maps` gives every map of the configuration's ``textures``
(``{name: {"shape": [H, W], ...}}``) as an ``[H, W, 3]`` float32 array, the
same for the same seed, made in bulk with NumPy (about a second for the
1.61 GB of ``textured_flagship_8k``).  Map ``i`` of the list draws from
``numpy.random.default_rng([seed mod 2**64, i])``.

* A diffuse map (``"color"``) is the row's colour times the factor
  ``f = 0.8 + 0.1·cos(2π(x + ½)/W + φx) + 0.1·cos(2π(y + ½)/H + φy)``,
  in [0.6, 1.0], at seeded phases: one period across the map each way, so
  the map tiles without a seam.
* The sky (``"sky": [lo, hi]``), sphere-mapped (row 0 the zenith, the
  middle row the horizon, the last the nadir), is grey: ``e(v)·a(x)`` with
  ``a = 0.975 + 0.025·cos(2π(x + ½)/W + φ)`` and ``e`` at ``hi`` on the
  horizon, falling by :data:`SKY_FALL` e-folds to the zenith, dropping
  below the horizon to ``lo`` over :data:`SKY_BAND_ROWS` rows (a smooth
  step in log space, whose pairs are the maps' only rough ones) and staying
  at ``lo`` to the nadir.

Why smooth: kernel 4 fetches the nearest texel, and a hit within float32
rounding of a texel's edge may take either neighbour in the program and in
the reference.  Where neighbours differ by under :data:`SMOOTH_RTOL`
relative, the lane stays inside the check's RTOL of 1e-3
(reference/render.py) over the textured bounces of a path.  The content
changes no work: the path, its segments and every texel address are fixed
before a texel is read.  :func:`smooth_share` measures the share of
neighbouring pairs that are that close; ``iid=True`` makes the i.i.d.
texels of the control that shows what texel-edge flips cost.
"""

from __future__ import annotations

import math

import numpy as np

#: The relative difference of two neighbouring texels under which a flip
#: between them keeps a lane inside the check's RTOL.
SMOOTH_RTOL = 2.5e-4
#: Rows below the horizon over which the sky drops from ``hi`` to ``lo``.
SKY_BAND_ROWS = 64
#: The sky's fall from the horizon to the zenith, in e-folds over the
#: upper half (a relative step of 0.9 / H a row: 2.2e-4 at H = 4096).
SKY_FALL = 0.45


def _rng(seed: int, index: int):
    return np.random.default_rng([int(seed) % 2**64, index])


def _cosine(n: int, amplitude: float, phase: float) -> np.ndarray:
    x = (np.arange(n, dtype=np.float64) + 0.5) / n
    return (amplitude * np.cos(2.0 * math.pi * x + phase)).astype(np.float32)


def _diffuse(shape, color, rng, rows) -> np.ndarray:
    h, w = shape
    phx, phy = rng.uniform(0.0, 2.0 * math.pi, 2)
    f = (np.float32(0.8) + _cosine(h, 0.1, phy)[rows, None]) + _cosine(w, 0.1, phx)[None, :]
    out = np.empty((f.shape[0], w, 3), np.float32)
    np.multiply(f[..., None], np.asarray(color, np.float32), out=out)
    return out


def sky_elevation(h: int, lo: float, hi: float) -> np.ndarray:
    """``e`` of each of the sky's ``h`` rows (row 0 the zenith)."""
    v = (np.arange(h, dtype=np.float64) + 0.5) / h
    upper = hi * np.exp(-2.0 * SKY_FALL * (0.5 - v))
    s = np.clip((v - 0.5) * h / SKY_BAND_ROWS, 0.0, 1.0)
    step = s * s * (3.0 - 2.0 * s)
    lower = np.exp(math.log(hi) + (math.log(lo) - math.log(hi)) * step)
    return np.where(v <= 0.5, upper, lower).astype(np.float32)


def _sky(shape, lo, hi, rng, rows) -> np.ndarray:
    h, w = shape
    a = np.float32(0.975) + _cosine(w, 0.025, rng.uniform(0.0, 2.0 * math.pi))
    e = sky_elevation(h, lo, hi)[rows]
    out = np.empty((e.shape[0], w, 3), np.float32)
    np.multiply((e[:, None] * a[None, :])[..., None], np.ones(3, np.float32), out=out)
    return out


def _iid(spec, rng) -> np.ndarray:
    h, w = spec["shape"]
    if "sky" in spec:
        lo, hi = spec["sky"]
        return rng.uniform(lo, hi, (h, w, 1)).astype(np.float32).repeat(3, axis=2)
    f = rng.uniform(0.6, 1.0, (h, w, 1)).astype(np.float32)
    return f * np.asarray(spec["color"], np.float32)


def make_map(spec: dict, seed: int, index: int, iid: bool = False,
             rows: slice = slice(None)) -> np.ndarray:
    """Map ``index`` of a configuration, from its ``spec``; with ``rows``
    only those rows of it (not for ``iid``)."""
    rng = _rng(seed, index)
    if iid:
        return _iid(spec, rng)
    if "sky" in spec:
        lo, hi = spec["sky"]
        return _sky(spec["shape"], lo, hi, rng, rows)
    return _diffuse(spec["shape"], spec["color"], rng, rows)


def make_maps(config: dict, seed: int, iid: bool = False) -> dict:
    """``{name: [H, W, 3] float32}`` for every map of ``config["textures"]``."""
    return {name: make_map(spec, seed, i, iid)
            for i, (name, spec) in enumerate(config["textures"].items())}


def texel_bytes(config: dict) -> int:
    """The bytes the configuration's maps hold (float32 RGB)."""
    return sum(12 * spec["shape"][0] * spec["shape"][1] for spec in config["textures"].values())


def smooth_pairs(image) -> tuple:
    """``(smooth, pairs)`` of an ``[H, W, 3]`` map (a torch tensor, on any
    device): its horizontally and vertically neighbouring texel pairs, and
    those whose every channel differs by at most :data:`SMOOTH_RTOL` of the
    larger."""
    smooth = pairs = 0
    for a, b in ((image[:, 1:], image[:, :-1]), (image[1:], image[:-1])):
        close = ((a - b).abs() <= SMOOTH_RTOL * a.abs().maximum(b.abs())).all(-1)
        smooth += int(close.sum())
        pairs += close.numel()
    return smooth, pairs


def smooth_share(maps: dict, device=None) -> float:
    """The share of all the maps' neighbouring pairs that are smooth, each
    map measured on ``device`` (the CPU by default)."""
    import torch

    counts = [smooth_pairs(torch.from_numpy(m).to(device)) for m in maps.values()]
    return sum(s for s, _ in counts) / sum(p for _, p in counts)
