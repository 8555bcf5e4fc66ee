"""Plain reference of a recovery run: the target, the dual-buffer loss, its
gradients by torch autograd of :mod:`pathtrace`, and Adam with the box
constraints, followed step by step from the same start.

The loss of step ``i`` (frame index ``i``) renders two buffers, frames ``i``
and ``i + 10007``, and averages the product of their residuals against the
target: with ``pool = 1`` lane by lane (sample ``s`` of a pixel in one buffer
with sample ``s`` in the other), else each buffer's per-pixel mean over its
samples pooled over ``pool × pool`` patches.  Both are unbiased estimates of
the squared error.  The loss is computed in blocks of rows (a multiple of
``pool``), each block's gradient added to the total, so that a 1080p frame
fits.
"""

from __future__ import annotations

import statistics

import torch

from . import pathtrace as pt

SECOND_BUFFER = 10007


def lanes_rows(tables, cam, spp, max_depth, seed, frame, y0, rows):
    """The radiance of rows ``y0 .. y0+rows-1`` (``[rows, W, spp, 3]``) and
    the segments it traced."""
    lane0 = y0 * cam.width * spp
    n = rows * cam.width * spp
    L, _, _, _, segs = pt.trace_lanes(tables, cam, spp, max_depth, seed, frame * spp,
                                      lane0, n, want_aovs=False)
    return L.reshape(rows, cam.width, spp, 3), int(segs.sum())


def pool(x, p):
    """Mean over ``p × p`` patches of an ``[H,W,3]`` image."""
    h, w = x.shape[0], x.shape[1]
    return x.reshape(h // p, p, w // p, p, 3).mean(dim=(1, 3))


def target_image(scene, cam, spp, max_depth, seed, frames, block_rows, dtype, device):
    """The per-pixel mean of ``frames`` frames at the scene's own values."""
    tables = pt.Tables(scene, dtype, device)
    acc = torch.zeros((cam.height, cam.width, 3), dtype=torch.float64, device=device)
    with torch.no_grad():
        for f in range(frames):
            for y0 in range(0, cam.height, block_rows):
                rows = min(block_rows, cam.height - y0)
                lanes, _ = lanes_rows(tables, cam, spp, max_depth, seed, f, y0, rows)
                acc[y0:y0 + rows] += lanes.double().mean(dim=2)
    return (acc / frames).to(dtype)


def loss_and_grads(scene, cam, spp, max_depth, pool_size, seed, frame, target, values,
                   block_rows, dtype):
    """``(loss, {name: gradient}, segments)`` of one step at ``values``."""
    if cam.height % pool_size or cam.width % pool_size or block_rows % pool_size:
        raise ValueError("the pool must divide the frame and the block")
    leaves = {k: v.detach().clone().requires_grad_() for k, v in values.items()}
    tables = pt.Tables(scene, dtype, target.device, values=leaves)
    if pool_size == 1:
        count = cam.height * cam.width * spp * 3
    else:
        count = (cam.height // pool_size) * (cam.width // pool_size) * 3
    loss = 0.0
    grads = {k: torch.zeros_like(v) for k, v in values.items()}
    segments = 0
    for y0 in range(0, cam.height, block_rows):
        rows = min(block_rows, cam.height - y0)
        res = []
        for f in (frame, frame + SECOND_BUFFER):
            lanes, segs = lanes_rows(tables, cam, spp, max_depth, seed, f, y0, rows)
            segments += segs
            if pool_size == 1:
                res.append(lanes - target[y0:y0 + rows, :, None, :])
            else:
                res.append(pool(lanes.mean(dim=2) - target[y0:y0 + rows], pool_size))
        part = (res[0] * res[1]).sum() / count
        got = torch.autograd.grad(part, list(leaves.values()), allow_unused=True)
        for k, g in zip(leaves, got):
            if g is not None:
                grads[k] += g.to(grads[k].dtype)
        loss += float(part.detach())
    return loss, grads, segments


class Adam:
    """Adam (Kingma & Ba) on a dict of tensors, then the box constraints."""

    def __init__(self, values, lr, constraints, betas=(0.9, 0.999), eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.constraints = constraints
        self.m = {k: torch.zeros_like(v) for k, v in values.items()}
        self.v = {k: torch.zeros_like(v) for k, v in values.items()}
        self.t = 0

    def step(self, values, grads):
        self.t += 1
        out = {}
        for k, p in values.items():
            g = grads[k]
            self.m[k] = self.b1 * self.m[k] + (1.0 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1.0 - self.b2) * g * g
            m_hat = self.m[k] / (1.0 - self.b1 ** self.t)
            v_hat = self.v[k] / (1.0 - self.b2 ** self.t)
            new = p - self.lr * m_hat / (torch.sqrt(v_hat) + self.eps)
            lo, hi = self.constraints.get(k, (None, None))
            out[k] = new if lo is None and hi is None else torch.clamp(new, min=lo, max=hi)
        return out


def follow(scene, cam, traffic, seed, start, target, steps, block_rows, dtype):
    """The reference's own run of ``steps`` steps from ``start``: the loss of
    each, the first gradient, the values after the last, the segments a
    step traced (mean)."""
    constraints = {k: tuple(v) for k, v in traffic["constraints"].items()}
    adam = Adam(start, traffic["lr"], constraints)
    values = dict(start)
    losses, first, segs = [], None, []
    for i in range(steps):
        loss, grads, s = loss_and_grads(scene, cam, traffic["spp"], traffic["max_depth"],
                                        traffic["pool"], seed, i, target, values,
                                        block_rows, dtype)
        losses.append(loss)
        segs.append(s)
        if first is None:
            first = grads
        values = adam.step(values, grads)
    return dict(losses=losses, first_grad=first, values=values,
                segments=statistics.mean(segs))


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Per leaf, the gap between the two sides' norms, measured against the
    larger of the reference's norm of that leaf and of the median leaf."""
    norms = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in ref}
    median = statistics.median(norms.values())
    gaps = {}
    for k in ref:
        if keep is not None and k not in keep:
            continue
        p = float(torch.linalg.vector_norm(prog[k].double()))
        gaps[k] = abs(p - norms[k]) / max(norms[k], median, 1e-30)
    return gaps


def leaf_diffs(prog: dict, ref: dict) -> dict:
    """Per leaf, the norm of the two sides' difference, measured against the
    larger of the reference's norm of that leaf and of the median leaf: it
    sees a gradient whose sign or direction is wrong while its norm holds."""
    norms = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in ref}
    median = statistics.median(norms.values())
    return {k: float(torch.linalg.vector_norm(prog[k].double() - ref[k].double()))
            / max(norms[k], median, 1e-30) for k in ref}


def moving_leaves(first_grad: dict) -> set:
    """Leaves whose reference gradient is not nought to rounding: at least a
    thousandth of the median leaf's norm."""
    norms = {k: float(torch.linalg.vector_norm(g.double())) for k, g in first_grad.items()}
    median = statistics.median(norms.values())
    return {k for k, n in norms.items() if n >= 1e-3 * median}
