"""Differentiable planar path: the autograd reference of the gradient kernels.

Counterpart of fspt_tpu/ops/diff_path.py.  The plain path body of the
megakernels (:func:`ops.cuda_path.build_path_core`) run over ``[N]`` lane
planes with the material table left as tensors (``tmats``) and the primary
rays from :func:`camera.generate_rays`, so torch autograd differentiates
radiance with respect to every material value and every camera tensor.  Its
radiance is the megakernel's path: same straight-line body, same PCG streams.

Gradient semantics are those of a hit-id replay: which primitive a lane hits
is piecewise constant, so autograd through the strict-< closest-hit merge
differentiates the winner's t and normal (correct almost everywhere);
silhouette terms need the integrator's edge reparameterization and are not
taken here.  Discrete decisions (lobe choice, reflect or refract) are
functions of the uniforms, not of the parameters.

The CUDA gradient kernels (ops/cuda_grad.py: kernels 8 whole chain, 9 and
10) are held against the same body under autograd; this module is its form
for a scene, a camera and a band of image rows.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from fspt_tpu_torch.camera import generate_rays
from fspt_tpu_torch.ops import rng
from fspt_tpu_torch.ops.cuda_path import PathBody, planes_to_output
from fspt_tpu_torch.ops.cuda_trace import intersect_lanes

#: Bound of a sanitized cotangent (fspt_tpu/ops/diff_path.py:66-67).
GRAD_CLIP = 1e12


class _SanitizeGrad(torch.autograd.Function):
    """Identity whose backward replaces non-finite cotangents with 0 and
    clips the rest to ±:data:`GRAD_CLIP` (diff_path.py:50-70).  Grazing hits
    make the intersection chain's derivatives heavy-tailed (1/cos θ); one
    overflowing lane would otherwise poison a whole band's camera gradient
    with NaN.  Applied to the primary rays only: well-conditioned lanes keep
    exact derivatives."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        ct = torch.nan_to_num(ct, nan=0.0, posinf=0.0, neginf=0.0)
        return torch.clamp(ct, -GRAD_CLIP, GRAD_CLIP)


def make_diff_path(scene_pack, cfg, z_far: float = 10000.0, sg_hits: bool = False):
    """The differentiable planar renderer of a ScenePack.

    Returns ``fn(table, camera, seed, sample0, y0=0, rows=None) →
    TraceOutput``, differentiable with respect to the tensors of ``table``
    (a MaterialTable, e.g. ``scene.materials._replace(diffuse=p)``) and of
    ``camera``, or None for a scene the megakernels do not take as an
    untextured one: a BVH scene, a textured scene, or one over 512
    primitives.

    ``sg_hits=True`` detaches the closest-hit outputs (t, normal): for
    material-only recovery the rays never depend on the table, so the
    intersection chain adds nothing to the gradient.  Leave it False for
    camera gradients.  ``z_far`` must be ``camera.z_far``.  ``cfg.edge_eps``
    is ignored: silhouette terms need the general integrator.
    """
    body = PathBody(scene_pack, None, cfg, z_far=z_far)
    if body.bvh or not body.fits or body.textured:
        return None

    intersect = None
    if sg_hits:
        def intersect(sx, sy, sz, dx, dy, dz, alive):
            with torch.no_grad():
                return intersect_lanes(body.scene, sx, sy, sz, dx, dy, dz, want_texcoords=False)

    def trace(table, camera, seed, sample0, y0=0, rows=None):
        core = body.core(tmats=table, intersect=intersect)
        start, seg, pix, smp = generate_rays(camera, cfg.width, cfg.height, cfg.spp,
                                             seed, sample0, y0=y0, rows=rows)
        start = _SanitizeGrad.apply(start)
        seg = _SanitizeGrad.apply(seg)
        h0 = rng.seed_hash(seed)
        return planes_to_output(core(h0, start[:, 0], start[:, 1], start[:, 2],
                                     seg[:, 0], seg[:, 1], seg[:, 2], pix, smp))

    return trace


def make_image_fn(scene_pack, cfg, z_far: float = 10000.0, remat: bool = False,
                  sg_hits: bool = False):
    """Differentiable band images on the planar path.

    Returns ``img_fn(table, camera, seed, frame_idx, y0, rows) → ([rows, W,
    3] mean-over-spp image, segments)``, or None where :func:`make_diff_path`
    is.  ``remat=True`` runs the trace under ``torch.utils.checkpoint``: the
    backward recomputes the bounce chain instead of keeping its tensors.
    """
    trace = make_diff_path(scene_pack, cfg, z_far=z_far, sg_hits=sg_hits)
    if trace is None:
        return None

    def img_fn(table, camera, seed, frame_idx, y0, rows):
        def radiance(table, camera):
            out = trace(table, camera, seed, frame_idx * cfg.spp, y0=y0, rows=rows)
            return out.radiance, out.segments

        if remat:
            rad, segments = checkpoint(radiance, table, camera, use_reentrant=False)
        else:
            rad, segments = radiance(table, camera)
        img = rad.reshape(rows, cfg.width, cfg.spp, 3).mean(dim=2)
        return img, segments

    return img_fn
