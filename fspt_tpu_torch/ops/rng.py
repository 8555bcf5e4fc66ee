"""Counter-based RNG streams, bit-identical to fspt_tpu/ops/rng.py.

Every Monte-Carlo draw is a pure function of ``(seed, pixel, sample,
counter)`` through the PCG-RXS-M-XS integer hash (O'Neill; Jarzynski &
Olano, JCGT 2020).  The CUDA kernels (csrc/fspt_kernels.cuh) evaluate the
same hash in ``uint32``; here torch's partial ``uint32`` support is avoided
by computing in ``int64`` and masking to 32 bits after every multiply and
add.  The largest intermediate, ``(2^32 - 1) * 747796405 + 2891336453``,
stays below ``2^63``.

Stream layout (shared with the reference and its oracle):

* camera draws use counters ``CTR_CAMERA + slot`` (jitter_x, jitter_y,
  lens_angle, lens_radius);
* bounce ``d`` draws use ``CTR_BOUNCE + d * bounce_slots + slot`` with slots
  ``(choice, dir_a, dir_b, aux)``;
* the edge-reparameterization draw of bounce ``d`` uses ``CTR_EDGE + d``,
  far from the bounce range, so drawing it never shifts a material stream.

Functions accept Python ints or integer tensors and return the hash as an
``int64`` tensor (or int) holding the ``uint32`` value.
"""

from __future__ import annotations

import numpy as np
import torch

CTR_CAMERA = 0
CTR_BOUNCE = 16
CTR_EDGE = 4096

_M32 = 0xFFFFFFFF
_SEED_XOR = 0x9E3779B9
_UNIT = 1.0 / (1 << 24)


def _u32(x):
    """An int, NumPy value or integer tensor as its uint32 bit pattern."""
    if isinstance(x, (int, np.integer)):
        return int(x) & _M32
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x.astype(np.int64))
    return x.to(torch.int64) & _M32


def pcg_hash(x):
    """One round of the PCG-RXS-M-XS output permutation over uint32."""
    x = (x * 747796405 + 2891336453) & _M32
    word = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & _M32
    return (word >> 22) ^ word


def seed_hash(seed) -> int:
    """``h0 = pcg(seed ^ 0x9E3779B9)``, the per-seed prefix of every stream."""
    return pcg_hash(_u32(seed) ^ _SEED_XOR)


def sample_hash(h0, pixel, sample):
    """The per-(pixel, sample) prefix ``pcg(pcg(h0 + pixel) + sample)``."""
    h = pcg_hash((h0 + _u32(pixel)) & _M32)
    return pcg_hash((h + _u32(sample)) & _M32)


def counter_uniform(hs, ctr):
    """Uniform draw for counter ``ctr`` from a :func:`sample_hash` prefix."""
    return bits_to_uniform(pcg_hash((hs + ctr) & _M32))


def stream_bits(seed, pixel, sample, ctr):
    """uint32 hash of the stream coordinates; broadcasts over tensor inputs."""
    h = sample_hash(seed_hash(seed), pixel, sample)
    return pcg_hash((h + _u32(ctr)) & _M32)


def bits_to_uniform(bits):
    """Map uint32 bits to float32 in [0, 1) with 24 bits of precision."""
    return (bits >> 8).to(torch.float32) * _UNIT


def stream_uniform(seed, pixel, sample, ctr):
    """float32 uniform in [0,1) for the given stream coordinates."""
    return bits_to_uniform(stream_bits(seed, pixel, sample, ctr))


def camera_uniforms(seed, pixel, sample):
    """The 4 camera-sampling uniforms, stacked on a new trailing axis."""
    hs = sample_hash(seed_hash(seed), pixel, sample)
    return torch.stack([counter_uniform(hs, CTR_CAMERA + s) for s in range(4)],
                       dim=-1)


def bounce_uniforms(seed, pixel, sample, depth, bounce_slots=4):
    """The per-bounce uniforms (choice, dir_a, dir_b, aux)."""
    hs = sample_hash(seed_hash(seed), pixel, sample)
    base = CTR_BOUNCE + depth * bounce_slots
    return torch.stack([counter_uniform(hs, base + s) for s in range(4)],
                       dim=-1)


def edge_uniform(seed, pixel, sample, depth):
    """The per-bounce edge-reparameterization uniform (its own counter
    namespace); ``depth`` may be an int or a per-lane tensor."""
    return stream_uniform(seed, pixel, sample, CTR_EDGE + depth)
