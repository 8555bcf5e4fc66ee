"""The port's PCG streams are bit-identical to fspt_tpu/ops/rng.py."""

import numpy as np
import pytest
import torch

from fspt_tpu.ops import rng as ref
from fspt_tpu_torch.ops import rng as port

SEEDS = [0, 7, 2**31 + 5, 2**32 - 1]


def _coords(seed, n=4096):
    r = np.random.default_rng(seed % 9973)
    u32 = lambda: r.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    pix, smp, ctr = u32(), u32(), u32()
    pix[:4] = [0, 1, 2**31, 2**32 - 1]  # both sides of the int32 sign bit
    return pix, smp, ctr


def _t64(a):
    return torch.from_numpy(a.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_stream_bits_exact(seed):
    pix, smp, ctr = _coords(seed)
    want = ref.stream_bits(seed, pix, smp, ctr).astype(np.int64)
    got = port.stream_bits(seed, _t64(pix), _t64(smp), _t64(ctr))
    np.testing.assert_array_equal(got.numpy(), want)
    # int32 tensors carrying the same bit patterns hash the same.
    got32 = port.stream_bits(seed, torch.from_numpy(pix.view(np.int32)),
                             torch.from_numpy(smp.view(np.int32)), _t64(ctr))
    np.testing.assert_array_equal(got32.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_uniforms_exact(seed):
    pix, smp, ctr = _coords(seed)
    np.testing.assert_array_equal(
        port.stream_uniform(seed, _t64(pix), _t64(smp), _t64(ctr)).numpy(),
        ref.stream_uniform(seed, pix, smp, ctr))
    np.testing.assert_array_equal(
        port.camera_uniforms(seed, _t64(pix), _t64(smp)).numpy(),
        ref.camera_uniforms(seed, pix, smp))
    for depth in (0, 3, 7):
        np.testing.assert_array_equal(
            port.bounce_uniforms(seed, _t64(pix), _t64(smp), depth).numpy(),
            ref.bounce_uniforms(seed, pix, smp, depth))


@pytest.mark.parametrize("seed", SEEDS)
def test_edge_uniform_exact(seed):
    pix, smp, _ = _coords(seed)
    for depth in (0, 1, 7):
        np.testing.assert_array_equal(
            port.edge_uniform(seed, _t64(pix), _t64(smp), depth).numpy(),
            ref.edge_uniform(seed, pix, smp, depth))
    # A per-lane depth tensor (the queue's) draws each lane's own counter.
    depths = np.arange(len(pix)) % 5
    np.testing.assert_array_equal(
        port.edge_uniform(seed, _t64(pix), _t64(smp), _t64(depths)).numpy(),
        ref.edge_uniform(seed, pix, smp, depths.astype(np.uint32)))


def test_seed_hash_matches_pcg_of_seed():
    for seed in SEEDS:
        want = int(ref.pcg_hash(np.uint32(seed & 0xFFFFFFFF) ^ np.uint32(0x9E3779B9)))
        assert port.seed_hash(seed) == want
