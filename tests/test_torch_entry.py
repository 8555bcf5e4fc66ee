"""The port's entry points (fspt_tpu_torch/entry.py) against the reference's
(__graft_entry__.py): ``entry()`` against the reference's XLA render step
at the port-vs-JAX bar of tests/test_torch_cli.py, and
``dryrun_multichip(2)`` in a gloo world of 2 CPU ranks (the reference's
seven sharded steps and assertions, ``q_segs == bvh_segs`` included), with
the world of 1 that ``multihost.initialize()`` makes for one process."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_parallel import close_to_reference, result, run_cases, spawn_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rank_cases(rank, world, payload):
    from fspt_tpu_torch import entry

    return run_cases({"dryrun_2": lambda: entry.dryrun_multichip(2, device="cpu"),
                      "dryrun_1": lambda: entry.dryrun_multichip(1, device="cpu")})


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return {2: spawn_world(_rank_cases, 2, tmp_path_factory.mktemp("entry_world"), {})}


def test_entry_matches_reference_entry():
    import jax

    import __graft_entry__ as ref_entry
    from fspt_tpu_torch import entry

    fn, args = entry.entry(device="cpu")
    fb, segs = fn(*args)
    ref_fn, ref_args = ref_entry.entry()
    ref_fb, ref_segs = jax.jit(ref_fn)(*ref_args)
    assert fb.mean.shape == (64, 64, 3)
    close_to_reference(fb.mean.numpy(), ref_fb.mean)
    np.testing.assert_array_equal(fb.mat.numpy(), np.asarray(ref_fb.mat))
    assert int(segs) == int(ref_segs)
    assert float(fb.mean.mean()) > 0.01  # a lit box


def test_dryrun_multichip_2(world2):
    """Both ranks run every step; the losses are the all-reduced ones, so
    equal on both, and the queued step traces the unrolled one's segments."""
    r0, r1 = (result(world2, 2, "dryrun_2", rank) for rank in (0, 1))
    assert r0 == r1
    assert r0["queued_segments"] == r0["bvh_segments"] > 0
    for k in ("recovery_loss", "vertex_loss", "fused_loss"):
        assert np.isfinite(r0[k]), k


def test_dryrun_multichip_1_in_a_world_of_2(world2):
    """A mesh of the first rank: rank 0 runs the steps alone, rank 1 is
    outside it; the band step's segments are the whole frame's either way."""
    one, outside = (result(world2, 2, "dryrun_1", rank) for rank in (0, 1))
    assert outside == {}
    assert one["render_segments"] == result(world2, 2, "dryrun_2")["render_segments"]


def test_initialize_makes_a_world_of_one():
    """One process without the torchrun environment: ``initialize()`` makes
    a world of 1 (no network), after which ``make_mesh(1)`` works; before
    it, ``make_mesh`` names ``initialize``."""
    code = (
        "import os, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "for k in ('WORLD_SIZE', 'RANK', 'MASTER_ADDR', 'MASTER_PORT'):\n"
        "    os.environ.pop(k, None)\n"
        "from fspt_tpu_torch.parallel import make_mesh, multihost\n"
        "try:\n"
        "    make_mesh(1, device='cpu')\n"
        "except RuntimeError as e:\n"
        "    assert 'initialize()' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('make_mesh ran without a world')\n"
        "multihost.initialize(device='cpu')\n"
        "multihost.initialize(device='cpu')  # a no-op once up\n"
        "import torch.distributed as dist\n"
        "m = make_mesh(1, device='cpu')\n"
        "assert (dist.get_world_size(), dist.get_backend(), m.rank, m.size) == "
        "(1, 'gloo', 0, 1)\n"
        "assert multihost.is_primary()\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
