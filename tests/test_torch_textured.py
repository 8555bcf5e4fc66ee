"""The textured flagship (``samples.textured_flagship``) against the
benchmark's plain reference, its texel maker, and kernel 4's texel fetch
counts, on the CPU.

The scene is the benchmark's ``textured_flagship_8k`` configuration with
its maps made small (64×64, the sky 128×64) by the configuration's own
maker (benchmark/harness/texdata.py), so that the port's plain kernel-4
path (the fold of its slot planes) and the reference (benchmark/reference,
plain PyTorch) trace a 32×32 frame in a second.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import texdata  # noqa: E402
from benchmark.reference import pathtrace as pt  # noqa: E402
from benchmark.reference import render as ref_render  # noqa: E402
from benchmark.reference import scene as ref_scene  # noqa: E402
from fspt_tpu_torch.config import RenderConfig  # noqa: E402
from fspt_tpu_torch.ops import cuda_path  # noqa: E402
from fspt_tpu_torch.scene import samples  # noqa: E402

CPU = torch.device("cpu")
SEED = 3_000_000_123


def _config(small: bool = True) -> dict:
    config = json.loads((ROOT / "benchmark/configs/textured_flagship_8k.json").read_text())
    if small:
        for spec in config["textures"].values():
            spec["shape"] = [64, 128] if "sky" in spec else [64, 64]
    return config


def _tracer(maps, width=32, height=32, spp=2, depth=4):
    b = samples.build("textured_flagship", device=CPU, textures=maps)
    cfg = RenderConfig(width=width, height=height, spp=spp, max_depth=depth)
    return cuda_path.make_camera_path_tracer(b.compile(device=CPU), b.cameras[0], cfg)


def test_the_textured_sample_agrees_with_the_reference():
    """Kernel 4's plain path (``trace.fold(trace.plain_planes(...))``)
    against the reference on a 32×32×2 frame at depth 4, every number of
    the render check within its limit, the segments equal; the sample's
    rows are the description's (families, colours, texture scales, sky)."""
    config = _config()
    maps = texdata.make_maps(config, SEED)
    tracer = _tracer(maps)
    assert tracer.kernel is cuda_path.DEFERRED_PATH
    scene = ref_scene.build(config["reference"]["scene"], maps)
    tables = pt.Tables(scene, torch.float32, CPU)
    n = 32 * 32 * 2
    out = tracer.fold(tracer.plain_planes(SEED, 6, 0, n))
    ref = pt.trace_frame(tables, pt.PinholeCamera(scene.camera, 32, 32), 2, 4, SEED, 6, n)
    fb = ref_render.empty_framebuffer(32, 32, CPU)
    prog = dict(radiance=out.radiance, normal=out.aov_normal, depth=out.aov_depth,
                mat=out.aov_mat, segments=int(out.segments), before=fb,
                after=ref_render.accumulate(fb, out.radiance, out.aov_normal, out.aov_depth,
                                            out.aov_mat, 32, 32, 2))
    numbers = ref_render.judge_frame(prog, ref, 32, 32, 2)
    for key, value in numbers.items():
        assert value <= ref_render.LIMITS[key], (key, value)
    assert numbers["segments_gap"] == 0.0
    sp = samples.build("textured_flagship", device=CPU, textures=maps).compile(device=CPU)
    assert int(sp.sky_mat) == tables.sky
    assert torch.equal(sp.materials.mtype.long(), tables.family)
    assert torch.equal(sp.materials.diffuse, tables.diffuse)
    assert torch.equal(sp.materials.tex_scale, tables.tex_scale)
    assert torch.equal(sp.textures.texels, tables.texels)


def test_the_texel_maker():
    """Deterministic for a seed, other maps at another seed, the
    configuration's shapes and 1,610,612,736 bytes; at the published
    widths every neighbouring pair of a wall's rows is smooth, and the
    sky's rough pairs are its step below the horizon alone; the i.i.d.
    texels of the control are rough."""
    small = _config()
    a, b = texdata.make_maps(small, SEED), texdata.make_maps(small, SEED)
    c = texdata.make_maps(small, SEED + 1)
    assert list(a) == list(samples.TEXTURED_FLAGSHIP_MAPS)
    for name in a:
        assert a[name].dtype == np.float32 and np.array_equal(a[name], b[name])
        assert not np.array_equal(a[name], c[name])
    assert 0.6 * 0.05 <= min(float(m.min()) for m in a.values())
    assert max(float(a[k].max()) for k in a if k != "sky") <= 1.0
    assert 0.0189 <= float(a["sky"].min()) and float(a["sky"].max()) <= 2.0
    iid = texdata.make_maps(small, SEED, iid=True)
    assert all(iid[k].shape == a[k].shape for k in a)
    assert texdata.smooth_share(iid) < 0.01  # the control's texels: each pair differs

    config = _config(small=False)
    assert texdata.texel_bytes(config) == config["texel_bytes"] == 1_610_612_736
    for i, (name, spec) in enumerate(config["textures"].items()):
        h, w = spec["shape"]
        assert (h, w) == ((4096, 8192) if name == "sky" else (4096, 4096))
        rows = texdata.make_map(spec, SEED, i, rows=slice(h // 2 - 40, h // 2 + 80))
        assert rows.shape == (120, w, 3)
        smooth, pairs = texdata.smooth_pairs(torch.from_numpy(rows))
        rough_rows = 0 if name != "sky" else texdata.SKY_BAND_ROWS + 1
        assert pairs - smooth == rough_rows * w, name
    e = texdata.sky_elevation(4096, 0.02, 2.0)
    assert abs(float(e[2047]) - 2.0) < 1e-3 and float(e[-1]) == np.float32(0.02)


def test_plain_fetch_counts_are_the_slot_planes():
    """The plain version's texel fetch counts (``trace.counted`` on the
    CPU) against a count over its slot planes by hand: a slot whose row
    has a map fetches, the sky's row apart; its outputs are ``trace``'s."""
    maps = texdata.make_maps(_config(), SEED)
    tracer = _tracer(maps, width=16, height=12, spp=2, depth=5)
    n = 16 * 12 * 2
    planes = tracer.plain_planes(SEED, 2, 0, n)
    counted = tracer.counted(SEED, 2)
    plain = tracer(SEED, 2)
    assert plain.fetches is None
    for field in ("radiance", "aov_normal", "aov_depth", "aov_mat"):
        assert torch.equal(getattr(counted, field), getattr(plain, field)), field
    sp = samples.build("textured_flagship", device=CPU, textures=maps).compile(device=CPU)
    tex_id = sp.materials.tex_id.numpy()
    sky_row = int(sp.sky_mat)
    surface = sky = 0
    for m in planes.mat.numpy().reshape(-1):
        if m >= 0 and tex_id[min(m, len(tex_id) - 1)] >= 0:
            if m == sky_row:
                sky += 1
            else:
                surface += 1
    assert counted.fetches.tolist() == [surface, sky]
    assert surface > 0 and sky > 0
