"""What the benchmark loads: never JAX or the JAX package, and the plain
reference nothing of the program under test.  Names are compared whole, by
the part before the first dot, because the port's name begins with the JAX
package's."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "fspt_tpu"}

_LOAD = """
import importlib.util, json, sys
sys.path.insert(0, {root!r})
import benchmark.run
from benchmark.harness import cell
for kind, names in {files!r}.items():
    for name in names:
        path = cell.BENCH_DIR / kind / (name + ".py")
        cell.load_module(path, "probe_" + kind + "_" + name.replace(".", "_"))
{extra}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _tops(extra: str = "", reference_only: bool = False) -> set:
    drivers = sorted(p.stem for p in (ROOT / "benchmark" / "drivers").glob("*.py"))
    metrics = sorted(p.name[:-3] for p in (ROOT / "benchmark" / "metrics").glob("*.py"))
    files = {} if reference_only else {"drivers": drivers, "metrics": metrics}
    code = _LOAD.format(root=str(ROOT), files=files, extra=extra)
    if reference_only:
        code = code.replace("import benchmark.run\nfrom benchmark.harness import cell\n",
                            "from benchmark.harness import cell\n")
    out = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    """run.py, every driver, every metric reader and the reference, and the
    port's modules a run calls into, in a clean interpreter."""
    extra = "\n".join([
        "import benchmark.control",
        "import benchmark.reference.pathtrace, benchmark.reference.scene",
        "import benchmark.reference.render, benchmark.reference.recover",
        "import fspt_tpu_torch.ops.cuda_path, fspt_tpu_torch.ops.cuda_grad",
        "import fspt_tpu_torch.parallel.train, fspt_tpu_torch.render.framebuffer",
        "import fspt_tpu_torch.scene.samples, fspt_tpu_torch.scene.parser",
    ])
    tops = _tops(extra)
    assert not tops & FORBIDDEN, sorted(tops & FORBIDDEN)
    assert "fspt_tpu_torch" in tops  # the probe did load the port


def test_the_reference_loads_nothing_of_the_program():
    extra = "\n".join([
        "import benchmark.reference.pathtrace, benchmark.reference.scene",
        "import benchmark.reference.render, benchmark.reference.recover",
    ])
    tops = _tops(extra, reference_only=True)
    assert not tops & (FORBIDDEN | {"fspt_tpu_torch"}), sorted(tops)


def test_the_reference_sources_import_nothing_of_the_program():
    """Every import statement under benchmark/reference/, by whole
    top-level name."""
    for path in sorted((ROOT / "benchmark" / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [] if node.level else [node.module]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in FORBIDDEN | {"fspt_tpu_torch", "benchmark"}, (path, name)
