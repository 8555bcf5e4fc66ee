"""A cell's pieces, found by name from ``BENCHMARK.json``.

A workload names its configuration and its traffic mix; the configuration's
``file`` is read from the manifest, the traffic from
``benchmark/traffic/<traffic>.json``, its driver from
``benchmark/drivers/<driver>.py`` and each per-layer metric's reader from
``benchmark/metrics/<metric>.py``.  Adding a cell, a mix, a driver or a
metric adds files; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_module(path: Path, name: str):
    """Import the Python file ``path`` under the module name ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def traffic_path(name: str) -> Path:
    return BENCH_DIR / "traffic" / f"{name}.json"


def driver_path(name: str) -> Path:
    return BENCH_DIR / "drivers" / f"{name}.py"


def metric_path(name: str) -> Path:
    return BENCH_DIR / "metrics" / f"{name}.py"


def resolve(workload: str, root: Path = ROOT) -> SimpleNamespace:
    """The workload's entry, configuration, traffic, driver module and the
    per-layer metrics it reports (``[(entry, reader module)]``)."""
    m = manifest(root)
    cells = {w["name"]: w for w in m["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in m["configs"]}
    config_entry = configs[cell["config"]]
    config = json.loads((root / config_entry["file"]).read_text())
    traffic = json.loads(traffic_path(cell["traffic"]).read_text())
    driver = load_module(driver_path(traffic["driver"]), f"bench_driver_{traffic['driver']}")
    end_to_end = [e for e in m["end_to_end"] if workload in e.get("workloads", [workload])]
    reported = {e["name"] for e in end_to_end}
    per_layer = []
    for metric in m["per_layer"]:
        listed = metric.get("workloads")
        if (listed is None and metric["moves"] in reported) or (listed and workload in listed):
            reader = load_module(metric_path(metric["name"]),
                                 "bench_metric_" + metric["name"].replace(".", "_"))
            per_layer.append((metric, reader))
    return SimpleNamespace(name=workload, entry=cell, config=config, traffic=traffic,
                           driver=driver, end_to_end=end_to_end, per_layer=per_layer,
                           run_seconds=m["run_seconds"])
