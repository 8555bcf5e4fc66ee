"""``BENCHMARK.json`` against the contract's form, and every piece of every
cell found by name."""

from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


@pytest.fixture(scope="module")
def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    assert 1 <= len(manifest["command"]) <= 32
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units(manifest):
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in manifest[group]]
        assert len(names) == len(set(names)), group
        for e in manifest[group]:
            assert NAME.match(e["name"]), e["name"]
    for e in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(e["unit"]), e["unit"]
        assert e["better"] in ("lower", "higher")
    for w in manifest["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    for c in manifest["configs"]:
        assert 1 <= len(c["source"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for m in manifest["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_entries_have_only_the_contract_keys(manifest):
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for e in manifest["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.0 < e["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_piece_is_found_by_name(manifest):
    from benchmark.harness import cell as cells

    configs = {c["name"]: c for c in manifest["configs"]}
    used = set()
    for w in manifest["workloads"]:
        config = configs[w["config"]]
        used.add(config["name"])
        assert config["file"].startswith("benchmark/") and (ROOT / config["file"]).is_file()
        assert json.loads((ROOT / config["file"]).read_text())["name"] == config["name"]
        traffic = json.loads(cells.traffic_path(w["traffic"]).read_text())
        assert cells.driver_path(traffic["driver"]).is_file()
        resolved = cells.resolve(w["name"])
        assert resolved.per_layer, w["name"]
    assert used == set(configs)
    for m in manifest["per_layer"]:
        assert cells.metric_path(m["name"]).is_file(), m["name"]


def test_every_cell_reports_setup_and_another_metric(manifest):
    from benchmark.harness import cell as cells

    for w in manifest["workloads"]:
        names = {e["name"] for e in cells.resolve(w["name"]).end_to_end}
        assert "setup_s" in names and len(names) >= 2, w["name"]
    setup = next(e for e in manifest["end_to_end"] if e["name"] == "setup_s")
    assert "workloads" not in setup and setup["bound"] <= 0.25


def test_moves_is_reported_by_every_listed_cell(manifest):
    from benchmark.harness import cell as cells

    for m in manifest["per_layer"]:
        assert m["workloads"], m["name"]
        for w in m["workloads"]:
            reported = {e["name"] for e in cells.resolve(w).end_to_end}
            assert m["moves"] in reported, (m["name"], w)


def test_checked_frames_come_after_the_traced_ones(manifest):
    """A checked frame copies its outputs and framebuffer; none of those
    copies may fall among the frames a traced run records (1 .. count)."""
    from benchmark.harness import cell as cells

    for w in manifest["workloads"]:
        traffic = json.loads(cells.traffic_path(w["traffic"]).read_text())
        if "check_within" in traffic:
            assert traffic["check_within"][0] > traffic["trace_iterations"], w["name"]


def test_split_metrics_read_the_drivers_name():
    from benchmark import run

    readings = {"recover_step_ms": (8.8, "ms"), "segments_per_s": (1e10, "segments/s")}
    assert run.driver_value(readings, "recover_step_ms.pool8") == (8.8, "ms")
    assert run.driver_value(readings, "segments_per_s") == (1e10, "segments/s")
    assert run.driver_value(readings, "frames_per_s") is None


def test_layers_share_their_names(manifest):
    by_layer = {}
    for m in manifest["per_layer"]:
        by_layer.setdefault(m["layer"], []).append(m["name"])
    assert set(by_layer) == {"entry", "framebuffer", "kernels", "device"}


def test_check_fits_with_24_cells(manifest):
    """A full check of 24 cells fits in 43,200 s at this run length."""
    s = manifest["run_seconds"]
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (s + 60) + cells * 2 * 90 + 1200 <= 43200


def test_four_chip_cells_are_few(manifest):
    four = [w for w in manifest["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(manifest["workloads"]) // 4)


def test_a_run_without_a_card_fails_and_prints_no_result():
    """On a machine without CUDA the command exits non-zero with nothing
    on standard output: it never falls back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "flagship-render",
                           "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr
