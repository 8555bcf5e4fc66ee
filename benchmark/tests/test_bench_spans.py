"""The readers of the program's spans (``benchmark/harness/spans.py`` and the
``host_ms.*`` / ``idle_ms.*`` metrics) on hand-built readings with known
overlaps, and on a traced run of each cell on the CPU."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from conftest import ROOT, WORKLOADS, run_small

#: Each span metric and the span it reads.
SPAN_METRICS = {
    "host_ms.trace.render": "fspt.trace",
    "host_ms.accumulate.render": "fspt.accumulate",
    "idle_ms.trace.render": "fspt.trace",
    "host_ms.grad.recover.pool1": "fspt.recover.grad",
    "host_ms.optimizer.recover.pool1": "fspt.recover.optimizer",
    "idle_ms.step.recover.pool1": "fspt.recover.step",
    "host_ms.grad.recover.pool8": "fspt.recover.grad",
    "host_ms.optimizer.recover.pool8": "fspt.recover.optimizer",
    "idle_ms.step.recover.pool8": "fspt.recover.step",
}


def _reader(name):
    from benchmark.harness import cell as cells

    return cells.load_module(cells.metric_path(name), "bench_metric_" + name.replace(".", "_"))


def _reading(cpu, gaps, iterations=2):
    """What the readers see of ``harness/trace.Reading``: its host events
    ``(name, start_us, end_us)`` sorted by start, its gaps, its iterations."""
    return SimpleNamespace(_cpu=sorted(cpu, key=lambda r: r[1]), gaps=gaps,
                           iterations=iterations)


# Two iterations.  Host events in µs; the device is idle over the gaps.
#   fspt.recover.step       [0, 1000]      and [2000, 3000]
#   fspt.recover.grad       [100, 400]     and [2100, 2400]
#   fspt.recover.optimizer  [500, 900]     and [2500, 2900]
#   fspt.trace              [0, 200] and [100, 300] (overlapping: counted once)
#   fspt.accumulate         [3500, 3600]
#   gaps: [900, 1200], [1900, 2050], [2800, 2850]
CPU = [("fspt.recover.step", 0.0, 1000.0), ("fspt.recover.step", 2000.0, 3000.0),
       ("fspt.recover.grad", 100.0, 400.0), ("fspt.recover.grad", 2100.0, 2400.0),
       ("fspt.recover.optimizer", 500.0, 900.0), ("fspt.recover.optimizer", 2500.0, 2900.0),
       ("fspt.trace", 0.0, 200.0), ("fspt.trace", 100.0, 300.0),
       ("fspt.accumulate", 3500.0, 3600.0), ("aten::empty", 120.0, 130.0),
       ("bench.step", 0.0, 3000.0)]
GAPS = [(900.0, 1200.0), (1900.0, 2050.0), (2800.0, 2850.0)]
EXPECTED = {
    "host_ms.trace.render": 0.300 / 2,
    "host_ms.accumulate.render": 0.100 / 2,
    "idle_ms.trace.render": 0.0,
    "host_ms.grad.recover.pool1": 0.600 / 2,
    "host_ms.optimizer.recover.pool1": 0.800 / 2,
    # [900, 1000] + [2000, 2050] + [2800, 2850]
    "idle_ms.step.recover.pool1": 0.200 / 2,
}
EXPECTED.update({k.replace("pool1", "pool8"): v for k, v in EXPECTED.items()
                 if k.endswith("pool1")})


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_reader_on_known_overlaps(name):
    value = _reader(name).read(_reading(CPU, GAPS))
    assert value == pytest.approx(EXPECTED[name], abs=1e-12)


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_reader_without_its_span_reads_none(name):
    """A window without the program's spans (the program before it had
    them) reads nothing and does not raise."""
    other = [r for r in CPU if r[0] != SPAN_METRICS[name]]
    assert _reader(name).read(_reading(other, GAPS)) is None
    assert _reader(name).read(_reading([], [])) is None


def test_idle_under_a_span_with_a_gap_across_its_edges():
    from benchmark.harness import spans

    r = _reading([("fspt.trace", 100.0, 200.0), ("fspt.trace", 300.0, 400.0)],
                 [(50.0, 150.0), (180.0, 320.0), (390.0, 500.0)], iterations=1)
    # [100, 150] + [180, 200] + [300, 320] + [390, 400]
    assert spans.idle_ms(r, "fspt.trace") == pytest.approx(0.100)
    assert spans.host_ms(r, "fspt.trace") == pytest.approx(0.200)
    assert spans.overlap_us([(0.0, 10.0)], [(10.0, 20.0)]) == 0.0


def test_manifest_lists_each_span_metric_in_its_own_cells():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in manifest["per_layer"]}
    for name in SPAN_METRICS:
        m = entries[name]
        assert m["source"] == "program_span" and m["better"] == "lower" and m["unit"] == "ms"
        assert len(m["workloads"]) == 1
        cell = m["workloads"][0]
        assert cell == ("flagship-render" if name.endswith("render")
                        else "flagship-recover-" + name.rsplit(".", 1)[1])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traced_cpu_run_reports_the_span_metrics(workload):
    """A traced run on the CPU (no device records: the whole window is a
    gap) reports every span metric of the cell, each within the window."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    listed = [m["name"] for m in manifest["per_layer"]
              if m["name"] in SPAN_METRICS and workload in m["workloads"]]
    assert len(listed) == 3
    result, _ = run_small(workload, seconds=0.2, trace=True)
    window_ms = result["device"]["window_s"] * 1e3
    for name in listed:
        value = result["metrics"][name]["value"]
        assert 0.0 < value < window_ms, (name, value)
