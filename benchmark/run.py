#!/usr/bin/env python3
"""Run one cell of the port's benchmark on one CUDA card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is looked up by name in ``BENCHMARK.json``; its configuration,
traffic mix, driver and per-layer metric readers are files found by name
(benchmark/harness/cell.py).  One run: set-up (scene, kernels, warm-up: all
counted in ``setup_s``), the measured window of ``--seconds``, then the
plain reference judges what the window produced.  With ``--trace 1`` the
profiler records the window's first iterations and the result carries the
per-layer metrics instead of the end-to-end ones.

The last line on standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` when
traced, ``card``, and ``check`` last: each compared number and its limit);
the same numbers are the last lines on standard error.  Without a CUDA card
the run fails and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: Top-level modules that must not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "fspt_tpu")


def cache_environment(root: Path):
    """Keep every build and kernel cache at fixed paths inside the checkout
    (the program's nvcc builds already go to ``build/fspt_tpu_torch``)."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def driver_value(end_to_end: dict, name: str):
    """The driver's reading for the manifest's metric ``name``: under that
    name, or, for a metric kept apart per cell (``recover_step_ms.pool1``),
    under the name before its first dot."""
    return end_to_end.get(name, end_to_end.get(name.split(".")[0]))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             root: Path = ROOT, traffic_overrides=None, t0: float | None = None):
    """One run of ``workload`` on ``device``; returns ``(result, numbers)``
    with ``numbers`` the ``[(name, value, limit)]`` the check compared."""
    import torch

    from benchmark.harness import cell as cells
    from benchmark.harness import timing, workcount
    from benchmark.harness import trace as tracing

    c = cells.resolve(workload, root)
    traffic = {**c.traffic, **(traffic_overrides or {})}
    ctx = SimpleNamespace(root=root, config=c.config, traffic=traffic, seed=seed,
                          device=device, trace=trace)
    session = c.driver.Session(ctx)
    session.setup()
    timing.synchronize(device)
    setup_s = time.perf_counter() - (T0 if t0 is None else t0)
    phases = ", ".join(f"{k} {v:.3f} s" for k, v in session.setup_phases.items())
    print(f"benchmark: set-up {setup_s:.3f} s ({phases})", file=sys.stderr, flush=True)

    tracer = tracing.Tracer(traffic["trace_iterations"]) if trace else None
    w0 = time.perf_counter()
    k = 0
    while True:
        session.iteration(k)
        k += 1
        if tracer is not None and tracer.active:
            tracer.step()
        window_s = time.perf_counter() - w0
        if window_s >= seconds and (tracer is None or not tracer.active):
            break
    cuda = device.type == "cuda"
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    end_to_end = session.end_to_end(window_s)
    session.release()
    if cuda:
        torch.cuda.empty_cache()
    c0 = time.perf_counter()
    numbers = session.check()
    print(f"benchmark: window {window_s:.3f} s ({k} iterations), "
          f"check {time.perf_counter() - c0:.3f} s", file=sys.stderr, flush=True)
    correct = all(math.isfinite(v) and v <= limit for _, v, limit in numbers)

    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": c.entry["chips"], "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": session.attempted, "failed": session.failed}
    if trace:
        reading = tracing.Reading(tracer.events, tracer.count, c.traffic["driver"])
        # Iteration 0 ran under the profiler's warm-up; 1 .. count are traced.
        reading.work = session.work(1, tracer.count)
        reading.least_s, reading.bound = workcount.least_time(*reading.work)
        metrics = {}
        for entry, reader in c.per_layer:
            value = reader.read(reading)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
        dev.update(busy_s=reading.busy_s, window_s=reading.window_s)
        result.update(metrics=metrics, device=dev, breakdown=reading.breakdown())
        result["roofline_bound"] = {"by": reading.bound, "least_s": reading.least_s,
                                    "ops": reading.work[0], "bytes": reading.work[1]}
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        for entry in c.end_to_end:
            value = driver_value(end_to_end, entry["name"])
            if value is not None:
                metrics[entry["name"]] = {"value": value[0], "unit": value[1]}
        result.update(metrics=metrics, device=dev)
    return result, numbers


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one cell of the port's benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cache_environment(ROOT)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import cell as cells
    from benchmark.harness import timing

    chips = next(w["chips"] for w in cells.manifest(ROOT)["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result, numbers = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                               torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    result["card"] = timing.card()
    result["check"] = {name: {"value": value, "limit": limit} for name, value, limit in numbers}
    print(f"card: {result['card']['nvidia_smi']}", file=sys.stderr)
    for name, value, limit in numbers:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
