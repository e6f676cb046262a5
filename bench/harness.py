"""One run of one cell: find everything by name, set up, measure, verify.

A cell of ``BENCHMARK.json`` names a configuration (its ``file``), a
traffic mix (``bench/traffic/<traffic>.json``, whose ``driver`` names a
module of ``bench/drivers``) and, by the cell's own name, its limits
(``bench/limits/<cell>.json``).  Every metric is a reader in
``bench/metrics/<metric>.py``.  A later cell, mix, configuration or metric
is a new file and a new entry; nothing here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import pathlib
import time
from typing import NamedTuple

import torch

from bench import tracing
from bench.drivers.common import now, sync

ROOT = pathlib.Path(__file__).resolve().parents[1]


class Record(NamedTuple):
    """What a metric reader reads of one run."""
    setup_s: float
    window_s: float
    attempted: int
    completed: int
    failed: int
    solve_s: list            # each solve's seconds (closed-loop cells)
    counters: dict           # the driver's counters over the window
    range_name: str          # the harness's range around each call
    trace: tracing.Summary | None
    trace_solves: int        # solves completed in the profiled calls
    trace_bytes: int | None  # bytes their work needs


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    metrics: list            # the BENCHMARK.json entries this run reports


def load_cell(name: str, trace: bool, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "bench" / "traffic"
                      / f"{w['traffic']}.json").read_text())
    limits = json.loads((root / "bench" / "limits"
                         / f"{name}.json").read_text())
    return Cell(name, w["chips"], config, mix, limits,
                reported(bench, name, trace))


def reported(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of ``cell`` reports: its end-to-end ones,
    or with ``trace`` the per-layer ones that list it (or, listing none,
    move an end-to-end metric it reports)."""
    def lists(m):
        return "workloads" not in m or cell in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if lists(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}

    def layer(m):
        return cell in m["workloads"] if "workloads" in m \
            else m["moves"] in names
    return [m for m in bench["per_layer"] if layer(m)]


def reader(name: str, root: pathlib.Path = ROOT):
    """The ``read`` function of ``root/bench/metrics/<name>.py``."""
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver_of(cell: Cell, seed: int, device, variant=None):
    module = importlib.import_module(f"bench.drivers.{cell.mix['driver']}")
    return module.Driver(cell.config, cell.mix, seed, device, variant)


def window(drv, seconds: float, trace: bool):
    """Calls until ``seconds`` have passed (at least one); with ``trace``
    the first ``trace_calls`` of them run under the profiler, and the
    window lasts until they are done.  Returns
    (window seconds, per-solve seconds, profiler or None, calls traced)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    dev = drv.device
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    n_trace = drv.mix["trace_calls"] if trace else 0
    prof = span = None
    if n_trace:
        # the profiler's own start-up stays out of the traced span
        prof = profile(activities=acts)
        prof.__enter__()
        sync(dev)
        time.sleep(0.02)
    solve_s: list[float] = []
    i = 0
    t0 = now()
    while True:
        if i == 0 and n_trace:
            span = record_function(tracing.WINDOW)
            span.__enter__()
        solve_s += drv.call(i)
        i += 1
        if span is not None and i == n_trace:
            sync(dev)
            span.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            span = None
        if now() - t0 >= seconds and i >= n_trace:
            break
    return now() - t0, solve_s, prof, n_trace


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             t_start: float, device="cuda", variant=None,
             root: pathlib.Path = ROOT) -> dict:
    """One run: set up, measure for ``seconds``, read the metrics, then
    free the port's state and compare the sampled answers with the
    reference.  Returns the result line as a dict."""
    dev = torch.device(device)
    drv = driver_of(cell, seed, dev, variant)
    drv.setup()
    setup_s = now() - t_start
    window_s, solve_s, prof, traced = window(drv, seconds, trace)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    tally = drv.tally()
    summary, solves_t, bytes_t = None, 0, None
    if prof is not None:
        summary = tracing.summarize(prof.events(), drv.range_name)
        solves_t, bytes_t = drv.trace_work(traced)
    rec = Record(setup_s=setup_s, window_s=window_s,
                 attempted=tally["attempted"], completed=tally["completed"],
                 failed=tally["failed"], solve_s=solve_s,
                 counters=tally["counters"], range_name=drv.range_name,
                 trace=summary, trace_solves=solves_t, trace_bytes=bytes_t)
    metrics = {}
    for m in cell.metrics:
        value = reader(m["name"], root)(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    drv.release()
    del prof
    t_ref = now()
    checks = drv.verify(cell.limits)
    t_ref = now() - t_ref
    correct = all(_within(checks[k], cell.limits[k]) for k in cell.limits)
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": peak}
    if summary is not None:
        device_info.update(busy_s=summary.busy_s, window_s=summary.span_s)
    out = {"correct": correct, "attempted": tally["attempted"],
           "failed": tally["failed"], "metrics": metrics,
           "device": device_info}
    if summary is not None:
        out["breakdown"] = {"device_ops": summary.device_ops,
                            "idle_gaps": summary.idle_gaps}
    out["reference_s"] = t_ref
    out["checks"] = {k: {"value": _number(checks[k]), "limit": cell.limits[k]}
                     for k in cell.limits}
    return out


def _within(value, limit) -> bool:
    return isinstance(value, (int, float)) and not math.isnan(value) \
        and value <= limit


def _number(value):
    """A gap that is not finite (an answer that is NaN or infinite) is
    written as 1e300, so the result stays plain JSON."""
    return value if math.isfinite(value) else 1e300
