"""The harness on the CPU: cells found by name, the benchmark's file, the
result line, new files picked up without an edit, and what a run loads."""
from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys
import time

import pytest
import torch

from bench import harness
from bench.tests import tiny
from bench.tests.tiny import one_thread  # noqa: F401

REPO = tiny.REPO
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.build(tmp_path_factory.mktemp("tiny"))


def run(root, cell, trace=False, seconds=0.05, **kw):
    c = harness.load_cell(cell, trace, root)
    return harness.run_cell(c, 2_147_483_659, seconds, trace,
                            t_start=time.perf_counter(), device="cpu",
                            root=root, **kw)


def test_benchmark_json_keeps_the_contract():
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "bench/run.py"]
    assert b["paths"] == ["bench"]
    assert 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (REPO / c["file"]).is_file()
        assert json.loads((REPO / c["file"]).read_text())["name"] == c["name"]
        names.add(c["name"])
    cells = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        cells.add(w["name"])
    metrics = b["end_to_end"] + b["per_layer"]
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
        assert (REPO / "bench" / "metrics" / f"{m['name']}.py").is_file()
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", ["news20-lasso.solve", "zeta-logreg.solve",
                                  "news20-lasso.serve", "zeta-logreg.serve"])
def test_each_cell_is_found_by_name(cell):
    for trace in (False, True):
        c = harness.load_cell(cell, trace)
        assert c.config["loss"] in ("lasso", "logistic")
        assert c.mix["driver"] in ("solve_loop", "serve_backlog")
        assert c.limits["decisions"] == 0
        names = {m["name"] for m in c.metrics}
        if trace:
            assert names, "every cell reports a per-layer metric"
        else:
            assert "setup_s" in names and len(names) >= 2
        for m in c.metrics:
            assert callable(harness.reader(m["name"]))


@pytest.mark.parametrize("cell,trace", [
    ("tiny-lasso.solve", False), ("tiny-logreg.solve", False),
    ("tiny-lasso.serve", False), ("tiny-logreg.serve", False),
    ("tiny-lasso.solve", True), ("tiny-lasso.serve", True)])
def test_result_line_schema(root, cell, trace):
    out = run(root, cell, trace)
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    for name, m in out["metrics"].items():
        assert isinstance(m["value"], float | int) and m["unit"]
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in out["breakdown"].values())
        sync = ("solver" if cell.endswith("solve") else "serve") \
            + ".host_syncs_per_solve"
        assert sync in out["metrics"]
    else:
        assert "setup_s" in out["metrics"] and "solves_per_s" in out["metrics"]
        assert ("solve_ms_p95" in out["metrics"]) == cell.endswith("solve")
    json.loads(json.dumps(out, allow_nan=False))


def test_new_config_mix_cell_and_metric_are_new_files_only(root, tmp_path):
    """A sparse logistic configuration (rcv1's regime, cut small), its
    traffic, its cell, its limits and a new metric, added as files and
    entries: the harness runs the cell and reports the metric."""
    import shutil
    new = tmp_path / "root"
    shutil.copytree(root, new)
    tiny.write(new / "bench" / "configs" / "tiny-rcv1.json", {
        "generator": "logistic_sparse", "loss": "logistic", "lam_ratio": 0.1,
        "shape": {"n": 1200, "d": 3000, "density": 0.02, "tile": 40}})
    tiny.write(new / "bench" / "traffic" / "t-rcv1.json", {
        "driver": "solve_loop", "P": 256, "rounds": 16,
        "rounds_per_launch": 8, "newton": True,
        "guard": {"factor": 10.0, "p_min": 1}, "warmup": 1,
        "trace_calls": 1, "sample": 1})
    shutil.copy(REPO / "bench" / "limits" / "zeta-logreg.solve.json",
                new / "bench" / "limits" / "tiny-rcv1.solve.json")
    (new / "bench" / "metrics" / "solve_ms_p50.py").write_text(
        "import numpy as np\n\n\ndef read(rec):\n"
        "    return float(np.median(rec.solve_s)) * 1e3 if rec.solve_s "
        "else None\n")
    b = json.loads((new / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tiny-rcv1", "source": "tests",
                         "file": "bench/configs/tiny-rcv1.json",
                         "reduced": [], "why": "tests"})
    b["workloads"].append({"name": "tiny-rcv1.solve", "config": "tiny-rcv1",
                           "traffic": "t-rcv1", "chips": 1, "why": "tests"})
    b["end_to_end"].append({"name": "solve_ms_p50", "unit": "ms",
                            "better": "lower", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": ["tiny-rcv1.solve"]})
    tiny.write(new / "BENCHMARK.json", b)
    out = run(new, "tiny-rcv1.solve")
    assert out["correct"] is True, out["checks"]
    assert {"solve_ms_p50", "solves_per_s", "setup_s"} <= set(out["metrics"])


def _modules_of(code: str) -> set[str]:
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1",
             "PYTHONPATH": f"{REPO}:{REPO / 'src'}"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_the_reference_no_port(root):
    tops = _modules_of(
        "import json, sys, time, pathlib\n"
        "from bench import harness, run\n"
        f"root = pathlib.Path({str(root)!r})\n"
        "c = harness.load_cell('tiny-lasso.serve', False, root)\n"
        "harness.run_cell(c, 7, 0.05, False, t_start=time.perf_counter(), "
        "device='cpu', root=root)\n"
        "assert run.forbidden_modules() == []\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "repro_torch" in tops and "bench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}
    ref = _modules_of(
        "import json, sys\n"
        "import bench.reference.shotgun, bench.reference.serve, "
        "bench.reference.bytes, bench.data.generators, bench.data.streams\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not ref & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_the_purity_check_compares_whole_names():
    from bench import run as run_mod
    assert run_mod.forbidden_modules(
        ["repro_torch", "repro_torch.core", "jaxtyping", "bench"]) == []
    assert run_mod.forbidden_modules(
        ["repro.core", "jax.numpy", "jaxlib", "flax.linen", "torch"]) == \
        ["flax", "jax", "jaxlib", "repro"]


@pytest.mark.parametrize("tree", ["checkout", "bench_only"])
def test_run_prints_no_result_without_a_card_or_the_program(tree, tmp_path):
    """Without a card the command exits non-zero with no result; in a
    directory holding only BENCHMARK.json and bench/ it does on any
    machine."""
    import shutil
    if tree == "checkout" and torch.cuda.is_available():
        pytest.skip("this machine has a card: the run would measure")
    where = REPO
    if tree == "bench_only":
        where = tmp_path
        shutil.copy(REPO / "BENCHMARK.json", where)
        shutil.copytree(REPO / "bench", where / "bench",
                        ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "news20-lasso.solve",
         "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=where,
        capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert proc.returncode != 0
    assert "{" not in proc.stdout
