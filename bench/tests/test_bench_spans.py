"""The per-layer metrics that read the port's own spans and counters
(``repro_torch.obs``), on the tiny root: a traced run reports each one its
cell lists, equal to the tally over the profiled solves (or launches); an
untraced run reports none of them."""
from __future__ import annotations

import json
import time

import pytest

from bench import harness
from bench.tests import tiny
from bench.tests.tiny import one_thread  # noqa: F401

NEW = ("solver.launch_host_us", "solver.pad_bytes_per_solve",
       "serve.admit_ms_per_solve", "serve.admit_bytes_per_solve",
       "serve.cache_host_bytes_per_solve")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.build(tmp_path_factory.mktemp("tiny"))


def _listed(cell: str) -> set[str]:
    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    real = tiny.CELLS[cell][2]
    return {m["name"] for m in bench["per_layer"]
            if m["name"] in NEW and real in m["workloads"]}


def _run(root, cell, trace, monkeypatch):
    """One run of ``cell`` from a clean tally; returns (result line, the
    ``Record`` the readers were handed)."""
    from repro_torch import obs
    seen = []
    real_reader = harness.reader

    def reader(name, root=harness.ROOT):
        read = real_reader(name, root)

        def spy(rec):
            seen.append(rec)
            return read(rec)
        return spy

    monkeypatch.setattr(harness, "reader", reader)
    obs.reset()
    c = harness.load_cell(cell, trace, root)
    out = harness.run_cell(c, 3_000_000_019, 0.05, trace,
                           t_start=time.perf_counter(), device="cpu",
                           root=root)
    return out, seen[0]


@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_traced_run_reports_the_tally(root, cell, monkeypatch):
    from repro_torch import obs
    out, rec = _run(root, cell, True, monkeypatch)
    assert out["correct"] is True, out["checks"]
    want = _listed(cell)
    assert want and {m for m in out["metrics"] if m in NEW} == want
    t = obs.totals()
    spans, counters = t["spans"], t["counters"]
    solves = rec.trace_solves
    assert solves >= 1 and t["dropped"] == 0
    expect = {}
    if cell.endswith(".solve"):
        mix = tiny.MIXES[tiny.CELLS[cell][1]]
        launches = counters["solver.launches"]
        assert launches == solves * mix["rounds"] // mix["rounds_per_launch"]
        assert spans["repro_torch.solve"]["calls"] == solves
        expect["solver.launch_host_us"] = \
            spans["repro_torch.solve.launches"]["seconds"] * 1e6 / launches
        if "solver.pad_bytes_per_solve" in want:
            expect["solver.pad_bytes_per_solve"] = \
                counters["solver.pad_bytes"] / solves
    else:
        expect["serve.admit_ms_per_solve"] = \
            spans["repro_torch.serve.admit"]["seconds"] * 1e3 / solves
        expect["serve.admit_bytes_per_solve"] = \
            counters["serve.admit_bytes"] / solves
        expect["serve.cache_host_bytes_per_solve"] = \
            counters["serve.cache_host_bytes"] / solves
        assert counters["serve.cache_host_bytes"] > 0
    assert set(expect) == want
    for name, value in expect.items():
        assert out["metrics"][name]["value"] == pytest.approx(value,
                                                              rel=1e-12)
        assert value > 0


@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_untraced_run_reports_none_of_them(root, cell, monkeypatch):
    out, rec = _run(root, cell, False, monkeypatch)
    assert out["correct"] is True, out["checks"]
    assert rec.trace is None
    assert not set(out["metrics"]) & set(NEW)
    for name in NEW:
        assert harness.reader(name)(rec) is None
