"""``serve.layout_hit_share``: the share of the service's BlockedCSC
admissions that took the design's cached layouts (the port's counters
``serve.layout_hits`` and ``serve.layout_builds``), read on the tiny root
and on a hand-made tally."""
from __future__ import annotations

import types

import pytest

from bench import harness
from bench.tests import tiny
from bench.tests.test_bench_spans import _run
from bench.tests.tiny import one_thread  # noqa: F401

NAME = "serve.layout_hit_share"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.build(tmp_path_factory.mktemp("tiny"))


def test_layout_hit_share_reads_hits_over_admissions():
    """Hits over hits plus builds in the profiled jobs, and None in an
    untraced run or where the program counted neither (a dense stream, or
    a port without the counters)."""
    from torch.profiler import profile

    from repro_torch import obs
    read = harness.reader(NAME)
    traced = types.SimpleNamespace(trace=object(), trace_solves=4)
    obs.reset()
    assert read(traced) is None
    with profile():
        obs.count("serve.layout_builds", 1)
        obs.count("serve.layout_hits", 3)
    assert read(traced) == 0.75
    assert read(types.SimpleNamespace(trace=None, trace_solves=0)) is None
    obs.reset()


@pytest.mark.parametrize("trace", [True, False])
def test_sparse_serve_run_reports_the_share(root, trace, monkeypatch):
    """A traced run of the sparse serving cell reports the share, equal to
    the tally; an untraced one reports nothing."""
    from repro_torch import obs
    out, rec = _run(root, "tiny-lasso.serve", trace, monkeypatch)
    assert out["correct"] is True, out["checks"]
    if not trace:
        assert NAME not in out["metrics"]
        assert harness.reader(NAME)(rec) is None
        return
    counters = obs.totals()["counters"]
    hits = counters["serve.layout_hits"]
    builds = counters.get("serve.layout_builds", 0)
    assert hits >= 1
    assert out["metrics"][NAME]["value"] == pytest.approx(
        hits / (hits + builds), rel=1e-12)


@pytest.mark.parametrize("cell", ["tiny-logreg.serve", "tiny-lasso.solve"])
def test_cells_without_sparse_admission_leave_it_out(root, cell,
                                                     monkeypatch):
    """A dense serving cell and a solve cell admit no BlockedCSC design, so
    the reader finds nothing and the line leaves the metric out."""
    out, rec = _run(root, cell, True, monkeypatch)
    assert out["correct"] is True, out["checks"]
    assert NAME not in out["metrics"]
    assert harness.reader(NAME)(rec) is None
