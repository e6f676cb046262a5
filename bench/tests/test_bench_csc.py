"""The cell of a heavy-tailed CSC design (``url-logreg.solve``) at a size
the CPU holds: a sound run is ``correct``, the CSC reference agrees with
``shotgun.Design`` on a design that fits tiles, and a port that drops its
overflow store, or runs in bfloat16, is not."""
from __future__ import annotations

import json
import time

import pytest
import torch

from bench import harness
from bench.data import csc as gen
from bench.data import generators
from bench.reference import csc as ref_csc
from bench.reference import shotgun as ref
from bench.tests import tiny
from bench.tests.tiny import one_thread  # noqa: F401

CONFIGS = {
    "tiny-url": {"generator": "url_skewed", "loss": "logistic",
                 "lam_ratio": 0.1, "tile": 16,
                 "shape": {"n": 3000, "d": 9000, "nnz": 120000,
                           "binary_below": 0.1}},
}
MIXES = {
    "t-csc": {"driver": "solve_csc", "P": 256, "rounds": 16,
              "rounds_per_launch": 8, "newton": True,
              "guard": {"factor": 10.0, "p_min": 1}, "warmup": 1,
              "trace_calls": 2, "sample": 2},
}
CELLS = {
    "tiny-url.solve": ("tiny-url", "t-csc", "url-logreg.solve"),
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.build(tmp_path_factory.mktemp("tiny"))
    real = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name, cfg in CONFIGS.items():
        tiny.write(root / "bench" / "configs" / f"{name}.json", cfg)
        bench["configs"].append({"name": name, "source": "tests",
                                 "reduced": [], "why": "tests",
                                 "file": f"bench/configs/{name}.json"})
    for name, mix in MIXES.items():
        tiny.write(root / "bench" / "traffic" / f"{name}.json", mix)
    for cell, (conf, mix, stands_for) in CELLS.items():
        (root / "bench" / "limits" / f"{cell}.json").write_text(
            (tiny.REPO / "bench" / "limits" / f"{stands_for}.json")
            .read_text())
        bench["workloads"].append({"name": cell, "config": conf,
                                   "traffic": mix, "chips": 1,
                                   "why": "tests"})
    for m, r in zip(bench["end_to_end"] + bench["per_layer"],
                    real["end_to_end"] + real["per_layer"]):
        if "workloads" in m:
            m["workloads"] += [c for c, (_, _, s) in CELLS.items()
                               if s in r["workloads"]]
    tiny.write(root / "BENCHMARK.json", bench)
    return root


def run(root, cell, trace=False, variant=None):
    c = harness.load_cell(cell, trace, root)
    return harness.run_cell(c, 2_147_483_659, 0.05, trace,
                            t_start=time.perf_counter(), device="cpu",
                            root=root, variant=variant)


@pytest.mark.parametrize("cell", list(CELLS))
def test_sound_run_is_correct(root, cell):
    out = run(root, cell, trace=True)
    assert out["correct"] is True, out["checks"]
    assert out["checks"]["decisions"]["value"] == 0
    assert out["attempted"] > 0 and out["failed"] == 0
    names = set(out["metrics"])
    assert {"solver.host_syncs_per_solve", "solver.launch_host_us"} <= names
    if cell == "tiny-url.solve":
        assert {"solver.overflow_host_us",
                "solver.overflow_segments_per_solve"} <= names


def test_csc_design_agrees_with_tiles():
    """On a design whose columns fit a tile, the CSC reference and the
    tiled one give the same objective trace and iterate."""
    data = gen.url_skewed(7, n=400, d=1000, nnz=4000, device="cpu")
    A = data.A
    counts = (A.col_ptr[1:] - A.col_ptr[:-1])
    tile = int(counts.max())
    nblk = -(-A.d // 128)
    rows = torch.zeros(nblk * 128, tile, dtype=torch.int32)
    vals = torch.zeros(nblk * 128, tile)
    col = torch.repeat_interleave(torch.arange(A.d), counts)
    rank = torch.arange(A.rows.numel()) - A.col_ptr[col]
    rows[col, rank], vals[col, rank] = A.rows, A.vals
    tiles = generators.SparseRaw(
        rows=rows.reshape(nblk, 128, tile).transpose(1, 2).contiguous(),
        vals=vals.reshape(nblk, 128, tile).transpose(1, 2).contiguous(),
        nnz_blk=A.nnz_blk, n=A.n, d=A.d)
    got = ref_csc.Design(A, data.y, "logistic")
    want = ref.Design(tiles, data.y, "logistic")
    assert got.lambda_max() == pytest.approx(want.lambda_max(), rel=1e-12)
    idx = torch.tensor([[0, 5], [2, 7], [1, 3], [6, 4]], dtype=torch.int32)
    kw = dict(R=2, newton=True, guard={"factor": 10.0, "p_min": 1})
    a = ref.solve(got, 0.1 * got.lambda_max(), idx, **kw)
    b = ref.solve(want, 0.1 * want.lambda_max(), idx, **kw)
    assert ref.trace_gap(a.trace, b.trace) < 1e-12
    assert ref.rel_gap(a.x, b.x) < 1e-12 and a.status == b.status


def test_dropped_overflow_store_is_not_correct(root, monkeypatch):
    """The port's design without its overflow store (the spilled entries
    left out of every round) fails ``correct``."""
    import dataclasses

    from bench.drivers import solve_csc
    real = solve_csc.port_problem

    def dropped(*args, **kw):
        prob = real(*args, **kw)
        assert prob.A.ovf is not None
        return prob._replace(A=dataclasses.replace(prob.A, ovf=None))
    monkeypatch.setattr(solve_csc, "port_problem", dropped)
    assert run(root, "tiny-url.solve")["correct"] is False


@pytest.mark.parametrize("cell", list(CELLS))
def test_control_is_not_correct(root, cell):
    """``bench/control.py``'s control (the port's bfloat16 design) falls
    outside the limits."""
    assert run(root, cell, variant="bf16")["correct"] is False
