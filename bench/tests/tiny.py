"""A benchmark root at a size the CPU holds, for the tests: the four cells
of ``BENCHMARK.json`` cut to small shapes, each held to the limits of the
cell it stands for, with the real metric readers."""
from __future__ import annotations

import json
import pathlib
import shutil

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]

CONFIGS = {
    "tiny-lasso": {"generator": "large_sparse", "loss": "lasso",
                   "lam_ratio": 0.1,
                   "shape": {"n": 1500, "d": 4000, "density": 0.01,
                             "tile": 32}},
    "tiny-logreg": {"generator": "logistic_dense", "loss": "logistic",
                    "lam_ratio": 0.1, "shape": {"n": 2000, "d": 300}},
}
MIXES = {
    "t-refit": {"driver": "solve_loop", "P": 512, "rounds": 32,
                "rounds_per_launch": 8, "newton": False, "guard": None,
                "warmup": 1, "trace_calls": 2, "sample": 2},
    "t-newton": {"driver": "solve_loop", "P": 256, "rounds": 16,
                 "rounds_per_launch": 8, "newton": True,
                 "guard": {"factor": 10.0, "p_min": 1}, "warmup": 1,
                 "trace_calls": 2, "sample": 2},
    "t-grid": {"driver": "serve_backlog", "slots": 4, "K": 4,
               "rounds_per_launch": 8, "max_rounds": 32, "tol": 1e-4,
               "designs": 2, "lam_grid": [0.5, 0.05, 4], "copies": 2,
               "warmup": 1, "trace_calls": 1, "sample": 1},
    "t-grid-dense": {"driver": "serve_backlog", "slots": 2, "K": 2,
                     "rounds_per_launch": 8, "max_rounds": 32, "tol": 1e-4,
                     "designs": 2, "lam_grid": [0.5, 0.05, 2], "copies": 2,
                     "warmup": 1, "trace_calls": 1, "sample": 1},
}
# tiny cell -> (config, traffic, the cell whose limits it is held to)
CELLS = {
    "tiny-lasso.solve": ("tiny-lasso", "t-refit", "news20-lasso.solve"),
    "tiny-logreg.solve": ("tiny-logreg", "t-newton", "zeta-logreg.solve"),
    "tiny-lasso.serve": ("tiny-lasso", "t-grid", "news20-lasso.serve"),
    "tiny-logreg.serve": ("tiny-logreg", "t-grid-dense", "zeta-logreg.serve"),
}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: the suite runs under several workers,
    and tiny shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write(path: pathlib.Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1) + "\n")


def build(root: pathlib.Path) -> pathlib.Path:
    """Write the tiny root under ``root`` and return it."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    shutil.copytree(REPO / "bench" / "metrics", root / "bench" / "metrics",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, cfg in CONFIGS.items():
        write(root / "bench" / "configs" / f"{name}.json", cfg)
    for name, mix in MIXES.items():
        write(root / "bench" / "traffic" / f"{name}.json", mix)
    (root / "bench" / "limits").mkdir()
    for cell, (_, _, real) in CELLS.items():
        shutil.copy(REPO / "bench" / "limits" / f"{real}.json",
                    root / "bench" / "limits" / f"{cell}.json")
    bench["configs"] = [{"name": k, "source": "tests", "reduced": [],
                         "file": f"bench/configs/{k}.json", "why": "tests"}
                        for k in CONFIGS]
    bench["workloads"] = [{"name": c, "config": conf, "traffic": mix,
                           "chips": 1, "why": "tests"}
                          for c, (conf, mix, _) in CELLS.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [c for c, (_, _, real) in CELLS.items()
                              if real in m["workloads"]]
    write(root / "BENCHMARK.json", bench)
    return root
