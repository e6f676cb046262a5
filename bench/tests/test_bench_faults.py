"""``correct`` comes out false when the timed path is broken underneath,
and for the control, at a size the CPU holds, against the real limits.

The runs skip the harness's look for a card (they call ``run_cell`` on the
CPU, where the port's kernel wrappers run their plain versions) and break
the port where it computes: a step that returns its state unchanged, half
of the batch left out, an answer altered where it is produced.  No cell
runs on more than one card, so there is no exchange between cards to
leave out.
"""
from __future__ import annotations

import time

import pytest
import torch

from bench import control, harness
from bench.tests import tiny
from bench.tests.tiny import one_thread  # noqa: F401

CELLS = list(tiny.CELLS)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.build(tmp_path_factory.mktemp("tiny"))


def run(root, cell, variant=None):
    c = harness.load_cell(cell, False, root)
    return harness.run_cell(c, 1_000_003, 0.05, False,
                            t_start=time.perf_counter(), device="cpu",
                            root=root, variant=variant)


def _kernel_names(cell):
    """(module, name) of the kernel wrapper the cell's timed path calls."""
    sparse = cell.startswith("tiny-lasso")
    if cell.endswith("solve"):
        return ("repro_torch.kernels.ops", "fused_sparse_shotgun_rounds"
                if sparse else "fused_shotgun_rounds")
    return ("repro_torch.core.batched", "batched_fused_sparse_shotgun_rounds"
            if sparse else "batched_fused_shotgun_rounds")


def _unchanged(real, sparse):
    """The kernel's state comes back as it went in: (x, z, f, nnz,
    health) with the input x and z."""
    def kernel(*args, **kw):
        out = real(*args, **kw)
        z, x = (args[2], args[3]) if sparse else (args[1], args[2])
        return (x.clone(), z.clone(), *out[2:])
    return kernel


def _half_left_out(real, sparse, serve):
    """Half of the batch left out: every other slot frozen (a served
    job), or half of each round's drawn blocks (a solve)."""
    def kernel(*args, **kw):
        if serve:
            args = list(args)
            args[8] = args[8].clone()
            args[8][1::2] = 0
            return real(*args, **kw)
        K = (args[4] if sparse else args[3]).shape[1]
        kw["k_eff"] = max(1, K // 2)
        return real(*args, **kw)
    return kernel


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    assert run(root, cell)["correct"] is True


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_underneath_is_not_correct(root, cell, fault, monkeypatch):
    import importlib
    serve = cell.endswith("serve")
    mod_name, name = _kernel_names(cell)
    mod = importlib.import_module(mod_name)
    real = getattr(mod, name)
    sparse = "sparse" in name
    if fault == "unchanged":
        monkeypatch.setattr(mod, name, _unchanged(real, sparse))
    elif fault == "half":
        monkeypatch.setattr(mod, name, _half_left_out(real, sparse, serve))
    elif serve:
        from repro_torch.launch import solver_serve
        fin = solver_serve.SolverService._finalize

        def finalize(self, slot, req, status):
            fin(self, slot, req, status)
            if req.rid == 0:
                req.x = req.x * 1.01
        monkeypatch.setattr(solver_serve.SolverService, "_finalize",
                            finalize)
    else:
        from repro_torch.kernels import ops
        solve = ops.block_shotgun_solve

        def altered(*args, **kw):
            res = solve(*args, **kw)
            x = res.x.clone()
            x[torch.argmax(x.abs())] *= 1.01
            return res._replace(x=x)
        monkeypatch.setattr(ops, "block_shotgun_solve", altered)
    out = run(root, cell)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    """The control in the port's place: the port's bfloat16 design path
    for a solve, the bfloat16 reference for a served job."""
    if cell.endswith("solve"):
        out = run(root, cell, variant="bf16")
        assert out["correct"] is False, out["checks"]
        return
    c = harness.load_cell(cell, False, root)
    checks = control.serve_control(c, 1_000_003, 0.05, torch.device("cpu"))
    assert any(checks[k] > c.limits[k] for k in c.limits), checks
