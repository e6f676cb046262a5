"""The port's dry-run (``repro_torch.launch.dryrun``) on the CPU.

- ``model_flops`` (with the parameter totals) equals the reference's for
  every arch x shape (the reference's needs only ``eval_shape``; its
  module sets a 512-device ``XLA_FLAGS`` on import, which this file puts
  back before JAX starts).
- ``run_cell`` and ``measure_cell`` return "ok" for each shape kind on a
  (2, 4) fake mesh at the smoke size, with the argument bytes the specs
  give.
- ``measure_cell``'s two-point extrapolation equals the full-depth count
  of flops and collective bytes for a prefill and two decodes, as the
  costs are linear in depth.
- The CLI writes under ``build/dryrun/`` and nothing under
  ``benchmarks/``."""
import dataclasses
import os
import pathlib

import pytest

torch = pytest.importorskip("torch")

_flags = os.environ.get("XLA_FLAGS")
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.launch import dryrun as JD  # noqa: E402
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
HOST = ((2, 4), ("data", "model"))


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_match_reference(arch):
    for name, info in SHAPES.items():
        args = (info["seq"], info["batch"], info["kind"])
        assert D.model_flops(ARCHS[arch].CONFIG, *args) == JD.model_flops(
            JARCHS[arch].CONFIG, *args), name


@pytest.mark.parametrize("arch, shape", [
    ("qwen3-4b", "train_4k"), ("qwen3-4b", "prefill_32k"),
    ("granite-moe-1b-a400m", "decode_32k"),
    ("mamba2-2.7b", "prefill_32k"), ("mamba2-2.7b", "long_500k")])
def test_cells_run_on_a_fake_mesh(arch, shape, tmp_path, monkeypatch):
    monkeypatch.setattr(D, "RESULTS", tmp_path)
    cfg = ARCHS[arch].smoke_config()
    kw = dict(device="cpu", cfg_override=cfg, mesh=HOST)
    run = D.run_cell(arch, shape, "host", **kw)
    assert run["status"] == "ok", run.get("traceback")
    mem = run["memory"]
    assert mem["argument_bytes"] == mem["argument_bytes_from_specs"] > 0
    assert run["hlo_flops_per_device"] > 0 and run["bottleneck"]
    assert run["devices"] == 8 and run["device_type"] == "cpu"
    measured = D.measure_cell(arch, shape, "host", **kw)
    assert measured["status"] == "ok", measured.get("traceback")
    assert measured["num_groups"] == cfg.num_groups
    assert (tmp_path / f"{arch}__{shape}__host__baseline.json").exists()
    assert (tmp_path / f"{arch}__{shape}__host__roofline.json").exists()


@pytest.mark.parametrize("arch, shape, layers", [
    ("qwen3-4b", "prefill_32k", 3), ("qwen3-4b", "decode_32k", 3),
    ("jamba-1.5-large-398b", "decode_32k", None)])
def test_extrapolation_equals_the_full_depth_count(arch, shape, layers,
                                                   tmp_path, monkeypatch):
    """The two-point fit equals the full-depth count exactly, for a
    three-layer prefill and decode and Jamba's two-group smoke decode (the
    decode step pins the residual's layout at each group boundary, so every
    group costs the same)."""
    monkeypatch.setattr(D, "RESULTS", tmp_path)
    cfg = ARCHS[arch].smoke_config()
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    kw = dict(device="cpu", cfg_override=cfg, mesh=HOST)
    full = D.run_cell(arch, shape, "host", **kw)
    est = D.measure_cell(arch, shape, "host", **kw)
    assert full["status"] == est["status"] == "ok"
    assert est["hlo_flops_per_device"] == full["hlo_flops_per_device"]
    assert est["collectives"] == full["collectives"]
    assert est["collective_bytes_per_device"] == \
        full["collective_bytes_per_device"]


def test_cli_writes_under_build_only(monkeypatch):
    bench = ROOT / "benchmarks"
    before = sorted((p, p.stat().st_mtime_ns) for p in bench.rglob("*"))
    assert D.RESULTS == ROOT / "build" / "dryrun"
    out = D.RESULTS / "qwen3-4b__long_500k__single__baseline.json"
    assert D.main(["--arch", "qwen3-4b", "--shape", "long_500k",
                   "--device", "cpu"]) == 0
    assert out.exists() and '"skip"' in out.read_text()
    assert sorted((p, p.stat().st_mtime_ns)
                  for p in bench.rglob("*")) == before
