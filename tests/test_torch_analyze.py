"""The port's lint (``repro_torch.analyze``) against the JAX package's
shotgun-lint (``repro.analyze``) on the same inputs, a positive and a
negative fixture per rule, the whole port tree, and the CLI's exit codes.

Parity: the same findings give the same canonical order and report text;
the same allowlist texts give the same entries, the same suppressed and
stale sets and the same errors; a tree of plain Python files seeded with
shape asserts gives the same SL003 (path, line) set.  The run rules run
here on the CPU: SL101 on compiler report text the test writes (``nvcc``
exists only on the card), SL102 on toy solvers and on the real registry,
SL103 on a fixture tree and live on two gloo ranks."""
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro.analyze import allowlist as jallow  # noqa: E402
from repro.analyze import ast_checks as jast  # noqa: E402
from repro.analyze import findings as jfind  # noqa: E402
from repro_torch.analyze import __main__ as cli  # noqa: E402
from repro_torch.analyze import allowlist as tallow  # noqa: E402
from repro_torch.analyze import ast_checks as tast  # noqa: E402
from repro_torch.analyze import findings as tfind  # noqa: E402
from repro_torch.analyze import trace_checks as tc  # noqa: E402
from repro_torch.analyze.runner import ALL_RULES, run_checkers  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
SRC_RULES = [r for r in ALL_RULES if r.startswith("SL0")]


def lint(tmp_path, source, rel="mod.py", rules=None):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return tfind.sort_findings(tast.run_ast_checks(tmp_path, rules))


# ---------------------------------------------------------------------------
# parity with repro.analyze
# ---------------------------------------------------------------------------

ROWS = [("b.py", 9, "SL002", "error", "m1"),
        ("a.py", 20, "SL001", "error", "m2"),
        ("a.py", 3, "SL003", "warning", "m3"),
        ("a.py", 3, "SL001", "error", "m4"),
        ("a.py", 3, "SL001", "error", "m0")]


def test_findings_order_and_report_match_the_reference():
    mine = [tfind.Finding(*r) for r in ROWS]
    ref = [jfind.Finding(*r) for r in ROWS]
    assert [tuple(f) for f in tfind.sort_findings(mine)] == \
        [tuple(f) for f in jfind.sort_findings(ref)]
    assert tfind.render_report(mine) == jfind.render_report(ref)
    assert tfind.render_report(reversed(mine)) == jfind.render_report(ref)


ALLOW_OK = textwrap.dedent("""
    # vetted: demo entries
    [[allow]]
    rule = "SL003"
    path = "a.py"
    match = "m3"
    reason = "demo suppression"

    [[allow]]
    rule = "SL001"
    path = "a.py"
    reason = "every SL001 of a.py"

    [[allow]]
    rule = "SL002"
    path = "never.py"
    reason = "stale entry"
""")


@pytest.mark.parametrize("text", [
    ALLOW_OK, '[[allow]]\nrule = "SL001"\n',
    '[[allow]]\nrule = "SL001"\npath = "a.py"\nmatch = "x"\n'])
def test_allowlist_parse_and_suppression_match_the_reference(tmp_path, text):
    path = tmp_path / "allow.toml"
    path.write_text(text)

    def run(allow, find):
        try:
            entries = allow.load_allowlist(path)
        except ValueError as e:
            return ("error", str(e))
        kept, suppressed, unused = allow.apply_allowlist(
            [find.Finding(*r) for r in ROWS], entries)
        return ([tuple(e) for e in entries], [tuple(f) for f in kept],
                [tuple(f) for f in suppressed], [tuple(e) for e in unused])

    mine, ref = run(tallow, tfind), run(jallow, jfind)
    assert mine == ref
    if text is ALLOW_OK:
        assert [f[4] for f in mine[2]] == ["m2", "m3", "m4", "m0"]
        assert [e[1] for e in mine[3]] == ["never.py"]
    else:
        assert mine[0] == "error" and "missing required keys" in mine[1]


@pytest.mark.parametrize("text", [ALLOW_OK, '[[allow]]\nrule = SL001\n',
                                  'rule = "SL001"\n'])
def test_toml_subset_fallback_matches_the_reference(text):
    def run(allow):
        try:
            return allow._parse_toml_subset(text)
        except ValueError as e:
            return str(e)
    assert run(tallow) == run(jallow)


def test_shape_asserts_match_the_reference(tmp_path):
    files = {
        "split.py": """
            def split(n, d, block):
                assert d % block == 0
                assert n > 0
                assert n + 1 > d
            """,
        "pkg/check.py": """
            LOSS = "lasso"

            def check(x, d, loss):
                assert x.shape == (d,)
                assert loss == LOSS
                assert x.ndim == 1, "a vector"
            """,
    }
    for rel, src in files.items():
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(textwrap.dedent(src))
    mine = {(f.path, f.line) for f in tast.run_ast_checks(tmp_path,
                                                          ["SL003"])}
    ref = {(f.path, f.line) for f in jast.run_ast_checks(tmp_path,
                                                         ["SL003"])}
    assert mine == ref == {("split.py", 3), ("split.py", 5),
                           ("pkg/check.py", 5), ("pkg/check.py", 7)}


# ---------------------------------------------------------------------------
# SL001 — host sync inside a round
# ---------------------------------------------------------------------------

def test_sl001_flags_syncs_inside_a_range_block(tmp_path):
    fs = lint(tmp_path, """
        import random
        import time
        import numpy as np
        import torch
        ROUNDS_RANGE = "repro_torch.scalar_rounds"

        def solve(x, rounds):
            with torch.profiler.record_function(ROUNDS_RANGE):
                for _ in range(rounds):
                    f = x.sum().item()                    # flagged
                    print(f)                              # flagged
                    t = time.perf_counter()               # flagged
                    u = np.random.rand()                  # flagged
                    torch.cuda.synchronize()              # flagged
                    v = random.random()                   # flagged

                    def peek(z):
                        return z.cpu().numpy()            # flagged twice
            return x
    """)
    assert [f.rule for f in fs] == ["SL001"] * 8
    assert sorted({f.line for f in fs}) == [11, 12, 13, 14, 15, 16, 19]


@pytest.mark.parametrize("opener", ["obs.span", "span"])
def test_sl001_flags_syncs_inside_an_obs_span_range(tmp_path, opener):
    """A ``.cpu()`` seeded inside the port's own span of a ``*_RANGE``
    window is flagged; the same read in a span of another name is not."""
    fs = lint(tmp_path, f"""
        from repro_torch import obs
        from repro_torch.obs import span
        LOOP_RANGE = "repro_torch.loop"

        def loop(x, launches):
            with {opener}(LOOP_RANGE):
                for _ in range(launches):
                    h = x.cpu()                           # flagged
            with {opener}("repro_torch.serve.launch.read"):
                h = x.cpu()
            return x, h
    """)
    assert [(f.rule, f.line) for f in fs] == [("SL001", 9)]


def test_sl001_ignores_syncs_outside_range_blocks(tmp_path):
    fs = lint(tmp_path, """
        import time
        import torch
        import common

        def solve(x, rounds):
            t0 = time.perf_counter()
            with torch.profiler.record_function("setup"):
                scale = float(x.abs().max().item())
            with torch.profiler.record_function(common.ITERS_RANGE):
                for _ in range(rounds):
                    x = x * 0.5
            print(x.sum().item(), time.perf_counter() - t0, scale)
            return x.tolist()
    """)
    assert fs == []


# ---------------------------------------------------------------------------
# SL002 — f32 accumulation (Python and CUDA)
# ---------------------------------------------------------------------------

def test_sl002_flags_uncast_matmuls_in_kernels_dir(tmp_path):
    fs = lint(tmp_path, """
        import torch

        def margin(A, x):
            return A @ x                                   # flagged

        def margin_mv(A, x):
            return torch.mv(A, x)                          # flagged

        def grads(Ak, r):
            return torch.einsum("nkb,n->kb", Ak, r)        # flagged

        def margin_ok(A, x):
            return A.float() @ x

        def margin_ok_t(A, r):
            return torch.matmul(A.to(torch.float32).t(), r)

        def margin_ok_kw(A, x):
            return torch.addmv(x, A.to(dtype=torch.float32), x)
    """, rel="kernels/k.py")
    assert [(f.rule, f.line) for f in fs] == [("SL002", 5), ("SL002", 8),
                                              ("SL002", 11)]


def test_sl002_matmul_rule_scoped_to_kernels_and_dist(tmp_path):
    fs = lint(tmp_path, """
        import torch

        def core_margin(A, x):
            return A @ x + torch.matmul(A, x)
    """, rel="core/c.py")
    assert fs == []
    fs = lint(tmp_path, "def wire(A, x):\n    return A @ x\n",
              rel="dist/w.py")
    assert [f.rule for f in fs] == ["SL002"]


def test_sl002_flags_half_precision_sums_in_cuda(tmp_path):
    fs = lint(tmp_path, """
        #include <cuda_bf16.h>
        // __shared__ __nv_bfloat16 not_code[8];  (a comment)
        __global__ void bad_kernel(const __nv_bfloat16* a, __half* out) {
          __shared__ __nv_bfloat16 buf[128];               // flagged
          __nv_bfloat16 acc = a[0];
          for (int i = 1; i < 8; ++i) acc += a[i];         // flagged
          out[threadIdx.x] += __float2half(1.0f);          // flagged
        }
        __device__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
        __global__ void good_kernel(const __nv_bfloat16* a, float* out) {
          __shared__ float part[128];
          float v = 0.f;
          for (int i = 0; i < 8; ++i) v += to_f32(a[i]);
          out[threadIdx.x] += v;
        }
    """, rel="csrc/k.cu", rules=["SL002"])
    assert [(f.rule, f.line) for f in fs] == [("SL002", 5), ("SL002", 7),
                                              ("SL002", 8)]
    assert "buf" in fs[0].message and "acc" in fs[1].message


# ---------------------------------------------------------------------------
# SL003 — bare assert on shape arithmetic
# ---------------------------------------------------------------------------

def test_sl003_flags_bare_shape_asserts(tmp_path):
    fs = lint(tmp_path, """
        def split(n, d, block):
            assert d % block == 0                 # flagged
            assert n > 0

        def check(x, d):
            assert x.shape == (d,)                # flagged
    """)
    assert [(f.rule, f.line) for f in fs] == [("SL003", 3), ("SL003", 7)]


def test_sl003_ignores_non_shape_asserts(tmp_path):
    fs = lint(tmp_path, """
        def check(prob, loss, n, tile):
            assert prob.loss == loss
            if n % tile:
                raise ValueError(f"n={n} not a multiple of tile={tile}")
    """)
    assert fs == []


# ---------------------------------------------------------------------------
# SL004 — raw exp/log in kernels (Python and CUDA)
# ---------------------------------------------------------------------------

def test_sl004_python_outside_and_inside_the_helper(tmp_path):
    fs = lint(tmp_path, """
        import torch

        def _stable_logistic_tile(m):
            return torch.clamp_min(m, 0.0) + torch.log1p(torch.exp(-m.abs()))

        def loss(m):
            return torch.log(1.0 + torch.exp(m))      # flagged twice

        def weights(m):
            return m.exp()                             # flagged
    """, rel="kernels/k.py")
    assert [(f.rule, f.line) for f in fs] == [("SL004", 8), ("SL004", 8),
                                              ("SL004", 11)]
    assert lint(tmp_path / "other", "import torch\n\ndef f(m):\n"
                "    return torch.exp(m)\n", rel="core/c.py") == []


def test_sl004_cuda_outside_and_inside_loss_tile(tmp_path):
    fs = lint(tmp_path, """
        template <int LOSS>
        __device__ __forceinline__ void loss_tile(float z, float& r) {
          const float sig = 1.0f / (1.0f + expf(-z));
          r = log1pf(expf(-fabsf(z))) + sig;
        }
        __device__ float naive(float z) {
          return logf(1.0f + __expf(z));              // flagged twice
        }
        __device__ float caller(float z) {
          float r;
          loss_tile<0>(z, r);
          return r + exp(z);                          // flagged
        }
    """, rel="csrc/k.cuh", rules=["SL004"])
    assert [(f.rule, f.line) for f in fs] == [("SL004", 8), ("SL004", 8),
                                              ("SL004", 13)]


# ---------------------------------------------------------------------------
# SL101 — resource budget of every compiled instantiation
# ---------------------------------------------------------------------------

REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z9ok_kernelPf' for 'sm_90a'
ptxas info    : Function properties for _Z9ok_kernelPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 4096 bytes smem, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN2sb12spill_kernelILi3ELb1EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN2sb12spill_kernelILi3ELb1EEEvPKf
    24 bytes stack frame, 20 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 8192 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z10big_kernelPf' for 'sm_90a'
ptxas info    : Function properties for _Z10big_kernelPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, 50000 bytes smem, 384 bytes cmem[0]
"""


def test_sl101_parses_the_report_per_mangled_name():
    usage = tc.parse_ptxas(REPORT)
    assert sorted(usage) == ["_Z10big_kernelPf", "_Z9ok_kernelPf",
                             "_ZN2sb12spill_kernelILi3ELb1EEEvPKf"]
    u = usage["_ZN2sb12spill_kernelILi3ELb1EEEvPKf"]
    assert (u.registers, u.smem, u.spill_stores, u.spill_loads) == \
        (64, 8192, 20, 16)
    assert tc.kernel_basename(u.name) == "spill_kernel"
    assert tc.kernel_basename("_Z9ok_kernelPf") == "ok_kernel"


def test_sl101_flags_spills_static_smem_and_missing_kernels():
    anchors = {"spill_kernel": ("src/repro_torch/csrc/k.cu", 12)}
    kernels = ["_Z9ok_kernelPf", "_Z10big_kernelPf",
               "_ZN2sb12spill_kernelILi3ELb1EEEvPKf", "_Z6lost_kv"]
    fs = tc.check_budget(REPORT, kernels, anchors)
    msgs = sorted(f.message.split(":")[0] + " " + f.message.split()[1]
                  for f in fs)
    assert msgs == ["_Z10big_kernelPf 50000", "_Z6lost_kv the",
                    "_ZN2sb12spill_kernelILi3ELb1EEEvPKf 20"]
    spill = next(f for f in fs if "spill stores" in f.message)
    assert (spill.rule, spill.path, spill.line) == \
        ("SL101", "src/repro_torch/csrc/k.cu", 12)
    assert "16 bytes spill loads at 64 registers" in spill.message
    # the clean kernel alone: nothing
    ok = REPORT.split("ptxas info    : Compiling entry function "
                      "'_ZN2sb12spill")[0]
    assert tc.check_budget(ok, ["_Z9ok_kernelPf"]) == []


def test_sl101_flags_dynamic_shared_memory_it_cannot_budget(tmp_path):
    csrc = tmp_path / "src" / "repro_torch" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "a.cu").write_text("__global__ void a(float* p) {\n"
                               "  __shared__ float s[32];\n}\n")
    assert tc._dynamic_smem_findings(tmp_path) == []
    (csrc / "b.cu").write_text("__global__ void b(float* p) {\n"
                               "  extern __shared__ float s[];\n}\n")
    fs = tc._dynamic_smem_findings(tmp_path)
    assert [(f.rule, f.path, f.line) for f in fs] == [
        ("SL101", "src/repro_torch/csrc/b.cu", 2)]
    assert "232,448" in fs[0].message


def test_sl101_anchors_each_kernel_at_its_definition():
    csrc = REPO / "src" / "repro_torch" / "csrc"
    anchors = tc._kernel_anchors(csrc, REPO)
    assert sorted(anchors) == [
        "fused_rounds_kernel", "fused_sparse_kernel",
        "fused_sparse_ovf_kernel", "gather_chunk_kernel",
        "scatter_rows_kernel", "scatter_task_kernel",
        "sparse_gather_split_kernel"]
    for name, (path, line) in anchors.items():
        assert name in (REPO / path).read_text().splitlines()[line - 1]


def test_sl101_without_nvcc_is_a_missing_tool_not_a_pass(monkeypatch):
    from repro_torch.kernels import compare_sass

    def missing(name):
        raise RuntimeError(f"{name} not found on PATH or in "
                           "/usr/local/cuda/bin")
    monkeypatch.setattr(compare_sass, "_tool", missing)
    with pytest.raises(tc.MissingTool, match="nvcc"):
        tc.check_resources(REPO)


# ---------------------------------------------------------------------------
# SL102 — repeat-call leak
# ---------------------------------------------------------------------------

def _toy(sync: bool):
    from repro_torch.core.shotgun import ROUNDS_RANGE

    def solve():
        x = torch.zeros(8)
        fs = []
        with torch.profiler.record_function(ROUNDS_RANGE):
            for r in range(4):
                x = x + 1.0
                fs.append(x.sum().item() if sync else x.sum())
        return x, torch.tensor(fs) if sync else torch.stack(fs)
    return solve


def test_sl102_catches_a_sync_inside_the_rounds():
    fs = tc.check_repeat(REPO, targets=[("leaky", _toy(True)),
                                        ("clean", _toy(False))])
    assert len(fs) == 1 and fs[0].rule == "SL102"
    assert "'leaky'" in fs[0].message and "aten::item" in fs[0].message


def test_sl102_catches_cache_growth_and_a_differing_repeat(monkeypatch):
    from repro_torch.kernels import shotgun_block as sb
    monkeypatch.setattr(sb, "_WORK", {})
    calls = []

    def grows():
        sb._WORK[len(sb._WORK)] = None
        return torch.zeros(2)

    def drifts():
        calls.append(1)
        return torch.full((2,), float(len(calls)))
    fs = tc.check_repeat(REPO, targets=[("grows", grows),
                                        ("drifts", drifts)])
    msgs = [f.message for f in fs]
    assert len(msgs) == 2
    assert "shotgun_block._WORK changed" in msgs[0]
    assert "output differs" in msgs[1]


def test_sl102_registry_and_baselines_are_clean_on_the_cpu():
    targets = tc.repeat_targets("cpu")
    from repro_torch.core.shotgun import SOLVER_NAMES
    assert {t[0] for t in targets} >= set(SOLVER_NAMES) - {"sharded"}
    assert len(targets) == len(SOLVER_NAMES) - 1 + 9
    assert tc.check_repeat(REPO, targets=targets) == []


# ---------------------------------------------------------------------------
# SL103 — process-group consistency
# ---------------------------------------------------------------------------

def test_sl103_flags_collectives_without_a_group(tmp_path):
    (tmp_path / "core").mkdir()
    (tmp_path / "core" / "sharded.py").write_text(textwrap.dedent("""
        import torch.distributed as dist
        from repro_torch.dist import collectives as C

        def merge(z, dz, fg):
            dist.all_reduce(dz)                       # flagged
            dist.barrier()                            # flagged
            z = z + C.all_reduce(dz)                  # flagged
            z = z + C.all_reduce(dz, None)            # flagged
            dist.all_reduce(dz, group=fg.group)
            dist.barrier(fg.group)
            return z + C.all_gather(dz, fg.group)
    """))
    fs = tc.sweep_groups(tmp_path)
    assert [(f.rule, f.line) for f in fs] == [("SL103", 6), ("SL103", 7),
                                              ("SL103", 8), ("SL103", 9)]
    assert "dist.all_reduce()" in fs[0].message
    assert tc.sweep_groups(REPO) == []


def test_sl103_fixture_probes_and_the_live_probe():
    def wrong_group():
        raise RuntimeError("collective on the default group timed out")
    fs = tc.check_groups(REPO, probes=[("bad", wrong_group),
                                       ("good", lambda: None)])
    assert len(fs) == 1 and fs[0].rule == "SL103"
    assert fs[0].path == "src/repro_torch/core/sharded.py"
    assert "bad: RuntimeError" in fs[0].message
    # two gloo ranks: flat, hierarchical, and rank 0 alone in a subgroup
    assert tc.live_probes("cpu") == []


# ---------------------------------------------------------------------------
# the whole port tree and the CLI
# ---------------------------------------------------------------------------

def test_whole_port_tree_clean_under_the_source_rules():
    report = run_checkers(REPO, rules=SRC_RULES)
    assert report.ok, tfind.render_report(report.findings)
    assert report.unused_allows == []
    assert report.suppressed             # the allowlist's entries are used


def test_cli_ast_exits_zero_on_this_tree():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analyze", "--ast"],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout and "0 stale" in proc.stdout


def test_cli_exits_one_on_a_seeded_tree(tmp_path, capsys):
    (tmp_path / "kernels").mkdir()
    (tmp_path / "kernels" / "bad.py").write_text(textwrap.dedent("""
        import torch
        ITERS_RANGE = "iters"

        def solve(A, x, block):
            assert A.shape[1] % block == 0
            with torch.profiler.record_function(ITERS_RANGE):
                f = (A @ x).sum().item()
            return torch.exp(f)
    """))
    rc = cli.main(["--ast", "--root", str(tmp_path), "--allowlist", "none"])
    out = capsys.readouterr().out
    assert rc == 1, out
    for rule in ("SL001", "SL002", "SL003", "SL004"):
        assert rule in out, (rule, out)


def test_cli_exits_two_without_nvcc_and_on_bad_usage(monkeypatch, capsys):
    from repro_torch.kernels import compare_sass

    def missing(name):
        raise RuntimeError(f"{name} not found on PATH")
    monkeypatch.setattr(compare_sass, "_tool", missing)
    for argv in (["--rules", "SL101"], ["--all"]):
        assert cli.main(argv) == 2
        assert "nvcc" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        cli.main(["--rules", "SL999"])
    assert e.value.code == 2


@pytest.mark.parametrize("rules", ["SL101", "SL102", "SL103"])
def test_cli_refuses_run_rules_on_another_tree(tmp_path, capsys, rules):
    """The run rules probe the imported package, so another root is bad
    usage (exit 2), not a report that mixes two trees."""
    (tmp_path / "src" / "repro_torch").mkdir(parents=True)
    with pytest.raises(SystemExit) as e:
        cli.main(["--rules", rules, "--root", str(tmp_path)])
    assert e.value.code == 2
    assert "imported package" in capsys.readouterr().err
