"""Run-level rules of the port's lint: these build or import the checked
code and run small probes, so they catch what no source walk can.  Each
keeps the id and the role of its rule in ``repro.analyze.trace_checks``.

  SL101  resource budget   every kernel the build compiles from ``csrc/``
                            with ``_build.NVCC_FLAGS``, read from the
                            compiler's own report (``-Xptxas -v``, kept
                            beside the library by ``_build.build``): no
                            spill store or load, static shared memory at
                            most 48 KB, no ``extern __shared__`` (its
                            launch's bytes are not in the report; the
                            227 KB check of static plus dynamic bytes
                            comes with the first such kernel), and a report
                            line for every kernel of the library.  Needs
                            ``nvcc`` and ``cuobjdump``; without them it
                            raises ``MissingTool`` (never passes quietly).
  SL102  repeat-call leak   each ``SOLVER_NAMES`` entry but ``"sharded"``
                            and each baseline, called twice on the same
                            inputs at a tiny size: on the second call no
                            ``SYNC_CALLS`` record may fall inside a
                            ``*_RANGE`` profiler window, no per-device cache
                            of the kernel wrappers may gain an entry, the
                            library may not be loaded again, and the output
                            must repeat bit for bit.
  SL103  process-group consistency  every collective in the sharded
                            driver, the engines and ``dist/`` names its
                            group (one called with none runs on the default
                            group even when the solver was handed a
                            subgroup); then live probes bind
                            ``shotgun_sharded_solve`` to
                            ``make_feature_group()``, to
                            ``make_feature_group(inner=…)`` and, on the CPU,
                            to a subgroup of rank 0 alone while rank 1 joins
                            no collective (a collective on the default
                            group then times out) — two gloo ranks spawned
                            on the CPU, one NCCL rank on the card.

``SYNC_CALLS``, ``is_sync`` and ``syncs_of`` are the one list of host syncs
and the one reading of it: SL102, ``chip_smoke.py``'s legs and the card
tests count from them (SL001 finds their source spellings, ``.item()`` and
the like, by AST).

The run rules check the package that is imported: a ``root`` whose
``src/repro_torch`` is another tree is refused (``ValueError``), since
SL102's and SL103's probes would run this package all the same.

Tests seed each rule through its function's arguments: SL101 takes report
text and kernel names (``check_budget``), SL102 (label, call) targets
(``check_repeat``), SL103 (label, call) probes (``check_groups``).
"""
from __future__ import annotations

import ast
import inspect
import json
import pathlib
import re
import subprocess
import tempfile
from typing import Iterable, NamedTuple

import numpy as np
import torch

from repro_torch.analyze.findings import Finding

PKG = pathlib.Path(__file__).resolve().parents[1]     # src/repro_torch
REPO = PKG.parents[1]

# Runtime calls and operators that make the host wait on the card, or copy
# from it: none may fall inside an unguarded solve's rounds or a baseline's
# iterations.  ``is_sync`` also takes any other ``*Synchronize`` record.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "aten::item",
              "aten::_local_scalar_dense")


def is_sync(name: str) -> bool:
    """Whether a profiler record of this name makes the host wait."""
    return name.endswith("Synchronize") or name in SYNC_CALLS


class MissingTool(RuntimeError):
    """A rule needs a tool this machine lacks (``nvcc``, ``cuobjdump``)."""


def syncs_of(events, range_name: str) -> tuple[list[str], int, int]:
    """From a profiler window's events: the names of the host-sync events
    (``is_sync``) inside the ranges named ``range_name``, how many such ranges
    there were, and the device-to-host copies anywhere in the window."""
    cpu = torch.autograd.DeviceType.CPU
    ranges = [e.time_range for e in events
              if e.name == range_name and e.device_type == cpu]
    inside = [e.name for e in events
              if e.device_type == cpu and is_sync(e.name)
              and any(r.start <= e.time_range.start <= r.end
                      for r in ranges)]
    dtoh = sum(1 for e in events
               if e.device_type != cpu and "DtoH" in e.name)
    return inside, len(ranges), dtoh


def _anchor(fn) -> tuple[str, int]:
    """(repo-relative path, line) of a function's definition."""
    fn = inspect.unwrap(fn)
    path = pathlib.Path(inspect.getsourcefile(fn)).resolve()
    try:
        rel = path.relative_to(REPO).as_posix()
    except ValueError:
        rel = path.as_posix()
    return rel, inspect.getsourcelines(fn)[1]


# ---------------------------------------------------------------------------
# SL101 — resource budget of every compiled instantiation
# ---------------------------------------------------------------------------

STATIC_SMEM_MAX = 48 * 1024      # static __shared__ above this does not link

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


class KernelUsage(NamedTuple):
    name: str            # mangled
    registers: int       # -1 for a function that is not a kernel
    smem: int            # static shared memory, bytes
    stack: int
    spill_stores: int
    spill_loads: int


def parse_ptxas(text: str) -> dict[str, KernelUsage]:
    """Mangled function name -> its usage, from ``-Xptxas -v`` output
    (entry functions, and any other function with a properties line)."""
    found: dict[str, dict] = {}
    entry = props = None
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            entry = m.group(1)
            found.setdefault(entry, {"registers": 0})
            continue
        m = _PROPS.search(line)
        if m:
            props = m.group(1)
            found.setdefault(props, {"registers": -1})
            continue
        m = _SPILL.search(line)
        if m and props is not None:
            found[props].update(stack=int(m.group(1)),
                                spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
            continue
        m = _USED.search(line)
        if m and entry is not None:
            s = _SMEM.search(line)
            found[entry].update(registers=int(m.group(1)),
                                smem=int(s.group(1)) if s else 0)
    return {name: KernelUsage(name, f.get("registers", -1), f.get("smem", 0),
                              f.get("stack", 0), f.get("spill_stores", 0),
                              f.get("spill_loads", 0))
            for name, f in found.items()}


def kernel_basename(mangled: str) -> str:
    """The unqualified name inside an Itanium-mangled symbol
    ("_ZN2sb3fooILi1EEvT_" -> "foo"); the symbol itself otherwise."""
    if not mangled.startswith("_Z"):
        return mangled
    i, name = 2 + mangled.startswith("_ZN"), mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        size = int(mangled[i:j])
        name, i = mangled[j:j + size], j + size
    return name


def _kernel_anchors(csrc: pathlib.Path, root: pathlib.Path):
    """kernel basename -> (repo-relative source, line of its __global__
    definition), from the sources in ``csrc``."""
    from repro_torch.analyze.ast_checks import CudaSource, _line_of
    out: dict[str, tuple[str, int]] = {}
    for path in sorted(csrc.glob("*.cu*")):
        src = CudaSource(path, root)
        for g in re.finditer(r"__global__\s", src.text):
            head = re.match(r"[^;{]*", src.text[g.end():]).group(0)
            # the name is the first call-like word after __launch_bounds__
            bounds = re.match(r"\s*(?:\w+\s+)*?__launch_bounds__\s*"
                              r"\([^)]*\)", head)
            skip = bounds.end() if bounds else 0
            m = re.search(r"(\w+)\s*\(", head[skip:])
            if m:
                pos = g.end() + skip + m.start(1)
                out.setdefault(m.group(1), (src.rel, _line_of(src.text, pos)))
    return out


def check_budget(report: str, kernels: Iterable[str],
                 anchors=None) -> list[Finding]:
    """SL101 findings of one build: ``report`` is the compilers' output,
    ``kernels`` the mangled names of the kernels in the library, and
    ``anchors`` maps a kernel's basename to (path, line)."""
    anchors = anchors or {}
    usage = parse_ptxas(report)
    findings = []

    def where(name):
        return anchors.get(kernel_basename(name), ("src/repro_torch/csrc", 0))

    for name, u in sorted(usage.items()):
        path, line = where(name)
        if u.spill_stores or u.spill_loads:
            findings.append(Finding(
                path, line, "SL101", "error",
                f"{name}: {u.spill_stores} bytes spill stores, "
                f"{u.spill_loads} bytes spill loads at {u.registers} "
                "registers — spilled values go through local memory every "
                "use; free registers or raise the block's register budget"))
        if u.registers >= 0 and u.smem > STATIC_SMEM_MAX:
            findings.append(Finding(
                path, line, "SL101", "error",
                f"{name}: {u.smem} bytes of static shared memory > "
                f"{STATIC_SMEM_MAX} — above 48 KB only dynamic shared "
                "memory is allowed"))
    for name in sorted(set(kernels) - {n for n, u in usage.items()
                                       if u.registers >= 0}):
        path, line = where(name)
        findings.append(Finding(
            path, line, "SL101", "error",
            f"{name}: the library holds this kernel but the compiler's "
            "report has no line for it — the report does not belong to "
            "this library"))
    return findings


def _tool(name: str) -> str:
    from repro_torch.kernels import compare_sass
    try:
        return compare_sass._tool(name)
    except RuntimeError as e:
        raise MissingTool(f"SL101 needs {name}: {e}") from None


def library_kernels(lib: pathlib.Path) -> set[str]:
    """The mangled names of the kernels in a built library."""
    from repro_torch.kernels import compare_sass
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)],
                          check=True, capture_output=True, text=True).stdout
    return set(compare_sass.parse_sass(sass))


def library_report(root: pathlib.Path):
    """(report, kernel names, anchors) of this package's library, built
    from ``csrc/`` or cached with its report."""
    from repro_torch.kernels import _build
    _tool("nvcc")
    anchors = _kernel_anchors(_build.CSRC, pathlib.Path(root))
    lib = _build.build()
    return _build.build_info["ptxas"], library_kernels(lib), anchors


def _dynamic_smem_findings(root: pathlib.Path) -> list[Finding]:
    """Every ``extern __shared__`` in the sources: the bytes its launch
    requests are not in the compiler's report, so the 227 KB budget of
    static plus dynamic shared memory cannot be checked yet."""
    from repro_torch.analyze.ast_checks import CudaSource, _line_of
    csrc = pathlib.Path(root) / "src" / "repro_torch" / "csrc"
    findings = []
    for path in sorted(csrc.glob("*.cu*")):
        src = CudaSource(path, root)
        for m in re.finditer(r"extern\s+__shared__", src.text):
            findings.append(Finding(
                src.rel, _line_of(src.text, m.start()), "SL101", "error",
                "dynamic shared memory declared: SL101 reads only static "
                "bytes from the compiler's report; teach it the bytes this "
                "launch requests and the 227 KB (232,448 B) budget of "
                "static plus dynamic shared memory"))
    return findings


def check_resources(root: pathlib.Path) -> list[Finding]:
    report, kernels, anchors = library_report(root)
    return (check_budget(report, kernels, anchors)
            + _dynamic_smem_findings(root))


# ---------------------------------------------------------------------------
# SL102 — repeat-call leak
# ---------------------------------------------------------------------------

def _ranges() -> tuple[str, ...]:
    from repro_torch.core.baselines.common import ITERS_RANGE
    from repro_torch.core.shotgun import ROUNDS_RANGE
    return ROUNDS_RANGE, ITERS_RANGE


def cache_state() -> dict[str, object]:
    """The kernel wrappers' per-device caches (entry counts) and the
    identity of the loaded library: a second call on the same shapes must
    leave every value as it was."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import shotgun_block as sb
    return {"shotgun_block._SLOTS": len(sb._SLOTS),
            "shotgun_block._WORK": len(sb._WORK),
            "shotgun_block._LIB": id(sb._LIB),
            "_build._lib": id(_build._lib)}


def _tensors(obj) -> list[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for k in sorted(obj) for t in _tensors(obj[k])]
    if isinstance(obj, (tuple, list)):
        return [t for v in obj for t in _tensors(v)]
    return []


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def probe_repeat(call) -> list[str]:
    """Call ``call`` twice; what leaked on the second call (empty when
    nothing did)."""
    from torch.profiler import ProfilerActivity, profile
    first = call()
    _sync()
    before = cache_state()
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        second = call()
        _sync()
    events = prof.events()
    leaks = []
    for name in _ranges():
        inside = syncs_of(events, name)[0]
        if inside:
            leaks.append(f"host syncs inside {name} on the second call: "
                         f"{sorted(set(inside))} ({len(inside)})")
    after = cache_state()
    for key in sorted(after):
        if after[key] != before[key]:
            leaks.append(f"{key} changed on the second call "
                         f"({before[key]} -> {after[key]})")
    a, b = _tensors(first), _tensors(second)
    if len(a) != len(b) or not all(
            x.shape == y.shape and torch.equal(x, y) for x, y in zip(a, b)):
        leaks.append("the second call's output differs from the first's")
    return leaks


def repeat_targets(device: str | torch.device) -> list[tuple]:
    """(label, zero-arg call) for each ``SOLVER_NAMES`` entry but
    ``"sharded"`` (its process group is SL103's) and each baseline, on a
    tiny problem (n = 64, d = 256, at most 8 rounds or iterations), each
    call drawing from a fresh generator of the same seed."""
    from repro_torch.core import baselines as bl
    from repro_torch.core import objectives as obj
    from repro_torch.core.shotgun import SOLVER_NAMES, get_solver
    from repro_torch.core.spec import SolverSpec
    from repro_torch.data import synthetic as syn
    from repro_torch.data.sparse import BlockedCSC

    dev = torch.device(device)
    A, y, _ = syn.sparco(seed=0, n=64, d=256)
    prob = obj.make_problem(A, y, lam=0.4, device=dev)
    Al, yl, _ = syn.logistic_data(seed=0, n=64, d=256)
    lprob = obj.make_problem(Al, yl, lam=0.05, loss=obj.LOGISTIC, device=dev)
    As = np.where(np.random.default_rng(0).random(Al.shape) < 0.9, 0.0,
                  Al).astype(np.float32)
    slprob = obj.make_problem(BlockedCSC.from_dense(As, device=dev), yl,
                              lam=0.05, loss=obj.LOGISTIC, device=dev)

    def gen():
        return torch.Generator(device=dev).manual_seed(0)

    lasso = SolverSpec(P=4, rounds=8)
    block = SolverSpec(P=128, rounds=8)
    fused = SolverSpec(P=128, rounds=8, fused=True)
    logistic = SolverSpec(loss=obj.LOGISTIC, P=128, rounds=8, fused=True)
    calls = {
        "shooting": lambda s: s(prob, gen(), rounds=8),
        "shotgun": lambda s: s(prob, gen(), spec=lasso),
        "shotgun_dup": lambda s: s(obj.dup_from(prob), gen(), P=4, rounds=8),
        "shotgun_cdn": lambda s: s(lprob, gen(), P=4, rounds=4),
        "shooting_cdn": lambda s: s(lprob, gen(), rounds=4),
        "block": lambda s: s(prob, gen(), spec=block),
        "block_fused": lambda s: s(prob, gen(), spec=fused,
                                   rounds_per_launch=4),
        "shotgun_logreg_fused": lambda s: s(lprob, gen(), spec=logistic,
                                            rounds_per_launch=4),
        "sparse_logreg_fused": lambda s: s(slprob, gen(), spec=logistic,
                                           rounds_per_launch=4),
    }
    targets = []
    for name in SOLVER_NAMES:
        if name == "sharded":
            continue
        solve = get_solver(name)
        targets.append((name, solve,
                        lambda c=calls[name], s=solve: c(s)))
    for fn, call in (
            (bl.fista_solve, lambda: bl.fista_solve(prob, iters=8)),
            (bl.sparsa_solve, lambda: bl.sparsa_solve(prob, iters=8)),
            (bl.gpsr_bb_solve, lambda: bl.gpsr_bb_solve(prob, iters=8)),
            (bl.iht_solve, lambda: bl.iht_solve(prob, s=16, iters=8)),
            (bl.fpc_as_solve, lambda: bl.fpc_as_solve(
                prob, ist_iters=4, sub_iters=4, cycles=2)),
            (bl.l1_ls_solve, lambda: bl.l1_ls_solve(
                prob, outer=2, newton_per_t=1, cg_iters=8)),
            (bl.sgd_solve, lambda: bl.sgd_solve(
                prob, gen(), steps=8, record_every=4)),
            (bl.parallel_sgd_solve, lambda: bl.parallel_sgd_solve(
                prob, gen(), steps=8, K=2, record_every=4)),
            (bl.smidas_solve, lambda: bl.smidas_solve(
                lprob, gen(), steps=8, record_every=4))):
        targets.append((fn.__name__, fn, call))
    return targets


def check_repeat(root: pathlib.Path, targets=None,
                 device: str | None = None) -> list[Finding]:
    """SL102 over ``targets`` ((label, call) or (label, function, call)),
    by default ``repeat_targets`` on the card when there is one, else on
    the CPU."""
    if targets is None:
        device = device or ("cuda" if torch.cuda.is_available() else "cpu")
        targets = repeat_targets(device)
    findings = []
    for target in targets:
        label, fn, call = target if len(target) == 3 else \
            (target[0], target[1], target[1])
        path, line = _anchor(fn)
        try:
            leaks = probe_repeat(call)
        except Exception as e:                      # the probe itself broke
            leaks = [f"the probe failed to run: {type(e).__name__}: {e}"]
        findings.extend(Finding(path, line, "SL102", "error",
                                f"{label!r}: {leak}") for leak in leaks)
    return findings


# ---------------------------------------------------------------------------
# SL103 — process-group consistency
# ---------------------------------------------------------------------------

# Files whose collectives SL103 sweeps (relative to src/repro_torch).
SPEC_SWEEP_FILES = ("core/sharded.py", "core/engines.py",
                    "dist/collectives.py", "dist/faults.py")
# torch.distributed collectives -> position of their group argument.
_DIST_COLLECTIVES = {"all_reduce": 2, "all_gather": 2,
                     "all_gather_into_tensor": 2, "all_gather_single": 2,
                     "all_gather_object": 2, "reduce_scatter": 3,
                     "reduce_scatter_tensor": 3, "reduce_scatter_single": 3,
                     "broadcast": 2, "barrier": 0}
# The port's own collectives (dist/collectives.py, dist/faults.py) ->
# positions of their group arguments (None: keyword only).
_PORT_COLLECTIVES = {"all_reduce": 1, "all_gather": 1, "reduce_scatter": 1,
                     "host_hop": None, "hierarchical_psum": 1,
                     "faulty_psum": 4, "hierarchical_faulty_psum": 4}
_GROUP_KEYWORDS = ("group", "outer", "inner")
_DIST_PREFIXES = ("dist.", "torch.distributed.")
_PORT_PREFIXES = ("C.", "collectives.", "faults.")


def _collective(cname: str, rel: str):
    """(which, group position) when ``cname`` calls a collective, else
    None."""
    for p in _DIST_PREFIXES:
        if cname.startswith(p) and cname[len(p):] in _DIST_COLLECTIVES:
            return cname, _DIST_COLLECTIVES[cname[len(p):]]
    for p in _PORT_PREFIXES:
        if cname.startswith(p) and cname[len(p):] in _PORT_COLLECTIVES:
            return cname, _PORT_COLLECTIVES[cname[len(p):]]
    local = rel.endswith(("dist/collectives.py", "dist/faults.py"))
    if local and cname in _PORT_COLLECTIVES:
        return cname, _PORT_COLLECTIVES[cname]
    return None


def _is_none(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value is None


def sweep_groups(root: pathlib.Path) -> list[Finding]:
    """AST sweep: every collective call in ``SPEC_SWEEP_FILES`` passes a
    group (not the literal None), by position or by keyword."""
    from repro_torch.analyze.ast_checks import _rel, _scan_base, dotted_name
    root = pathlib.Path(root)
    base = _scan_base(root)
    findings = []
    for rel in SPEC_SWEEP_FILES:
        path = base / rel
        if not path.exists():
            continue
        rel_repo = _rel(path, root)
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            hit = _collective(dotted_name(node.func), rel_repo)
            if hit is None:
                continue
            cname, pos = hit
            given = [k.value for k in node.keywords
                     if k.arg in _GROUP_KEYWORDS]
            if pos is not None and len(node.args) > pos:
                given.append(node.args[pos])
            if any(isinstance(a, ast.Starred) for a in node.args) or \
                    any(k.arg is None for k in node.keywords):
                continue                      # *args / **kw: cannot tell
            if not given or all(_is_none(g) for g in given):
                findings.append(Finding(
                    rel_repo, node.lineno, "SL103", "error",
                    f"{cname}() is called with no process group — it runs "
                    "on the default group even when the solver was handed "
                    "a subgroup; pass the group through"))
    return findings


def _probe_problem(device):
    from repro_torch.core import objectives as obj
    from repro_torch.data import synthetic as syn
    A, y, _ = syn.sparco(seed=0, n=64, d=256)
    return obj.make_problem(A, y, lam=0.4, device=device)


def _bind(prob, label: str, group, **kw) -> str | None:
    """One sharded solve bound to ``group``; None, or what went wrong."""
    from repro_torch.core.sharded import shotgun_sharded_solve
    from repro_torch.core.spec import SolverSpec
    try:
        res = shotgun_sharded_solve(prob, spec=SolverSpec(P=2, rounds=4),
                                    engine="scalar", group=group, **kw)
        if not bool(torch.isfinite(res.trace.objective).all()):
            return f"{label}: non-finite objective"
    except Exception as e:
        return f"{label}: {type(e).__name__}: {e}"
    return None


def _feature_group_probes(prob, inner: int) -> list[str]:
    from repro_torch.core.sharded import make_feature_group
    from repro_torch.dist.faults import FaultPlan
    errs = [_bind(prob, "flat make_feature_group()", make_feature_group()),
            _bind(prob, f"hierarchical make_feature_group(inner={inner})",
                  make_feature_group(inner=inner), hierarchical=True,
                  faults=FaultPlan())]
    return [e for e in errs if e]


def _spec_probe_rank(rank: int, world: int, store: str, out: str) -> None:
    """One spawned gloo rank of the CPU live probe: the flat and the
    hierarchical feature group over both ranks, then a subgroup of rank 0
    alone, which rank 1 waits out on the store (a collective on the default
    group then times out on rank 0)."""
    import datetime

    import torch.distributed as dist

    from repro_torch.core.sharded import make_feature_group
    from repro_torch.dist.ranks import join_group
    join_group(rank, world, store, timeout_s=30.0)
    prob = _probe_problem("cpu")
    errs = _feature_group_probes(prob, inner=world)
    solo = dist.new_group([0])
    kv = dist.FileStore(store + ".probe", world)
    kv.set_timeout(datetime.timedelta(seconds=120))
    if rank == 0:
        try:
            err = _bind(prob, "subgroup of rank 0 alone",
                        make_feature_group(solo))
            errs += [err] if err else []
        finally:
            kv.set("solo_done", "1")
    else:
        kv.wait(["solo_done"])
    pathlib.Path(out, f"rank{rank}.json").write_text(json.dumps(errs))
    dist.destroy_process_group()


def live_probes(device: str | None = None) -> list[str]:
    """Bind ``shotgun_sharded_solve`` to the feature groups: two gloo ranks
    spawned on the CPU, or one NCCL rank in this process on the card."""
    from repro_torch.dist import ranks
    device = device or ("cuda" if torch.cuda.is_available() else "cpu")
    if device == "cuda":
        with ranks.one_rank("nccl", timeout_s=60.0):
            return _feature_group_probes(_probe_problem("cuda"), inner=1)
    with tempfile.TemporaryDirectory() as out:
        try:
            ranks.spawn("repro_torch.analyze.trace_checks:_spec_probe_rank",
                        2, out, timeout_s=240.0)
        except (RuntimeError, subprocess.TimeoutExpired) as e:
            return [f"two gloo ranks: {e}"]
        return [e for r in range(2) for e in json.loads(
            pathlib.Path(out, f"rank{r}.json").read_text())]


def check_groups(root: pathlib.Path, probes=None,
                 device: str | None = None) -> list[Finding]:
    """SL103: the AST sweep, then ``probes`` ((label, call) that raises on
    a wrong group), by default the live probes."""
    from repro_torch.core.sharded import shotgun_sharded_solve
    findings = sweep_groups(root)
    path, line = _anchor(shotgun_sharded_solve)
    if probes is None:
        errs = live_probes(device)
    else:
        errs = []
        for label, call in probes:
            try:
                call()
            except Exception as e:
                errs.append(f"{label}: {type(e).__name__}: {e}")
    findings.extend(Finding(path, line, "SL103", "error",
                            f"sharded solve failed to bind: {e}")
                    for e in errs)
    return findings


TRACE_RULES = {
    "SL101": check_resources,
    "SL102": check_repeat,
    "SL103": check_groups,
}


def run_trace_checks(root: pathlib.Path,
                     rules: Iterable[str] | None = None) -> list[Finding]:
    wanted = set(rules) if rules is not None else set(TRACE_RULES)
    pkg = pathlib.Path(root).resolve() / "src" / "repro_torch"
    if wanted & set(TRACE_RULES) and pkg != PKG:
        raise ValueError(
            f"the run rules (SL1xx) check the imported package {PKG}, not "
            f"{pkg}: run them from that tree, or check it with --ast")
    findings: list[Finding] = []
    for rule, check in TRACE_RULES.items():
        if rule in wanted:
            findings.extend(check(pathlib.Path(root)))
    return findings
