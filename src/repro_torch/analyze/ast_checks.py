"""Source-level rules of the port's lint — stdlib ``ast`` for Python and
plain text for CUDA, never an import of the checked code, so these run
anywhere in milliseconds.  Each keeps the id and the role of its rule in
``repro.analyze.ast_checks``.

  SL001  host sync inside a round  ``.item()``, ``.tolist()``, ``.cpu()``,
                         ``.numpy()``, ``torch.cuda.synchronize``,
                         ``print``, ``time.*`` and host RNG (``np.random.*``,
                         ``random.*``: the port draws from an explicit
                         ``torch.Generator``) inside the body of a ``with
                         torch.profiler.record_function(<NAME>_RANGE)``
                         or ``with obs.span(<NAME>_RANGE)`` block — the
                         windows (``core/shotgun.py`` ``ROUNDS_RANGE``,
                         ``core/baselines/common.py`` ``ITERS_RANGE``)
                         inside which a solve must never wait on the card
                         — and in defs nested there.
                         An AST walk cannot see every host read: a
                         ``float(t)``, an index assignment from a host
                         value into a card tensor (``stop[-1] = True``) or
                         a card tensor indexed by a card index (``v[j]``)
                         each copy to or from the host without a call this
                         rule names.  Those are SL102's to catch, in the
                         profiler's records of a live solve.
  SL002  f32 accumulation  in ``kernels/`` and ``dist/``, where bf16
                         operands are a supported storage format: ``@``,
                         ``torch.matmul`` / ``mm`` / ``mv`` / ``bmm`` /
                         ``einsum`` / ``addmv`` / ``addmm`` / ``dot`` with
                         no operand cast to f32 at the use site
                         (``.float()``, ``.to(torch.float32)``); in CUDA
                         (all of ``csrc/``), ``+=`` into a variable, pointer
                         or array declared ``__nv_bfloat16`` / ``__half``,
                         and a ``__shared__`` array of either.  The paper's
                         Thm 3.2 / Lemma 3.3 error budget assumes f32
                         accumulation.  (A template type parameter that is
                         instantiated as bf16 is invisible to the text
                         rule; the kernels keep every sum in ``float``.)
  SL003  bare shape assert  ``assert`` on shape arithmetic: raise
                         ``ValueError`` carrying the offending values
                         instead (asserts vanish under ``python -O`` and
                         lose the operands).
  SL004  raw exp/log in kernels  ``expf``, ``logf``, ``__expf``,
                         ``__logf``, ``exp(``, ``log(`` in CUDA outside the
                         stable loss tile (``shotgun_block.cuh::loss_tile``),
                         and ``torch.exp`` / ``torch.log`` (or the tensor
                         methods) in ``kernels/*.py`` outside
                         ``shotgun_block.py::_stable_logistic_tile``: naked
                         exp overflows f32 at z ≈ 89 and naked log(σ)
                         underflows to -inf, so every logistic tile goes
                         through the max(m, 0) + log1p(exp(−|m|)) form.

The scan set is ``<root>/src/repro_torch/**/*.py`` and
``<root>/src/repro_torch/csrc/*.cu|*.cuh`` when the tree has that layout,
else every such file under ``root`` (fixture trees).  Vetted exceptions go
in ``allowlist.toml``.
"""
from __future__ import annotations

import ast
import pathlib
import re
from typing import Iterable

from repro_torch.analyze.findings import Finding

# Dirs (relative to the scan root) where bf16 operands are a supported
# storage format, so the operator-form matmul rules apply.
DTYPE_STRICT_DIRS = ("kernels", "dist")

# SL001: methods that copy a tensor to the host, and host-side calls.
SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
SYNC_CALLS_AST = ("torch.cuda.synchronize", "print")
HOST_CALL_PREFIXES = ("time.", "np.random.", "numpy.random.", "random.")
RANGE_SUFFIX = "_RANGE"
# Besides torch's ``record_function``, the port's spans open a profiler
# range (``repro_torch.obs.span``, called through the module or imported).
RANGE_OPENERS = ("obs.span", "span")

_MATMUL_CALLS = {f"torch.{f}" for f in ("matmul", "mm", "mv", "bmm", "einsum",
                                        "addmv", "addmm", "dot")}

# SL004: the one Python function allowed to spell torch.exp / torch.log in
# kernels/, and the one CUDA function allowed to call exp / log.
STABLE_LOGISTIC_HELPER = "_stable_logistic_tile"
STABLE_LOGISTIC_CUDA = "loss_tile"
_RAW_EXP_LOG = {"torch.exp", "torch.log"}
_CUDA_EXP_LOG = re.compile(r"\b(__expf|__logf|expf|logf|exp|log)\s*\(")

_CUDA_HALF = r"(?:__nv_bfloat16|__half)"
_CUDA_HALF_DECL = re.compile(
    r"\b" + _CUDA_HALF + r"\b\s*(?:const\s*)?(?:\*\s*(?:const\s*)?"
    r"(?:__restrict__\s*)?)?(\w+)\s*(?=[\[=;,)])")
_CUDA_HALF_SHARED = re.compile(
    r"__shared__\s+(?:\w+\s+)*" + _CUDA_HALF + r"\s+(\w+)\s*\[")


def dotted_name(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for Name/Attribute chains; '' else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _scan_base(root: pathlib.Path) -> pathlib.Path:
    base = root / "src" / "repro_torch"
    return base if base.is_dir() else root


def iter_py_files(root: pathlib.Path) -> list[pathlib.Path]:
    """Deterministic Python scan set: ``<root>/src/repro_torch`` when it
    exists (the repo layout), else every .py under root."""
    return sorted(_scan_base(root).rglob("*.py"))


def iter_cuda_files(root: pathlib.Path) -> list[pathlib.Path]:
    """Deterministic CUDA scan set: ``<root>/src/repro_torch/csrc`` when
    the tree has that layout, else every .cu / .cuh under root."""
    base = _scan_base(root)
    if base != root:
        return sorted(p for p in (base / "csrc").glob("*.cu*")
                      if p.suffix in (".cu", ".cuh"))
    return sorted(p for p in root.rglob("*.cu*")
                  if p.suffix in (".cu", ".cuh"))


def _rel(path: pathlib.Path, root: pathlib.Path) -> str:
    try:
        return path.relative_to(root).as_posix()
    except ValueError:
        return path.as_posix()


class ParsedModule:
    """One parsed Python file plus its parent map."""

    def __init__(self, path: pathlib.Path, root: pathlib.Path):
        self.path = path
        self.rel = _rel(path, root)
        self.tree = ast.parse(path.read_text(), filename=str(path))
        self.parents: dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        self.ranges = _collect_ranges(self.tree)

    def in_range(self, node: ast.AST) -> bool:
        """Whether ``node`` lies lexically inside a ``*_RANGE`` block."""
        while node is not None:
            if node in self.ranges:
                return True
            node = self.parents.get(node)
        return False

    def inside_def(self, node: ast.AST, name: str) -> bool:
        while node is not None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name == name:
                return True
            node = self.parents.get(node)
        return False


def _is_range_item(item: ast.withitem) -> bool:
    call = item.context_expr
    if not isinstance(call, ast.Call) or not call.args:
        return False
    name = dotted_name(call.func)
    if not (name.endswith("record_function") or name in RANGE_OPENERS):
        return False
    return dotted_name(call.args[0]).rsplit(".", 1)[-1].endswith(RANGE_SUFFIX)


def _collect_ranges(tree: ast.AST) -> set:
    """The statements of every ``with record_function(<NAME>_RANGE)`` or
    ``with obs.span(<NAME>_RANGE)`` body."""
    out: set = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.With, ast.AsyncWith)) and \
                any(_is_range_item(i) for i in node.items):
            out.update(node.body)
    return out


# ---------------------------------------------------------------------------
# SL001 — host sync inside a round
# ---------------------------------------------------------------------------

def check_host_sync(mod: ParsedModule) -> Iterable[Finding]:
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) or not mod.in_range(node):
            continue
        cname = dotted_name(node.func)
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in SYNC_METHODS and not node.args:
            yield Finding(mod.rel, node.lineno, "SL001", "error",
                          f".{node.func.attr}() inside a *{RANGE_SUFFIX} "
                          "window copies to the host and waits on the card "
                          "every round — keep the value on the device until "
                          "the solve returns")
        elif cname in SYNC_CALLS_AST:
            yield Finding(mod.rel, node.lineno, "SL001", "error",
                          f"{cname}() inside a *{RANGE_SUFFIX} window makes "
                          "the host wait on the card every round — hoist it "
                          "out of the rounds")
        elif any(cname.startswith(p) for p in HOST_CALL_PREFIXES):
            yield Finding(mod.rel, node.lineno, "SL001", "error",
                          f"host-side call {cname}() inside a "
                          f"*{RANGE_SUFFIX} window — draw from an explicit "
                          "torch.Generator on the device and time outside "
                          "the rounds")


# ---------------------------------------------------------------------------
# SL002 — f32 accumulation
# ---------------------------------------------------------------------------

def _unwrap_transpose(node: ast.AST) -> ast.AST:
    while True:
        if isinstance(node, ast.Attribute) and node.attr in ("T", "mT"):
            node = node.value
        elif isinstance(node, ast.Call) and isinstance(node.func,
                                                       ast.Attribute) \
                and node.func.attr == "t" and not node.args:
            node = node.func.value
        else:
            return node


def _is_f32_cast(node: ast.AST) -> bool:
    node = _unwrap_transpose(node)
    if not isinstance(node, ast.Call) or \
            not isinstance(node.func, ast.Attribute):
        return False
    if node.func.attr == "float" and not node.args:
        return True
    if node.func.attr in ("to", "type"):
        return any(dotted_name(a).endswith("float32")
                   for a in list(node.args) + [k.value for k in node.keywords])
    return False


def _in_strict_dtype_dir(rel: str) -> bool:
    parts = rel.split("/")
    return any(d in parts for d in DTYPE_STRICT_DIRS)


def check_dtype_accumulation(mod: ParsedModule) -> Iterable[Finding]:
    if not _in_strict_dtype_dir(mod.rel):
        return
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call):
            cname = dotted_name(node.func)
            if cname in _MATMUL_CALLS and \
                    not any(_is_f32_cast(a) for a in node.args):
                yield Finding(
                    mod.rel, node.lineno, "SL002", "error",
                    f"{cname}() with no operand cast to f32 — on bf16 "
                    "storage this accumulates in bf16; cast an operand "
                    "with .float() or .to(torch.float32)")
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            if not (_is_f32_cast(node.left) or _is_f32_cast(node.right)):
                yield Finding(
                    mod.rel, node.lineno, "SL002", "error",
                    "`@` matmul with no operand cast to f32 — on bf16 "
                    "storage this accumulates in bf16; cast an operand "
                    "with .float() or .to(torch.float32)")


def _strip_c_comments(text: str) -> str:
    """``text`` with // and /* */ comments and string literals blanked,
    newlines kept, so offsets keep their line numbers."""
    out = []
    i, n = 0, len(text)
    while i < n:
        two = text[i:i + 2]
        if two == "//":
            j = text.find("\n", i)
            j = n if j < 0 else j
        elif two == "/*":
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
        elif text[i] == '"':
            j = i + 1
            while j < n and text[j] != '"':
                j += 2 if text[j] == "\\" else 1
            j = min(j + 1, n)
        else:
            out.append(text[i])
            i += 1
            continue
        out.append("".join(c if c == "\n" else " " for c in text[i:j]))
        i = j
    return "".join(out)


def _line_of(text: str, pos: int) -> int:
    return text.count("\n", 0, pos) + 1


class CudaSource:
    """One CUDA source, comments blanked."""

    def __init__(self, path: pathlib.Path, root: pathlib.Path):
        self.path = path
        self.rel = _rel(path, root)
        self.text = _strip_c_comments(path.read_text())

    def _close(self, start: int, opening: str, closing: str) -> int:
        """The offset just past the ``closing`` that matches an
        ``opening`` already open before ``start``."""
        depth, i = 1, start
        while i < len(self.text) and depth:
            c = self.text[i]
            depth += (c == opening) - (c == closing)
            i += 1
        return i

    def scope_of(self, pos: int) -> tuple[int, int]:
        """(start, end) offsets of the scope of a declaration at ``pos``:
        a parameter's function body, else the rest of the enclosing brace
        block (the rest of the file at top level)."""
        head = self.text[:pos]
        if head.count("(") > head.count(")"):          # a parameter
            close = self._close(pos, "(", ")")
            body = re.match(r"[^;{]*\{", self.text[close:])
            if body is None:
                return pos, pos                         # a prototype
            start = close + body.end()
            return start, self._close(start, "{", "}")
        return pos, self._close(pos, "{", "}")

    def function_spans(self, name: str) -> list[tuple[int, int]]:
        """(start, end) offsets of the bodies of every definition of the
        function ``name``."""
        spans = []
        for m in re.finditer(r"\b" + re.escape(name) + r"\s*\(", self.text):
            i = self._close(m.end(), "(", ")")
            head = re.match(r"\s*(?:const\s*)?\{", self.text[i:])
            if head is None:
                continue                          # a call, not a definition
            start = i + head.end()
            spans.append((start, self._close(start, "{", "}")))
        return spans


def check_cuda_accumulation(src: CudaSource) -> Iterable[Finding]:
    for m in _CUDA_HALF_SHARED.finditer(src.text):
        yield Finding(src.rel, _line_of(src.text, m.start()), "SL002",
                      "error",
                      f"__shared__ half-precision array {m.group(1)} — "
                      "in-kernel accumulation must stay f32 (store bf16 in "
                      "device memory, convert to float on load)")
    seen = set()
    for d in _CUDA_HALF_DECL.finditer(src.text):
        name = d.group(1)
        a, b = src.scope_of(d.start())
        pat = re.compile(r"(?<![\w.>])" + re.escape(name)
                         + r"\s*(?:\[[^\]\n]*\]\s*)*\+=")
        for m in pat.finditer(src.text, a, b):
            if m.start() in seen:
                continue
            seen.add(m.start())
            yield Finding(src.rel, _line_of(src.text, m.start()), "SL002",
                          "error",
                          f"`+=` into half-precision {name} — sums must "
                          "accumulate in float (convert with "
                          "__bfloat162float / __half2float first)")


# ---------------------------------------------------------------------------
# SL003 — bare assert on shape arithmetic
# ---------------------------------------------------------------------------

def _is_shape_arith(test: ast.AST) -> bool:
    for node in ast.walk(test):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod):
            return True
        if isinstance(node, ast.Attribute) and node.attr in (
                "shape", "size", "ndim", "nbytes"):
            return True
        if isinstance(node, ast.Compare):
            sides = [node.left] + list(node.comparators)
            if any(isinstance(s, ast.BinOp) for s in sides):
                return True
    return False


def check_bare_assert(mod: ParsedModule) -> Iterable[Finding]:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Assert) and _is_shape_arith(node.test):
            cond = ast.unparse(node.test)
            yield Finding(
                mod.rel, node.lineno, "SL003", "error",
                f"bare assert on shape arithmetic `{cond}` — raise "
                "ValueError with the offending values instead (asserts "
                "vanish under python -O)")


# ---------------------------------------------------------------------------
# SL004 — raw exp/log in kernels
# ---------------------------------------------------------------------------

def _in_kernels_dir(rel: str) -> bool:
    return "kernels" in rel.split("/")


def check_raw_exp_log(mod: ParsedModule) -> Iterable[Finding]:
    if not _in_kernels_dir(mod.rel):
        return
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        cname = dotted_name(node.func)
        method = (isinstance(node.func, ast.Attribute) and not node.args
                  and node.func.attr in ("exp", "log")
                  and cname not in _RAW_EXP_LOG)
        if cname not in _RAW_EXP_LOG and not method:
            continue
        if mod.inside_def(node, STABLE_LOGISTIC_HELPER):
            continue
        what = cname if cname in _RAW_EXP_LOG else f".{node.func.attr}"
        yield Finding(
            mod.rel, node.lineno, "SL004", "error",
            f"raw {what}() in a kernel module — exp overflows f32 at "
            "z ≈ 89 and log(σ) underflows to -inf; route logistic math "
            f"through {STABLE_LOGISTIC_HELPER} (sigmoid + log1p margin "
            "form)")


def check_cuda_exp_log(src: CudaSource) -> Iterable[Finding]:
    blessed = src.function_spans(STABLE_LOGISTIC_CUDA)
    for m in _CUDA_EXP_LOG.finditer(src.text):
        if any(a <= m.start() < b for a, b in blessed):
            continue
        yield Finding(
            src.rel, _line_of(src.text, m.start()), "SL004", "error",
            f"raw {m.group(1)}() in a kernel source — exp overflows f32 at "
            "z ≈ 89 and log(σ) underflows to -inf; route logistic math "
            f"through {STABLE_LOGISTIC_CUDA} (max(m, 0) + "
            "log1pf(expf(−|m|)))")


AST_RULES = {
    "SL001": check_host_sync,
    "SL002": check_dtype_accumulation,
    "SL003": check_bare_assert,
    "SL004": check_raw_exp_log,
}

CUDA_RULES = {
    "SL002": check_cuda_accumulation,
    "SL004": check_cuda_exp_log,
}


def run_ast_checks(root: pathlib.Path,
                   rules: Iterable[str] | None = None) -> list[Finding]:
    root = pathlib.Path(root)
    wanted = set(rules) if rules is not None else set(AST_RULES)
    findings: list[Finding] = []
    for path in iter_py_files(root):
        mod = ParsedModule(path, root)
        for rule, check in AST_RULES.items():
            if rule in wanted:
                findings.extend(check(mod))
    for path in iter_cuda_files(root):
        src = CudaSource(path, root)
        for rule, check in CUDA_RULES.items():
            if rule in wanted:
                findings.extend(check(src))
    return findings
