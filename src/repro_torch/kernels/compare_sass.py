"""Compare the machine code (SASS) of the kernels in two copies of ``csrc/``.

    PYTHONPATH=src python -m repro_torch.kernels.compare_sass OLD_CSRC [NEW_CSRC]

Compiles each source of ``_build.SOURCES`` in both directories to a cubin
with the build's own flags (one ``nvcc`` per file, all started together),
disassembles the cubins with ``cuobjdump -sass`` and compares every kernel
of NEW with its counterpart in OLD, instruction by instruction.  NEW_CSRC
defaults to this package's ``csrc/``.  A kernel whose template gained
trailing ``bool`` parameters is compared, for the instantiation with them
all false, with the OLD kernel that lacks them: a template flag added to a
kernel (``EMIT_DZ``, ``BATCHED``) is shown to leave the instantiations that
existed before it unchanged.  Needs ``nvcc`` and ``cuobjdump``; prints one
line per kernel and exits 1 when a compared kernel differs.
"""
from __future__ import annotations

import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

from repro_torch.kernels import _build

_FUNC = re.compile(r"\s+Function : (\S+)")
_INSN = re.compile(r"\s+/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
_FALSE_TAIL = "Lb0EEv"          # a trailing `false` bool template argument


def parse_sass(text: str) -> dict[str, list[str]]:
    """Kernel name (mangled) -> its instructions, from cuobjdump -sass."""
    out: dict[str, list[str]] = {}
    cur = None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _INSN.match(line)
        if m and cur is not None:
            cur.append(" ".join(m.group(1).split()))
    return out


def counterpart(name: str, old: dict) -> str | None:
    """The OLD kernel that ``name`` extends: itself, or ``name`` with its
    trailing false bool template arguments dropped one at a time."""
    while name not in old:
        i = name.rfind(_FALSE_TAIL)
        if i < 0 or not name.startswith("_Z"):
            return None
        name = name[:i] + "Ev" + name[i + len(_FALSE_TAIL):]
    return name


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin") / name
    if default.exists():
        return str(default)
    raise RuntimeError(f"{name} not found on PATH or in /usr/local/cuda/bin")


def disassemble(csrc: pathlib.Path, work: pathlib.Path) -> dict:
    """Every kernel of every source in ``csrc``: name -> instructions."""
    nvcc, cuobjdump = _tool("nvcc"), _tool("cuobjdump")
    cubins = [work / f"{pathlib.Path(s).stem}.cubin" for s in _build.SOURCES]
    results = _build._run_all(
        [[nvcc, *_build.NVCC_FLAGS, "-cubin", "-o", str(o), str(csrc / s)]
         for s, o in zip(_build.SOURCES, cubins)])
    for cmd, rc, out in results:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
    kernels: dict[str, list[str]] = {}
    for cubin in cubins:
        sass = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True,
                              capture_output=True, text=True).stdout
        kernels.update(parse_sass(sass))
    return kernels


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (1, 2):
        print(__doc__.splitlines()[2].strip(), file=sys.stderr)
        return 2
    old_dir = pathlib.Path(argv[0])
    new_dir = pathlib.Path(argv[1]) if len(argv) == 2 else _build.CSRC
    with tempfile.TemporaryDirectory() as tmp:
        (pathlib.Path(tmp) / "old").mkdir()
        (pathlib.Path(tmp) / "new").mkdir()
        old = disassemble(old_dir, pathlib.Path(tmp) / "old")
        new = disassemble(new_dir, pathlib.Path(tmp) / "new")
    same = differ = 0
    for name in sorted(new):
        was = counterpart(name, old)
        if was is None:
            print(f"new   {len(new[name]):6d} {name}")
        elif old[was] == new[name]:
            same += 1
            print(f"same  {len(new[name]):6d} {name}")
        else:
            differ += 1
            print(f"DIFF  {len(old[was]):6d} -> {len(new[name])} {name}")
    print(f"compare_sass: {same} kernels identical, {differ} differ")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
