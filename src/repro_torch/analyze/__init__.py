"""The port's lint: static and run-time checks of the port's own
invariants (port of ``repro.analyze``, the JAX package's shotgun-lint).

Every rule keeps the id of the reference rule whose job it does in torch:

  source (no execution)
    SL001  host sync inside a round    (reference: trace purity in jit,
           scan and kernel bodies)     ``.item()``, ``.cpu()``, ``print``,
           host RNG ... inside ``record_function(<NAME>_RANGE)`` and
           ``obs.span(<NAME>_RANGE)`` blocks
    SL002  f32 accumulation            (reference: dtype accumulation)
           uncast matmuls in kernels/ and dist/, bf16 ``+=`` and bf16
           ``__shared__`` arrays in csrc/
    SL003  bare shape assert           (reference: the same)
    SL004  raw exp/log in kernels      (reference: the same) in csrc/ and
           kernels/*.py outside the stable logistic tile
  run (builds or imports the port)
    SL101  resource budget of every compiled instantiation  (reference:
           VMEM budget of every registered config) — spills, shared memory,
           from the build's ``-Xptxas -v`` report; needs nvcc
    SL102  repeat-call leak            (reference: retrace leak) — host
           syncs, cache entries or a library reload on a second call
    SL103  process-group consistency   (reference: mesh axis names) —
           collectives without a group; live binds to feature groups

``python -m repro_torch.analyze`` is the CLI; ``runner.run_checkers`` is
the library entry point; ``allowlist.toml`` holds vetted exceptions.
"""
from repro_torch.analyze.findings import (Finding, render_report,  # noqa: F401
                                          sort_findings)
from repro_torch.analyze.runner import (ALL_RULES, LintReport,  # noqa: F401
                                        run_checkers)
