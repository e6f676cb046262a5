"""The port's fault-injection smoke (``python -m repro_torch.dist.faults``,
port of ``repro.dist.faults._smoke``) on two gloo ranks on the CPU, and its
F* against the JAX package's FISTA on the same problem.

The smoke solves the reference's problem (``sparco(seed=0, n=128,
d=512)``, λ = 1) under its fault plan and guard for its 800 rounds, with
the reference's P = 64 coordinates a round over all ranks; F must be
finite and within 0.5% of F*, equal its fault-free twin's F to rtol 1e-4,
and the same plan with no retries must trip the guard.  F* (2000 FISTA iterations) agrees with the reference's to
rtol 1e-4: both run f32 FISTA to the same optimum from power iterations
that start from different vectors."""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import objectives as jobj  # noqa: E402
from repro.core.baselines.fista import fista_solve  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.core import objectives as tobj  # noqa: E402
from repro_torch.core.baselines import f_star  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.dist import faults  # noqa: E402


def test_smoke_on_two_gloo_ranks_reaches_half_a_percent(capsys):
    assert faults.main(["--device", "cpu", "--ranks", "2"]) == 0
    out = capsys.readouterr().out
    m = re.search(r"ranks=2 F\*=(\S+) F=(\S+) gap=(\S+)% status=(\w+)", out)
    assert m, out
    fstar, f, gap = (float(v) for v in m.groups()[:3])
    assert np.isfinite(f) and gap <= 0.5 and m.group(4) in ("ok",
                                                           "recovered")
    m2 = re.search(r"fault-free F=(\S+); no retries: status=(\w+)", out)
    assert m2, out
    assert abs(f - float(m2.group(1))) <= 1e-4 * abs(float(m2.group(1)))
    assert m2.group(2) != "ok"
    assert "fault-injection smoke PASS" in out


def test_smoke_f_star_matches_the_reference():
    A, y, _ = tsyn.sparco(seed=0, n=128, d=512)
    mine = f_star(tobj.make_problem(A, y, lam=1.0, device="cpu"), iters=2000)
    jA, jy, _ = jsyn.sparco(seed=0, n=128, d=512)
    ref = float(fista_solve(jobj.make_problem(jA, jy, lam=1.0),
                            iters=2000).objective[-1])
    np.testing.assert_allclose(mine, ref, rtol=1e-4)


def test_smoke_cli_rejects_several_ranks_on_the_card():
    with pytest.raises(SystemExit) as e:
        faults.main(["--device", "cuda", "--ranks", "2"])
    assert e.value.code == 2
