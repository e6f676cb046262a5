"""The port's CUDA kernels on the card against their plain versions on the
same inputs, bit-identical repeat runs, and the launch counters.  Marked
``gpu``; each test skips (inside the ``cuda`` fixture, so every worker
collects the same tests) when ``torch.cuda.is_available()`` is false.

Run on a machine with the card:
    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: the kernels sum in another order than the plain versions
(tile partials, shuffle trees); after R = 8 rounds x, z and F agree to
rtol/atol 1e-4 (bf16 A: 1e-3, as against the JAX kernel)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import objectives as tobj  # noqa: E402
from repro_torch.core.spec import SolverSpec  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import shotgun_block as tsb  # noqa: E402

pytestmark = pytest.mark.gpu
BLOCK = 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _padded(loss, dev, n=1000, d=700, seed=0):
    name = "lasso" if loss == "lasso" else "logistic"
    A, y, _ = (tsyn.sparco(seed=seed, n=n, d=d) if name == "lasso"
               else tsyn.logistic_data(seed=seed, n=n, d=d))
    prob = tobj.make_problem(A, y, 0.3 if name == "lasso" else 0.5,
                             loss=name, device=dev)
    Ap, yp, mask = tops.pad_problem(prob.A, prob.y)
    return prob, Ap, yp, mask


def _inputs(Ap, R=8, K=3, seed=1):
    g = torch.Generator(device=Ap.device).manual_seed(seed)
    nblk = Ap.shape[1] // BLOCK
    x = torch.randn(Ap.shape[1], generator=g, device=Ap.device) * 0.05
    idx = torch.randint(0, nblk, (R, K), generator=g, device=Ap.device,
                        dtype=torch.int32)
    idx[R // 2, -1] = idx[R // 2, 0]                   # duplicate draw
    return x, Ap @ x, idx


@pytest.mark.parametrize("store", ["f32", "bf16"])
def test_gather_and_scatter_match_plain(cuda, store):
    _, Ap, _, _ = _padded("lasso", cuda)
    A = Ap.to(torch.bfloat16) if store == "bf16" else Ap
    g = torch.Generator(device=cuda).manual_seed(2)
    r = torch.randn(A.shape[0], generator=g, device=cuda)
    idx = torch.tensor([2, 0, 2, 5], dtype=torch.int32, device=cuda)
    delta = torch.randn(4, BLOCK, generator=g, device=cuda) * 0.1
    tol = 1e-3 if store == "bf16" else 1e-4
    got = tsb.gather_block_matvec(A, r, idx)
    torch.testing.assert_close(got, tsb.gather_block_matvec_plain(A, r, idx),
                               rtol=tol, atol=tol)
    zk = tsb.scatter_block_update(A, r, idx, delta)
    torch.testing.assert_close(
        zk, tsb.scatter_block_update_plain(A, r, idx, delta),
        rtol=tol, atol=tol)
    assert torch.equal(got, tsb.gather_block_matvec(A, r, idx))
    assert torch.equal(zk, tsb.scatter_block_update(A, r, idx, delta))


@pytest.mark.parametrize("store", ["f32", "bf16"])
@pytest.mark.parametrize("loss", ["lasso", "logistic", "logistic_newton"])
def test_fused_matches_plain_and_repeats_bitwise(cuda, loss, store):
    prob, Ap, yp, mask = _padded(loss, cuda)
    A = Ap.to(torch.bfloat16) if store == "bf16" else Ap
    x, z, idx = _inputs(A.float())
    tol = 1e-3 if store == "bf16" else 1e-4
    for k_eff in (None, 2):
        args = (A, z, x, idx, prob.lam, prob.beta, yp, mask)
        got = tsb.fused_shotgun_rounds(*args, loss=loss, k_eff=k_eff)
        want = tsb.fused_shotgun_rounds_plain(*args, loss=loss, k_eff=k_eff)
        for u, v in zip(got[:3], want[:3]):
            torch.testing.assert_close(u, v, rtol=tol, atol=tol)
        assert torch.all((got[3] - want[3]).abs() <= 1)
        assert float(got[4]) == float(want[4]) == 0.0
        again = tsb.fused_shotgun_rounds(*args, loss=loss, k_eff=k_eff)
        for u, v in zip(got, again):
            assert torch.equal(u, v)


def test_fused_invariants_on_card(cuda):
    prob, Ap, yp, mask = _padded("logistic", cuda)
    x, z, idx = _inputs(Ap)
    args = (Ap, z, x, idx, prob.lam, prob.beta, yp, mask)
    full = tsb.fused_shotgun_rounds(*args, loss="logistic")
    same = tsb.fused_shotgun_rounds(*args, loss="logistic",
                                    k_eff=torch.tensor(3, device=cuda))
    for u, v in zip(full, same):
        assert torch.equal(u, v)
    xo, zo, _, _, h = tsb.fused_shotgun_rounds(*args, loss="logistic",
                                               k_eff=0)
    assert torch.equal(xo, x) and torch.equal(zo, z) and float(h) == 0.0
    *_, h = tsb.fused_shotgun_rounds(
        *args, loss="logistic", guard_f=full[2].min() * 0.5)
    assert float(h) == 1.0


@pytest.mark.parametrize("fused", [True, False])
def test_solve_on_card_matches_cpu_and_counts_launches(cuda, fused):
    A, y, _ = tsyn.sparco(seed=3, n=900, d=1000)
    spec = SolverSpec(loss="lasso", P=256, rounds=16, fused=fused)
    idx = np.random.default_rng(0).integers(0, 8, (16, 2)).astype(np.int32)
    idx[:, 1] = (idx[:, 0] + 1 + idx[:, 1] % 7) % 8     # distinct per round
    res = {}
    for dev in ("cpu", cuda):
        prob = tobj.make_problem(A, y, 5.0, device=dev)
        tsb.reset_launches()
        res[str(dev)] = tops.block_shotgun_solve(prob, spec=spec,
                                                 blk_idx=idx)
        counts = dict(tsb.LAUNCHES)
    assert counts == ({"fused_shotgun_rounds": 2, "gather_block_matvec": 0,
                       "scatter_block_update": 0} if fused else
                      {"fused_shotgun_rounds": 0, "gather_block_matvec": 16,
                       "scatter_block_update": 16})
    cpu, gpu = res["cpu"], res["cuda"]
    torch.testing.assert_close(gpu.trace.objective.cpu(),
                               cpu.trace.objective, rtol=1e-4, atol=0)
    torch.testing.assert_close(gpu.x.cpu(), cpu.x, rtol=1e-4, atol=1e-4)
    assert int(gpu.status) == 0
