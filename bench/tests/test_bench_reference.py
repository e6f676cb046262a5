"""The yardstick on the CPU: byte counts and the reference against sizes
and values worked out by hand, the service's schedule, the streams."""
from __future__ import annotations

import math

import pytest
import torch

from bench.data import generators, streams
from bench.reference import bytes as nbytes
from bench.reference import serve as ref_serve
from bench.reference import shotgun as ref
from bench.tests.tiny import one_thread  # noqa: F401


def test_dense_block_bytes_by_hand():
    # n = 10 rows, d = 300 columns: blocks of 128, 128 and 44 columns
    got = nbytes.block_bytes_dense(10, 300, 4)
    assert got.tolist() == [10 * 128 * 4, 10 * 128 * 4, 10 * 44 * 4]


def test_sparse_block_bytes_count_nonzeros_not_padding():
    got = nbytes.block_bytes_sparse(torch.tensor([3, 0, 5]), 4)
    assert got.tolist() == [24, 0, 40]
    assert nbytes.block_bytes_sparse(torch.tensor([3]), 2).tolist() == [18]


def test_rounds_bytes_count_each_pair_once_a_round():
    tables = [torch.tensor([10, 20, 30]), torch.tensor([1, 2, 4])]
    # round 0: design 0 blocks 1, 1 (drawn twice), 2; design 1 block 1
    # round 1: design 0 block 0; design 1 blocks 2, 2, 0
    draws = torch.tensor([[[0, 1], [0, 1], [0, 2], [1, 1]],
                          [[0, 0], [1, 2], [1, 2], [1, 0]]])
    assert nbytes.rounds_bytes(draws, tables) == (20 + 30 + 2) + (10 + 4 + 1)


def test_solve_bytes_and_roofline_by_hand():
    assert nbytes.solve_bytes(5, 7) == 4 * 5 + 8 * 5 + 4 * 7
    assert nbytes.roofline_percent(3.35e12, 2.0) == pytest.approx(50.0)
    assert nbytes.roofline_percent(1.0, 0.0) is None


def _two_columns(sparse: bool):
    """Columns e₀ and e₁ of R² (already unit norm), 126 zero columns."""
    A = torch.zeros(2, 128)
    A[0, 0] = A[1, 1] = 1.0
    if not sparse:
        return A
    rows = torch.zeros(1, 1, 128, dtype=torch.int32)
    vals = torch.zeros(1, 1, 128)
    rows[0, 0, 1] = 1
    vals[0, 0, :2] = 1.0
    return generators.SparseRaw(rows, vals, torch.tensor([2]), 2, 128)


@pytest.mark.parametrize("sparse", [False, True])
def test_lasso_rounds_by_hand(sparse):
    # y = (3, 0.5), λ = 1: x₀ = S(3, 1) = 2, x₁ = S(0.5, 1) = 0, then a
    # fixed point; F = ½((2 − 3)² + 0.5²) + 2 = 2.625
    D = ref.Design(_two_columns(sparse), torch.tensor([3.0, 0.5]), "lasso")
    idx = torch.zeros(2, 1, dtype=torch.int32)
    out = ref.solve(D, 1.0, idx, R=1, newton=False, guard=None)
    assert out.x[:2].tolist() == [2.0, 0.0]
    assert out.z.tolist() == [2.0, 0.0]
    assert out.trace.tolist() == [2.625, 2.625]
    assert out.status == ref.STATUS_OK
    assert D.lambda_max() == 3.0


@pytest.mark.parametrize("newton", [False, True])
def test_logistic_round_by_hand(newton):
    # y = (1, −1), z = 0: r = −y·σ(0) = (−½, ½); β = ¼ (and the Newton
    # curvature σ(0)(1 − σ(0)) = ¼ too): x = S((2, −2), λ/¼ = 1) = (1, −1);
    # F = 2·log(1 + e⁻¹) + λ·2
    D = ref.Design(_two_columns(False), torch.tensor([1.0, -1.0]),
                   "logistic")
    x, z, f = ref.rounds(D, torch.zeros(128, dtype=torch.float64),
                         torch.zeros(2, dtype=torch.float64),
                         torch.zeros(1, 1, dtype=torch.int32), 0.25,
                         newton=newton, k_eff=1)
    assert x[:2].tolist() == [1.0, -1.0]
    assert float(f[0]) == pytest.approx(2 * math.log1p(math.exp(-1)) + 0.5,
                                        rel=1e-12)


def test_duplicate_draws_add_their_updates():
    D = ref.Design(_two_columns(False), torch.tensor([3.0, 0.5]), "lasso")
    x, _, _ = ref.rounds(D, torch.zeros(128, dtype=torch.float64),
                         torch.zeros(2, dtype=torch.float64),
                         torch.zeros(1, 2, dtype=torch.int32), 1.0,
                         newton=False, k_eff=2)
    assert x[0].item() == 4.0       # both draws of block 0 step by 2


def test_guard_rolls_back_and_halves():
    # a threshold of ~0 trips every launch: x stays 0, every round reports
    # F(0), the status is "recovered"
    D = ref.Design(_two_columns(False), torch.tensor([3.0, 0.5]), "lasso")
    idx = torch.zeros(4, 2, dtype=torch.int32)
    out = ref.solve(D, 1.0, idx, R=2, newton=False,
                    guard={"factor": 1e-9, "p_min": 1})
    f0 = 0.5 * (9 + 0.25)
    assert out.trace.tolist() == [f0] * 4
    assert float(out.x.abs().sum()) == 0.0
    assert out.status == ref.STATUS_RECOVERED


def test_gaps():
    want = torch.tensor([2.0, -4.0], dtype=torch.float64)
    assert ref.rel_gap(torch.tensor([2.0, -3.0]), want) == 0.25
    assert ref.trace_gap(torch.tensor([1.0, -4.0]), want) == 0.5
    assert ref.rel_gap(torch.tensor([math.nan, 0.0]), want) == math.inf


def test_schedule_by_hand():
    # steps 2, 1, 3, 1 on two slots: q0, q1 at step 0; q2 takes q1's slot
    # at step 1; q3 takes q0's at step 2
    admit, slot, final = ref_serve.schedule([2, 1, 3, 1], 2)
    assert admit == [0, 0, 1, 2]
    assert slot == [0, 1, 1, 0]
    assert final == [1, 0, 3, 2]


def test_streams_repeat_with_the_seed_and_differ_across_it():
    kw = dict(designs=4, grid=8, copies=2)
    a = streams.job(2**31 + 9, 4, **kw)
    assert a == streams.job(2**31 + 9, 4, **kw)
    assert a != streams.job(2**31 + 10, 4, **kw)
    assert sorted(a) == sorted(streams.job(2**31 + 10, 4, **kw))
    assert sorted(a) == sorted([streams.Request(p, j) for p in range(4)
                                for j in range(8)] * 2)
    assert streams.subseed(-5, 1) != streams.subseed(5, 1)
    idx = streams.draws(11, 6, 4, 9, "cpu")
    assert idx.shape == (6, 4) and idx.dtype == torch.int32
    assert all(len(set(r.tolist())) == 4 for r in idx)
    assert torch.equal(idx, streams.draws(11, 6, 4, 9, "cpu"))
    grid = streams.lam_grid(0.5, 0.05, 8)
    assert grid[0] == 0.5 and grid[-1] == pytest.approx(0.05)


def test_generators_keep_shapes_and_repeat():
    a = generators.large_sparse(3, n=500, d=1000, density=0.05, tile=16,
                                device="cpu")
    b = generators.large_sparse(3, n=500, d=1000, density=0.05, tile=16,
                                device="cpu")
    assert a.A.rows.shape == (8, 16, 128)
    assert torch.equal(a.A.vals, b.A.vals) and torch.equal(a.y, b.y)
    live = a.A.vals != 0
    assert int(live.sum()) == int(a.A.nnz_blk.sum())
    assert bool((a.A.vals[7, :, 1000 - 7 * 128:] == 0).all())  # padding
    cols = (torch.arange(8).reshape(8, 1, 1) * 128
            + torch.arange(128).reshape(1, 1, 128)).expand(8, 16, 128)
    dense = torch.zeros(500, 1024).index_put_(
        (a.A.rows.reshape(-1).long(), cols.reshape(-1)),
        a.A.vals.reshape(-1), accumulate=True)
    assert torch.allclose(generators.sparse_matvec(a.A, a.x_true),
                          dense[:, :1000] @ a.x_true, atol=1e-5)
