"""The port's solver service on the CPU: against the JAX service on the
same problems and draws, and the reference's own serving contracts inside
the port, bit for bit:

  * refill determinism — a served stream equals the same requests solved
    one at a time, and equals itself under round-deadline eviction;
  * warm starts — a repeated (problem_id, λ) spends at most half the cold
    rounds;
  * admission — a mixed-loss request raises;
  * backoff — a diverging request rolls back and halves k_eff, and ends
    with the status the JAX service gives it.

Against JAX: 192 × 384, K = 1, R = 8, max_rounds = 24 and tol = 0, so both
services run the fixed budget and no launch-boundary decision can flip at
a tolerance edge; x agrees to rtol 1e-5 with atol 1e-5·max(1, max|x|)
(tests/test_torch_batched.py says why), status and rounds_used exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import objectives as jobj  # noqa: E402
from repro.core.batched import WarmStartCache as JCache  # noqa: E402
from repro.core.batched import batch_meta_of as jmeta_of  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.kernels.batched import batched_draw_blocks  # noqa: E402
from repro.launch import solver_serve as jserve  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.batched import (SlotArrays,  # noqa: E402
                                      WarmStartCache, batch_meta_of,
                                      stack_problems)
from repro_torch.launch import solver_serve as tserve  # noqa: E402
from repro_torch.launch.solver_serve import (SolveRequest,  # noqa: E402
                                             SolverService, make_stream,
                                             solve_queue_sequential,
                                             stream_over)

KW = dict(K=1, max_rounds=24, rounds_per_launch=8)


def _port_request(jreq, max_launches, R, K, cache):
    """The port's twin of a JAX request: the same problem (converted once
    per design) and the draws JAX's service will make for it."""
    key_sched = jax.random.split(jreq.key, max_launches * R)
    nblk = -(-jreq.prob.d // 128)
    sched = np.asarray(batched_draw_blocks(key_sched[None], K, nblk))[0]
    if jreq.problem_id not in cache:
        p = jreq.prob
        cache[jreq.problem_id] = convert.problem_from_numpy(
            np.asarray(p.A), np.asarray(p.y), float(p.lam), p.loss,
            device="cpu")
    prob = cache[jreq.problem_id]._replace(
        lam=torch.tensor(float(jreq.prob.lam)))
    return SolveRequest(rid=jreq.rid, problem_id=jreq.problem_id, prob=prob,
                        blk_sched=sched)


def _close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        np.asarray(got, np.float32), want, rtol=tol,
        atol=tol * max(1.0, float(np.abs(want).max(initial=0.0))))


def test_served_stream_matches_jax_service():
    jreqs = jserve.make_stream(192, 384, requests=6, repeat_frac=0.0,
                               lam=2.0)
    designs = {}
    treqs = [_port_request(r, 3, 8, 1, designs) for r in jreqs]
    jdone = {r.rid: r for r in jserve.SolverService(
        jmeta_of(jreqs[0].prob), slots=3, tol=0.0, cache=JCache(),
        interpret=True, **KW).serve(jreqs)}
    tsvc = SolverService(batch_meta_of(treqs[0].prob), slots=3, tol=0.0,
                         cache=WarmStartCache(), device="cpu", **KW)
    tdone = {r.rid: r for r in tsvc.serve(treqs)}
    assert sorted(tdone) == sorted(jdone) == list(range(6))
    for rid, j in jdone.items():
        t = tdone[rid]
        assert (t.status, t.rounds_used, t.warm) == (j.status,
                                                     j.rounds_used, j.warm)
        _close(t.x.numpy(), j.x)
        _close(t.f_final, j.f_final)
    assert tsvc.launch_count == 6


@pytest.mark.parametrize("requests,repeat_frac,num_designs",
                         [(12, 0.5, 2), (7, 0.0, 3)])
def test_stream_rule_matches_jax_make_stream(requests, repeat_frac,
                                             num_designs):
    """make_stream (through stream_over) builds the reference's stream:
    the same problem ids, λ ladder and designs, request rid seeded 1000 +
    rid; stream_over on the designs alone gives the same requests."""
    kw = dict(requests=requests, repeat_frac=repeat_frac,
              num_designs=num_designs, lam=2.0)
    jreqs = jserve.make_stream(192, 384, **kw)
    treqs = make_stream(192, 384, device="cpu", **kw)
    assert len(treqs) == len(jreqs) == requests
    for t, j in zip(treqs, jreqs):
        assert (t.rid, t.problem_id, t.seed) == (j.rid, j.problem_id,
                                                 1000 + j.rid)
        np.testing.assert_allclose(float(t.prob.lam), float(j.prob.lam),
                                   rtol=1e-7)
        _close(t.prob.A.numpy(), j.prob.A)
    designs = [next(r.prob for r in treqs if r.problem_id == pid)
               for pid in range(num_designs)]
    again = tserve.stream_over(designs, requests=requests,
                               repeat_frac=repeat_frac, lam=2.0, seed=1000)
    for a, t in zip(again, treqs):
        assert (a.rid, a.problem_id, a.seed) == (t.rid, t.problem_id, t.seed)
        assert float(a.prob.lam) == float(t.prob.lam)
        assert a.prob.A is t.prob.A


def _fresh_stream(**kw):
    kw.setdefault("requests", 6)
    kw.setdefault("repeat_frac", 0.0)
    kw.setdefault("lam", 2.0)
    reqs = make_stream(192, 384, device="cpu", **kw)
    for r in reqs:
        r.problem_id = ("solo", r.rid)      # no cross-request cache hits
    return reqs


def _clone(reqs):
    return [SolveRequest(rid=r.rid, problem_id=r.problem_id, prob=r.prob,
                         seed=r.seed, blk_sched=r.blk_sched) for r in reqs]


def test_served_stream_matches_sequential_queue():
    """Per-request results are independent of slot assignment and
    co-tenants: the 3-slot served stream equals the queue solved through a
    1-slot service, request by request, bit for bit."""
    reqs = _fresh_stream()
    kw = dict(KW, tol=1e-4, device="cpu")
    served = {r.rid: r for r in SolverService(
        batch_meta_of(reqs[0].prob), slots=3, cache=WarmStartCache(),
        **kw).serve(_clone(reqs))}
    seq = {r.rid: r for r in solve_queue_sequential(
        _clone(reqs), cache=WarmStartCache(), **kw)}
    assert sorted(served) == sorted(seq) == [r.rid for r in reqs]
    for rid in served:
        a, b = served[rid], seq[rid]
        assert (a.status, a.rounds_used) == (b.status, b.rounds_used), rid
        assert torch.equal(a.x, b.x), rid


def test_served_stream_deterministic_under_eviction():
    """Round-deadline eviction re-queues a solve and resumes it from its
    partial iterate and margin; the results equal the eviction-free
    serve."""
    reqs = _fresh_stream(requests=4)
    kw = dict(KW, tol=1e-4, device="cpu")
    meta = batch_meta_of(reqs[0].prob)
    plain = {r.rid: r for r in SolverService(
        meta, slots=2, cache=WarmStartCache(), **kw).serve(_clone(reqs))}
    evicting = {r.rid: r for r in SolverService(
        meta, slots=2, cache=WarmStartCache(), deadline_launches=1,
        max_evictions=10, **kw).serve(_clone(reqs))}
    assert any(r.evictions > 0 for r in evicting.values())
    for rid in plain:
        assert torch.equal(evicting[rid].x, plain[rid].x), rid
        assert evicting[rid].rounds_used == plain[rid].rounds_used, rid


def test_warm_cache_hit_skips_half_the_cold_rounds():
    reqs = make_stream(256, 512, requests=8, repeat_frac=0.5, lam=2.0,
                       seed=0, device="cpu")
    svc = SolverService(batch_meta_of(reqs[0].prob), slots=4, K=1,
                        max_rounds=64, rounds_per_launch=8, tol=1e-4,
                        device="cpu")
    done = {r.rid: r for r in svc.serve(reqs)}
    cold = [done[r].rounds_used for r in range(4)]
    warm = [done[r].rounds_used for r in range(4, 8)]
    assert all(done[r].status == "ok" for r in done)
    assert all(done[r].warm in ("exact", "near") for r in range(4, 8))
    assert sum(warm) <= 0.5 * sum(cold), (warm, cold)
    assert svc.cache.stats.hits_exact + svc.cache.stats.hits_near >= 4
    assert 0.0 < svc.slot_occupancy <= 1.0


def test_a_second_serve_returns_only_its_own_requests():
    """``serve`` hands back the requests of its own call: the service
    keeps no finished request (each holds x on the device) past it."""
    reqs = make_stream(256, 512, requests=6, lam=2.0, seed=0, device="cpu")
    svc = SolverService(batch_meta_of(reqs[0].prob), slots=2, K=1,
                        max_rounds=16, rounds_per_launch=8, device="cpu")
    first = svc.serve(reqs[:4])
    second = svc.serve(reqs[4:])
    assert sorted(r.rid for r in first) == [0, 1, 2, 3]
    assert sorted(r.rid for r in second) == [4, 5]
    assert svc.board.finished == []


def test_admission_writes_the_slots_range_table():
    """Admitting a design into a slot writes that slot's range-start table
    (the fused kernel's row ranges) with the design's own, also when the
    slot held another design; the other slot keeps its table."""
    from repro_torch.core import objectives as tobj
    from repro_torch.data import synthetic as tsyn
    probs = []
    for seed, dens in ((0, 0.02), (1, 0.05)):
        A, y, _ = tsyn.large_sparse(seed=seed, n=300, d=640, density=dens,
                                    layout="bcsc")
        probs.append(tobj.make_problem(A, y, 0.1, device="cpu"))
    assert probs[0].A.tile != probs[1].A.tile
    meta = batch_meta_of(probs[0])._replace(
        tile=max(p.A.tile for p in probs))
    svc = SolverService(meta, slots=2, device="cpu", **KW)
    for rid, (slot, p) in enumerate(((0, probs[0]), (1, probs[1]),
                                     (0, probs[1]))):
        svc._admit(SolveRequest(rid=rid, problem_id=rid, prob=p, seed=rid),
                   slot)
        assert torch.equal(svc.stacked.rstart[slot], p.A.range_starts())
    assert torch.equal(svc.stacked.rstart[1], probs[1].A.range_starts())
    assert not torch.equal(probs[0].A.range_starts(),
                           probs[1].A.range_starts())


def _sparse_pair():
    """Two BlockedCSC Lasso designs of 300 × 640 whose tiles differ (24 and
    32), so a canvas of the deeper tile pads the first."""
    from repro_torch.core import objectives as tobj
    from repro_torch.data import synthetic as tsyn
    probs = []
    for seed, dens in ((0, 0.02), (1, 0.05)):
        A, y, _ = tsyn.large_sparse(seed=seed, n=300, d=640, density=dens,
                                    layout="bcsc")
        probs.append(tobj.make_problem(A, y, 0.1, device="cpu"))
    assert probs[0].A.tile < probs[1].A.tile
    return probs


def _uncached(A):
    """A copy of a BlockedCSC that shares nothing with it, its layout cache
    included."""
    return type(A)(rows=A.rows.clone(), vals=A.vals.clone(), n=A.n, d=A.d,
                   block=A.block)


@pytest.mark.parametrize("case", ["fits", "tile-padded", "bfloat16"])
def test_admission_builds_a_designs_layouts_once(case, monkeypatch):
    """Admitting one BlockedCSC design into slots 0, 1, then 0 again builds
    each of its layouts once (the padded or cast canvas copy too, cached on
    the design), and every slot array, iterate and margin equals what the
    same admissions of an uncached copy of the design write."""
    from repro_torch.data import sparse as tsp
    small, deep = _sparse_pair()
    prob = {"fits": small, "tile-padded": small,
            "bfloat16": small._replace(A=small.A.astype(torch.bfloat16))
            }[case]
    meta = batch_meta_of(small)
    if case == "tile-padded":
        meta = meta._replace(tile=deep.A.tile)
    x0 = torch.rand(prob.d, generator=torch.Generator().manual_seed(3))

    def admitted(design, count=None):
        svc = SolverService(meta, slots=2, device="cpu", **KW)
        for rid, slot in enumerate((0, 1, 0)):
            svc._admit(SolveRequest(rid=rid, problem_id=0, x0=x0, seed=rid,
                                    prob=prob._replace(A=design)), slot)
            if count is not None:
                assert count == {"row_table": 1, "scatter_order": 1,
                                 "range_starts": 1}, (rid, count)
        return svc

    count = {}
    for name in ("row_table", "scatter_order", "range_starts"):
        def spy(*a, _inner=getattr(tsp, name), _name=name):
            count[_name] = count.get(_name, 0) + 1
            return _inner(*a)
        monkeypatch.setattr(tsp, name, spy)
    got = admitted(prob.A, count)
    assert prob.A.has_layouts(meta.nblk, meta.tile)
    assert (prob.A.on_canvas(meta.nblk, meta.tile) is prob.A) == \
        (case == "fits")
    monkeypatch.undo()
    want = admitted(_uncached(prob.A))
    for a, b in zip(got.stacked, want.stacked):
        for u, v in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
            assert (u is None) == (v is None)
            assert u is None or torch.equal(u, v)
    for name in ("x", "z", "x_snap", "z_snap"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert bool(torch.any(got.z != 0))


def test_served_sparse_stream_equals_one_that_reuses_nothing():
    """A BlockedCSC stream over two designs, each served four times (one
    padded to the other's tile), equals the same stream whose every request
    carries an uncached copy of its design: the same x, objective, status,
    launches, rounds and cache verdict, bit for bit."""
    probs = _sparse_pair()
    meta = batch_meta_of(probs[1])

    def served(copy):
        reqs = stream_over(probs, requests=8, repeat_frac=0.5, lam=1.0,
                           seed=0)
        for r in reqs:
            if copy:
                r.prob = r.prob._replace(A=_uncached(r.prob.A))
        svc = SolverService(meta, slots=3, K=1, max_rounds=32,
                            rounds_per_launch=8, tol=1e-4, device="cpu")
        return {r.rid: r for r in svc.serve(reqs)}

    reused, fresh = served(False), served(True)
    assert sorted(reused) == sorted(fresh) == list(range(8))
    assert {r.warm for r in reused.values()} >= {"miss", "exact"}
    for rid, a in reused.items():
        b = fresh[rid]
        assert torch.equal(a.x, b.x), rid
        assert (a.f_final, a.status, a.launches, a.rounds_used, a.warm) == \
            (b.f_final, b.status, b.launches, b.rounds_used, b.warm), rid


def _dense_pair():
    """Two dense Lasso designs of 300 rows, 384 and 500 columns, so a
    canvas of the wider pads the first's columns."""
    from repro_torch.core import objectives as tobj
    from repro_torch.data import synthetic as tsyn
    probs = []
    for seed, d in ((0, 384), (1, 500)):
        A, y, _ = tsyn.sparco(seed=seed, n=300, d=d)
        probs.append(tobj.make_problem(A, y, 0.1, device="cpu"))
    return probs


@pytest.mark.parametrize("layout", ["dense", "bcsc"])
def test_admitted_slots_equal_the_stacked_solves_stack(layout):
    """The service's empty stack with problem i admitted into slot i is,
    field by field and bit for bit, the stack ``stack_problems`` builds of
    the same problems on the same canvas (one of them padded to it): the
    served slots hold what the stacked solve's slots hold."""
    probs = _dense_pair() if layout == "dense" else _sparse_pair()
    meta = batch_meta_of(probs[1])
    assert meta.layout == layout
    svc = SolverService(meta, slots=len(probs), device="cpu", **KW)
    for i, p in enumerate(probs):
        svc._admit(SolveRequest(rid=i, problem_id=i, prob=p, seed=i), i)
    _, want = stack_problems(probs, meta)
    for name, a, b in zip(SlotArrays._fields, svc.stacked, want):
        assert (a is None) == (b is None), name
        for u, v in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
            assert u is None or (u.dtype == v.dtype and torch.equal(u, v)), \
                name


def test_mixed_loss_request_raises():
    reqs = _fresh_stream(requests=2)
    svc = SolverService(batch_meta_of(reqs[0].prob), slots=2,
                        device="cpu", **KW)
    bad = reqs[1]
    bad.prob = bad.prob._replace(loss="logistic")
    with pytest.raises(ValueError, match="mixed-loss stream"):
        svc.serve(reqs)


def test_request_needs_draws():
    req = _fresh_stream(requests=1)[0]
    req.seed = None
    svc = SolverService(batch_meta_of(req.prob), slots=1, device="cpu",
                        **KW)
    with pytest.raises(ValueError, match="seed= or blk_sched="):
        svc.serve([req])


def _record_k_eff(monkeypatch, module):
    """Wrap ``module.launch_rounds`` to record each launch's k_eff."""
    seen, inner = [], module.launch_rounds

    def spy(meta, stacked, z, x, idx, k_eff, *a, **kw):
        seen.append(np.asarray(k_eff).tolist())
        return inner(meta, stacked, z, x, idx, k_eff, *a, **kw)

    monkeypatch.setattr(module, "launch_rounds", spy)
    return seen


def test_diverging_request_backs_off_like_jax(monkeypatch):
    """A correlated design with K = 3 blocks (P = 384) far above P*: the
    first launch trips the guard, the slot rolls back with k_eff halved to
    1, the next launch trips again and the request ends "diverged" — as in
    the JAX service, launch for launch."""
    A, y, _ = jsyn.sparco(seed=0, n=192, d=384, corr=0.9)
    jp = jobj.make_problem(A, y, lam=0.1)
    kw = dict(K=3, max_rounds=48, rounds_per_launch=8, tol=1e-4)
    jseen = _record_k_eff(monkeypatch, jserve)
    jreq = jserve.SolveRequest(rid=0, problem_id=0, prob=jp,
                               key=jax.random.PRNGKey(3))
    (jout,) = jserve.SolverService(jmeta_of(jp), slots=1, interpret=True,
                                   **kw).serve([jreq])
    tseen = _record_k_eff(monkeypatch, tserve)
    treq = _port_request(jreq, 6, 8, 3, {})
    (tout,) = SolverService(batch_meta_of(treq.prob), slots=1, device="cpu",
                            **kw).serve([treq])
    assert jseen == [[3.0], [1.0]] and tseen == jseen
    assert (tout.status, tout.launches, tout.rounds_used) == (
        jout.status, jout.launches, jout.rounds_used) == ("diverged", 1, 0)
    _close(tout.f_final, jout.f_final)
