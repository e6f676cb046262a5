"""The port's spans and counters (``repro_torch.obs``) on the CPU: nothing
is recorded without a profiler; under one, the spans nest with the right
parents and request ids, self time is inclusive time less the children's,
the profiler's timeline holds each span around the host ops of its call,
the byte counters of a tiny solve and of tiny served jobs equal the sizes
counted here from the shapes, and a BlockedCSC job's layout hits and
builds add up to its admissions."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core import objectives as obj
from repro_torch.core.batched import batch_meta_of
from repro_torch.core.spec import SolverSpec
from repro_torch.kernels import ops
from repro_torch.launch import solver_serve as serve

N, D = 100, 300      # a solve, padded to (512, 384): TILE_N rows, blocks
SN, SD = 256, 500    # a served design, padded to (512, 512)
SPEC = SolverSpec(P=256, rounds=8, fused=True)


@pytest.fixture(autouse=True)
def clean_tally():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    obs.reset()
    yield
    obs.reset()
    torch.set_num_threads(n)


def _problem():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((N, D)).astype(np.float32) / np.sqrt(N)
    y = A[:, :5].sum(axis=1).astype(np.float32)
    return obj.make_problem(A, y, lam=0.05, device="cpu")


def _solve(prob):
    return ops.block_shotgun_solve(prob, torch.Generator().manual_seed(1),
                                   spec=SPEC, rounds_per_launch=4)


def _service_and_stream(requests=4):
    """Two designs, the second half of the stream repeating the first (so
    warm starts hit the cache), served on two slots."""
    reqs = serve.make_stream(SN, SD, requests=requests, repeat_frac=0.5,
                             lam=2.0, device="cpu")
    svc = serve.SolverService(batch_meta_of(reqs[0].prob), slots=2, K=1,
                              max_rounds=32, rounds_per_launch=8, tol=1e-4,
                              device="cpu")
    return svc, reqs


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def test_nothing_is_recorded_without_a_profiler():
    assert not obs.enabled()
    _solve(_problem())
    svc, reqs = _service_and_stream()
    assert len(svc.serve(reqs)) == len(reqs)
    assert obs.totals() == {"spans": {}, "counters": {}, "dropped": 0}
    assert obs.spans() == []


def _children(records, i):
    return [r for r in records if r.parent == i]


def test_tensor_counts_are_read_by_totals():
    """A tensor count is kept as it is under a profiler and summed by
    ``totals()`` with the counter's numbers; without a profiler it is
    dropped."""
    obs.count("t.n", torch.tensor(5))
    assert obs.totals()["counters"] == {}

    def run():
        obs.count("t.n", 2)
        obs.count("t.n", torch.tensor(5))
        obs.count("t.n", torch.tensor(7, dtype=torch.int32))
    _profiled(run)
    assert obs.totals()["counters"] == {"t.n": 14}
    obs.reset()
    assert obs.totals()["counters"] == {}


def test_solve_spans_nest_and_lie_on_the_profilers_timeline():
    prob = _problem()
    _, events = _profiled(lambda: _solve(prob))
    recs = obs.spans()
    assert [r.name for r in recs] == [
        ops.SOLVE_SPAN, ops.PAD_SPAN, ops.DRAWS_SPAN, ops.LAUNCHES_SPAN]
    assert [r.parent for r in recs] == [-1, 0, 0, 0]
    assert all(r.rid is None for r in recs)
    top = recs[0]
    assert all(top.start_ns <= r.start_ns <= r.end_ns <= top.end_ns
               for r in recs[1:])
    t = obs.totals()
    kids = sum(r.end_ns - r.start_ns for r in recs[1:])
    assert t["spans"][ops.SOLVE_SPAN]["self_seconds"] == pytest.approx(
        (top.end_ns - top.start_ns - kids) / 1e9, abs=1e-12)
    for r in recs[1:]:
        s = t["spans"][r.name]
        assert s["calls"] == 1 and s["self_seconds"] == s["seconds"]
    assert t["counters"]["solver.launches"] == SPEC.rounds // 4

    # one timeline: the profiler holds each span, and every host op of
    # the call starts inside the solve's range; the draws' sort inside
    # the draws' range
    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU]
    ranges = {e.name: e.time_range for e in cpu if e.name.startswith(
        "repro_torch.")}
    assert set(ranges) == {r.name for r in recs}
    solve = ranges[ops.SOLVE_SPAN]
    ops_ = [e for e in cpu if e.name.startswith("aten::")]
    assert ops_ and all(solve.start <= e.time_range.start <= solve.end
                        for e in ops_)
    draws = ranges[ops.DRAWS_SPAN]
    sorts = [e for e in ops_ if e.name in ("aten::argsort", "aten::sort")]
    assert sorts and all(draws.start <= e.time_range.start <= draws.end
                         for e in sorts)


def test_served_job_spans_carry_request_ids():
    svc, reqs = _service_and_stream()
    done, events = _profiled(lambda: svc.serve(reqs))
    recs = obs.spans()
    names = {r.name for r in recs}
    admit, launch = serve.ADMIT_SPAN, serve.LAUNCH_SPAN
    assert names == {admit, admit + ".layout", admit + ".warm",
                     admit + ".margin", admit + ".objective",
                     admit + ".draws", launch, launch + ".kernel",
                     launch + ".read", serve.FINALIZE_SPAN}
    assert names <= {e.name for e in events}
    rids = sorted(r.rid for r in recs if r.name == admit)
    assert rids == sorted(r.rid for r in reqs)
    assert sorted(r.rid for r in recs if r.name == serve.FINALIZE_SPAN) \
        == sorted(r.rid for r in done)
    for i, r in enumerate(recs):
        if r.name.startswith(admit + "."):
            assert recs[r.parent].name == admit and r.rid is None
        elif r.name.startswith(launch + "."):
            assert recs[r.parent].name == launch
        elif r.name == serve.FINALIZE_SPAN:
            assert recs[r.parent].name == launch    # finalized at a step
        else:
            assert r.parent == -1
        kids = _children(recs, i)
        assert all(r.start_ns <= k.start_ns <= k.end_ns <= r.end_ns
                   for k in kids)
    t = obs.totals()["spans"]
    for name, s in t.items():
        inc = sum(r.end_ns - r.start_ns for r in recs if r.name == name)
        kids = sum(k.end_ns - k.start_ns for i, r in enumerate(recs)
                   if r.name == name for k in _children(recs, i))
        assert s["calls"] == sum(r.name == name for r in recs)
        assert s["seconds"] == pytest.approx(inc / 1e9, abs=1e-12)
        assert s["self_seconds"] == pytest.approx((inc - kids) / 1e9,
                                                  abs=1e-12)


def test_pad_bytes_of_a_dense_solve():
    _profiled(lambda: _solve(_problem()))
    n_pad, d_pad = 512, 384
    want = n_pad * d_pad * 4 + n_pad * 4 + n_pad * 4    # A, y, mask
    assert obs.totals()["counters"]["solver.pad_bytes"] == want


def test_admission_and_cache_bytes_of_a_served_job():
    svc, reqs = _service_and_stream()
    done, _ = _profiled(lambda: svc.serve(reqs))
    n_pad, d_pad = 512, 512
    assert (svc.meta.n_pad, svc.meta.d_pad) == (n_pad, d_pad)
    # normalized A, y, mask, λ, β; x0; z0
    arrays = n_pad * d_pad * 4 + 2 * n_pad * 4 + 2 * 4
    x0, z0 = d_pad * 4, n_pad * 4
    # built once, then copied into the slot (x0 and z0 twice: the
    # iterate and its rollback snapshot)
    per_admission = (arrays + x0 + z0) + (arrays + 2 * x0 + 2 * z0)
    c = obs.totals()["counters"]
    assert c["serve.admit_bytes"] == len(reqs) * per_admission
    st = svc.cache.stats
    assert st.hits_exact + st.hits_near == 2 and st.misses == 2
    puts = sum(r.status == "ok" for r in done)
    assert puts == len(reqs)
    # each put's x (true d) to the host, each hit's x0 back
    assert c["serve.cache_host_bytes"] == (puts + 2) * SD * 4


def _sparse_designs():
    """Two BlockedCSC designs of 300 × 640 with tiles 24 and 32, so the
    first is padded to the canvas of the second."""
    from repro_torch.data import synthetic as syn
    designs = []
    for seed, dens in ((0, 0.02), (1, 0.05)):
        A, y, _ = syn.large_sparse(seed=seed, n=300, d=640, density=dens,
                                   layout="bcsc")
        designs.append(obj.make_problem(A, y, 0.1, device="cpu"))
    return designs


def _sparse_service_and_stream(designs):
    """Each design asked for twice, served on two slots."""
    reqs = serve.stream_over(designs, requests=4, repeat_frac=0.5, lam=1.0,
                             seed=0)
    svc = serve.SolverService(batch_meta_of(designs[1]), slots=2, K=1,
                              max_rounds=32, rounds_per_launch=8, tol=1e-4,
                              device="cpu")
    return svc, reqs


def test_layout_counters_add_up_to_the_admissions():
    """Each BlockedCSC admission counts one layout hit or one build: a
    design's first admission builds, its later ones (in this job or the
    next) hit; a dense stream counts neither."""
    designs = _sparse_designs()
    svc, reqs = _sparse_service_and_stream(designs)
    _profiled(lambda: svc.serve(reqs))
    t = obs.totals()
    c = t["counters"]
    assert t["spans"][serve.ADMIT_SPAN]["calls"] == len(reqs)
    assert (c["serve.layout_builds"], c["serve.layout_hits"]) == \
        (len(designs), len(reqs) - len(designs))
    obs.reset()
    svc, reqs = _sparse_service_and_stream(designs)     # a second job
    _profiled(lambda: svc.serve(reqs))
    c = obs.totals()["counters"]
    assert "serve.layout_builds" not in c
    assert c["serve.layout_hits"] == len(reqs)
    obs.reset()
    svc, reqs = _service_and_stream()
    _profiled(lambda: svc.serve(reqs))
    c = obs.totals()["counters"]
    assert "serve.layout_hits" not in c and "serve.layout_builds" not in c


def test_admission_bytes_of_a_served_sparse_job():
    """A BlockedCSC admission counts y, λ, β, x0 and z0, the layouts only
    when it builds them (with the canvas copy of a design that needs one),
    then the slot write."""
    designs = _sparse_designs()
    svc, reqs = _sparse_service_and_stream(designs)
    _profiled(lambda: svc.serve(reqs))
    m = svc.meta
    n, d_pad, slots = m.n_pad, m.d_pad, m.nblk * m.tile * m.block
    assert designs[1].A.on_canvas(m.nblk, m.tile) is designs[1].A
    request = n * 4 + 2 * 4 + d_pad * 4 + n * 4      # y, λ, β, x0, z0
    layouts = (slots * 4 + m.nblk * 4 + m.nblk * m.block     # the order
               + m.nblk * (-(-n // 128) + 1) * 4)            # range starts
    tables = sum(D.A.on_canvas(m.nblk, m.tile).row_table().nbytes
                 for D in designs)
    canvas = 2 * slots * 4                      # the first design's copy
    # the slot write: tiles, y, λ, β, layouts; x0 and z0 twice
    write = 2 * slots * 4 + n * 4 + 2 * 4 + layouts + 2 * (d_pad + n) * 4
    want = len(reqs) * (request + write) + len(designs) * layouts \
        + tables + canvas
    assert obs.totals()["counters"]["serve.admit_bytes"] == want


def _skewed_csc(n=200, d=400, tile=8):
    """A design in CSC whose first columns run 10–40× deeper than ``tile``
    (their entries past it spill into the overflow store)."""
    rng = np.random.default_rng(3)
    A = (rng.random((n, d)) < 0.03) * rng.standard_normal((n, d))
    A[:, :3] = rng.standard_normal((n, 3))
    A[:, 130] = rng.standard_normal(n) * (rng.random(n) < 0.5)
    cols, rows = np.nonzero(A.T)
    col_ptr = np.r_[0, np.cumsum(np.bincount(cols, minlength=d))]
    return col_ptr, rows, A[rows, cols].astype(np.float32), n, d, tile


@pytest.mark.parametrize("n,R,warps,items,piped", [
    (2_396_130, 32, 2112, 32 * 9360, 32 * 7248),   # url, 264 CTAs of 8
    (2_396_130, 8, 2112, 8 * 9360, 8 * 7248),
    (2_200_000, 8, 2112, 8 * 8594, 8 * 6482),      # the card tests' tall
    (3000, 8, 2112, 8 * 12, 0),                    # and small designs
    (540_672, 4, 2112, 4 * 2112, 0),               # one item a warp
    (540_673, 4, 2112, 4 * 2113, 4),
    (2_396_130, 32, None, 32 * 9360, 0)])          # the plain version
def test_bc_item_counts(n, R, warps, items, piped):
    """``solver.overflow_bc_items`` is R·⌈n / 256⌉ and
    ``solver.overflow_bc_pipelined_items`` R·(n_lt − min(n_lt, warps)):
    each warp of the grid walks items w, w + warps, … and loads each
    next item's range-start pairs under the one before."""
    from repro_torch.kernels.shotgun_sparse import _bc_items
    assert _bc_items(n, R, warps) == (items, piped)
    if warps:
        assert piped / items == pytest.approx(
            1 - min(1, warps / -(-n // 256)))


def test_overflow_spans_and_counters():
    """``from_csc`` and a solve on its overflow store record their spans
    and counters only under a profiler; the store's bytes are what the
    shapes give, and the segments are those of the drawn blocks."""
    from repro_torch.data.sparse import BlockedCSC
    args = _skewed_csc()
    S = BlockedCSC.from_csc(*args[:5], tile=args[5], device="cpu")
    prob = obj.make_problem(S, np.sign(np.arange(S.n) % 2 - 0.5), lam=0.1,
                            loss="logistic", device="cpu")
    spec = SolverSpec(loss="logistic", P=256, rounds=8, fused=True,
                      newton=True)
    ops.block_shotgun_solve(prob, torch.Generator().manual_seed(1),
                            spec=spec, rounds_per_launch=4)
    assert obs.totals() == {"spans": {}, "counters": {}, "dropped": 0}

    idx = ops.draw_blocks(torch.Generator().manual_seed(1), 8, 2, S.nblk,
                          "cpu")

    def run():
        T = BlockedCSC.from_csc(*args[:5], tile=args[5], device="cpu")
        ops.block_shotgun_solve(prob, spec=spec, blk_idx=idx,
                                rounds_per_launch=4)
        return T
    T, _ = _profiled(run)
    t = obs.totals()
    assert t["spans"]["repro_torch.design.from_csc"]["calls"] == 1
    assert t["counters"]["design.tile_bytes"] == T.rows.nbytes + \
        T.vals.nbytes
    o = T.ovf
    assert t["counters"]["design.overflow_bytes"] == sum(
        a.nbytes for a in (o.rows, o.vals, o.cols, o.ptr, o.seg_ptr,
                           o.seg_col))
    assert t["spans"]["repro_torch.solve.overflow"]["calls"] == 2
    assert t["counters"]["solver.overflow_launches"] == 2
    per_block = np.diff(o.blk_seg)
    assert int(np.max(per_block)) == o.seg_slots > 1
    assert t["counters"]["solver.overflow_segments"] == int(
        per_block[idx.numpy()].sum()) > 0
    # BC's row items: one a 256-row tile a round; the plain version walks
    # them on no warps, so none is loaded under a previous one
    assert t["counters"]["solver.overflow_bc_items"] == 8 * -(-S.n // 256)
    assert t["counters"]["solver.overflow_bc_pipelined_items"] == 0
    parents = {r.name: r.parent for r in obs.spans()}
    records = obs.spans()
    assert records[parents["repro_torch.solve.overflow"]].name == \
        "repro_torch.solve.launches"
