"""The readings the limits of ``correct`` are set from; not run by the
benchmark's own runs.

    python3 bench/control.py --workload <cell> --seeds 12 --control-seeds 3 \\
        [--seconds 2] [--out build/bench/control.json]

For each of ``--seeds`` fresh seeds it runs the cell as a run does (its
set-up, a short window at the cell's own load, the comparison of the
sampled answers with the reference) and reads every compared number: the
largest over the seeds is the lower reading.  Then, on ``--control-seeds``
more seeds, the control takes the port's place: the port's own bfloat16
design path for a one-at-a-time solve, and for a served job the reference
itself with its design values rounded to bfloat16 (the service has no
such path), following the served job's schedule.  The smallest of each
number over those seeds is the upper reading.  Both go to standard output
as JSON lines and, summed up, to ``--out``.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def serve_control(cell, seed: int, seconds: float, device) -> dict:
    """A served job's numbers with the bfloat16 reference in the
    service's place: it replays the sampled jobs on the served schedule
    with its own verdicts, and its answers are judged as the service's
    are."""
    from bench import harness
    from bench.reference import serve as ref_serve
    drv = harness.driver_of(cell, seed, device)
    drv.setup()
    harness.window(drv, seconds, False)
    drv.release()
    designs, lams = drv.reference("bf16")
    band = 2.0 * cell.limits["f_gap"]
    served, own_stops = [], 0
    for i, job, _ in drv.sample.items:
        scheds = drv.scheds(i)
        job = [r._replace(sched=scheds[q]) for q, r in enumerate(job)]
        got = drv.replay(designs, lams, job, band)
        own_stops += sum(w.stops for w in got)
        served.append((i, [ref_serve.Served(
            pid=r.pid, lam_idx=r.lam_idx, sched=None, launches=w.launches,
            rounds_used=w.rounds_used, status=w.status)
            for r, w in zip(job, got)],
            [(w.x, w.f_final, w.warm) for w in got]))
    del designs
    checks = drv.verify(cell.limits, served=served)
    checks["decisions"] += own_stops
    return checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2_200_000_011)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from bench import harness
    cell = harness.load_cell(a.workload, False)
    dev = torch.device(a.device)
    serve = cell.mix["driver"] == "serve_backlog"
    sound, control = [], []
    for k in range(a.seeds + a.control_seeds):
        seed = a.first_seed + 7919 * k
        is_control = k >= a.seeds
        t = time.perf_counter()
        if is_control and serve:
            checks, correct = serve_control(cell, seed, a.seconds, dev), None
        else:
            out = harness.run_cell(cell, seed, a.seconds, False, t_start=t,
                                   device=dev,
                                   variant="bf16" if is_control else None)
            checks = {k2: v["value"] for k2, v in out["checks"].items()}
            correct = out["correct"]
            checks["reference_s"] = out["reference_s"]
        (control if is_control else sound).append(checks)
        print(json.dumps({"seed": seed, "control": is_control,
                          "correct": correct, "checks": checks,
                          "seconds": time.perf_counter() - t}), flush=True)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    names = sorted(set(sound[0] if sound else control[0]) - {"reference_s"})
    summary = {"workload": a.workload, "seeds": a.seeds,
               "control_seeds": a.control_seeds,
               "lower": {n: max(c[n] for c in sound) for n in names}
               if sound else None,
               "upper": {n: min(c[n] for c in control) for n in names}
               if control else None,
               "device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu"),
               "seconds": time.perf_counter() - T0}
    print(json.dumps(summary), flush=True)
    if a.out:
        path = pathlib.Path(a.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(summary, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
