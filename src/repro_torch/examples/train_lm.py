"""End-to-end LM training driver example: a small qwen3-family model for a
few hundred steps with checkpointing and auto-resume (port of
``examples/train_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300 [--device cpu]

The second run with the same ``--ckpt-dir`` resumes from its newest
checkpoint (``--simulate-failure-at K`` stops the first after step K); a
run that finds the last step already saved trains nothing.  The default
``--ckpt-dir`` lies in the temporary directory (``TMPDIR``), under a name
of the port's own, so the reference's example never resumes from it.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from repro_torch import tree as T
from repro_torch.launch.train import train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.train_lm",
        description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--simulate-failure-at", type=int, default=-1)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)

    t0 = time.time()
    state, losses = train("qwen3-4b", smoke=True, steps=a.steps,
                          batch=a.batch, seq=a.seq, lr=3e-3,
                          ckpt_dir=a.ckpt_dir, save_every=a.save_every,
                          simulate_failure_at=a.simulate_failure_at,
                          log_every=25, device=a.device)
    dt = time.time() - t0
    n_params = sum(t.numel() for t in T.leaves(state.params))
    if not losses:
        print(f"already trained to step {int(state.step)} in {a.ckpt_dir}; "
              "nothing to run")
        return dict(params=n_params, steps=a.steps, losses=[], seconds=dt)
    print(f"\ntrained {n_params / 1e6:.1f}M params for {a.steps} steps "
          f"in {dt:.0f}s; loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"loss must decrease: {losses[0]} -> "
                           f"{losses[-1]}")
    return dict(params=n_params, steps=a.steps, losses=losses, seconds=dt)


if __name__ == "__main__":
    main()
