"""Sparse logistic probe on frozen LM features — the paper's exact problem
(Eq. 3) with an assigned-architecture transformer as the featurizer
(DESIGN §6: the faithful integration of Shotgun with the LM substrate;
port of ``examples/lm_probe.py``).

A qwen3-family LM is trained briefly on synthetic token streams, its mean-
pooled final hidden states become the design matrix A, and Shotgun-CDN
solves the L1-regularized probe that predicts a latent binary property of
the sequence.  The features and labels stay on the device from the model
to the solver.  The index streams of the solver come from the CPU (as in
every example); the weights are drawn on the device.

    PYTHONPATH=src python -m repro_torch.examples.lm_probe [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.lm_probe --full   # Qwen3-4B, 36 layers, d_model 2560
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCHS
from repro_torch.core import objectives as obj
from repro_torch.core.cdn import shotgun_cdn_solve
from repro_torch.core.spectral import p_star
from repro_torch.data.loader import LoaderConfig, TokenLoader
from repro_torch.device import resolve_device
from repro_torch.examples import start_vector
from repro_torch.models import model as M
from repro_torch.models import steps as S

ROWS, SEQ, LR, LAM, P_CAP = 16, 64, 3e-3, 0.5, 16
WARMUP_STEPS, BATCHES, ROUNDS = 20, 32, 800
PROBE_TOKEN, FEATURE_STEP0 = 7, 100


def synchronize(device: torch.device) -> None:
    """Wait for the card before a host clock is read (nothing on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm_up(cfg, state, loader, steps: int, first: int = 0):
    """Constant-rate train steps ``first`` to ``steps`` - 1 on the loader's
    batches of those steps, so that the features are not those of random
    weights.  Returns (state, the last step's loss as a 0-d device
    tensor)."""
    step = S.make_train_step(cfg, lr=LR)
    loss = None
    for t in range(first, steps):
        state, metrics = step(state, loader.batch_at(t))
        loss = metrics["loss"]
    return state, loss


def featurize(cfg, params, loader, batches: int):
    """(A, y) on the loader's device: the mean-pooled float32 final hidden
    states of batches ``FEATURE_STEP0 + i`` and their labels, +1 where
    ``PROBE_TOKEN`` appears in the row and -1 elsewhere."""
    feats, labels = [], []
    with torch.no_grad():
        for i in range(batches):
            toks = loader.batch_at(FEATURE_STEP0 + i)["tokens"]
            _, h = M.forward(cfg, params, {"tokens": toks},
                             return_hidden=True)
            feats.append(h.float().mean(dim=1))         # (B, d_model)
            labels.append(torch.where(
                torch.any(toks == PROBE_TOKEN, dim=1), 1.0, -1.0))
    return torch.cat(feats), torch.cat(labels)


def standardize(A: torch.Tensor) -> torch.Tensor:
    """Columns centred and divided by their population standard deviation
    (numpy's ``std``: ``correction=0``): removes the shared mean direction
    that would otherwise push rho toward d."""
    return (A - A.mean(dim=0)) / (A.std(dim=0, correction=0) + 1e-6)


def probe_problem(A, y, rounds: int):
    """The L1-regularized logistic probe of (A, y) on their device, its P*,
    P = min(P*, 16) and the uniforms of ``rounds`` rounds of P active-set
    draws, drawn from seed 2 on the CPU and moved to the device."""
    prob = obj.make_problem(A, y, lam=LAM, loss=obj.LOGISTIC,
                            device=A.device)
    ps = p_star(prob.A, v0=start_vector(prob.d))
    P = max(1, min(ps, P_CAP))
    u = torch.rand((rounds, P, prob.d),
                   generator=torch.Generator().manual_seed(2))
    return prob, ps, P, u.to(A.device)


def probe(prob, P: int, uniforms):
    """Shotgun-CDN with the active set on the probe (Eq. 3)."""
    return shotgun_cdn_solve(prob, P=P, rounds=uniforms.shape[0],
                             uniforms=uniforms)


def accuracy(prob, x) -> torch.Tensor:
    """Training accuracy of sign(A x), a margin of 0 counted as +1."""
    pred = torch.sign(obj.matvec(prob.A, x))
    return torch.mean((torch.where(pred == 0, 1.0, pred) == prob.y).float())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.lm_probe",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="Qwen3-4B's published config in place of its "
                         "smoke config")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    arch = ARCHS["qwen3-4b"]
    cfg = arch.CONFIG if a.full else arch.smoke_config()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # 1. briefly train the LM so that the features are not trivial
    t0 = time.perf_counter()
    # the weights drawn from seed 0 (the reference's PRNGKey(0)) on the
    # device, as launch.train draws them: the published config's 4.4 B
    # normals take half a minute on the host
    state = S.init_train_state(cfg, torch.Generator(dev).manual_seed(0))
    loader = TokenLoader(LoaderConfig(vocab_size=cfg.vocab_size,
                                      global_batch=ROWS, seq_len=SEQ),
                         device=dev)
    synchronize(dev)
    t1 = time.perf_counter()
    # the first step timed apart: it pays for the optimizer state's first
    # touch and the device's first launches of each operation
    state, loss = warm_up(cfg, state, loader, min(WARMUP_STEPS, 1))
    synchronize(dev)
    t1b = time.perf_counter()
    state, loss = warm_up(cfg, state, loader, WARMUP_STEPS, first=1)
    synchronize(dev)
    t2 = time.perf_counter()
    print(f"LM warmed up: loss {float(loss):.3f}")

    # 2. featurize: mean-pooled final hidden states (frozen LM features),
    #    standardized on the device
    params = state.params
    del state
    A, y = featurize(cfg, params, loader, BATCHES)
    A = standardize(A)
    synchronize(dev)
    t3 = time.perf_counter()
    positives = int((y > 0).sum())
    print(f"probe design matrix: n={A.shape[0]}, d={A.shape[1]}, "
          f"positives={positives}")

    # 3. Shotgun-CDN sparse logistic probe (Eq. 3) with the P* estimate
    del params
    prob, ps, P, u = probe_problem(A, y, ROUNDS)
    synchronize(dev)
    t4 = time.perf_counter()
    res = probe(prob, P, u)
    synchronize(dev)
    t5 = time.perf_counter()
    F = res.trace.objective.cpu().numpy()
    acc = float(accuracy(prob, res.x))
    nnz = int(torch.sum(res.x != 0))
    print(f"Shotgun-CDN (P={P}, P*={ps}): F={float(F[-1]):.3f}, "
          f"train acc={acc:.3f}, nnz={nnz}/{prob.d}")
    peak = (torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else None)
    return dict(config=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
                loss=float(loss), n=A.shape[0], d=A.shape[1],
                positives=positives, p_star=ps, P=P, F=F, accuracy=acc,
                nnz=nnz, init_s=t1 - t0,
                warmup_first_ms=(t1b - t1) * 1e3,
                warmup_ms_a_step=(t2 - t1b) * 1e3 / max(WARMUP_STEPS - 1, 1),
                featurize_ms=(t3 - t2) * 1e3,
                cdn_ms_a_round=(t5 - t4) * 1e3 / ROUNDS, peak_gib=peak)


if __name__ == "__main__":
    main()
