"""The port's example programs, one module a program of ``examples/``:

    python -m repro_torch.examples.quickstart            # Lasso, P*, Shotgun vs Shooting
    python -m repro_torch.examples.lasso_paths           # warm-started λ-path
    python -m repro_torch.examples.distributed_shotgun   # sharded, block and fused solves
    python -m repro_torch.examples.train_lm              # LM training with resume
    python -m repro_torch.examples.lm_probe              # Shotgun-CDN on LM features

Each runs on the card unless given ``--device cpu``, and each ``main(argv)``
prints what its reference program prints and returns the same numbers as
a dict.  Every solver draw comes from a CPU ``torch.Generator`` seeded
with the reference's ``PRNGKey`` value and moves to the device as an index
(or uniform) stream, so a run on the card and a run on the CPU take the
same draws (``lm_probe`` draws its model's weights on the device, as
``launch.train`` does).
"""
import torch


def start_vector(d: int) -> torch.Tensor:
    """The power iteration's start vector: seed 0's normal draw on the CPU
    (the reference's ``spectral_radius`` starts from ``PRNGKey(0)``)."""
    return torch.randn(d, generator=torch.Generator().manual_seed(0))
