"""The port's LM train step against the JAX package's on the CPU for the
Jamba hybrid at the smoke size (16 layers: Mamba-2 and attention mixers,
MLP and MoE FFNs, Adafactor), with ``tests/test_torch_train_step.py``'s
checks and tolerances; in a file of its own, as the reference's compiles
take most of a minute (so its full step and ``grad_accum=2`` are one
check, on four rows)."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_train_step import (_few_threads,  # noqa: E402,F401
                                   check_grads, check_loss_falls,
                                   check_remat_bit_identical,
                                   check_train_step)

ARCH = "jamba-1.5-large-398b"


def test_loss_and_grads_match_reference():
    check_grads(ARCH, rows=4)


def test_train_step_with_grad_accum_matches_reference():
    """The full step and ``grad_accum=2`` in one: two microbatches of two
    rows against the reference's jitted step with its scan."""
    check_train_step(ARCH, grad_accum=2, rows=4)


def test_remat_is_bit_identical():
    check_remat_bit_identical(ARCH)


def test_loss_falls():
    check_loss_falls(ARCH)
