"""The port's LM train step against the JAX package's on the CPU for the
MoE (Granite, Phi-3.5), Mamba-2 and Whisper (the reference's encoder
frames fed to both) smoke configurations — with ``tests/test_torch_train_step.py``'s checks and
tolerances, and the MoE capacity path's backward: Granite at 1024 tokens
with a capacity factor that drops picks, whose dropped picks must get the
zero gradient the reference's one-hot dispatch gives them."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_train_step import (_few_threads,  # noqa: E402,F401
                                   check_grad_accum, check_grads,
                                   check_loss_falls,
                                   check_remat_bit_identical,
                                   check_train_step)

FAMILIES = ["granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b", "mamba2-2.7b",
            "whisper-large-v3"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(arch):
    check_grads(arch)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_reference(arch):
    check_train_step(arch)


@pytest.mark.parametrize("arch", FAMILIES)
def test_grad_accum_matches_reference(arch):
    check_grad_accum(arch)


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_is_bit_identical(arch):
    check_remat_bit_identical(arch)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_falls(arch):
    check_loss_falls(arch)


def test_moe_capacity_path_grads_match_reference(monkeypatch):
    """2 × 512 tokens take the grouped capacity path (2 groups of 512);
    a capacity factor of 0.25 leaves 64 rows an expert, so picks drop."""
    from repro_torch.models import moe
    kept = []
    real = moe.capacity_slots

    def spy(gate_idx, e, cap):
        pos, keep = real(gate_idx, e, cap)
        kept.append(float(keep.float().mean()))
        return pos, keep
    monkeypatch.setattr(moe, "capacity_slots", spy)
    check_grads("granite-moe-1b-a400m", rows=2, seq=512,
                moe_capacity_factor=0.25)
    assert kept and max(kept) < 0.9, kept
