"""Atomic checkpoints of the segmented sharded solve (port of
``repro.ckpt``)."""
