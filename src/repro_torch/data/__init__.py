"""Synthetic datasets (numpy copies of ``repro.data.synthetic``, plus on-device twins)."""
