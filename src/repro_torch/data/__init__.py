"""Synthetic datasets (numpy copies of ``repro.data.synthetic``, plus
on-device twins), the BlockedCSC container and the LM token loader."""
