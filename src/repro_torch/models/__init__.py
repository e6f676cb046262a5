"""The LM substrate (port of ``repro.models``): layers, GQA and MLA
attention, MoE, Mamba-2 and the model (decoder, encoder, cross attention)
over ``configs/``.  ``sharding.py`` and ``steps.py`` are not ported yet."""
