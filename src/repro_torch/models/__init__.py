"""The LM substrate (port of ``repro.models``): layers, GQA and MLA
attention, MoE, Mamba-2 and the model (decoder, encoder, cross attention)
over ``configs/``, and the train, prefill and decode steps (``steps.py``).
``sharding.py`` is not ported yet."""
