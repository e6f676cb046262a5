"""The LM substrate (port of ``repro.models``): layers, GQA attention and the
decoder model over ``configs/``.  MLA, MoE, Mamba-2, the encoder and
``sharding.py`` are not ported yet; ``model.init``/``forward`` raise
``NotImplementedError`` for a config that needs them."""
