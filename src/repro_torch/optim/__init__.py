"""Optimizers, schedules and the L1 prox of the LM training path (port of
``repro.optim``): ``prox``, ``adamw``, ``adafactor``, ``schedule``."""
