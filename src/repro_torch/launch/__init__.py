"""Entry points (port of ``repro.launch``): the solver service and its
slot board, the LM server and the LM trainer."""
