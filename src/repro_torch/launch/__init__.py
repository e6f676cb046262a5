"""The solver service and its slot board (port of ``repro.launch``)."""
