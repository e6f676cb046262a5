"""The Δz wire layer of the sharded driver (port of ``repro.dist``):
compression with error feedback, hierarchical collectives on
``torch.distributed``, fault injection."""
