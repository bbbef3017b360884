"""Distributed helpers (a port of ``repro.distributed``): the mesh context,
specs and collectives over mesh axes (``sharding``) and the bitplane
gradient compression (``grad_compress``)."""
