"""Bitplane kernels: the CUDA kernels (``bitplane``), their plain torch
versions (``ref``) and the dispatch wrappers (``ops``)."""
