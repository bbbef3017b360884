"""Distributed training helpers (a port of ``repro.distributed``): so far
the error-feedback gradient compression of ``grad_compress``."""
