"""Optimizers (a port of ``repro.optim``): AdamW."""
