"""Training (a port of ``repro.train``): the step factories of ``step`` and
the restart-safe, checkpointing ``Trainer`` of ``loop``."""
