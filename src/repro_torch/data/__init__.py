"""Seeded synthetic scientific fields (``fields``)."""
