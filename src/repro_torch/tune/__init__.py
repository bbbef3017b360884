"""repro_torch.tune — the unified tuning config and its on-disk cache.

``RefactorConfig`` is the one source of truth for every tuning knob of the
write/read stack; ``as_config`` normalizes legacy loose kwargs into one;
``cached_config`` looks up a tuned winner (``tune.cache``).  The
reference's search and cost model are not ported yet.
"""
from __future__ import annotations

from repro_torch.tune.cache import cached_config
from repro_torch.tune.config import DEFAULT_CONFIG, RefactorConfig, as_config

__all__ = ["RefactorConfig", "DEFAULT_CONFIG", "as_config", "cached_config"]
