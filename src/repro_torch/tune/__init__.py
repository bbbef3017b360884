"""repro_torch.tune — the unified tuning config.

``RefactorConfig`` is the one source of truth for every tuning knob of the
write/read stack; ``as_config`` normalizes legacy loose kwargs into one.
The reference's search, cost model and cache are not ported yet.
"""
from __future__ import annotations

from repro_torch.tune.config import DEFAULT_CONFIG, RefactorConfig, as_config

__all__ = ["RefactorConfig", "DEFAULT_CONFIG", "as_config"]
