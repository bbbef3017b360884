"""repro_torch.tune — the unified tuning config, its cache and the tuner.

``RefactorConfig`` is the one source of truth for every tuning knob of the
write/read stack; ``as_config`` normalizes legacy loose kwargs into one;
``cached_config`` looks up a tuned winner (``tune.cache``); ``tune`` finds
one by a cost-model-guided search with measured probes (``tune.search``,
``tune.cost``).  The search and the model load lazily so core modules can
import this package without cycles.
"""
from __future__ import annotations

from repro_torch.tune.cache import cached_config
from repro_torch.tune.config import DEFAULT_CONFIG, RefactorConfig, as_config

__all__ = ["RefactorConfig", "DEFAULT_CONFIG", "as_config", "tune",
           "TuneResult", "CostModel", "cached_config"]


def __getattr__(name):
    # lazy: tune.search and tune.cost import core modules, which import THIS
    # package for the config; resolving them on first touch keeps the
    # import graph acyclic
    if name in ("tune", "TuneResult"):
        from repro_torch.tune import search as _s
        return getattr(_s, name)
    if name == "CostModel":
        from repro_torch.tune.cost import CostModel
        return CostModel
    raise AttributeError(name)
