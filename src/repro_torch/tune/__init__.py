"""repro_torch.tune — the unified tuning config, its cache and the tuner.

``RefactorConfig`` is the one source of truth for every tuning knob of the
write/read stack; ``as_config`` normalizes legacy loose kwargs into one;
``cached_config`` looks up a tuned winner (``tune.cache``); ``tune`` finds
one by measured probes (``tune.search``).  The search loads lazily so core
modules can import this package without cycles.  The reference's
``CostModel`` lowers to XLA HLO and has no counterpart here.
"""
from __future__ import annotations

from repro_torch.tune.cache import cached_config
from repro_torch.tune.config import DEFAULT_CONFIG, RefactorConfig, as_config

__all__ = ["RefactorConfig", "DEFAULT_CONFIG", "as_config", "tune",
           "TuneResult", "cached_config"]


def __getattr__(name):
    # lazy: tune.search imports core modules, which import THIS package for
    # the config; resolving it on first touch keeps the import graph acyclic
    if name in ("tune", "TuneResult"):
        from repro_torch.tune import search as _s
        return getattr(_s, name)
    if name == "CostModel":
        raise AttributeError(
            "repro_torch.tune has no CostModel: the reference's model lowers "
            "the fused program to XLA HLO, which has no torch counterpart; "
            "tune() ranks candidates by measured probes alone")
    raise AttributeError(name)
