"""On-disk autotune config cache (``out/tune/``).

A port of ``repro.tune.cache``.  Winning configs are cached per *backend
fingerprint* (the port's prefix, resolved backend, device name, device count
and torch version: anything that can change which config wins) and per
*problem key* (shape, dtype, levels).  Layout::

    out/tune/<fingerprint>/<problem>.json
        {"config": {...RefactorConfig...},
         "meta": {"fingerprint": ..., "problem": ..., ...}}

The fingerprint starts with ``repro_torch-``, so the port and the JAX
package share the directory without ever reading each other's entries (a
JAX-written entry names a Pallas backend and an XLA device).

The chunked pipelines consult the cache by default (``cached_config``): a
hit replays the tuned plan with one memoized disk read; a miss costs one
``os.stat`` and falls back to the caller's defaults.  Nothing here starts a
search.  ``REPRO_TUNE_CACHE`` overrides the cache root (tests point it at a
temporary directory).
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.obs.metrics import StatCounters
from repro_torch.tune.config import RefactorConfig

_REPO = Path(__file__).resolve().parents[3]
_ENV = "REPRO_TUNE_CACHE"
FINGERPRINT_PREFIX = "repro_torch"


@dataclasses.dataclass
class CacheStats(StatCounters):
    """Process-global hit/miss/store counters (thread-safe)."""
    hits: int = 0
    misses: int = 0
    stores: int = 0


STATS = CacheStats()

# memo of (root, fingerprint, problem) -> Optional[RefactorConfig]: a writer
# streaming many variables with the same chunk shape stats the disk once
_MEMO: Dict[Tuple[str, str, str], Optional[RefactorConfig]] = {}
_MEMO_LOCK = threading.Lock()


def cache_root(root: Optional[os.PathLike] = None) -> Path:
    if root is not None:
        return Path(root)
    env = os.environ.get(_ENV)
    return Path(env) if env else _REPO / "out" / "tune"


def backend_fingerprint(backend: str = "auto", n_devices: int = 1,
                        device=None) -> str:
    """Everything that can change which config wins, flattened to a slug:
    the resolved backend (``cuda`` kernels or the plain ``torch`` version),
    the card's name (or ``cpu``), the device count and torch's version."""
    import torch

    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        kind = torch.cuda.get_device_name(dev).replace(" ", "_")
        resolved = "torch" if backend == "torch" else "cuda"
    else:
        kind = "cpu"
        resolved = "torch"
    return (f"{FINGERPRINT_PREFIX}-{resolved}-{kind}-{n_devices}dev"
            f"-torch{torch.__version__}")


def problem_key(shape: Sequence[int], dtype: str = "float32",
                levels: Optional[int] = None) -> str:
    dims = "x".join(str(int(d)) for d in shape) or "scalar"
    return f"{dims}-{dtype}-L{'auto' if levels is None else int(levels)}"


def _path(root: Path, fingerprint: str, problem: str) -> Path:
    return root / fingerprint / f"{problem}.json"


def load(fingerprint: str, problem: str,
         root: Optional[os.PathLike] = None) -> Optional[RefactorConfig]:
    """Cached winner or None; memoized per (root, fingerprint, problem)."""
    r = cache_root(root)
    memo_key = (str(r), fingerprint, problem)
    with _MEMO_LOCK:
        if memo_key in _MEMO:
            hit = _MEMO[memo_key]
            STATS.add(hits=1 if hit is not None else 0,
                      misses=0 if hit is not None else 1)
            return hit
    p = _path(r, fingerprint, problem)
    cfg: Optional[RefactorConfig] = None
    try:
        cfg = RefactorConfig.from_json(json.loads(p.read_text())["config"])
    except FileNotFoundError:
        pass
    except (json.JSONDecodeError, KeyError, TypeError, ValueError):
        # a corrupt cache entry must never break a write: treat as a miss
        cfg = None
    with _MEMO_LOCK:
        _MEMO[memo_key] = cfg
    STATS.add(hits=1 if cfg is not None else 0,
              misses=0 if cfg is not None else 1)
    return cfg


def store(fingerprint: str, problem: str, config: RefactorConfig,
          meta: Optional[Dict[str, Any]] = None,
          root: Optional[os.PathLike] = None) -> Path:
    """Persist a winner (atomic rename) and refresh the memo."""
    r = cache_root(root)
    p = _path(r, fingerprint, problem)
    p.parent.mkdir(parents=True, exist_ok=True)
    payload = {"config": config.to_json(),
               "meta": dict(meta or {}, fingerprint=fingerprint,
                            problem=problem)}
    tmp = p.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(payload, indent=2, sort_keys=True))
    os.replace(tmp, p)
    with _MEMO_LOCK:
        _MEMO[(str(r), fingerprint, problem)] = config
    STATS.add(stores=1)
    return p


def invalidate_memo() -> None:
    """Drop the in-process memo (tests that rewrite cache files on disk)."""
    with _MEMO_LOCK:
        _MEMO.clear()


def cached_config(shape: Sequence[int], dtype: str = "float32",
                  levels: Optional[int] = None, backend: str = "auto",
                  n_devices: int = 1,
                  root: Optional[os.PathLike] = None,
                  device=None) -> Optional[RefactorConfig]:
    """The one-call lookup used by the pipelines; ``device`` is where the
    caller runs (``None`` means ``cuda``)."""
    return load(backend_fingerprint(backend, n_devices, device),
                problem_key(shape, dtype, levels), root=root)
