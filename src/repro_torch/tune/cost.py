"""Roofline cost model over the fused encode program's dispatched operators.

A port of ``repro.tune.cost``.  Instead of running every candidate config,
run the candidate's fused program (``core.refactor_fused.
fused_encode_plan(...).run``) once on a ``meta`` tensor of the chunk's
shape, with nothing executed, under ``launch.op_analysis.OpAnalysis``,
which counts its FLOPs, HBM bytes and collective wire bytes, and score it
against the card's peaks::

    t_model = max(flops / peak_flops, bytes / hbm_bw) + wire / link_bw

The reference lowers and compiles the program and mines its HLO
(``fused_program_hlo``, ``launch.hlo_analysis``); the port has no compiled
program, so the operators it dispatches stand in for the HLO (no fusion:
each operator's operands and results count as HBM traffic).  The program
runs with the ``cuda`` backend, so that each bitplane kernel counts as one
operator at its operand and result bytes (its fake runs on ``meta``); the
host-side lossless finish is outside it, as in the reference.

Absolute accuracy does not matter for the tuner: the model only *ranks*
candidates, and the few measured probe runs (``tune.search``) both
calibrate the scale and decide the winner.  Platform keys are the
reference's (``"gpu"``, ``"cpu"``; torch's ``cuda`` device is ``"gpu"``),
so one roofline artifact serves both packages.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike
from repro_torch.tune.config import RefactorConfig


@dataclasses.dataclass(frozen=True)
class Peaks:
    flops: float
    hbm_bw: float
    link_bw: float


# nominal peaks per platform (FLOP/s, HBM bytes/s, link bytes/s).  GPU: the
# NVIDIA H100 80GB HBM3 (SXM) data sheet at its 700 W limit: 3.35 TB/s of
# HBM3, 67 TFLOP/s of float32 (the write program does float32 and integer
# work and no matmul), 450 GB/s of NVLink a direction.  CPU: an
# order-of-magnitude placeholder, as in the reference; probe calibration
# absorbs the error.
NOMINAL_PEAKS: Dict[str, Peaks] = {
    "gpu": Peaks(67e12, 3.35e12, 450e9),
    "cpu": Peaks(1e11, 3e10, 1e10),
}


# where a machine's measured roofline calibration lives; overridable so
# jobs and tests can point the tuner at a specific artifact
ROOFLINE_ARTIFACT_ENV = "REPRO_ROOFLINE_JSON"
DEFAULT_ROOFLINE_ARTIFACT = os.path.join("out", "benchmarks",
                                         "roofline.json")


def platform_of(device: DeviceLike = None) -> str:
    """The reference's platform key of a torch device (``None``: the card,
    as every entry point defaults)."""
    kind = torch.device("cuda" if device is None else device).type
    return "gpu" if kind == "cuda" else kind


def calibrated_peaks(platform: str,
                     path: Optional[str] = None) -> Optional[Peaks]:
    """This machine's measured effective peaks from its roofline artifact:
    its ``calibrated`` section (nominal peaks divided by the fitted model
    scale).  ``None`` (nominal fallback) when the artifact is absent,
    unreadable, for another platform, or carries non-finite or zero rates:
    a corrupt artifact must never poison the tuner."""
    path = path if path is not None else os.environ.get(
        ROOFLINE_ARTIFACT_ENV, DEFAULT_ROOFLINE_ARTIFACT)
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
        cal = doc["calibrated"]
        if cal.get("platform") != platform:
            return None
        peaks = Peaks(float(cal["flops"]), float(cal["hbm_bw"]),
                      float(cal["link_bw"]))
    except (OSError, ValueError, KeyError, TypeError):
        return None
    vals = (peaks.flops, peaks.hbm_bw, peaks.link_bw)
    if not all(math.isfinite(v) and v > 0 for v in vals):
        return None
    return peaks


def platform_peaks(platform: Optional[str] = None) -> Peaks:
    """Peaks for scoring: the machine's calibrated roofline artifact when
    one is present (``calibrated_peaks``), else the nominal platform row.
    ``None`` means the card's platform, ``"gpu"``."""
    if platform is None:
        platform = platform_of(None)
    cal = calibrated_peaks(platform)
    if cal is not None:
        return cal
    return NOMINAL_PEAKS.get(platform, NOMINAL_PEAKS["cpu"])


@dataclasses.dataclass(frozen=True)
class ProgramCost:
    """The dispatched operators' resource use of one candidate's program."""
    flops: float
    hbm_bytes: float
    wire_bytes: float

    def seconds(self, peaks: Peaks, scale: float = 1.0) -> float:
        """Roofline time estimate: bound by the slower of compute/memory,
        plus the collective term; ``scale`` is the probe calibration."""
        t = max(self.flops / peaks.flops, self.hbm_bytes / peaks.hbm_bw)
        return scale * (t + self.wire_bytes / peaks.link_bw)


def program_analysis(shape: Sequence[int], levels: Optional[int],
                     config: RefactorConfig, dtype: str = "float32") -> Dict:
    """``OpAnalysis.summary()`` of one candidate config's fused program,
    counted on a ``meta`` tensor: no probe data and nothing executed.  The
    program runs once before it is counted, so that its per-device tables
    are cached (as they are on the card after a chunk's first write).  The
    backend is ``cuda`` (each kernel one operator) unless the config asks
    for the plain version (``torch``)."""
    from repro_torch.core import decompose as dc
    from repro_torch.core import refactor as rf
    from repro_torch.core import refactor_fused as rff
    from repro_torch.launch.op_analysis import OpAnalysis

    shape = tuple(int(d) for d in shape)
    if levels is None:
        levels = dc.num_levels(shape)
    mag_bits = config.resolved_mag_bits()
    group_planes = tuple(rf._group_plane_split(mag_bits, config.group_size))
    backend = "torch" if config.backend == "torch" else "cuda"
    plan = rff.fused_encode_plan(shape, levels, config.design, mag_bits,
                                 group_planes, backend)
    x = torch.empty(shape, dtype=getattr(torch, dtype), device="meta")
    plan.run(x)
    with OpAnalysis() as ana:
        plan.run(x)
    return ana.summary()


def analyze_config(shape: Sequence[int], levels: Optional[int],
                   config: RefactorConfig, dtype: str = "float32"
                   ) -> ProgramCost:
    """FLOPs / bytes / wire of one candidate config's fused program
    (``program_analysis``)."""
    s = program_analysis(shape, levels, config, dtype)
    return ProgramCost(flops=float(s["flops_per_device"]),
                       hbm_bytes=float(s["hbm_bytes_per_device"]),
                       wire_bytes=float(s["collective_wire_bytes_per_device"]))


class CostModel:
    """Scores candidate configs; calibrates its scale from measured probes.

    ``cost`` caches per program key: configs differing only in pipeline
    knobs (``dispatch_ahead``, thresholds) share one analysis.  ``device``
    picks the peaks' platform (``None``: the card's)."""

    def __init__(self, shape: Sequence[int], levels: Optional[int] = None,
                 dtype: str = "float32", peaks: Optional[Peaks] = None,
                 device: DeviceLike = None):
        self.shape = tuple(int(d) for d in shape)
        self.levels = levels
        self.dtype = dtype
        self.peaks = (peaks if peaks is not None
                      else platform_peaks(platform_of(device)))
        self.scale = 1.0
        self._cache: Dict[Tuple, ProgramCost] = {}

    def cost(self, config: RefactorConfig) -> ProgramCost:
        key = config.program_key()
        if key not in self._cache:
            self._cache[key] = analyze_config(self.shape, self.levels,
                                              config, self.dtype)
        return self._cache[key]

    def score(self, config: RefactorConfig) -> float:
        """Predicted seconds for one chunk through the fused program."""
        return self.cost(config).seconds(self.peaks, self.scale)

    def calibrate(self, config: RefactorConfig, measured_s: float) -> float:
        """Fit ``scale`` so the model's prediction for ``config`` matches a
        measured probe; returns the new scale.  One probe is enough to move
        predictions from nominal-peak units into this machine's units."""
        predicted = self.cost(config).seconds(self.peaks, 1.0)
        if predicted > 0 and measured_s > 0:
            self.scale = measured_s / predicted
        return self.scale
