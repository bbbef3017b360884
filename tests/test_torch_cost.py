"""The port's roofline cost model (``repro_torch.tune.cost``) against the
reference's (``repro.tune.cost``), on the CPU.

What is held (mirroring ``tests/test_tune.py``'s cost-model tests):
* one real analysis: ``CostModel((256,), levels=1)`` counts the fused
  program on ``meta`` with a nonzero memory term (no FLOPs: the encode
  chain is bitwise and elementwise), ``calibrate`` rescales predictions to
  a measured time, and configs that differ only in pipeline knobs share
  the cached cost;
* the model's count is ``OpAnalysis``'s of the same program run for real
  on the CPU (the plain backend), and on ``meta`` with ``backend="cuda"``
  it holds one operator a kernel launch, the kernels' fakes;
* the roofline formula, the nominal GPU row (the H100's data sheet) and the
  platform keys;
* ``calibrated_peaks``/``platform_peaks`` decide as the reference's on the
  same artifact documents: calibrated on the CPU, nominal for another
  platform, for a corrupt file, for zero rates and without a file.
Tolerance: none.
"""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.tune import cost as jc  # noqa: E402
from repro_torch.core import decompose as dc  # noqa: E402
from repro_torch.core import refactor as rf  # noqa: E402
from repro_torch.core import refactor_fused as rff  # noqa: E402
from repro_torch.launch.op_analysis import OpAnalysis  # noqa: E402
from repro_torch.tune import cost as tc  # noqa: E402
from repro_torch.tune.config import DEFAULT_CONFIG  # noqa: E402

torch.set_num_threads(1)


def test_cost_model_real_program():
    m = tc.CostModel((256,), levels=1)
    cost = m.cost(DEFAULT_CONFIG)
    assert cost.hbm_bytes > 0 and cost.flops == 0 and cost.wire_bytes == 0
    before = m.score(DEFAULT_CONFIG)
    assert before > 0
    m.calibrate(DEFAULT_CONFIG, measured_s=before * 10)
    assert m.score(DEFAULT_CONFIG) == pytest.approx(before * 10)
    assert m.scale == pytest.approx(10)
    # pipeline-knob-only variants share the analysis cache
    assert m.cost(DEFAULT_CONFIG.replace(dispatch_ahead=4)) is cost
    assert m.cost(DEFAULT_CONFIG.replace(depth=4, size_threshold=1)) is cost
    assert m.cost(DEFAULT_CONFIG.replace(design="shuffle")) is not cost


def _plan(shape, cfg, backend):
    levels = dc.num_levels(shape)
    mag_bits = cfg.resolved_mag_bits()
    return rff.fused_encode_plan(
        shape, levels, cfg.design, mag_bits,
        tuple(rf._group_plane_split(mag_bits, cfg.group_size)), backend)


@pytest.mark.parametrize("design", ["register_block", "locality", "shuffle"])
def test_the_model_counts_what_the_program_runs(design):
    """The plain backend's cost equals ``OpAnalysis`` of the program run for
    real on the CPU; the card's (``cuda`` on ``meta``) holds each bitplane
    encode as one kernel operator (a sign and a magnitude encode a size
    bucket) in place of the plain version's operators."""
    shape = (40, 36)
    cfg = DEFAULT_CONFIG.replace(design=design)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=shape).astype(np.float32))
    plan = _plan(shape, cfg, "torch")
    plan.run(x)
    with OpAnalysis() as ana:
        plan.run(x)
    plain = tc.CostModel(shape, device="cpu").cost(cfg.replace(
        backend="torch"))
    assert plain.hbm_bytes == ana.summary()["hbm_bytes_per_device"]
    assert plain.flops == ana.summary()["flops_per_device"] == 0

    xm = x.to("meta")
    kplan = _plan(shape, cfg, "cuda")
    kplan.run(xm)
    with OpAnalysis() as ana:
        kplan.run(xm)
    ops = ana.summary()["ops_by_name"]
    symbol = {"register_block": "rb_encode", "locality": "loc_encode",
              "shuffle": "shuffle_encode"}[design]
    n_buckets = len({e.n_words for e in kplan.entries})
    assert ops[f"repro_torch.{symbol}.default"]["count"] == 2 * n_buckets
    assert tc.CostModel(shape).cost(cfg).hbm_bytes == \
        ana.summary()["hbm_bytes_per_device"]


def test_roofline_seconds_and_the_nominal_gpu_row():
    p = tc.Peaks(flops=2.0, hbm_bw=4.0, link_bw=8.0)
    assert tc.ProgramCost(10.0, 12.0, 16.0).seconds(p) == 5.0 + 2.0
    assert tc.ProgramCost(2.0, 40.0, 0.0).seconds(p, scale=3.0) == 30.0
    # NVIDIA H100 80GB HBM3 (SXM) at 700 W: HBM3, float32, NVLink a way
    assert tc.NOMINAL_PEAKS["gpu"] == tc.Peaks(67e12, 3.35e12, 450e9)
    assert set(tc.NOMINAL_PEAKS) == {"gpu", "cpu"}
    ref_cpu = jc.NOMINAL_PEAKS["cpu"]
    assert tc.NOMINAL_PEAKS["cpu"] == tc.Peaks(ref_cpu.flops, ref_cpu.hbm_bw,
                                                ref_cpu.link_bw)
    assert tc.platform_of("cuda") == tc.platform_of(None) == "gpu"
    assert tc.platform_of("cpu") == "cpu"
    assert tc.CostModel((64,), device="cpu").peaks == tc.platform_peaks("cpu")
    assert math.isfinite(tc.CostModel((64,)).score(DEFAULT_CONFIG))


def _same_decision(platform):
    """The port's and the reference's reading of the current artifact:
    both calibrated to the same rates, or both nominal."""
    got, want = tc.calibrated_peaks(platform), jc.calibrated_peaks(platform)
    if want is None:
        assert got is None
        assert tc.platform_peaks(platform) == tc.NOMINAL_PEAKS[platform]
    else:
        assert (got.flops, got.hbm_bw, got.link_bw) == (
            want.flops, want.hbm_bw, want.link_bw)
        assert tc.platform_peaks(platform) == got
    return got


def test_platform_peaks_calibrated_from_roofline_artifact(tmp_path,
                                                          monkeypatch):
    assert tc.ROOFLINE_ARTIFACT_ENV == jc.ROOFLINE_ARTIFACT_ENV
    assert tc.DEFAULT_ROOFLINE_ARTIFACT == jc.DEFAULT_ROOFLINE_ARTIFACT
    art = tmp_path / "roofline.json"
    art.write_text(json.dumps({"calibrated": {
        "platform": "cpu", "scale": 2.0,
        "flops": 5e10, "hbm_bw": 1.5e10, "link_bw": 5e9}}))
    monkeypatch.setenv(tc.ROOFLINE_ARTIFACT_ENV, str(art))
    p = _same_decision("cpu")
    assert (p.flops, p.hbm_bw, p.link_bw) == (5e10, 1.5e10, 5e9)
    # another platform's artifact must not apply
    assert _same_decision("gpu") is None
    # corrupt artifact -> nominal, never an exception
    art.write_text("{not json")
    assert _same_decision("cpu") is None
    # zero/non-finite rates are unusable -> nominal
    for bad in (0.0, float("nan"), -1.0):
        art.write_text(json.dumps({"calibrated": {
            "platform": "cpu", "flops": bad, "hbm_bw": 1e9,
            "link_bw": 1e9}}))
        assert _same_decision("cpu") is None
    # a GPU artifact calibrates the port's card as the reference's GPU
    art.write_text(json.dumps({"calibrated": {
        "platform": "gpu", "flops": 3e13, "hbm_bw": 2e12, "link_bw": 1e11}}))
    assert _same_decision("gpu") == tc.Peaks(3e13, 2e12, 1e11)
    assert tc.CostModel((64,)).peaks == tc.Peaks(3e13, 2e12, 1e11)
    # absent artifact -> nominal
    monkeypatch.delenv(tc.ROOFLINE_ARTIFACT_ENV)
    monkeypatch.chdir(tmp_path)
    assert _same_decision("cpu") is None
