"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: a cell's
step run once as rank 0 of a fake world (``torch.distributed``'s ``fake``
backend, ``meta`` tensors), each cell in a process of its own.

What is held:
* the counterpart of the reference's ``test_mini_dryrun_all_step_kinds``
  (``tests/test_distributed.py``): jamba's and deepseek-v2-236b's smoke
  configs on a fake (2, 2, 2) ('pod', 'data', 'model') world, the train,
  prefill and decode steps all ``ok``, with argument bytes, FLOPs, HBM
  bytes, temp bytes and wire bytes with the largest calls;
* the analysis's own cost: no mini cell's wall more than doubles against
  the same cell run under no mode (``analysis=False``), the two run back
  to back in one worker (which first alternating from cell to cell), so
  that both see the same load;
* the dry run against a real run: jamba's smoke (its batch of 5, which
  ``cell_policy`` cannot cut over 'model', so that the steps compute over
  'model' on the blocks) on a fake (1, 2) world and on a real 2-rank gloo
  world running the same step on real tensors (``measure(fake=False)``
  through ``tests/_torch_dist_worker.py``): the argument bytes, ``WIRE``
  by kind, the FLOPs (by operator), the HBM bytes, the temp bytes and the
  largest collectives (``launch.op_analysis``) equal, for each step
  kind;
* the records: a skipped cell is written as the reference writes it, a
  cell past its wall limit is ``timeout``, a cell that raises is ``fail``
  with its error.
"""
import json
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import dryrun  # noqa: E402

from _torch_dist_worker import run_world  # noqa: E402

torch.set_num_threads(1)

KINDS = [("train", 8, 32), ("prefill", 4, 64), ("decode", 8, 64)]
MINI = ("jamba-v0.1-52b", "deepseek-v2-236b")
REAL = ("jamba-v0.1-52b", [("train", 5, 16), ("prefill", 5, 16),
                           ("decode", 5, 16)])


def _mini_spec(arch, kind, b, s):
    return dryrun.cell_spec(arch, kind, "mini", smoke=True,
                            shape_dims=(kind, s, b),
                            mesh_dims=((2, 2, 2), ("pod", "data", "model")))


def _real_spec(kind, b, s):
    return dryrun.cell_spec(REAL[0], kind, "pair", smoke=True,
                            shape_dims=(kind, s, b),
                            mesh_dims=((1, 2), ("data", "model")))


def _twins(spec, bare_first):
    """A mini cell and its twin under no mode, back to back in this
    worker: {"mini": record, "bare": record}."""
    order = ("bare", "mini") if bare_first else ("mini", "bare")
    specs = {"mini": spec, "bare": dict(spec, analysis=False)}
    return {which: dryrun.run_spec(specs[which], 600) for which in order}


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    minis = [(a, k, _mini_spec(a, k, b, s)) for a in MINI
             for k, b, s in KINDS]
    specs = {("pair", k): _real_spec(k, b, s) for k, b, s in REAL[1]}
    with ThreadPoolExecutor(4) as ex:
        twins = {(a, k): ex.submit(_twins, spec, i % 2 == 1)
                 for i, (a, k, spec) in enumerate(minis)}
        futs = {key: ex.submit(dryrun.run_spec, spec, 600)
                for key, spec in specs.items()}
        real = ex.submit(run_world, 2, [
            ("dryrun_real", (1, 2), dict(spec=_real_spec(k, b, s)))
            for k, b, s in REAL[1]], tmp)
        out = {key: f.result() for key, f in futs.items()}
        for (a, k), f in twins.items():
            got = f.result()
            out[("mini", a, k)], out[("bare", a, k)] = got["mini"], got["bare"]
        out["real"] = real.result()
    return out


@pytest.mark.parametrize("kind", [k[0] for k in KINDS])
@pytest.mark.parametrize("arch", MINI)
def test_mini_dryrun_all_step_kinds(cells, arch, kind):
    rec = cells[("mini", arch, kind)]
    assert rec["status"] == "ok", rec.get("traceback", rec)
    mem = rec["memory"]
    assert mem["argument_bytes"] > 0
    assert mem["temp_bytes"] > 0
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert rec["flops_per_device"] > 0
    assert rec["hbm_bytes_per_device"] > 0
    assert rec["collectives"]["wire_bytes_per_device"] > 0
    top = rec["collectives"]["top"]
    assert 0 < len(top) <= 12 and top[0]["wire_bytes"] > 0
    assert [c["wire_bytes"] for c in top] == sorted(
        (c["wire_bytes"] for c in top), reverse=True)
    assert rec["policy"]["batch_axes"]


@pytest.mark.parametrize("kind", [k[0] for k in KINDS])
@pytest.mark.parametrize("arch", MINI)
def test_the_analysis_at_most_doubles_a_mini_cell_s_wall(cells, arch, kind):
    rec, bare = cells[("mini", arch, kind)], cells[("bare", arch, kind)]
    assert bare["status"] == "ok", bare.get("traceback", bare)
    assert "flops_per_device" not in bare
    assert bare["memory"]["argument_bytes"] == \
        rec["memory"]["argument_bytes"]
    assert rec["wall_s"] <= 2 * bare["wall_s"], (rec["wall_s"],
                                                 bare["wall_s"])


@pytest.mark.parametrize("kind", [k[0] for k in REAL[1]])
def test_fake_world_predicts_the_real_run(cells, kind):
    """Each rank of the real 2-rank world against the fake world's rank 0:
    the same argument bytes (each argument), ``WIRE`` (calls and bytes of
    each kind), FLOPs (each operator's), HBM bytes, temp bytes and the
    largest collectives."""
    fake = cells[("pair", kind)]
    assert fake["status"] == "ok", fake.get("traceback", fake)
    assert fake["policy"]["batch_axes"] == ["data"]    # 'model' computes
    i = [k for k, _, _ in REAL[1]].index(kind)
    for rank in cells["real"]:
        real = rank[i]
        assert real["memory"]["by_argument"] == \
            fake["memory"]["by_argument"]
        assert real["collectives"]["by_kind"] == \
            fake["collectives"]["by_kind"]
        assert real["flops_by_op"] == fake["flops_by_op"]
        assert real["flops_per_device"] == fake["flops_per_device"]
        assert real["hbm_bytes_per_device"] == fake["hbm_bytes_per_device"]
        assert real["memory"]["temp_bytes"] == fake["memory"]["temp_bytes"]
        assert real["collectives"]["top"] == fake["collectives"]["top"]
    assert fake["memory"]["temp_bytes"] > 0
    assert fake["collectives"]["top"]
    assert any(k.startswith("tp_") for k in fake["collectives"]["by_kind"])


def test_a_skipped_cell_is_written(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    rec = dryrun.run_cell("qwen2-7b", "long_500k", "single")
    assert rec["status"] == "skip" and "long_500k" in rec["reason"]
    path = tmp_path / "torch__qwen2-7b__long_500k__single.json"
    assert json.loads(path.read_text()) == rec
    assert dryrun.run_cell("qwen2-7b", "long_500k", "single") == rec


def test_a_cell_past_its_wall_limit_is_a_timeout():
    rec = dryrun.run_spec(_mini_spec(MINI[0], *KINDS[0]), timeout=0.5)
    assert rec["status"] == "timeout"


def test_a_cell_that_raises_is_a_failure():
    spec = dict(_mini_spec(MINI[0], *KINDS[0]), opts=["micro3"])
    rec = dryrun.run_spec(spec, timeout=600)
    assert rec["status"] == "fail"
    assert "microbatches" in rec["error"], rec["error"]


def test_list_prints_every_cell(capsys):
    dryrun.main(["--list", "--arch", "qwen2-7b"])
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"qwen2-7b {s}" for s in
                     ("train_4k", "prefill_32k", "decode_32k", "long_500k")]
