"""The port's benchmark (sesr_tpu_torch/bench.py) on the CPU at a small
frame: every row times the function the JAX package computes (each row's
forward, run on the CPU, array_equal with its JAX counterpart on the same
input), each artifact serves in the mode JAX's select_packed_forward picks,
one run prints exactly one JSON line, and a row that raises is not caught.
The timings themselves are the card's (chip_smoke.py phase 13)."""

import dataclasses
import json
import os
import statistics

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sesr_tpu.config import spec_for_task as jspec_for_task
from sesr_tpu.ops.packed import (packed_fast_forward, packed_hybrid_forward,
                                 select_packed_forward)
from sesr_tpu.quant.integer import integer_forward as jinteger_forward
from sesr_tpu.quant.params import QuantParams as JQuantParams
from sesr_tpu_torch import bench
from tests.test_torch_params import one_torch_thread  # noqa: F401 (fixture)

H, W = 24, 32
# the rows of a run with --per-task and --all-paths at H x W, in order
DEFAULT_ROWS = ["sr_x2 24x32 batch 1 f32", "sr_x2 24x32 batch 8 f32",
                "sr_x2 48x64 batch 1 int8"]
PER_TASK_ROWS = [f"per-task {t} 24x32 batch 1 f32" for t in bench.PER_TASK]
ALL_PATH_ROWS = ["sr_x2 24x32 batch 4 f32", "sr_x2 24x32 batch 1 int8",
                 "sr_x2 48x64 batch 1 f32", "sr_x2 24x32 batch 1 f32 reference-exact",
                 "sr_x2 24x32 batch 1 f32 pe-exact", "nr 24x32 batch 1 f32",
                 "nr 24x32 batch 1 f32 pe-exact"]


@pytest.fixture(scope="module")
def rows():
    built = bench.make_rows("cpu", H, W, all_paths=True, per_task=True)
    assert [r.name for r in built] == DEFAULT_ROWS + PER_TASK_ROWS + ALL_PATH_ROWS
    return {r.name: r for r in built}


def _jax_artifact(task):
    return (jspec_for_task(task.removesuffix("_qat")),
            JQuantParams.load(os.path.join(bench.ARTIFACTS, f"qparams_{task}.npz")))


def _jax_forward(row, task):
    """The JAX package's counterpart of ``row``'s forward."""
    jspec, jqp = _jax_artifact(task)
    if row.mode == "fast":
        return lambda x: packed_fast_forward(jspec, jqp, x, out_dtype=row.out_dtype)
    if row.mode == "hybrid":
        return lambda x: packed_hybrid_forward(jspec, jqp, x, out_dtype=row.out_dtype)
    if row.mode == "pe-exact":
        mode, fwd = select_packed_forward(
            dataclasses.replace(jqp, fast_cert_ok=False, fast_cert_layers=None))
        assert mode == "pe-exact"
        return lambda x: fwd(jspec, jqp, x, out_dtype=row.out_dtype)
    assert row.mode == "reference-exact" and row.out_dtype == "f32"
    return lambda x: jinteger_forward(jspec, jqp, x, corrected=False)[0]


@pytest.mark.parametrize("name", DEFAULT_ROWS + PER_TASK_ROWS + ALL_PATH_ROWS)
def test_row_times_the_jax_function(rows, name):
    """The forward each row times, on the CPU on the row's own seeded
    input, equals the JAX package's."""
    row = rows[name]
    assert row.task == name.removeprefix("per-task ").split()[0]
    assert row.x.device.type == "cpu"
    got = row()
    assert got.dtype == (torch.int8 if row.out_dtype == "int8" else torch.float32)
    want = np.asarray(_jax_forward(row, row.task)(jnp.asarray(row.x.numpy())))
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("task", bench.PER_TASK)
def test_per_task_mode_is_jax_mode(rows, task):
    row = rows[f"per-task {task} 24x32 batch 1 f32"]
    jmode = select_packed_forward(_jax_artifact(task)[1])[0]
    assert row.mode == jmode
    assert row.mode == ("hybrid" if task in ("nr", "nrdm_6") else "fast")


def test_forced_rows_run_their_datapath(rows):
    """The rows that do not serve the certificate's mode: K1's reference-exact
    forward and the corrected kernel's PE-exact mode, each naming its
    kernel."""
    assert rows["sr_x2 24x32 batch 1 f32 reference-exact"].kernel is bench.pe_exact_net
    for name in ("sr_x2 24x32 batch 1 f32 pe-exact", "nr 24x32 batch 1 f32 pe-exact",
                 "nr 24x32 batch 1 f32"):
        assert rows[name].kernel is bench.corrected_net
    for name in DEFAULT_ROWS:
        assert rows[name].kernel is bench.fast_net


def test_run_prints_one_json_line(capsys):
    res = bench.run_bench(device="cpu", height=H, width=W, repeats=2, calls=2)
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert set(result) == {"metric", "value", "unit", "vs_baseline"}
    head = res.rows[0]
    assert head.name == DEFAULT_ROWS[0] and [r.name for r in res.rows] == DEFAULT_ROWS
    assert result == res.result
    assert result["value"] == head.median_mpxs == statistics.median(head.mpxs)
    assert len(head.samples_ms) == 2 and head.calls == 2 * 3
    assert result["unit"] == "Mpixel/s" and result["vs_baseline"] > 0
    assert result["vs_baseline"] == result["value"] / res.baseline_mpxs
    assert "fast deployment datapath" in result["metric"] and result["metric"].endswith(
        "24x32 input, cpu")
    for row in res.rows:
        assert f"bench: {row.name} (fast, plain PyTorch): samples" in err
    assert "device not measured on cpu" in err and "bench: card: cpu" in err
    assert "12x16 crop of the headline input" in err


def test_failing_row_is_not_caught(monkeypatch, capsys):
    def boom(*args, **kwargs):
        raise RuntimeError("row failed")

    monkeypatch.setitem(bench.FORCED, "reference-exact", boom)
    with pytest.raises(RuntimeError, match="row failed"):
        bench.run_bench(device="cpu", height=H, width=W, repeats=1, calls=1, all_paths=True)
    assert capsys.readouterr().out == ""
