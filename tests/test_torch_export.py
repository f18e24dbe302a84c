"""The port's RTL test-vector exporters (sesr_tpu_torch/export/): every
exporter against the reference-generated text files of the ten golden
bundles, the whole output_txt/ tree against sesr_tpu.export.vectors on
the shipped artifacts, the vectorized hex formatter against int_to_hex,
and the import boundary of the new modules."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from sesr_tpu.config import spec_for_task as jspec_for_task
from sesr_tpu.export import vectors as jvectors
from sesr_tpu.ops.fixedpoint import int_to_hex as jint_to_hex
from sesr_tpu.quant.integer import integer_forward as jinteger_forward
from sesr_tpu.quant.params import QuantParams as JQuantParams
from sesr_tpu_torch.config import spec_for_task
from sesr_tpu_torch.export import hexfmt
from sesr_tpu_torch.export.vectors import (export_all, export_end2end, export_input_tiles,
                                           export_param_buf, export_pe_add, export_pe_out,
                                           export_requant_shifts, export_weights)
from sesr_tpu_torch.ops.fixedpoint import int_to_hex
from sesr_tpu_torch.quant.integer import integer_forward
from sesr_tpu_torch.quant.params import QuantParams
from tests.test_integer_bitexact import (GOLDEN_TASKS, RESIDUAL_MODE, SPEC_TASK,
                                         _load_golden, _qat_bounds)
from tests.test_torch_params import _port_golden_qparams
from tests.test_torch_params import one_torch_thread  # noqa: F401 (fixture)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
TASKS = ["nr", "dm", "nrdm_3", "nrdm_6", "sr_x4", "sr_x2"]
EXPORTERS = ["weights", "input_tiles", "param_buf", "pe_out", "pe_add",
             "requant_shifts", "end2end"]


def _golden_run(task):
    """(golden bundle, spec, port QuantParams, host dumps) of the bundle's
    fixture through the port's interpreter in the bundle's residual mode."""
    g = _load_golden(task)
    spec = spec_for_task(SPEC_TASK.get(task, task))
    qp = _port_golden_qparams(task, g)
    _, dumps = integer_forward(spec, qp, g["fixture"].transpose(0, 2, 3, 1),
                               collect_dumps=True, device="cpu",
                               residual_mode=RESIDUAL_MODE.get(task, "sim"),
                               qat_add_bounds=_qat_bounds(task, g))
    return g, spec, qp, {k: v.numpy() for k, v in dumps.items()}


def _ref(g, key):
    return bytes(g[f"txt:output_txt/{key}"])


@pytest.mark.parametrize("exporter", EXPORTERS)
@pytest.mark.parametrize("task", GOLDEN_TASKS)
def test_golden_text_files(task, exporter):
    """Every golden text file of the exporter's, byte for byte (the
    checks of tests/test_export.py, on the port)."""
    g, spec, qp, dumps = _golden_run(task)
    L = qp.num_convs
    if exporter == "weights":
        mine = export_weights(qp)
        want = {f"conv.weight.{i}.txt": _ref(g, f"weight/conv.weight.{i}.txt")
                for i in range(L)}
    elif exporter == "input_tiles":
        mine = export_input_tiles(qp, dumps, list(spec.kernel_sizes))
        want = {f"input.{d}.txt": _ref(g, f"input/input.{d}.txt") for d in range(L + 1)}
    elif exporter == "param_buf":
        mine, want = {"p": export_param_buf(qp)}, {"p": _ref(g, "bias/param_buf.txt")}
    elif exporter == "pe_out":
        mine = export_pe_out(qp, dumps)
        want = {f"pe_output{i}_{p}.txt": _ref(g, f"pe_out/pe_output{i}_{p}.txt")
                for i in range(L) for p in range(4)}
    elif exporter == "pe_add":
        mine = export_pe_add(qp, dumps)
        want = {f"pe_add_output{i}.txt": _ref(g, f"pe_add/pe_add_output{i}.txt")
                for i in range(L)}
    elif exporter == "requant_shifts":
        mine = {"r": export_requant_shifts(qp)}
        want = {"r": _ref(g, "requan_shift_n/requan_shift_n.txt")}
        if "upstream_output_crash" in g:
            # sr_x2_qat: res_requant_n is -1; upstream's output.py crashed
            # on that last write, and the golden holds the prefix before
            # it; the value is its two's complement at 5 bits
            assert "format code 'x'" in bytes(g["upstream_output_crash"]).decode()
            assert qp.res_requant_n == -1
            want["r"] += b"1f"
    else:
        mine = export_end2end(qp, dumps)
        want = {f"input.{d}.txt": bytes(g[f"e2e_txt:output_txt/input/input.{d}.txt"])
                for d in (0, L)}
    assert sorted(mine) == sorted(want)
    for name in want:
        assert mine[name] == want[name], name


def _tree(root):
    files = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                files[os.path.relpath(path, root)] = f.read()
    return files


@pytest.mark.parametrize("shape", [(40, 64), (33, 47)])
@pytest.mark.parametrize("task", TASKS)
def test_tree_matches_jax(tmp_path, task, shape):
    """export_all on a shipped artifact: the same files, byte for byte, as
    sesr_tpu.export.vectors.export_all (W = 64 is a multiple of the tile,
    33 x 47 is ragged in both)."""
    path = os.path.join(REPO, "artifacts", f"qparams_{task}.npz")
    spec = spec_for_task(task)
    x = np.random.default_rng(23).random((1,) + shape + (spec.in_channels,),
                                         dtype=np.float32)
    qp = QuantParams.load(path)
    _, dumps = integer_forward(spec, qp, x, collect_dumps=True, device="cpu")
    written = export_all(qp, {k: v.numpy() for k, v in dumps.items()},
                         list(spec.kernel_sizes), str(tmp_path / "port"))
    jqp = JQuantParams.load(path)
    _, jdumps = jinteger_forward(jspec_for_task(task), jqp, jnp.asarray(x),
                                 collect_dumps=True)
    jvectors.export_all(jqp, jdumps, list(spec.kernel_sizes), str(tmp_path / "jax"))
    port, jax = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(port) == sorted(jax)
    assert len(written) == len(port) == 7 * spec.num_convs + 5
    for name in jax:
        assert port[name] == jax[name], name


def test_tile_streams_at_tile_multiples():
    """A height that is a multiple of the tile (the input stream's last
    height block of domain 0 then holds no rows) and a width of one tile:
    the tile and end-to-end streams equal the JAX package's."""
    path = os.path.join(REPO, "artifacts", "qparams_nr.npz")
    spec = spec_for_task("nr")
    x = np.random.default_rng(4).random((1, 64, 32, 3), dtype=np.float32)
    qp, jqp = QuantParams.load(path), JQuantParams.load(path)
    _, dumps = integer_forward(spec, qp, x, collect_dumps=True, device="cpu")
    dumps = {k: v.numpy() for k, v in dumps.items()}
    mine = export_input_tiles(qp, dumps, list(spec.kernel_sizes))
    want = jvectors.export_input_tiles(jqp, dumps, list(spec.kernel_sizes))
    assert mine["input.0.txt"].startswith(b"20\n03\n")
    assert {k: v.encode() for k, v in want.items()} == mine
    assert {k: v.encode() for k, v in jvectors.export_end2end(jqp, dumps).items()} == \
        export_end2end(qp, dumps)
    assert export_pe_add(qp, dumps) == {
        k: v.encode() for k, v in jvectors.export_pe_add(jqp, dumps).items()}


@settings(max_examples=60, deadline=None, database=None)
@given(bits=st.sampled_from([5, 8, 16, 18, 20]), data=st.data())
def test_hexfmt_equals_int_to_hex(bits, data):
    """Every value in [-2^bits, 16^digits) formats as int_to_hex does (the
    JAX package's and the port's); one outside raises."""
    d = hexfmt.digits_of(bits)
    lo, hi = -(1 << bits), 16 ** d - 1
    values = data.draw(st.lists(st.integers(lo, hi), min_size=1, max_size=40))
    as_float = data.draw(st.booleans())
    arr = np.array(values, np.float64 if as_float else np.int64)
    cells = hexfmt.hex_cells(arr, bits)
    assert cells.shape == (len(values), d)
    for v, row in zip(values, cells):
        assert row.tobytes().decode() == jint_to_hex(v, bits) == int_to_hex(v, bits)
    rows = hexfmt.hex_rows(arr.reshape(1, -1), bits)
    assert rows.tobytes().decode() == "".join(jint_to_hex(v, bits) for v in values) + "\n"
    bad = data.draw(st.one_of(st.integers(-(1 << 40), lo - 1), st.integers(hi + 1, 1 << 40)))
    with pytest.raises(ValueError):
        hexfmt.hex_cells(np.array(values + [bad]), bits)


def test_hexfmt_refuses_non_integers():
    for bad in ([0.5], [np.nan], [np.inf], ["7"]):
        with pytest.raises(ValueError):
            hexfmt.hex_cells(np.array(bad), 8)
    assert hexfmt.hex_cells(np.array([-3.0, 4.0]), 8).tobytes() == b"fd04"
    assert hexfmt.header(400) == b"190\n" and hexfmt.header(3) == b"03\n"


def test_export_modules_import_neither_jax_nor_the_jax_package():
    code = ("import sys, sesr_tpu_torch.export.hexfmt, sesr_tpu_torch.export.vectors, "
            "sesr_tpu_torch.models.experimental, sesr_tpu_torch.quant.observers, "
            "sesr_tpu_torch.data.datasets, sesr_tpu_torch.cli\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'sesr_tpu', 'tools', 'native', 'matplotlib'))\n"
            "assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
