"""The port's QuantParams (sesr_tpu_torch/quant/params.py): the artifact
format in both directions with the JAX package, and the golden exact tier
(weights, scales, zeros, requant constants, fused bias) on the
reference-generated goldens of all ten bundles."""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

from sesr_tpu.quant.params import QuantParams as JQuantParams
from sesr_tpu_torch.config import spec_for_task
from sesr_tpu_torch.quant import params as tparams
from sesr_tpu_torch.quant.params import QuantParams
from tests.test_integer_bitexact import SPEC_TASK, _load_golden

ARTIFACTS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), os.pardir,
                                          "artifacts", "qparams_*.npz")))
SIM_GOLDENS = ["nrdm_3", "sr_x4", "sr_x2", "nrdm_3_qat", "sr_x4_qat", "sr_x2_qat"]
# with the bundles of the graph_add compositions (tests/test_torch_residual.py)
GOLDENS = SIM_GOLDENS + ["nr", "dm", "nr_qat", "dm_qat"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for torch in a test module: the suite runs six
    xdist workers on the machine's cores, and torch's default of one
    thread per core in each of them oversubscribes it several times over.
    The caller's count comes back after the module. Port test modules
    import this fixture."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same(a, b):
    """Field-by-field equality of two QuantParams (either package)."""
    for f in dataclasses.fields(JQuantParams):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name in ("w_int", "bias_f", "bias_int"):
            assert len(va) == len(vb), f.name
            for x, y in zip(va, vb):
                assert x.dtype == y.dtype, f.name
                np.testing.assert_array_equal(x, y, err_msg=f.name)
        elif f.name == "hw":
            assert dataclasses.asdict(va) == dataclasses.asdict(vb)
        else:
            assert va == vb, f.name


def test_artifacts_present():
    assert len(ARTIFACTS) == 7


@pytest.mark.parametrize("path", ARTIFACTS, ids=os.path.basename)
def test_round_trip_both_directions(path, tmp_path):
    t = QuantParams.load(path)
    j = JQuantParams.load(path)
    _same(t, j)
    assert (t.cert_grade, t.cert_stamps) == (j.cert_grade, j.cert_stamps)
    assert [t.effective_zero(i) for i in range(t.num_convs)] == \
        [j.effective_zero(i) for i in range(j.num_convs)]
    for i in range(t.num_convs):
        np.testing.assert_array_equal(t.fused_bias(i), j.fused_bias(i))
    # port writes, JAX reads; JAX writes, port reads (literal suffixless paths)
    t.save(str(tmp_path / "by_port"))
    _same(JQuantParams.load(str(tmp_path / "by_port")), t)
    j.save(str(tmp_path / "by_jax"))
    _same(QuantParams.load(str(tmp_path / "by_jax")), j)


def test_legacy_cert_cells_default(tmp_path):
    """An artifact stamped before the geometry record existed loads with
    the geometry set its certification ran; an unstamped one with None."""
    src = QuantParams.load(ARTIFACTS[0])
    for stamped in (True, False):
        qp = dataclasses.replace(src, cert_cells=None,
                                 fast_cert_layers=(True,) * src.num_convs
                                 if stamped else None)
        path = str(tmp_path / f"legacy_{stamped}.npz")
        qp.save(path)
        with np.load(path) as d:
            meta = json.loads(str(d["__meta__"]))
            arrays = {k: d[k] for k in d.files if k != "__meta__"}
        meta.pop("cert_cells")
        with open(path, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta), **arrays)
        t, j = QuantParams.load(path), JQuantParams.load(path)
        assert t.cert_cells == j.cert_cells == \
            (tparams.LEGACY_CERT_CELLS if stamped else None)


def test_effective_zero_floor_and_raw_fused_bias():
    qp = QuantParams.load(ARTIFACTS[0])
    jqp = JQuantParams.load(ARTIFACTS[0])
    az = list(qp.a_zero)
    az[1], az[2] = -131, 7
    t = dataclasses.replace(qp, a_zero=az)
    j = dataclasses.replace(jqp, a_zero=az)
    assert t.effective_zero(1) == j.effective_zero(1) == -128
    assert t.effective_zero(2) == j.effective_zero(2) == 7
    for i in (1, 2):
        np.testing.assert_array_equal(t.fused_bias(i), j.fused_bias(i))


def _port_golden_qparams(task, g):
    """The port's QuantParams from the golden float weights and min/max."""
    spec = spec_for_task(SPEC_TASK.get(task, task))
    L = int(g["num_convs"])
    weights = [np.transpose(g[f"w_collapsed_{i}"], (2, 3, 1, 0)) for i in range(L)]
    biases = [np.asarray(g[f"b_collapsed_{i}"]) for i in range(L)]
    w_int, w_scale = tparams.quantize_weights(weights)
    calib = tparams.CalibState.fresh(L + 1)
    for d in range(L + 1):
        calib.update(d, float(g[f"min_val_{d}"]), float(g[f"max_val_{d}"]))
    return tparams.finalize(spec, w_int, w_scale, biases, calib)


@pytest.mark.parametrize("task", GOLDENS)
def test_golden_exact_tier(task):
    g = _load_golden(task)
    qp = _port_golden_qparams(task, g)
    L = qp.num_convs
    for i in range(L):
        assert qp.w_scale[i] == float(g[f"w_scale_{i}"]), i
        np.testing.assert_array_equal(np.transpose(qp.w_int[i], (3, 2, 0, 1)),
                                      g[f"w_int_{i}"], err_msg=f"conv {i}")
        assert qp.requant_m[i] == int(g[f"requan_m_{i}"]), i
        assert qp.requant_n[i] == int(g[f"requan_n_{i}"]), i
        np.testing.assert_array_equal(qp.fused_bias(i),
                                      g[f"bias_quan_{i}"].reshape(-1),
                                      err_msg=f"conv {i}")
    for d in range(L + 1):
        assert qp.a_scale[d] == float(g[f"a_scale_{d}"]), d
        assert qp.a_zero[d] == int(g[f"a_zero_{d}"]), d
    assert qp.res_requant_m == int(g["res_requant_m"])
    assert qp.res_requant_n == int(g["res_requant_n"])


def test_asym_sym_and_degenerate_domain():
    from sesr_tpu.quant import params as jparams
    for lo, hi in ((0.0, 1.0), (-0.37, 2.5), (0.08, 1.0), (-3.0, -0.5)):
        assert tparams.asym_qparams(lo, hi, 8) == jparams.asym_qparams(lo, hi, 8)
    assert tparams.sym_qparams(0.73, 8) == jparams.sym_qparams(0.73, 8)
    with pytest.raises(ValueError, match="degenerate"):
        tparams.asym_qparams(0.5, 0.5, 8)
    for L in (5, 8):
        assert [tparams.requant_target_domain(i, L) for i in range(L)] == \
            [jparams.requant_target_domain(i, L) for i in range(L)]
