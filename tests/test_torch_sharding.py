"""The port's sharded execution (sesr_tpu_torch/parallel/tiling.py) on gloo
ranks, held against the JAX package on the same numpy inputs: the mirror
of tests/test_sharding.py on layouts of at most four ranks.

Two worlds (four ranks, then two) each start once for the module and run
every check of their layouts (tests/test_torch_ranks.py ``sharding_world``);
each check is then one case here. The JAX side runs monolithic in this
process. Integer outputs must be array_equal, the float forward within the
JAX test's 1e-5, calibration's scales within rel 1e-6.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from sesr_tpu.config import spec_for_task as jspec_for_task
from sesr_tpu.models.sesr import CollapsedParams as JCollapsedParams
from sesr_tpu.models.sesr import forward_float as jforward_float
from sesr_tpu.ops.packed import select_packed_forward
from sesr_tpu.quant.calibrate import calibrate as jcalibrate
from sesr_tpu.quant.integer import integer_forward as jinteger_forward
from sesr_tpu.quant.params import QuantParams as JQuantParams
from sesr_tpu_torch.config import spec_for_task
from sesr_tpu_torch.models.sesr import CollapsedParams, forward_float
from sesr_tpu_torch.parallel.launch import spawn
from sesr_tpu_torch.quant.calibrate import calibrate
from sesr_tpu_torch.quant.integer import integer_forward
from tests.test_integer_bitexact import _golden_qparams, _load_golden
from tests.test_torch_params import _port_golden_qparams
from tests.test_torch_ranks import LAYOUTS_1D, LAYOUTS_2D, REPO, sharding_world

CASES_1D = ("integer", "shuffle", "float", "deploy_sr_x2", "deploy_nr", "fast_sr_x2",
            "hybrid_nr", "int8_sr_x2")
CASES_2D = ("integer", "shuffle", "float", "deploy_sr_x2", "deploy_nr")
ARTIFACT = REPO + "/artifacts/qparams_{}.npz"


def _key(layout):
    return "x".join(map(str, layout))


def _float_params(seed=3):
    """Random collapsed nrdm_6 weights (init_params' law), numpy."""
    spec = spec_for_task("nrdm_6")
    rng = np.random.default_rng(seed)
    chans = [3] + [spec.num_channels] * (spec.num_convs - 1) + [spec.conv_out_channels]
    arrays = {}
    for i, k in enumerate(spec.kernel_sizes):
        arrays[f"w{i}"] = (rng.standard_normal((k, k, chans[i], chans[i + 1]))
                           / np.sqrt(k * k * chans[i])).astype(np.float32)
        arrays[f"b{i}"] = np.zeros((chans[i + 1],), np.float32)
    return arrays


def _golden_float(g):
    L = int(g["num_convs"])
    arrays = {}
    for i in range(L):
        arrays[f"w{i}"] = np.ascontiguousarray(np.transpose(g[f"w_collapsed_{i}"], (2, 3, 1, 0)))
        arrays[f"b{i}"] = np.asarray(g[f"b_collapsed_{i}"], np.float32)
    return arrays


def _params(arrays, cls, conv=np.asarray):
    n = len(arrays) // 2
    return cls([conv(arrays[f"w{i}"]) for i in range(n)], [conv(arrays[f"b{i}"]) for i in range(n)])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharding")
    paths = {"sr_x2": ARTIFACT.format("sr_x2"), "nr": ARTIFACT.format("nr")}
    for task in ("nrdm_3", "sr_x4"):
        paths[task] = str(d / f"{task}.npz")
        _port_golden_qparams(task, _load_golden(task)).save(paths[task])
    rng = np.random.default_rng(7)
    inputs = {
        "x_int": rng.random((2, 24, 48, 3), dtype=np.float32),
        "x_sr4": rng.random((2, 16, 40, 1), dtype=np.float32),
        "x_float": rng.random((2, 20, 64, 3), dtype=np.float32),
        "x_dep": rng.random((2, 32, 64, 3), dtype=np.float32),
        "x_limit": rng.random((4, 12, 30, 3), dtype=np.float32),
        "calib": [rng.random((2, 16, 48, 3), dtype=np.float32) for _ in range(2)],
    }
    return paths, inputs, _float_params(), _golden_float(_load_golden("nrdm_3"))


@pytest.fixture(scope="module")
def worlds(setup):
    """{world size: [(rank 0's outputs, calibration), ...]}: two worlds,
    each started once."""
    paths, inputs, fparams, cparams = setup
    four = tuple(lay for lay in LAYOUTS_1D + LAYOUTS_2D if np.prod(lay) == 4)
    two = tuple(lay for lay in LAYOUTS_1D + LAYOUTS_2D if np.prod(lay) == 2)
    return {4: spawn(sharding_world, 4, "gloo", four, inputs, paths, fparams, cparams),
            2: spawn(sharding_world, 2, "gloo", two, inputs, paths, fparams, cparams)}


def _outputs(worlds, layout):
    return worlds[int(np.prod(layout))][0][0]


@pytest.fixture(scope="module")
def jax_refs(setup):
    """The JAX package's monolithic outputs, and the port's, per case."""
    paths, inputs, fparams, _ = setup
    refs, port = {}, {}
    for task in ("nrdm_3", "sr_x4"):
        jspec, _, jqp = _golden_qparams(task, _load_golden(task))
        x = inputs["x_int" if task == "nrdm_3" else "x_sr4"]
        qp = _port_golden_qparams(task, _load_golden(task))
        for corrected in (False, True) if task == "sr_x4" else (False,):
            name = "integer" if task == "nrdm_3" else f"shuffle{int(corrected)}"
            refs[name] = np.asarray(jinteger_forward(jspec, jqp, jnp.asarray(x),
                                                     corrected=corrected)[0])
            port[name] = integer_forward(spec_for_task(task), qp, x, corrected=corrected,
                                         device="cpu")[0].numpy()
    spec6 = jspec_for_task("nrdm_6")
    refs["float"] = np.asarray(jforward_float(spec6, _params(fparams, JCollapsedParams,
                                                             jnp.asarray),
                                              jnp.asarray(inputs["x_float"])))
    port["float"] = forward_float(spec_for_task("nrdm_6"), _params(fparams, CollapsedParams),
                                  inputs["x_float"], device="cpu").numpy()
    for task in ("sr_x2", "nr"):
        jqp = JQuantParams.load(paths[task])
        _, fwd = select_packed_forward(jqp)
        refs[f"deploy_{task}"] = np.asarray(fwd(jspec_for_task(task), jqp,
                                                jnp.asarray(inputs["x_dep"])))
    refs["int8_sr_x2"] = np.asarray(select_packed_forward(jqp_sr := JQuantParams.load(
        paths["sr_x2"]))[1](jspec_for_task("sr_x2"), jqp_sr, jnp.asarray(inputs["x_dep"]),
                            out_dtype="int8"))
    refs["fast_sr_x2"], refs["hybrid_nr"] = refs["deploy_sr_x2"], refs["deploy_nr"]
    return refs, port


def _ref_name(case, layout):
    return f"shuffle{int(len(layout) == 3)}" if case == "shuffle" else case


@pytest.mark.parametrize("layout,case", [(lay, c) for lay in LAYOUTS_1D for c in CASES_1D]
                         + [(lay, c) for lay in LAYOUTS_2D for c in CASES_2D])
def test_sharded_matches_jax(worlds, jax_refs, layout, case):
    got = _outputs(worlds, layout)[f"{_key(layout)}/{case}"]
    refs, port = jax_refs
    name = _ref_name(case, layout)
    want = refs[name]
    assert got.shape == want.shape and got.dtype == want.dtype
    if case == "float":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, port[name], rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)
        if name in port:
            np.testing.assert_array_equal(got, port[name])


@pytest.mark.parametrize("layout", LAYOUTS_1D)
def test_sharded_deployment_selects_by_certificate(worlds, layout, setup):
    """One builder for any artifact: the certificate's fast mode for sr_x2
    and hybrid for nr, each equal to the pinned builder; the fast builder
    refuses nr; the int8 output dequantizes to the f32 one exactly."""
    out = _outputs(worlds, layout)
    key = _key(layout)
    np.testing.assert_array_equal(out[f"{key}/deploy_sr_x2"], out[f"{key}/fast_sr_x2"])
    np.testing.assert_array_equal(out[f"{key}/deploy_nr"], out[f"{key}/hybrid_nr"])
    assert "fast_cert_ok" in out[f"{key}/refused_nr"]
    qp = JQuantParams.load(setup[0]["sr_x2"])
    L = len(qp.w_int)
    y8 = out[f"{key}/int8_sr_x2"]
    np.testing.assert_array_equal((y8.astype(np.float32) - np.float32(qp.a_zero[L]))
                                  * np.float32(qp.a_scale[L]), out[f"{key}/deploy_sr_x2"])


@pytest.mark.parametrize("layout", LAYOUTS_1D)
def test_sharded_calibration_matches_monolithic(worlds, setup, layout):
    """Min and max reduce over the whole mesh: every rank holds the same
    constants, those of single-device calibration (JAX and the port)."""
    paths, inputs, _, cparams = setup
    ranks = [calib[_key(layout)] for _, calib in worlds[int(np.prod(layout))]]
    for other in ranks[1:]:
        for a, b in zip(ranks[0], other):
            np.testing.assert_array_equal(a, b)
    a_scale, a_zero, m, n = ranks[0]
    jspec = jspec_for_task("nrdm_3")
    jqp = jcalibrate(jspec, _params(cparams, JCollapsedParams, jnp.asarray), inputs["calib"])
    qp = calibrate(spec_for_task("nrdm_3"), _params(cparams, CollapsedParams), inputs["calib"],
                   device="cpu")
    for want in (jqp, qp):
        np.testing.assert_allclose(a_scale, np.asarray(want.a_scale), rtol=1e-6)
        np.testing.assert_array_equal(a_zero, np.asarray(want.a_zero))
        np.testing.assert_array_equal(m, np.asarray(want.requant_m))
        np.testing.assert_array_equal(n, np.asarray(want.requant_n))


def test_halo_mode_unsharded_equals_same_mode(worlds, setup):
    """A mesh whose "sp" dimension has one rank: every conv's halo is the
    zero extension, so VALID on it equals the SAME forward."""
    _, inputs, fparams, _ = setup
    want = forward_float(spec_for_task("nrdm_6"), _params(fparams, CollapsedParams),
                         inputs["x_limit"], device="cpu").numpy()
    np.testing.assert_allclose(worlds[4][0][0]["limit"], want, rtol=1e-6, atol=1e-6)
    jwant = jforward_float(jspec_for_task("nrdm_6"),
                           _params(fparams, JCollapsedParams, jnp.asarray),
                           jnp.asarray(inputs["x_limit"]))
    np.testing.assert_allclose(worlds[4][0][0]["limit"], np.asarray(jwant), rtol=1e-6,
                               atol=1e-6)
