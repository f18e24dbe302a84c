"""The port's host-major meshes, tail forward, ``stream_frames`` and the
sharded QAT step (sesr_tpu_torch/parallel/multihost.py, tiling.py
``sharded_train_step``) on gloo ranks, held against the JAX package: the
mirror of tests/test_sharding.py's multihost and train-step cases on four
ranks.

One world of four ranks starts once for the module and runs every check
(tests/test_torch_ranks.py ``multihost_world``); each check is one case
here. Integer outputs must be array_equal with the JAX package's
monolithic forward on the same frames; the QAT step must give the
unsharded step's loss within rel 1e-5 and its parameters within rtol 1e-4
/ atol 1e-6 (the JAX test's bounds).
"""

import numpy as np
import optax
import pytest
import torch
import jax.numpy as jnp

from sesr_tpu.config import spec_for_task as jspec_for_task
from sesr_tpu.ops.packed import select_packed_forward
from sesr_tpu.quant import qat as jqat
from sesr_tpu.quant.integer import integer_forward as jinteger_forward
from sesr_tpu.quant.params import QuantParams as JQuantParams
from sesr_tpu_torch.config import spec_for_task
from sesr_tpu_torch.models.expanded import expanded_from_arrays
from sesr_tpu_torch.parallel.launch import spawn
from sesr_tpu_torch.quant import qat
from sesr_tpu_torch.quant.certify import adversarial_image
from sesr_tpu_torch.quant.params import QuantParams
from tests.test_integer_bitexact import _golden_qparams, _load_golden
from tests.test_torch_expanded import jax_params, seeded_blocks
from tests.test_torch_params import _port_golden_qparams
from tests.test_torch_ranks import REPO, multihost_world, observer_arrays

ARTIFACT = REPO + "/artifacts/qparams_{}.npz"
ADV_HW = (64, 96)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("multihost")
    paths = {"sr_x2": ARTIFACT.format("sr_x2"), "nr": ARTIFACT.format("nr"),
             "nrdm_3": str(d / "nrdm_3.npz")}
    _port_golden_qparams("nrdm_3", _load_golden("nrdm_3")).save(paths["nrdm_3"])
    rng = np.random.default_rng(23)

    def frames(n, hw):
        return rng.random((n, 1) + hw + (3,), dtype=np.float32)

    adv = adversarial_image(QuantParams.load(paths["nr"]), hw=ADV_HW)
    clean = frames(4, ADV_HW)
    inputs = {
        "x_mh": rng.random((4, 12, 20, 3), dtype=np.float32),
        "x_dep4": rng.random((4, 24, 64, 3), dtype=np.float32),
        "x_dep2": rng.random((2, 24, 64, 3), dtype=np.float32),
        "x_tail": rng.random((2, 12, 24, 3), dtype=np.float32),
        "frames7": frames(7, (12, 20)), "frames5": frames(5, (12, 24)),
        "frames6": frames(6, (16, 64)), "frames9": frames(9, (16, 32)),
        # batch 0 clean, the adversarial frame in batch 1, a tail of one
        "frames_adv": np.stack([clean[0], clean[1], adv.astype(np.float32), *clean[2:]]),
    }
    spec = spec_for_task("sr_x2")
    # |x| with ties (eight levels and a run of zeros) in uneven blocks, one
    # of a single element, for the percentile observer's order statistic
    ties = (np.round(rng.random(1001) * 7) / 7).astype(np.float32)
    ties[300:340] = 0.0
    n = len(ties)
    qat_in = {"params": seeded_blocks(spec, seed=0),
              "x": rng.random((2, 16, 32, 3), dtype=np.float32),
              "gt": rng.random((2, 32, 64, 3), dtype=np.float32),
              "ties": ties, "bounds": [0, 100, 450, 451, n],
              "indices": [0, 1, 339, 340, 500, n - 2, n - 1, int(0.9999 * n) - 1]}
    return paths, inputs, qat_in


@pytest.fixture(scope="module")
def world(setup):
    """[(rank 0's outputs, audit, QAT results) per rank]."""
    return spawn(multihost_world, 4, "gloo", *setup)


@pytest.fixture(scope="module")
def jax_out(setup):
    paths, inputs, _ = setup
    jspec3, _, jqp3 = _golden_qparams("nrdm_3", _load_golden("nrdm_3"))
    jq = {t: JQuantParams.load(paths[t]) for t in ("sr_x2", "nr")}

    def integer(x, **kw):
        return np.asarray(jinteger_forward(jspec3, jqp3, jnp.asarray(x), **kw)[0])

    def deploy(task, x, **kw):
        return np.asarray(select_packed_forward(jq[task])[1](jspec_for_task(task), jq[task],
                                                             jnp.asarray(x), **kw))

    def cat(key):
        return np.concatenate(list(inputs[key]))

    return {
        "integer": integer(inputs["x_mh"]),
        "packed_sr_x2": deploy("sr_x2", inputs["x_dep4"]),
        "packed_nr": deploy("nr", inputs["x_dep4"]),
        "pe_exact_nr": np.asarray(jinteger_forward(jspec_for_task("nr"), jq["nr"],
                                                   jnp.asarray(inputs["x_dep4"]),
                                                   corrected=True)[0]),
        "tail": integer(inputs["x_tail"]),
        "tail_deploy": deploy("sr_x2", inputs["x_dep2"]),
        "packed_2d": deploy("sr_x2", inputs["x_dep2"]),
        "stream": integer(cat("frames7")),
        "stream_tail": integer(cat("frames5")),
        "stream_deploy": deploy("sr_x2", cat("frames6")),
        "stream_int8": deploy("sr_x2", cat("frames6"), out_dtype="int8"),
        "stream_batched": deploy("sr_x2", cat("frames9")),
        "stream_audit": np.asarray(jinteger_forward(jspec_for_task("nr"), jq["nr"],
                                                    jnp.asarray(cat("frames_adv")),
                                                    corrected=True)[0]),
    }


@pytest.mark.parametrize("case", ["2x1x2/integer", "2x2x1/integer", "2x1x2/packed_sr_x2",
                                  "2x2x1/packed_sr_x2", "2x1x2/packed_nr", "2x2x1/packed_nr",
                                  "2x1x2/pe_exact_nr", "tail", "tail_deploy", "packed_2d",
                                  "stream", "stream_tail", "stream_deploy", "stream_int8",
                                  "stream_batched", "stream_audit"])
def test_multihost_matches_jax(world, jax_out, case):
    got, want = world[0][0][case], jax_out[case.split("/")[-1]]
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case,counts", [("stream", [4, 3]), ("stream_tail", [4, 1]),
                                         ("stream_deploy", [4, 2]), ("stream_int8", [4, 2]),
                                         ("stream_batched", [8, 1]),
                                         ("stream_audit", [2, 2, 1])])
def test_stream_batch_counts(world, case, counts):
    """Global batches of host x dp x frames_per_chip frames; a partial tail
    yields only its real frames."""
    assert world[0][0][f"{case}/counts"] == counts


def test_stream_audit_degrades_every_rank_to_pe_exact(world):
    """The adversarial frame fires an 18-bit event on an empirically
    stamped layer in one rank's block: every rank logs the failed audit,
    warns and serves the rest of the stream pe-exact (its outputs above
    equal the sound interpreter's)."""
    for _, (log, warned), _ in world:
        assert [(i, mode) for i, mode, _ in log] == [(0, "hybrid"), (1, "hybrid")]
        assert log[0][2] is True
        assert len(warned) == 1 and "degrading the stream to pe-exact" in warned[0]
    assert any(log[1][2] is False for _, (log, _), _ in world)


def test_multihost_rejects_cross_host_halo(world):
    out = world[0][0]
    assert "DCN" in out["refused_dcn"] and "DCN" in out["refused_local"]
    assert out["local_world_mesh"] == [[[0, 1]], [[2, 3]]]
    assert "only the sound 'pe-exact'" in out["refused_fast"]


@pytest.fixture(scope="module")
def unsharded_step(setup):
    """The unsharded step of the port (QAT and float) and the JAX package's
    float step (optax). The JAX QAT step is left out: on these random
    inputs the two frameworks' fake-quant forwards part by a quantization
    step at a float32 rounding flip, unsharded too (tests/test_torch_qat.py
    compares them on inputs without such a flip)."""
    qat_in = setup[2]
    spec = spec_for_task("sr_x2")
    out = {}
    for name, cfg in (("qat", qat.QATConfig()), ("ptq", qat.QATConfig(ptq=True)),
                      ("float", None)):
        params = expanded_from_arrays(qat_in["params"])
        leaves = [v.requires_grad_() for blk in params.blocks for v in blk]
        step = qat.make_train_step(spec, cfg, params, qat.adam(params, 1e-5))
        qstate, loss = step(qat.prepare(spec, qat.QATConfig(), "cpu"),
                            (torch.from_numpy(qat_in["x"]), torch.from_numpy(qat_in["gt"])))
        out[f"port/{name}"] = (float(loss), [v.detach().numpy() for v in leaves],
                               observer_arrays(qstate))
    jspec = jspec_for_task("sr_x2")
    opt = optax.adam(1e-5)
    jp = jax_params(qat_in["params"])
    jp2, _, _, jloss = jqat.make_train_step(jspec, None, opt)(
        jp, jqat.prepare(jspec, jqat.QATConfig()), opt.init(jp),
        (jnp.asarray(qat_in["x"]), jnp.asarray(qat_in["gt"])))
    out["jax/float"] = (float(jloss), [np.asarray(v) for blk in jp2.blocks for v in blk])
    return out


@pytest.mark.parametrize("mesh", ["2x2", "2x1x2"])
@pytest.mark.parametrize("against", ["port/qat", "port/float", "jax/float"])
def test_sharded_train_step_matches_unsharded(world, unsharded_step, mesh, against):
    """Every rank takes the same step, the unsharded one's within the JAX
    test's bounds (loss rel 1e-5; parameters rtol 1e-4, atol 1e-6)."""
    key = f"{mesh}/{against.split('/')[1]}"
    loss0, params0 = world[0][2][key][:2]
    for _, _, res in world[1:]:
        assert res[key][0] == loss0
        for a, b in zip(res[key][1], params0):
            np.testing.assert_array_equal(a, b)
    want_loss, want = unsharded_step[against][:2]
    np.testing.assert_allclose(loss0, want_loss, rtol=1e-5, atol=1e-8)
    for a, b in zip(params0, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("mesh", ["2x2", "2x1x2"])
def test_sharded_percentile_observer_matches_unsharded(world, unsharded_step, mesh):
    """The percentile observer under a mesh takes the order statistic of
    the whole tensor: after a sharded ptq=True step every observer's state
    on every rank is equal to the unsharded step's."""
    want = unsharded_step["port/ptq"][2]
    for _, _, res in world:
        got = res[f"{mesh}/ptq"][2]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert torch.equal(torch.from_numpy(a), torch.from_numpy(b))


def test_radix_select_equals_sort_on_tied_uneven_blocks(world, setup):
    """global_order_statistic over four ranks' uneven blocks of a tensor
    with ties (a run of zeros, eight levels) gives torch.sort's value at
    every index, on every rank."""
    qat_in = setup[2]
    flat = torch.sort(torch.from_numpy(qat_in["ties"])).values
    want = [float(flat[i]) for i in qat_in["indices"]]
    for _, _, res in world:
        assert res["order_statistics"] == want
