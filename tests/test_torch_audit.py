"""The port's runtime audit (sesr_tpu_torch/quant/audit.py) and ``infer
--audit`` (sesr_tpu_torch/cli.py ``serve``) against sesr_tpu.quant.audit
and sesr_tpu's audited stream on the same frames: the trusted layers by
mode, the adversarial and the bright nr frames, and a stream that
degrades to the PE-exact forward."""

import dataclasses
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sesr_tpu import cli as jcli
from sesr_tpu.config import spec_for_task as jspec_for_task
from sesr_tpu.ops.packed import packed_hybrid_forward
from sesr_tpu.parallel.multihost import make_mesh_multihost, stream_frames
from sesr_tpu.quant import audit as jaudit
from sesr_tpu.quant.params import QuantParams as JQuantParams
from sesr_tpu_torch import cli
from sesr_tpu_torch.config import spec_for_task
from sesr_tpu_torch.ops.corrected import hybrid_forward
from sesr_tpu_torch.quant import audit
from sesr_tpu_torch.quant.certify import adversarial_image
from sesr_tpu_torch.quant.integer import integer_forward
from sesr_tpu_torch.quant.params import QuantParams
from tests.test_torch_params import one_torch_thread  # noqa: F401 (fixture)

ARTIFACTS = os.path.join(os.path.dirname(__file__), os.pardir, "artifacts")
TASKS = ["nr", "dm", "nrdm_3", "nrdm_6", "sr_x4", "sr_x2"]


def _load(task):
    path = os.path.join(ARTIFACTS, f"qparams_{task}.npz")
    return QuantParams.load(path), JQuantParams.load(path)


@pytest.mark.parametrize("task", TASKS)
def test_trusted_layers_by_mode(task):
    qp, jqp = _load(task)
    for mode in ("fast", "hybrid", "pe-exact"):
        assert audit.empirically_trusted_layers(qp, mode) == \
            jaudit.empirically_trusted_layers(jqp, mode)
    assert audit.empirically_trusted_layers(qp, "pe-exact") == ()
    if task == "nr":                      # stamps FSSSx
        assert audit.empirically_trusted_layers(qp, "hybrid") == (0,)


def _same_result(res, jres):
    assert (res.ok, res.violations, res.diverged) == (jres.ok, jres.violations, jres.diverged)
    np.testing.assert_array_equal(res.ovf18, np.asarray(jres.ovf18))
    np.testing.assert_array_equal(res.y_exact.numpy(), np.asarray(jres.y_exact))


def test_adversarial_frame_on_nr():
    """The layer-0 adversarial image fires 18-bit events on nr's one
    empirically trusted layer; the audit flags it and the served hybrid
    output differs from the sound one. An in-distribution frame passes."""
    spec = spec_for_task("nr")
    qp, jqp = _load("nr")
    x = adversarial_image(qp, hw=(64, 96))
    y_served = hybrid_forward(spec, qp, x, device="cpu")
    jy_served = packed_hybrid_forward(jspec_for_task("nr"), jqp, jnp.asarray(x), s=(1, 8))
    np.testing.assert_array_equal(y_served.numpy(), np.asarray(jy_served))
    with pytest.warns(audit.OODSaturationWarning):
        res = audit.audit_frame(spec, qp, x, y_served=y_served, mode="hybrid", device="cpu")
    with pytest.warns(jaudit.OODSaturationWarning):
        jres = jaudit.audit_frame(jspec_for_task("nr"), jqp, x,
                                  y_served=np.asarray(jy_served), mode="hybrid")
    _same_result(res, jres)
    assert not res.ok and 0 in res.violations and res.ovf18[0] > 0 and res.diverged
    x_ok = np.random.default_rng(0).random((1, 64, 96, 3), dtype=np.float32)
    res_ok = audit.audit_frame(spec, qp, x_ok, y_served=hybrid_forward(spec, qp, x_ok,
                                                                       device="cpu"),
                               device="cpu")
    assert res_ok.ok and res_ok.violations == () and res_ok.diverged is False


def test_bright_frame_is_sound_under_hybrid():
    """A bright frame saturates nr's last conv, which hybrid serving runs
    per PE: the event happens and the audit passes."""
    spec = spec_for_task("nr")
    qp, jqp = _load("nr")
    x = np.ones((1, 64, 96, 3), np.float32)
    res = audit.audit_frame(spec, qp, torch.from_numpy(x), mode="hybrid")
    _same_result(res, jaudit.audit_frame(jspec_for_task("nr"), jqp, x, mode="hybrid"))
    assert res.ovf18[-1] > 0 and res.ok and res.diverged is None


def test_stream_degrades_as_jax():
    """audit every dispatch: the adversarial frame (the second) is flagged,
    served again through the corrected PE-exact forward, and every later
    frame is served PE-exact; every output equals the sound interpreter's
    and the JAX package's audited stream."""
    spec = spec_for_task("nr")
    qp, jqp = _load("nr")
    rng = np.random.default_rng(1)
    dim = [rng.random((1, 64, 96, 3), dtype=np.float32) for _ in range(3)]
    frames = [dim[0], adversarial_image(qp, hw=(64, 96)), dim[1], dim[2]]
    data = [(f, np.zeros_like(f)) for f in frames]
    res = cli.serve(spec, qp, data, device="cpu", audit_every=1, keep_outputs=True)
    assert res.violations == [(1, (0,))]
    assert res.mode == "pe-exact" and res.audited == 2
    log = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", jaudit.OODSaturationWarning)
        jouts = list(stream_frames(jspec_for_task("nr"), jqp,
                                   make_mesh_multihost(n_hosts=1, dp=1, sp=2), frames,
                                   lowering="deployment", audit_every=1, audit_log=log))
    assert [m for _, m, _ in log] == ["hybrid", "hybrid", "pe-exact", "pe-exact"]
    for f, y, jy in zip(frames, res.outputs, jouts):
        np.testing.assert_array_equal(y, np.asarray(jy)[0])
        np.testing.assert_array_equal(
            y, integer_forward(spec, qp, f, corrected=True, device="cpu")[0].numpy()[0])


def test_cli_infer_audit_summary(capsys, tmp_path):
    path = os.path.join(ARTIFACTS, "qparams_nr.npz")
    args = ["infer", "--task", "nr", "--qparams", path, "--n-images", "2", "--audit", "1"]
    res = cli.main(args + ["--device", "cpu"])
    port = capsys.readouterr()
    jcli.main(args)
    jax_out = capsys.readouterr().out
    line = "audit: 2 dispatch(es) audited, 0 OOD saturation violation(s)"
    assert line in port.out and line in jax_out
    assert res.mode == "hybrid" and res.audited == 2 and not res.violations
    # an artifact without stamps serves pe-exact: nothing to audit
    qp, _ = _load("nr")
    bare = str(tmp_path / "bare.npz")
    dataclasses.replace(qp, fast_cert_layers=None, fast_cert_static=None).save(bare)
    res = cli.main(["infer", "--task", "nr", "--qparams", bare, "--n-images", "1",
                    "--audit", "1", "--device", "cpu"])
    err = capsys.readouterr().err
    assert "nothing to audit" in err and res.mode == "pe-exact" and res.audited == 0
