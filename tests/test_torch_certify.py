"""The port's certification (sesr_tpu_torch/quant/certify.py) against
sesr_tpu.quant.certify: the static proofs and bounds on every shipped
artifact, certify_fast field for field on the same synthetic frames, the
zero-image cases, the adversarial inputs, and the artifact's round trip
into the JAX package."""

import dataclasses
import glob
import os

import numpy as np
import pytest

from sesr_tpu import cli as jcli
from sesr_tpu.config import spec_for_task as jspec_for_task
from sesr_tpu.data.datasets import SyntheticDataset as JSyntheticDataset
from sesr_tpu.ops.packed import CERTIFIED_CELLS as JCERTIFIED_CELLS
from sesr_tpu.quant import certify as jcertify
from sesr_tpu.quant.params import QuantParams as JQuantParams
from sesr_tpu_torch import cli
from sesr_tpu_torch.config import spec_for_task
from sesr_tpu_torch.data import SyntheticDataset
from sesr_tpu_torch.quant import certify
from sesr_tpu_torch.quant.calibrate import calibrate
from sesr_tpu_torch.quant.params import QuantParams
from tests.test_torch_calibrate import _golden
from tests.test_torch_params import _same
from tests.test_torch_params import one_torch_thread  # noqa: F401 (fixture)

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), os.pardir, "artifacts")
ARTIFACTS = sorted(glob.glob(os.path.join(ARTIFACT_DIR, "qparams_*.npz")))


def _frames(task, n=2):
    images = [inp for inp, _ in SyntheticDataset(task, n=n, hw=(64, 96))]
    jimages = [inp for inp, _ in JSyntheticDataset(task, n=n, hw=(64, 96))]
    for a, b in zip(images, jimages):
        np.testing.assert_array_equal(a, b)
    return images


def test_certified_cells_copy():
    assert certify.CERTIFIED_CELLS == tuple(JCERTIFIED_CELLS)


@pytest.mark.parametrize("path", ARTIFACTS, ids=os.path.basename)
def test_static_proofs_match_jax(path):
    qp, jqp = QuantParams.load(path), JQuantParams.load(path)
    L = qp.num_convs
    assert certify.static_layer_stamps(qp) == jcertify.static_layer_stamps(jqp)
    assert certify.static_layer_stamps(qp) == qp.fast_cert_static
    for i in range(L - 1):
        assert certify.static_requant_bound(qp, i) == jcertify.static_requant_bound(jqp, i)
    assert certify.static_shortcut_bound(qp) == jcertify.static_shortcut_bound(jqp)
    assert certify.static_shortcut_safe(qp) == jcertify.static_shortcut_safe(jqp)
    for i in range(L):
        x, meta = certify.adversarial_input_for_layer(qp, i)
        jx, jmeta = jcertify.adversarial_input_for_layer(jqp, i)
        np.testing.assert_array_equal(x, jx)
        assert meta == jmeta
    for hw in ((64, 96), (37, 53)):
        np.testing.assert_array_equal(certify.adversarial_image(qp, hw),
                                      jcertify.adversarial_image(jqp, hw))


@pytest.mark.parametrize("task", ["sr_x2", "sr_x4", "nr"])
def test_certify_fast_matches_jax(task, tmp_path):
    """sr_x4 and nr: the shipped artifacts with their stamps removed; sr_x2:
    an artifact the port calibrated from the sr_x2 bundle's float weights."""
    if task == "sr_x2":
        _, spec, params, _, calib_images, _ = _golden("sr_x2")
        calibrate(spec, params, calib_images, device="cpu").save(str(tmp_path / "fresh.npz"))
        path = str(tmp_path / "fresh.npz")
    else:
        path = os.path.join(ARTIFACT_DIR, f"qparams_{task}.npz")
    qp, jqp = QuantParams.load(path), JQuantParams.load(path)
    bare = dict(fast_cert_ok=False, fast_cert_images=0, fast_cert_layers=None,
                fast_cert_static=None, shortcut_static=False, cert_cells=None)
    qp, jqp = dataclasses.replace(qp, **bare), dataclasses.replace(jqp, **bare)
    images = _frames(task)
    seconds = {}
    got = certify.certify_fast(spec_for_task(task), qp, images, device="cpu",
                               seconds=seconds)
    want = jcertify.certify_fast(jspec_for_task(task), jqp, images)
    _same(got, want)
    assert (got.cert_grade, got.cert_stamps) == (want.cert_grade, want.cert_stamps)
    assert sorted(seconds) == ["equality", "interpreter", "strict"]
    # the stamped artifact reloads in the JAX package field for field
    got.save(str(tmp_path / "stamped.npz"))
    _same(JQuantParams.load(str(tmp_path / "stamped.npz")), want)


@pytest.mark.parametrize("task", ["sr_x2", "nr"])
def test_zero_images_match_jax(task):
    """With no images only the static proofs stamp: nr and sr_x2 carry
    empirical layers, so neither comes back fully certified."""
    path = os.path.join(ARTIFACT_DIR, f"qparams_{task}.npz")
    got = certify.certify_fast(spec_for_task(task), QuantParams.load(path), [], device="cpu")
    want = jcertify.certify_fast(jspec_for_task(task), JQuantParams.load(path), [])
    _same(got, want)
    assert not got.fast_cert_ok and got.fast_cert_layers == got.fast_cert_static


def test_certify_cli_refuses_zero_images_and_prints_jax_numbers(tmp_path, capsys):
    path = os.path.join(ARTIFACT_DIR, "qparams_nr.npz")
    with pytest.raises(SystemExit, match="zero images"):
        cli.main(["certify", "--task", "nr", "--qparams", path, "--n-images", "0",
                  "--device", "cpu"])
    out = str(tmp_path / "nr_stamped.npz")
    qp2 = cli.main(["certify", "--task", "nr", "--qparams", path, "--n-images", "2",
                    "--device", "cpu", "--out", out])
    port = capsys.readouterr().out
    jcli.main(["certify", "--task", "nr", "--qparams", path, "--n-images", "2",
               "--out", str(tmp_path / "jax.npz")])
    jax_out = capsys.readouterr().out
    assert port.replace(out, "OUT") == jax_out.replace(str(tmp_path / "jax.npz"), "OUT")
    assert "grade=partial layers=FSSSx over 2 images" in port
    _same(QuantParams.load(out), JQuantParams.load(str(tmp_path / "jax.npz")))
    assert qp2.cert_stamps == "FSSSx"
