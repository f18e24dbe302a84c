"""The port's sesr_tpu_torch/make_qparams.py against the
JAX package's calibrate + certify_fast on the same synthetic images, at
tests/test_torch_calibrate.py's bounds: the PTQ loop from golden float
weights, the AdaRound recipe with no optimizer step, the calibrate +
certify tail of the QAT recipe from artifacts/sr_x4_qat_collapsed.npz, and
the command line (``--out-dir`` required, never ``artifacts/``)."""

import dataclasses
import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest

from sesr_tpu.config import spec_for_task as jspec_for_task
from sesr_tpu.models.sesr import CollapsedParams as JCollapsedParams
from sesr_tpu.quant.adaround import adaround_calibrate as jadaround_calibrate
from sesr_tpu.quant.calibrate import calibrate as jcalibrate
from sesr_tpu.quant.certify import certify_fast as jcertify_fast
from sesr_tpu_torch import make_qparams
from sesr_tpu_torch.config import spec_for_task
from sesr_tpu_torch.data import SyntheticDataset
from sesr_tpu_torch.io.torch_import import load_reference_checkpoint
from sesr_tpu_torch.quant.adaround import adaround_calibrate
from sesr_tpu_torch.quant.params import QuantParams
from tests.test_torch_cli import _collapsed_npz
from tests.test_torch_params import one_torch_thread  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QAT_WEIGHTS = os.path.join(REPO, "artifacts", "sr_x4_qat_collapsed.npz")


def _jax_params(params):
    return JCollapsedParams([jnp.asarray(w) for w in params.weights],
                            [jnp.asarray(b) for b in params.biases])


def _assert_same_artifact(qp, jqp):
    """w_int equal, scales within rel 3e-3 and zeros within 2 (the golden
    bounds), the certificate's stamps equal."""
    for a, b in zip(qp.w_int, jqp.w_int):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert qp.w_scale == jqp.w_scale
    for d in range(len(qp.a_scale)):
        assert qp.a_scale[d] == pytest.approx(jqp.a_scale[d], rel=3e-3), f"domain {d}"
        assert abs(qp.a_zero[d] - jqp.a_zero[d]) <= 2, f"domain {d}"
    for f in ("fast_cert_ok", "fast_cert_images", "fast_cert_layers", "fast_cert_static",
              "shortcut_static", "cert_grade", "cert_stamps"):
        assert getattr(qp, f) == getattr(jqp, f), f


_CERTIFIED = {}


def _jax_certified(spec, jqp, images):
    """The JAX package's certify_fast of ``jqp`` over ``images``, run once
    per artifact in this module: two cases whose JAX artifacts are equal
    (sr_x4's nearest and zero-step AdaRound recipes) share it."""
    digest = hashlib.sha256(repr(spec).encode())
    for f in dataclasses.fields(jqp):
        v = getattr(jqp, f.name)
        for leaf in (v if isinstance(v, (list, tuple)) else [v]):
            digest.update(repr((f.name, np.asarray(leaf).dtype.str, np.asarray(leaf).shape)
                               ).encode())
            digest.update(np.ascontiguousarray(np.asarray(leaf)).tobytes()
                          if hasattr(leaf, "shape") else repr(leaf).encode())
    for img in images:
        digest.update(np.ascontiguousarray(img).tobytes())
    key = digest.hexdigest()
    if key not in _CERTIFIED:
        _CERTIFIED[key] = jcertify_fast(spec, jqp, images)
    return _CERTIFIED[key]


def _images(task):
    """Three synthetic calibration inputs, smaller than make_qparams' own."""
    return [inp for inp, _gt in SyntheticDataset(task, n=3, hw=(48, 64))]


@pytest.mark.parametrize("task,observer", [("nr", "minmax"), ("sr_x4", "percentile")])
def test_ptq_loop_matches_jax(tmp_path, task, observer):
    params = load_reference_checkpoint(task, path=_collapsed_npz(tmp_path, task))
    images = _images(task)
    got = make_qparams.build_ptq_artifact(task, params, images, "nearest", observer,
                                          device="cpu")
    spec = jspec_for_task(task)
    want = _jax_certified(spec, jcalibrate(spec, _jax_params(params), images,
                                           safe_zero_floor=True, observer=observer), images)
    _assert_same_artifact(got.qp, want)
    assert got.images == len(images) and got.layers == []


def test_adaround_recipe_with_no_step_matches_jax(tmp_path):
    """sr_x4's recipe (AdaRound, percentile) at 0 steps: the two-phase
    calibration around the rounding equals the JAX package's, through the
    builder and through adaround_calibrate."""
    task = "sr_x4"
    assert make_qparams.recipe(task) == ("adaround", "percentile")
    params = load_reference_checkpoint(task, path=_collapsed_npz(tmp_path, task))
    images = _images(task)
    got = make_qparams.build_ptq_artifact(task, params, images, "adaround", "percentile",
                                          adaround_steps=0, device="cpu")
    spec = jspec_for_task(task)
    jqp = jadaround_calibrate(spec, _jax_params(params), images, steps=0, safe_zero_floor=True,
                              observer="percentile")
    _assert_same_artifact(got.qp, _jax_certified(spec, jqp, images))
    assert [r.moved for r in got.layers] == [0.0] * spec.num_convs
    # the library's two-phase recipe, uncertified on both sides
    qp = adaround_calibrate(spec_for_task(task), params, images, steps=0, safe_zero_floor=True,
                            observer="percentile", device="cpu")
    _assert_same_artifact(qp, jqp)


def test_qat_recipe_tail_matches_jax():
    """The QAT recipe after its fine-tune: the QAT-collapsed weights,
    calibrated with the task's QAT observer and certified."""
    task = "sr_x4"
    params = load_reference_checkpoint(task, path=QAT_WEIGHTS)
    images = _images(task)
    obs = make_qparams.QAT_OBSERVER_DEFAULTS[task]
    got = make_qparams.build_ptq_artifact(task, params, images, "nearest", obs, device="cpu")
    spec = jspec_for_task(task)
    want = _jax_certified(spec, jcalibrate(spec, _jax_params(params), images,
                                           safe_zero_floor=True, observer=obs), images)
    _assert_same_artifact(got.qp, want)


def test_command_line(tmp_path, capsys):
    with pytest.raises(SystemExit):
        make_qparams.main(["--tasks", "nr"])
    assert "--out-dir" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="artifacts/"):
        make_qparams.main(["--out-dir", os.path.join(REPO, "artifacts", "x"), "--tasks", "nr"])
    assert not os.path.exists(os.path.join(REPO, "artifacts", "x"))
    ck = _collapsed_npz(tmp_path, "nr")
    with pytest.raises(SystemExit, match="exactly one"):
        make_qparams.main(["--out-dir", str(tmp_path / "o"), "--tasks", "nr", "dm",
                           "--checkpoint", ck])
    with pytest.raises(SystemExit, match="expanded checkpoint"):
        make_qparams.main(["--out-dir", str(tmp_path / "o"), "--qat", "sr_x4"])
    built = make_qparams.main(["--out-dir", str(tmp_path / "o"), "--tasks", "nr",
                               "--checkpoint", ck, "--n-images", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "calibrating on synthetic only" in out and "rounding=nearest" in out
    qp = QuantParams.load(str(tmp_path / "o" / "qparams_nr.npz"))
    assert qp.cert_stamps == built["nr"].qp.cert_stamps and qp.fast_cert_images == 2
