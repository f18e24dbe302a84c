"""The port's ``profile`` (sesr_tpu_torch/costs.py and the CLI command) on
the CPU: the convs' FLOPs from the shapes against the hand count,
FlopCounterMode over the plain forwards against the shapes, the JAX
package's XLA count for the same path and size no smaller than the port's,
the deployment path's bytes against a hand count, and the command's labels
and refusals as the JAX command prints them. Peak memory is the card's
(chip_smoke.py phase 13)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sesr_tpu import cli as jcli
from sesr_tpu.config import spec_for_task as jspec_for_task
from sesr_tpu.io.torch_import import load_reference_checkpoint as jload_checkpoint
from sesr_tpu.models.sesr import forward_float as jforward_float
from sesr_tpu.ops.packed import select_packed_forward
from sesr_tpu.quant.integer import integer_forward as jinteger_forward
from sesr_tpu.quant.params import QuantParams as JQuantParams
from sesr_tpu_torch import cli, costs
from sesr_tpu_torch.config import spec_for_task
from sesr_tpu_torch.io.torch_import import load_reference_checkpoint
from sesr_tpu_torch.quant.params import QuantParams
from tests.test_torch_cli import _collapsed_npz
from tests.test_torch_params import one_torch_thread  # noqa: F401 (fixture)

ARTIFACTS = os.path.join(os.path.dirname(__file__), os.pardir, "artifacts")
QP_SR_X2 = os.path.join(ARTIFACTS, "qparams_sr_x2.npz")
H, W = 24, 32
# MACs per input pixel, by hand: 5x5 3->16, 3x3 16->16 per block, 5x5 16->out
HAND_MACS = {"sr_x2": 25 * 3 * 16 + 3 * 9 * 16 * 16 + 25 * 16 * 12,     # 12,912
             "nr": 25 * 3 * 16 + 3 * 9 * 16 * 16 + 25 * 16 * 3,        # 9,312
             "nrdm_6": 25 * 3 * 16 + 6 * 9 * 16 * 16 + 25 * 16 * 3}    # 16,224


@pytest.mark.parametrize("task", sorted(HAND_MACS))
def test_conv_flops_from_shapes(task):
    spec = spec_for_task(task)
    assert costs.conv_macs(spec) == HAND_MACS[task]
    assert HAND_MACS == {"sr_x2": 12912, "nr": 9312, "nrdm_6": 16224}
    assert costs.conv_flops(spec, 2, 5, 7) == 2 * HAND_MACS[task] * 2 * 5 * 7


def _cost(path, tmp_path, task="sr_x2"):
    spec = spec_for_task(task)
    if path == "float":
        params = load_reference_checkpoint(task, path=_collapsed_npz(tmp_path, task))
        return costs.profile_path(spec, path, H, W, "cpu", params=params)
    qp = QuantParams.load(os.path.join(ARTIFACTS, f"qparams_{task}.npz"))
    return costs.profile_path(spec, path, H, W, "cpu", qp=qp)


@pytest.mark.parametrize("path", ["float", "interpreter"])
def test_flop_counter_equals_conv_flops(tmp_path, path):
    """FlopCounterMode over the plain float forward (the sr_x2 golden
    collapsed weights) and over the corrected interpreter counts exactly
    the convs' FLOPs."""
    c = _cost(path, tmp_path)
    assert c.flops_how == "FlopCounterMode" and c.bytes_how == "every op's operands, unfused"
    assert c.flops == costs.conv_flops(spec_for_task("sr_x2"), 1, H, W)
    assert c.bytes > c.argument_bytes + c.output_bytes
    assert c.peak_temp_bytes is None and c.argument_bytes == H * W * 3 * 4
    assert c.output_bytes == 2 * H * 2 * W * 3 * 4


def _jax_flops(path, tmp_path):
    jspec = jspec_for_task("sr_x2")
    if path == "float":
        params = jload_checkpoint("sr_x2", path=_collapsed_npz(tmp_path, "sr_x2"))
        fn = lambda x: jforward_float(jspec, params, x)                     # noqa: E731
    elif path == "interpreter":
        jqp = JQuantParams.load(QP_SR_X2)
        fn = lambda x: jinteger_forward(jspec, jqp, x, corrected=True)[0]   # noqa: E731
    else:
        jqp = JQuantParams.load(QP_SR_X2)
        fwd = select_packed_forward(jqp)[1]
        fn = lambda x: fwd(jspec, jqp, x)                                   # noqa: E731
    shape = jax.ShapeDtypeStruct((1, H, W, jspec.in_channels), jnp.float32)
    ca = jax.jit(fn).lower(shape).compile().cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    return float(ca["flops"])


def _padding_flops(spec, h, w):
    """2 x the MACs of the convs' taps that fall on the zero padding of a
    SAME conv over an (h, w) frame."""
    def valid(n, k):                  # the taps inside the frame, summed along one axis
        return n * k - (k // 2) * (k // 2 + 1)
    chans = [spec.in_channels] + [spec.num_channels] * (spec.num_convs - 1) \
        + [spec.conv_out_channels]
    return 2 * sum((h * w * k * k - valid(h, k) * valid(w, k)) * chans[i] * chans[i + 1]
                   for i, k in enumerate(spec.kernel_sizes))


@pytest.mark.parametrize("path", costs.PATHS)
def test_jax_count_is_no_smaller(tmp_path, path):
    """XLA's cost analysis of the JAX package's path (the JAX ``profile``)
    counts at least the port's FLOPs at the same size: the split convs'
    and the elementwise work come on top of the convs. XLA leaves out a
    SAME conv's taps on the zero padding, so the plain float forward (no
    other work to speak of) is held to the port's count less those taps."""
    jax_flops, port = _jax_flops(path, tmp_path), _cost(path, tmp_path).flops
    assert port == costs.conv_flops(spec_for_task("sr_x2"), 1, H, W)
    if path == "float":
        port -= _padding_flops(spec_for_task("sr_x2"), H, W)
    assert jax_flops >= port > 0


@pytest.mark.parametrize("task", ["sr_x2", "nr"])
def test_deployment_bytes_hand_count(tmp_path, task):
    spec = spec_for_task(task)
    qp = QuantParams.load(os.path.join(ARTIFACTS, f"qparams_{task}.npz"))
    out_ch = {"sr_x2": 12, "nr": 3}[task]
    weights = HAND_MACS[task]                            # one int8 byte a weight
    biases = 4 * (16 * 4 + out_ch)                       # int32, one per output channel
    px = 2 * H * W
    for out_dtype, out_bytes in (("f32", 4), ("int8", 1)):
        assert costs.deployment_bytes(spec, qp, 2, H, W, out_dtype) == \
            px * 3 * 4 + px * out_ch * out_bytes + weights + biases
    c = _cost("deployment", tmp_path, task)
    mode = "fast" if task == "sr_x2" else "hybrid"
    assert c.label == f"deployment ({mode}, plain version on cpu)"
    assert c.flops == costs.conv_flops(spec, 1, H, W)
    assert c.bytes == costs.deployment_bytes(spec, qp, 1, H, W)
    assert c.output_bytes == H * W * out_ch * 4


def test_cli_profile_prints_jax_labels(capsys):
    args = ["profile", "--task", "sr_x2", "--qparams", QP_SR_X2, "--height", "64",
            "--width", "96"]
    c = cli.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    jcli.main(args)
    jax_out = capsys.readouterr().out
    for label in ("flops/frame", "bytes accessed", "arithmetic intensity"):
        assert label in out and label in jax_out
    lines = out.splitlines()
    assert lines[0] == "sr_x2 deployment (fast, plain version on cpu) @ 64x96:"
    assert lines[1] == f"  flops/frame:          {c.flops:.3e}  (25824/px; 2 x the convs' " \
                       f"MACs, from the shapes)"
    assert lines[3].startswith("  peak temp allocation: not measured on cpu; argument")


def test_cli_profile_float_path(tmp_path, capsys):
    cli.main(["profile", "--task", "sr_x2", "--path", "float", "--checkpoint",
              _collapsed_npz(tmp_path, "sr_x2"), "--height", "16", "--width", "24",
              "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("sr_x2 float @ 16x24:\n  flops/frame:")
    assert "(25824/px; FlopCounterMode)" in out and "every op's operands, unfused" in out


@pytest.mark.parametrize("path", ["deployment", "interpreter"])
def test_cli_profile_requires_qparams(path):
    for main in (cli.main, jcli.main):
        with pytest.raises(SystemExit, match=f"--path {path} requires --qparams"):
            main(["profile", "--task", "sr_x2", "--path", path])
