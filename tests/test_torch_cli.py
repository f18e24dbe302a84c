"""The port end to end on the CPU: ``infer`` (serve) on sr_x2 and nr,
with and without ``--save-dir``, ``sim`` (simulate), reference-exact
and ``--corrected``, ``export`` and ``hist``, ``eval-float`` and
``calibrate`` from collapsed float weights, against the JAX package; the
reference fixture loader; the import boundary of the
port and of chip_smoke.py, and chip_smoke.py refusing to run without a
card or without the repository around it."""

import ast
import os
import re
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sesr_tpu import cli as jcli
from sesr_tpu.config import spec_for_task as jspec_for_task
from sesr_tpu.data.datasets import SyntheticDataset as JSyntheticDataset
from sesr_tpu.metrics import evaluate_pair as jevaluate_pair
from sesr_tpu.quant.integer import integer_forward as jinteger_forward
from sesr_tpu.quant.params import QuantParams as JQuantParams
from sesr_tpu_torch import cli, metrics, png
from sesr_tpu_torch.config import spec_for_task
from sesr_tpu_torch.data import SyntheticDataset
from sesr_tpu_torch.ops.fast import fast_forward
from sesr_tpu_torch.quant.observers import CHART_HEIGHT
from sesr_tpu_torch.quant.params import QuantParams
from tests.test_torch_params import one_torch_thread  # noqa: F401 (fixture)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
QP = os.path.join(REPO, "artifacts", "qparams_sr_x2.npz")
QP_NR = os.path.join(REPO, "artifacts", "qparams_nr.npz")
FORBIDDEN = {"jax", "jaxlib", "sesr_tpu", "tools", "optax", "flax"}


def _psnr_line(text):
    m = re.search(r"mean psnr: (\S+)\s+ssim: (\S+)\s+\((\d+) images\)", text)
    return m.groups()


def test_synthetic_data_and_metrics_match_jax():
    # every task's synthetic set, the Bayer tasks' mosaic and noise included
    for task in ("sr_x2", "sr_x4", "nr", "dm", "nrdm_3", "nrdm_6"):
        for (i_t, g_t), (i_j, g_j) in zip(SyntheticDataset(task, n=2),
                                          JSyntheticDataset(task, n=2)):
            np.testing.assert_array_equal(i_t, i_j)
            np.testing.assert_array_equal(g_t, g_j)
    rng = np.random.default_rng(2)
    gt = rng.random((32, 48, 3))
    pred = np.clip(gt + rng.normal(0, 0.05, gt.shape), -0.1, 1.1)
    inp = 0.1 * gt[::2, ::2]                # the sr_x2 global skip's input
    for task in ("sr_x2", "sr_x4", "nr", "dm", "nrdm_3"):
        p, g = (pred[:, :, :1], gt[:, :, :1]) if task == "sr_x4" else (pred, gt)
        kw = {"inp_hwc": inp} if task == "sr_x2" else {}
        assert metrics.evaluate_pair(task, p, g, **kw) == \
            jevaluate_pair(task, p, g, **kw), task


def test_serve_matches_jax_fast_path():
    """The dequantized outputs serve() scores are array-equal to the JAX
    certified fast interpreter's, and so are the scores."""
    spec, jspec = spec_for_task("sr_x2"), jspec_for_task("sr_x2")
    qp, jqp = QuantParams.load(QP), JQuantParams.load(QP)
    data = list(SyntheticDataset("sr_x2", n=3))
    res = cli.serve(spec, qp, data, batch=2, device="cpu")
    assert res.mode == "fast" and res.finite and res.n == 3
    assert res.out_shapes == [(2, 96, 128, 3), (1, 96, 128, 3)]
    want_p = []
    for inp, gt in data:
        y_j, _ = jinteger_forward(jspec, jqp, jnp.asarray(inp), corrected=True,
                                  compute="fast")
        y_t = fast_forward(spec, qp, inp, device="cpu")
        np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
        want_p.append(jevaluate_pair("sr_x2", np.asarray(y_j)[0], gt[0], inp[0]))
    assert [(p, s) for p, s in zip(res.psnr, res.ssim)] == want_p
    res8 = cli.serve(spec, qp, data, batch=1, out_dtype="int8", device="cpu")
    assert res8.psnr == res.psnr and res8.ssim == res.ssim


def test_infer_command_prints_the_jax_scores(capsys):
    cli.main(["infer", "--task", "sr_x2", "--qparams", QP, "--n-images", "2",
              "--device", "cpu"])
    port = capsys.readouterr().out
    assert port.startswith("sr_x2 cpu(fast) mean psnr")
    jcli.main(["infer", "--task", "sr_x2", "--qparams", QP, "--n-images", "2"])
    jax_out = capsys.readouterr().out
    assert _psnr_line(port) == _psnr_line(jax_out)


def test_sim_command_matches_jax_reference(tmp_path, capsys):
    spec, jspec = spec_for_task("sr_x2"), jspec_for_task("sr_x2")
    jqp = JQuantParams.load(QP)
    x = np.random.default_rng(9).random((1, 30, 44, 3), dtype=np.float32)
    np.save(tmp_path / "x.npy", x)
    res = cli.main(["sim", "--task", "sr_x2", "--qparams", QP, "--fixture",
                    str(tmp_path / "x.npy"), "--dump-dir", str(tmp_path / "d"),
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert "plain interpreter on cpu" in out and "overflow counts" in out
    y_j, d_j = jinteger_forward(jspec, jqp, jnp.asarray(x), collect_dumps=True)
    np.testing.assert_array_equal(res.y.numpy(), np.asarray(y_j))
    assert res.matches_plain is True
    assert res.overflow_counts == [int(v) for v in d_j["overflow_counts"]]
    saved = np.load(tmp_path / "d" / "dumps.npz")
    for k in d_j:
        np.testing.assert_array_equal(saved[k], np.asarray(d_j[k]), err_msg=k)
    # without a dump dir nothing but the forward runs
    res2 = cli.simulate(spec, QuantParams.load(QP), x, device="cpu")
    assert res2.overflow_counts is None and torch.equal(res2.y, res.y)
    cli.main(["sim", "--task", "sr_x2", "--qparams", QP, "--device", "cpu"])
    assert "not computed" in capsys.readouterr().out


def _mode_and_scores(text):
    """(mode, psnr, ssim, n) of an infer line, the port's
    "nr cpu(hybrid, int8) mean psnr: ..." or JAX's "nr packed(1x8,
    hybrid, int8) mean psnr: ..."."""
    m = re.search(r"\((?:\d+x\d+, )?([a-z-]+)[^)]*\) mean psnr", text)
    return (m.group(1),) + _psnr_line(text)


def test_infer_nr_prints_the_jax_mode_and_scores(tmp_path, capsys):
    """nr serves in the hybrid mode on the CPU, with JAX's scores; with
    --save-dir both write the int8 contract's outputs as the same 8-bit
    PNGs."""
    args = ["infer", "--task", "nr", "--qparams", QP_NR, "--n-images", "2"]
    cli.main(args + ["--device", "cpu"])
    port = capsys.readouterr().out
    assert port.startswith("nr cpu(hybrid) mean psnr")
    jcli.main(args)
    assert _mode_and_scores(port) == _mode_and_scores(capsys.readouterr().out)
    res = cli.main(args + ["--device", "cpu", "--save-dir", str(tmp_path / "port")])
    port = capsys.readouterr().out
    assert port.startswith("nr cpu(hybrid, int8) mean psnr") and res.out_shapes[0][0] == 1
    jcli.main(args + ["--save-dir", str(tmp_path / "jax")])
    assert _mode_and_scores(port) == _mode_and_scores(capsys.readouterr().out)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == ["out_0000.png", "out_0001.png"]
    for name in names:
        got = png.read_png(str(tmp_path / "port" / name))
        want = np.asarray(Image.open(tmp_path / "jax" / name))
        assert got.shape == want.shape == (96, 128, 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("task", ["nr", "sr_x2"])
def test_infer_data_folder_matches_jax(tmp_path, capsys, task):
    """infer --data on a folder: .raw Bayer planes with 12-bit PNG ground
    truth (nr), a GTmod12 / LRbicx2 pair of folders (sr_x2); the same
    scores as the JAX command on the same files."""
    rng = np.random.default_rng(13)
    if task == "nr":
        data = tmp_path / "raw"
        data.mkdir()
        for name in ("0801", "0802"):
            rng.integers(0, 4096, (24, 40)).astype(np.uint16).tofile(data / f"{name}_24_40.raw")
            Image.fromarray(rng.integers(0, 4096, (24, 40)).astype(np.uint16)).save(
                data / f"{name}.png")
    else:
        data = tmp_path / "GTmod12"
        (tmp_path / "LRbicx2").mkdir()
        data.mkdir()
        for name in ("a.png", "b.png"):
            Image.fromarray(rng.integers(0, 256, (24, 40, 3)).astype(np.uint8)).save(data / name)
            Image.fromarray(rng.integers(0, 256, (12, 20, 3)).astype(np.uint8)).save(
                tmp_path / "LRbicx2" / name)
    args = ["infer", "--task", task, "--qparams",
            os.path.join(REPO, "artifacts", f"qparams_{task}.npz"), "--data", str(data)]
    res = cli.main(args + ["--device", "cpu"])
    port = capsys.readouterr().out
    assert res.n == 2 and res.finite
    jcli.main(args)
    assert _mode_and_scores(port) == _mode_and_scores(capsys.readouterr().out)


def test_sim_corrected_matches_jax(tmp_path, capsys):
    """sim --corrected runs the corrected datapath: output and every dump
    array-equal to JAX's integer_forward(corrected=True), and to the JAX
    command's dump file."""
    jspec = jspec_for_task("nr")
    jqp = JQuantParams.load(QP_NR)
    x = np.random.default_rng(10).random((1, 26, 34, 3), dtype=np.float32)
    np.save(tmp_path / "x.npy", x)
    args = ["sim", "--task", "nr", "--qparams", QP_NR, "--fixture", str(tmp_path / "x.npy"),
            "--corrected"]
    res = cli.main(args + ["--dump-dir", str(tmp_path / "port"), "--device", "cpu"])
    assert "plain interpreter on cpu" in capsys.readouterr().out
    y_j, d_j = jinteger_forward(jspec, jqp, jnp.asarray(x), collect_dumps=True,
                                corrected=True)
    np.testing.assert_array_equal(res.y.numpy(), np.asarray(y_j))
    assert res.matches_plain is True
    assert res.overflow_counts == [int(v) for v in d_j["overflow_counts"]]
    jcli.main(args + ["--dump-dir", str(tmp_path / "jax")])
    port, jax_dumps = np.load(tmp_path / "port" / "dumps.npz"), np.load(tmp_path / "jax" / "dumps.npz")
    assert sorted(port.files) == sorted(jax_dumps.files)
    for k in jax_dumps.files:
        np.testing.assert_array_equal(port[k], jax_dumps[k], err_msg=k)
    # the reference-exact simulation of the same input differs
    ref = cli.simulate(spec_for_task("nr"), QuantParams.load(QP_NR), x, device="cpu")
    assert not torch.equal(ref.y, res.y)


def _numbers(text):
    return [float(v) for v in re.findall(r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?", text)]


def _collapsed_npz(tmp_path, task):
    """The golden bundle's collapsed float weights as a w_i (HWIO) / b_i .npz."""
    from tests.test_integer_bitexact import _load_golden
    g = _load_golden(task)
    L = int(g["num_convs"])
    path = str(tmp_path / f"{task}_collapsed.npz")
    np.savez(path, **{f"w_{i}": np.transpose(g[f"w_collapsed_{i}"], (2, 3, 1, 0))
                      for i in range(L)},
             **{f"b_{i}": g[f"b_collapsed_{i}"] for i in range(L)})
    return path


@pytest.mark.parametrize("task", ["sr_x2", "nr"])
def test_eval_float_prints_jax_numbers(tmp_path, capsys, task):
    args = ["eval-float", "--task", task, "--checkpoint", _collapsed_npz(tmp_path, task),
            "--n-images", "2"]
    res = cli.main(args + ["--device", "cpu"])
    port = capsys.readouterr().out
    jcli.main(args)
    jax_out = capsys.readouterr().out
    assert len(port.splitlines()) == len(jax_out.splitlines()) == 3
    np.testing.assert_allclose(_numbers(port), _numbers(jax_out), rtol=0, atol=2e-4)
    assert f"{task} mean psnr: {res.mean_psnr:.4f}" in port


@pytest.mark.parametrize("observer", ["minmax", "kl"])
def test_calibrate_prints_jax_numbers(tmp_path, capsys, observer):
    """sr_x4 from the shipped collapsed QAT weights: the fake-quant psnr and
    every domain's scale and zero, and the artifact; KL on nr is refused
    without --force in both, and kept with it."""
    ck = os.path.join(REPO, "artifacts", "sr_x4_qat_collapsed.npz")
    args = ["calibrate", "--task", "sr_x4", "--checkpoint", ck, "--n-images", "2",
            "--observer", observer]
    qp = cli.main(args + ["--out", str(tmp_path / "port.npz"), "--device", "cpu"])
    port = capsys.readouterr().out
    jcli.main(args + ["--out", str(tmp_path / "jax.npz")])
    jax_out = capsys.readouterr().out
    p_lines, j_lines = port.splitlines(), jax_out.splitlines()
    assert len(p_lines) == len(j_lines) == 2 + qp.num_convs + 1
    np.testing.assert_allclose(_numbers(p_lines[1]), _numbers(j_lines[1]), atol=0.01)
    jqp = JQuantParams.load(str(tmp_path / "jax.npz"))
    for d, (pl, jl) in enumerate(zip(p_lines[2:], j_lines[2:])):
        (ps, pz), (js, jz) = _numbers(pl)[1:], _numbers(jl)[1:]
        assert ps == pytest.approx(js, rel=3e-3) and abs(pz - jz) <= 2, d
        assert pl == f"domain {d}: scale={qp.a_scale[d]:.6g} zero={qp.a_zero[d]}"
        assert qp.a_scale[d] == pytest.approx(jqp.a_scale[d], rel=3e-3)
    saved = QuantParams.load(str(tmp_path / "port.npz"))
    assert (saved.a_scale, saved.a_zero) == (qp.a_scale, qp.a_zero)


def test_calibrate_kl_guardrail_and_adaround_refused(tmp_path, capsys):
    args = ["calibrate", "--task", "nr", "--checkpoint", _collapsed_npz(tmp_path, "nr"),
            "--n-images", "2", "--observer", "kl", "--no-eval"]
    with pytest.raises(SystemExit, match="--force"):
        cli.main(args + ["--out", str(tmp_path / "kl.npz"), "--device", "cpu"])
    with pytest.raises(SystemExit, match="--force"):
        jcli.main(args + ["--out", str(tmp_path / "jkl.npz")])
    qp = cli.main(args + ["--out", str(tmp_path / "kl.npz"), "--device", "cpu", "--force"])
    assert "WARNING (forced)" in capsys.readouterr().err
    assert QuantParams.load(str(tmp_path / "kl.npz")).a_scale == qp.a_scale
    # adaround is a choice since the rounding was ported
    # (tests/test_torch_adaround.py); another name is still refused
    with pytest.raises(SystemExit):
        cli.main(args + ["--out", str(tmp_path / "x.npz"), "--weight-rounding", "stochastic"])
    assert "invalid choice: 'stochastic'" in capsys.readouterr().err


def _tree(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def test_export_command_matches_jax(tmp_path, capsys):
    """export on a ragged input: the JAX command's tree, byte for byte."""
    x = np.random.default_rng(12).random((1, 33, 47, 3), dtype=np.float32)
    np.save(tmp_path / "x.npy", x)
    args = ["export", "--task", "nr", "--qparams", QP_NR, "--fixture", str(tmp_path / "x.npy")]
    res = cli.main(args + ["--out-dir", str(tmp_path / "port"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "the output of plain interpreter on cpu equals the interpreter's" in out
    assert f"{len(res.files)} files" in out and len(res.files) == 40
    jcli.main(args + ["--out-dir", str(tmp_path / "jax")])
    port, jax = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(port) == sorted(jax) and all(port[k] == jax[k] for k in jax)
    assert res.nbytes == sum(len(v) for v in port.values())


def test_reference_fixture_loader(tmp_path, monkeypatch, capsys):
    """The reference's sim input under SESR_REFERENCE_ROOT: sr_x4 reads
    rand_SR_Input_80x960.pt, every other task rand_DM_Input_80x960.pt;
    sim and export take it without --fixture. Without it, sim keeps the
    first synthetic input and export refuses, naming --fixture."""
    from sesr_tpu_torch.data.datasets import load_reference_fixture
    x = np.random.default_rng(13).random((1, 3, 20, 36), dtype=np.float32)
    torch.save(torch.from_numpy(x), tmp_path / "rand_DM_Input_80x960.pt")
    monkeypatch.setenv("SESR_REFERENCE_ROOT", str(tmp_path))
    got = load_reference_fixture("sr_x2")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, x.transpose(0, 2, 3, 1))
    with pytest.raises(FileNotFoundError, match="rand_SR_Input_80x960.pt"):
        load_reference_fixture("sr_x4")
    res = cli.main(["sim", "--task", "nr", "--qparams", QP_NR, "--device", "cpu"])
    assert f"sim input: {tmp_path / 'rand_DM_Input_80x960.pt'}" in capsys.readouterr().out
    want = cli.simulate(spec_for_task("nr"), QuantParams.load(QP_NR), x.transpose(0, 2, 3, 1),
                        device="cpu")
    assert torch.equal(res.y, want.y)
    exp = cli.main(["export", "--task", "nr", "--qparams", QP_NR, "--out-dir",
                    str(tmp_path / "vectors"), "--device", "cpu"])
    assert "input (1, 20, 36, 3)" in capsys.readouterr().out and len(exp.files) == 40
    monkeypatch.setenv("SESR_REFERENCE_ROOT", str(tmp_path / "absent"))
    with pytest.raises(SystemExit, match="--fixture"):
        cli.main(["export", "--task", "nr", "--qparams", QP_NR, "--out-dir",
                  str(tmp_path / "none"), "--device", "cpu"])
    assert not os.path.exists(tmp_path / "none")
    res = cli.main(["sim", "--task", "nr", "--qparams", QP_NR, "--device", "cpu"])
    assert "the first synthetic input" in capsys.readouterr().out
    first = SyntheticDataset("nr", n=1)[0][0]
    want = cli.simulate(spec_for_task("nr"), QuantParams.load(QP_NR), first, device="cpu")
    assert torch.equal(res.y, want.y)


def test_hist_command_writes_the_jax_tree(tmp_path, capsys):
    """hist from collapsed float weights: the JAX command's PNG tree, and
    each domain's range and count printed."""
    args = ["hist", "--task", "sr_x2", "--checkpoint", _collapsed_npz(tmp_path, "sr_x2"),
            "--n-images", "2"]
    res = cli.main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    out = capsys.readouterr().out
    jcli.main(args + ["--out", str(tmp_path / "jax")])
    assert sorted(_tree(tmp_path / "port")) == sorted(_tree(tmp_path / "jax"))
    assert f"wrote {len(res.files)} histogram PNGs" in out and len(res.files) == 16
    for d in range(6):
        assert (f"domain {d}: range [{res.lo[d]:.6g}, {res.hi[d]:.6g}], "
                f"{int(res.activation[d].sum())} values") in out
    for path in res.files:
        assert png.read_png(path).shape[0] == CHART_HEIGHT


def test_import_boundary():
    code = ("import sys, sesr_tpu_torch, sesr_tpu_torch.cli, sesr_tpu_torch.convert, "
            "sesr_tpu_torch.models.sesr, sesr_tpu_torch.models.blocks, "
            "sesr_tpu_torch.io.torch_import, sesr_tpu_torch.quant.qat, "
            "sesr_tpu_torch.quant.observers, sesr_tpu_torch.quant.calibrate, "
            "sesr_tpu_torch.quant.strict, sesr_tpu_torch.quant.certify, "
            "sesr_tpu_torch.quant.audit, sesr_tpu_torch.quant.adaround, "
            "sesr_tpu_torch.quant.frozen_add, sesr_tpu_torch.models.expanded, "
            "sesr_tpu_torch.io.checkpoint, sesr_tpu_torch.make_qparams, "
            "sesr_tpu_torch.__main__, sesr_tpu_torch.deploy, sesr_tpu_torch.png, "
            "sesr_tpu_torch.data.bayer, sesr_tpu_torch.data.datasets, "
            "sesr_tpu_torch.ops.corrected, sesr_tpu_torch.probes, sesr_tpu_torch.probes.conv, "
            "sesr_tpu_torch.probes.int8_gemm, sesr_tpu_torch.probes.bitcast, "
            "sesr_tpu_torch.probes.__main__, sesr_tpu_torch.export.vectors, "
            "sesr_tpu_torch.models.experimental, sesr_tpu_torch.parallel, "
            "sesr_tpu_torch.parallel.launch, sesr_tpu_torch.parallel.tiling, "
            "sesr_tpu_torch.parallel.multihost, sesr_tpu_torch.ops.halo, "
            "sesr_tpu_torch.ops.slab, sesr_tpu_torch.bench, sesr_tpu_torch.costs\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r})\n"
            "print(bad)\n"
            "assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_sources_import_neither_jax_nor_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "sesr_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        assert not (_imported_roots(path) & FORBIDDEN), path
    assert "sesr_tpu_torch" in _imported_roots(os.path.join(REPO, "chip_smoke.py"))


def test_chip_smoke_refuses_without_card_or_repo(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for script, cwd in ((os.path.join(REPO, "chip_smoke.py"), REPO),
                        (str(alone), str(tmp_path))):
        res = subprocess.run([sys.executable, script], cwd=cwd, capture_output=True,
                             text=True, timeout=300)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout
