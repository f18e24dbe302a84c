"""The port's training path on the CPU: the training checkpoint
(sesr_tpu_torch/io/checkpoint.py) and ``python -m sesr_tpu_torch train``
(save / resume, the collapsed --out that eval-float reads, preview PNGs)."""

import os
import shutil

import numpy as np
import pytest
import torch

from sesr_tpu_torch import cli, png
from sesr_tpu_torch.config import spec_for_task
from sesr_tpu_torch.io.checkpoint import load_training_state, save_training_state
from sesr_tpu_torch.models.expanded import init_expanded
from sesr_tpu_torch.quant import qat
from tests.test_torch_params import one_torch_thread  # noqa: F401 (fixture)

TRAIN = ["train", "--task", "sr_x4", "--n-images", "2", "--lr", "1e-3", "--device", "cpu"]


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for sub in tree for leaf in _leaves(sub)]


def test_checkpoint_round_trip(tmp_path):
    """Parameters, QAT observers, Adam's state and the step come back
    equal, into templates of the same structure."""
    spec = spec_for_task("sr_x4")
    params = init_expanded(spec, torch.Generator().manual_seed(1))
    for v in _leaves(params):
        v.requires_grad_()
    cfg = qat.QATConfig()
    opt = qat.adam(params, 1e-3)
    step = qat.make_train_step(spec, cfg, params, opt)
    qstate = qat.prepare(spec, cfg, "cpu")
    x = torch.rand((1, 8, 12, 1), generator=torch.Generator().manual_seed(2))
    gt = torch.rand((1, 32, 48, 1), generator=torch.Generator().manual_seed(3))
    for _ in range(2):
        qstate, _ = step(qstate, (x, gt))
    path = str(tmp_path / "sub" / "state.pt")
    save_training_state(path, params, qstate, opt.state_dict(), 2)
    assert os.listdir(tmp_path / "sub") == ["state.pt"]       # the temporary file moved
    fresh = init_expanded(spec, torch.Generator().manual_seed(9))
    p2, q2, o2, step_n = load_training_state(path, fresh, qat.prepare(spec, cfg, "cpu"))
    assert step_n == 2
    for a, b in zip(_leaves(params) + _leaves(qstate), _leaves(p2) + _leaves(q2)):
        assert a.dtype == b.dtype
        assert torch.equal(a.detach(), b)
    opt2 = qat.adam(p2, 1e-3)
    opt2.load_state_dict(o2)
    for s1, s2 in zip(opt.state.values(), opt2.state.values()):
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(s1[k], s2[k])
    other = spec_for_task("nrdm_3")
    with pytest.raises(ValueError):
        load_training_state(path, init_expanded(other, torch.Generator().manual_seed(0)),
                            qat.prepare(other, cfg, "cpu"))


@pytest.mark.parametrize("qat_on", [False, True], ids=["float", "qat"])
def test_resume_equals_uninterrupted(tmp_path, qat_on):
    """6 steps in one run, and 3 + 3 with a save and a resume between
    them (save every 2 steps, so the resumed run starts from its last
    save): the same parameters and observers, torch.equal."""
    extra = ["--qat"] if qat_on else []
    whole = cli.main(TRAIN + extra + ["--steps", "6"])
    path = str(tmp_path / "state.pt")
    first = cli.main(TRAIN + extra + ["--steps", "3", "--resume", path, "--save-every", "2"])
    assert first.start == 0
    second = cli.main(TRAIN + extra + ["--steps", "3", "--resume", path])
    assert second.start == 3 and len(second.losses) == 3
    assert whole.losses[3:] == second.losses
    for a, b in zip(_leaves(whole.params) + _leaves(whole.qstate),
                    _leaves(second.params) + _leaves(second.qstate)):
        assert torch.equal(a.detach(), b.detach())


def test_mid_run_save_resumes_equal(tmp_path, monkeypatch):
    """--save-every writes the state of its own step (parameters, QAT
    observers, Adam's moments): 4 steps resumed from the save at step 2 of
    a 3-step run equal 6 steps in one run, torch.equal."""
    saves = {}
    save = cli.save_training_state

    def keep(path, params, qstate, opt_state, step):
        save(path, params, qstate, opt_state, step)
        saves.setdefault(step, str(tmp_path / f"at{step}.pt"))
        shutil.copy(path, saves[step])

    monkeypatch.setattr(cli, "save_training_state", keep)
    whole = cli.main(TRAIN + ["--qat", "--steps", "6"])
    cli.main(TRAIN + ["--qat", "--steps", "3", "--resume", str(tmp_path / "state.pt"),
                      "--save-every", "2"])
    assert sorted(saves) == [2, 3]
    resumed = cli.main(TRAIN + ["--qat", "--steps", "4", "--resume", saves[2]])
    assert resumed.start == 2 and whole.losses[2:] == resumed.losses
    for a, b in zip(_leaves(whole.params) + _leaves(whole.qstate),
                    _leaves(resumed.params) + _leaves(resumed.qstate)):
        assert torch.equal(a.detach(), b.detach())


def test_train_out_feeds_eval_float(tmp_path, capsys):
    """--out writes the collapsed .npz that eval-float --checkpoint reads;
    the loss falls; a QAT run resumed from the float run's state writes
    the fake-quant-delta collapse."""
    out = str(tmp_path / "w.npz")
    state = str(tmp_path / "state.pt")
    res = cli.main(TRAIN + ["--steps", "8", "--resume", state, "--out", out])
    assert res.losses[-1] < res.losses[0]
    assert res.steps_per_second > 0
    capsys.readouterr()
    ev = cli.main(["eval-float", "--task", "sr_x4", "--checkpoint", out, "--n-images", "2",
                   "--device", "cpu"])
    assert "sr_x4 mean psnr:" in capsys.readouterr().out
    assert np.isfinite(ev.mean_psnr)
    with np.load(out) as ck:
        for i, w in enumerate(res.collapsed.weights):
            np.testing.assert_array_equal(ck[f"w_{i}"], w)
    q = cli.main(TRAIN + ["--steps", "2", "--resume", state, "--qat", "--out", out])
    assert q.start == 8
    assert "fake-quant-delta collapse" in capsys.readouterr().out


def test_preview_png_and_suffixless_out(tmp_path):
    prev = tmp_path / "prev"
    out = tmp_path / "weights"                  # no .npz suffix
    cli.main(TRAIN + ["--steps", "2", "--preview-dir", str(prev), "--preview-every", "2",
                      "--out", str(out)])
    img = png.read_png(str(prev / "preview_000002.png"))
    assert img.shape == (96, 128, 1) and img.dtype == np.uint8
    assert sorted(os.listdir(tmp_path)) == ["prev", "weights"]
    with np.load(str(out)) as ck:
        assert sorted(ck.files)[:2] == ["b_0", "b_1"]
