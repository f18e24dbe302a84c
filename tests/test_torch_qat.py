"""The port's QAT (sesr_tpu_torch/quant/qat.py) against sesr_tpu/quant/qat.py
on the same numpy-seeded inputs: fake-quant values and the STE gradient
(0.5 on the clip bounds, as jax.grad of jnp.clip gives), the observers,
the fake-quant forward and its observer states, one Adam step against
optax's, training that lowers the loss, sr_x2's skip-aware loss, and the
import of a reference QAT state dict."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sesr_tpu.config import spec_for_task as jspec_for_task
from sesr_tpu.quant import qat as jqat
from sesr_tpu_torch.config import spec_for_task
from sesr_tpu_torch.models.expanded import expanded_from_arrays
from sesr_tpu_torch.quant import qat
from tests.test_torch_expanded import jax_params, seeded_blocks
from tests.test_torch_params import one_torch_thread  # noqa: F401 (fixture)


def _specs(task):
    """The port's and the JAX package's spec of ``task``."""
    return spec_for_task(task), jspec_for_task(task)


def _states(lo, hi, flag=1):
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    return (qat.QuantizerState(torch.from_numpy(lo), torch.from_numpy(hi),
                               torch.tensor(flag, dtype=torch.int32)),
            jqat.QuantizerState(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(flag, jnp.int32)))


def _inputs(lo, hi, shape, seed):
    """Uniform values over [2 lo, 2 hi] with the bounds themselves and
    values that land exactly on qmin / qmax among them."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(2 * lo, 2 * hi, shape).astype(np.float32).reshape(-1)
    x[:4] = [lo, hi, 0.0, -0.0]
    return x.reshape(shape)


CASES = [  # (q_type, is_weight, per_channel)
    (0, False, False), (0, True, False), (1, False, False), (1, True, False), (0, True, True)]


@pytest.mark.parametrize("q_type,is_weight,per_channel", CASES)
def test_fake_quant_and_ste_gradient_equal_jax(q_type, is_weight, per_channel):
    shape = (3, 3, 4, 5)
    if per_channel:
        lo = -np.linspace(0.5, 1.5, 5)
        hi = np.linspace(0.4, 1.2, 5)
        lo, hi = lo.reshape(1, 1, 1, 5), hi.reshape(1, 1, 1, 5)
        x = _inputs(-1.0, 1.0, shape, 1)
    else:
        lo, hi = np.array([-0.7]), np.array([1.3])
        x = _inputs(-0.7, 1.3, shape, 1)
    ps, js = _states(lo, hi)
    xt = torch.from_numpy(x).requires_grad_()
    y = qat.fake_quant(xt, ps, 8, q_type, is_weight)
    want = jqat.fake_quant(jnp.asarray(x), js, 8, q_type, is_weight)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want))
    # a nonuniform cotangent, so every element's gradient is its own
    cot = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    (y * torch.from_numpy(cot)).sum().backward()
    g = jax.grad(lambda v: jnp.sum(jqat.fake_quant(v, js, 8, q_type, is_weight) * cot))(
        jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(g))


def test_clip_tie_gradient_is_half():
    """fake_quant(is_weight=True) at [1, -1, 0.5] with min / max +-1: 1 and
    -1 round exactly onto +-127, where the clip splits the gradient."""
    ps, js = _states([-1.0], [1.0])
    x = np.array([1.0, -1.0, 0.5], np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    qat.fake_quant(xt, ps, 8, 0, True).sum().backward()
    want = jax.grad(lambda v: jnp.sum(jqat.fake_quant(v, js, 8, 0, True)))(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(want), [0.5, 0.5, 1.0])
    np.testing.assert_array_equal(xt.grad.numpy(), [0.5, 0.5, 1.0])
    # outside the observer range the STE cuts the gradient
    ps, js = _states([-1.0], [1.0])
    xt = torch.tensor([0.5, -0.3, 5.0, -4.0], requires_grad=True)
    qat.fake_quant(xt, ps, 8, 0, False).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), [1.0, 1.0, 0.0, 0.0])


def _eq_state(p, j):
    for a, b in zip(p, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_observers_equal_jax():
    """Three observations in a row from a fresh state, each observer."""
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((2, 6, 7, 5)).astype(np.float32) * s for s in (1.0, 0.5, 2.0)]
    zeros, flag0 = np.zeros(1, np.float32), 0
    for per_channel in (False, True):
        shape = (5, 1, 1, 1) if per_channel else (1,)
        ps, js = _states(np.zeros(shape), np.zeros(shape), 0)
        pm, jm = ps, js
        for x in xs:
            ps = qat._minmax_update(ps, torch.from_numpy(x), per_channel)
            js = jqat._minmax_update(js, jnp.asarray(x), per_channel)
            _eq_state(ps, js)
            pm = qat._moving_avg_update(pm, torch.from_numpy(x), 0.1, per_channel)
            jm = jqat._moving_avg_update(jm, jnp.asarray(x), 0.1, per_channel)
            _eq_state(pm, jm)
    ps, js = _states(zeros, zeros, flag0)
    for x in xs:
        ps = qat._percentile_update(ps, torch.from_numpy(x), 0.1, 0.9999)
        js = jqat._percentile_update(js, jnp.asarray(x), 0.1, 0.9999)
        _eq_state(ps, js)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if hasattr(tree, "shape"):
        return [tree]
    return [leaf for sub in tree for leaf in _leaves(sub)]


def _torch_state(jstate):
    """A JAX QATState as the port's, on the CPU."""
    def qs(q):
        return qat.QuantizerState(*(torch.from_numpy(np.array(v)) for v in q))
    return qat.QATState(tuple(qat.ConvQuantState(qs(c.act), qs(c.weight)) for c in jstate.convs),
                        qat.AddQuantState(qs(jstate.add.res), qs(jstate.add.shortcut)))


@pytest.mark.parametrize("task", ["nrdm_3", "sr_x4"])
def test_qat_forward_close_to_jax(task):
    """One training-mode forward from fresh states: every weight observer
    and the first conv's input observer equal JAX's. The later activation
    observers see float32 conv outputs summed in another order, where one
    rounding flip at a domain's largest element moves its max by a step of
    the domain upstream: within rel 1e-3. Then the eval-mode forward from
    the same (JAX's) states, tests/test_qat.py's comparison: 1.5
    quantization steps of the widest domain at most, 1.5e-3 on average."""
    spec, jspec = _specs(task)
    blocks = seeded_blocks(spec, seed=4)
    x = np.random.default_rng(5).random((1, 12, 18, spec.in_channels), dtype=np.float32)
    cfg = qat.QATConfig()
    params = expanded_from_arrays(blocks)
    _, pstate = qat.qat_forward(spec, cfg, params, qat.prepare(spec, cfg, "cpu"), x)
    _, jstate = jqat.qat_forward(jspec, jqat.QATConfig(), jax_params(blocks),
                                 jqat.prepare(jspec), jnp.asarray(x))
    for i, (pc, jc) in enumerate(zip(pstate.convs, jstate.convs)):
        _eq_state(pc.weight, jc.weight)
        if i == 0:
            _eq_state(pc.act, jc.act)
        for a, b in zip(pc.act, jc.act):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-6)
    for a, b in zip(_leaves(pstate.add), _leaves(jstate.add)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-6)
    y, same = qat.qat_forward(spec, cfg, params, _torch_state(jstate), x, training=False)
    yj, _ = jqat.qat_forward(jspec, jqat.QATConfig(), jax_params(blocks), jstate,
                             jnp.asarray(x), training=False)
    for a, b in zip(_leaves(same), _leaves(jstate)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    diff = np.abs(y.numpy() - np.asarray(yj))
    step = max(float(jnp.maximum(jnp.abs(c.act.min_val), jnp.abs(c.act.max_val))[0]) / 127.5
               for c in jstate.convs)
    assert diff.max() <= 1.5 * step, (diff.max(), step)
    assert diff.mean() < 1.5e-3, diff.mean()


@pytest.mark.parametrize("task,qat_on", [("nrdm_3", False), ("sr_x4", False),
                                         ("sr_x4", True)])
def test_one_train_step_matches_optax(task, qat_on):
    """One make_train_step step of Adam + MSE at the QAT recipe's rate
    (1e-4): the loss within rel 1e-5, every leaf's gradient within 1e-5 of
    its largest element of jax.grad's of the same loss, and the updated
    parameters within 1e-6 of the optax step's. The gradient check sees
    what Adam's first update, about lr * sign(g), hides: a wrongly scaled
    gradient, or a clip whose tie gradient is 1 instead of 0.5. The QAT
    case runs sr_x4 (the task the QAT recipe ships) on a subsampled smooth
    image; on inputs where a float32 rounding flip moves an observer's max
    (test_qat_forward_close_to_jax), the two fake-quant forwards part by a
    quantization step, by design."""
    spec, jspec = _specs(task)
    blocks = seeded_blocks(spec, seed=6)
    rng = np.random.default_rng(7)
    if task == "sr_x4":
        gt = rng.random((1, 48, 72, 1), dtype=np.float32)
        x = np.ascontiguousarray(gt[:, ::4, ::4])
    else:
        x = rng.random((1, 12, 18, 3), dtype=np.float32)
        gt = rng.random((1, 12, 18, 3), dtype=np.float32)
    lr = 1e-4
    params = expanded_from_arrays(blocks)
    for v in _leaves(params):
        v.requires_grad_()
    cfg = qat.QATConfig() if qat_on else None
    step = qat.make_train_step(spec, cfg, params, qat.adam(params, lr))
    _, loss = step(qat.prepare(spec, qat.QATConfig(), "cpu"), (torch.from_numpy(x),
                                                               torch.from_numpy(gt)))
    jcfg = jqat.QATConfig() if qat_on else None
    opt = optax.adam(lr)
    jp = jax_params(blocks)
    jstep = jqat.make_train_step(jspec, jcfg, opt)
    jp2, _, _, jloss = jstep(jp, jqat.prepare(jspec, jqat.QATConfig()), opt.init(jp),
                             (jnp.asarray(x), jnp.asarray(gt)))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    for a, b in zip(_leaves(params), _leaves(jp2)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0, atol=1e-6)

    def jax_loss(p):
        if jcfg is None:
            y = jqat.forward_expanded(jspec, p, jnp.asarray(x))
        else:
            y, _ = jqat.qat_forward(jspec, jcfg, p, jqat.prepare(jspec, jcfg), jnp.asarray(x),
                                    training=True)
        return jnp.mean((y - gt) ** 2)

    # the step leaves its gradients on the leaves (zero_grad runs first)
    jgrads = jax.grad(jax_loss)(jp)
    for i, (a, b) in enumerate(zip(_leaves(params), _leaves(jgrads))):
        g, want = a.grad.numpy(), np.asarray(b)
        err = np.abs(g - want).max() / np.abs(want).max()
        assert err <= 1e-5, (i, err)


@pytest.mark.parametrize("qat_on", [False, True], ids=["float", "qat"])
def test_eight_steps_lower_the_loss(qat_on):
    spec = spec_for_task("sr_x4")
    params = expanded_from_arrays(seeded_blocks(spec, seed=8))
    for v in _leaves(params):
        v.requires_grad_()
    rng = np.random.default_rng(9)
    gt = rng.random((1, 32, 48, 1), dtype=np.float32)
    x = torch.from_numpy(np.ascontiguousarray(gt[:, ::4, ::4]))
    cfg = qat.QATConfig() if qat_on else None
    step = qat.make_train_step(spec, cfg, params, qat.adam(params, 1e-3))
    qstate = qat.prepare(spec, qat.QATConfig(), "cpu")
    losses = []
    for _ in range(8):
        qstate, loss = step(qstate, (x, torch.from_numpy(gt)))
        losses.append(float(loss))
    assert losses[-1] < 0.5 * losses[0], losses
    if qat_on:
        assert all(int(c.weight.num_flag) == 1 for c in qstate.convs)


def test_sr_x2_loss_scores_the_residual():
    """sr_x2 predicts a residual: the loss scores y + nearest_up(x) against
    the full image, as the JAX step does."""
    spec, jspec = _specs("sr_x2")
    blocks = seeded_blocks(spec, seed=10)
    rng = np.random.default_rng(11)
    x = rng.random((1, 8, 12, 3), dtype=np.float32)
    gt = rng.random((1, 16, 24, 3), dtype=np.float32)
    params = expanded_from_arrays(blocks)
    loss, _ = qat.train_loss(spec, None, params, None, torch.from_numpy(x),
                             torch.from_numpy(gt))
    y = qat.forward_expanded(spec, params, x, device="cpu").numpy()
    up = np.repeat(np.repeat(x, 2, axis=1), 2, axis=2)
    assert float(loss) == pytest.approx(float(np.mean((y + up - gt) ** 2)), rel=1e-6)
    opt = optax.adam(1e-3)
    jp = jax_params(blocks)
    jstep = jqat.make_train_step(jspec, None, opt)
    *_, jloss = jstep(jp, jqat.prepare(jspec), opt.init(jp),
                      (jnp.asarray(x), jnp.asarray(gt)))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)


def test_qat_state_from_state_dict_equals_jax():
    spec = spec_for_task("nrdm_3")
    rng = np.random.default_rng(12)
    names = (["conv_first"] + [f"residual_block.{i}" for i in range(spec.num_lblocks)]
             + ["conv_last"])
    sd = {}
    for name in names:
        for sub in ("conv_expand", "conv_squeeze"):
            for q in ("activation_quantizer", "weight_quantizer"):
                sd[f"{name}.{sub}.{q}.observer.min_val"] = -rng.random(1).astype(np.float32)
                sd[f"{name}.{sub}.{q}.observer.max_val"] = rng.random(1).astype(np.float32)
    for k in ("res", "shortcut"):
        sd[f"add_residual.observer_{k}.min_val"] = np.float32(-rng.random())
        sd[f"add_residual.observer_{k}.max_val"] = np.float32(rng.random())
    got = qat.qat_state_from_state_dict(spec, sd, device="cpu")
    want = jqat.qat_state_from_state_dict(jspec_for_task("nrdm_3"), sd)
    assert len(_leaves(got)) == len(_leaves(want))
    for a, b in zip(_leaves(got), _leaves(want)):
        assert a.dtype == (torch.int32 if np.asarray(b).dtype == np.int32 else torch.float32)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_quantized_activation_ops_equal_jax():
    rng = np.random.default_rng(13)
    x = rng.standard_normal((1, 6, 8, 3)).astype(np.float32)
    cfg, jcfg = qat.QATConfig(), jqat.QATConfig()
    ps, js = _states(np.zeros(1), np.zeros(1), 0)
    for fn, jfn, args in ((qat.quant_relu, jqat.quant_relu, (True,)),
                          (qat.quant_leaky_relu, jqat.quant_leaky_relu, (0.01, True)),
                          (qat.quant_adaptive_avg_pool, jqat.quant_adaptive_avg_pool,
                           ((3, 4), True))):
        y, st = fn(cfg, ps, torch.from_numpy(x), *args)
        yj, stj = jfn(jcfg, js, jnp.asarray(x), *args)
        if fn is qat.quant_adaptive_avg_pool:
            # a mean: another summation order
            np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(y.numpy(), np.asarray(yj))
        _eq_state(st, stj)
