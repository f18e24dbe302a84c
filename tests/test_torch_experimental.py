"""The port's experimental models (sesr_tpu_torch/models/experimental.py)
against sesr_tpu.models.experimental: the same parameters (drawn in JAX,
crossing as numpy) and inputs give outputs within 1e-5, the tests of
tests/test_experimental.py on the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sesr_tpu.config import spec_for_task as jspec_for_task
from sesr_tpu.models import experimental as jexp
from sesr_tpu.models.sesr import init_params as jinit_params
from sesr_tpu_torch.config import spec_for_task
from sesr_tpu_torch.models.experimental import (InceptionSESRParams, SplitSESRParams,
                                                anchor_upsample, anchor_weights,
                                                forward_inception, forward_split,
                                                inception_path_spec)
from sesr_tpu_torch.models.sesr import CollapsedParams
from sesr_tpu_torch.ops.conv import nearest_upsample_x2
from tests.test_experimental import _path_params
from tests.test_torch_params import one_torch_thread  # noqa: F401 (fixture)

ATOL = 1e-5


def _port(p):
    """JAX CollapsedParams as the port's, through numpy."""
    return CollapsedParams([np.asarray(w) for w in p.weights], [np.asarray(b) for b in p.biases])


def test_inception_forward(rng):
    base, jbase = spec_for_task("sr_x4"), jspec_for_task("sr_x4")
    assert [(s.name, s.num_channels) for s in inception_path_spec(base)] == \
        [(s.name, s.num_channels) for s in jexp.inception_path_spec(jbase)]
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    jparams = jexp.InceptionSESRParams(
        [_path_params(s, k) for s, k in zip(jexp.inception_path_spec(jbase), keys)])
    params = InceptionSESRParams([_port(p) for p in jparams.paths])
    x = rng.random((1, 12, 16, 1), dtype=np.float32)
    y = forward_inception(base, params, x, device="cpu")
    assert y.shape == (1, 48, 64, 1)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jexp.forward_inception(jbase, jparams, jnp.asarray(x))),
        rtol=0, atol=ATOL)
    singles = []
    for cs in (1, 2, 3):
        y1 = forward_inception(base, params, x, single_path=True, conv_scale=cs, device="cpu")
        np.testing.assert_allclose(
            y1.numpy(), np.asarray(jexp.forward_inception(jbase, jparams, jnp.asarray(x),
                                                          single_path=True, conv_scale=cs)),
            rtol=0, atol=ATOL)
        assert not torch.allclose(y, y1)
        singles.append(y1)
    torch.testing.assert_close(singles[0] + singles[1] + singles[2], y, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        forward_inception(base, params, x, single_path=True, conv_scale=4, device="cpu")
    with pytest.raises(TypeError):
        forward_inception(base, params, x, single_path=2, device="cpu")


def test_split_forward(rng):
    spec, jspec = spec_for_task("sr_x4"), jspec_for_task("sr_x4")
    t = 8
    k1, k2, k3, k4, k5, k6, k7 = jax.random.split(jax.random.PRNGKey(1), 7)

    def conv_params(kk, ic, oc, k):
        w = jax.random.normal(kk, (k, k, ic, oc)) * 0.1
        return type(jinit_params(jspec, kk))([w], [jnp.zeros((oc,))])

    first = [conv_params(k1, 1, t, 5), conv_params(k2, 1, t // 2, 5),
             conv_params(k3, 1, t // 2, 5)]
    trunk = type(first[0])(
        [jax.random.normal(k4, (3, 3, 2 * t, 2 * t)) * 0.05 for _ in range(3)],
        [jnp.zeros((2 * t,)) for _ in range(3)])
    last = [conv_params(k5, t, 16, 5), conv_params(k6, t // 2, 16, 5),
            conv_params(k7, t // 2, 16, 5)]
    jparams = jexp.SplitSESRParams(first, trunk, last)
    params = SplitSESRParams([_port(p) for p in first], _port(trunk), [_port(p) for p in last])
    x = rng.random((1, 10, 14, 1), dtype=np.float32)
    y = forward_split(spec, params, x, tiny_channels=t, device="cpu")
    assert y.shape == (1, 40, 56, 1)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jexp.forward_split(jspec, jparams, jnp.asarray(x), tiny_channels=t)),
        rtol=0, atol=ATOL)
    # the three first convs as one CollapsedParams
    merged = CollapsedParams([p.weights[0] for p in params.first],
                             [p.biases[0] for p in params.first])
    torch.testing.assert_close(
        forward_split(spec, params._replace(first=merged), x, tiny_channels=t, device="cpu"),
        y, rtol=0, atol=0)


def test_anchor_is_nearest_upsample(rng):
    x = rng.random((1, 6, 8, 3), dtype=np.float32)
    y = anchor_upsample(x, 2, device="cpu")
    np.testing.assert_array_equal(y.numpy(), nearest_upsample_x2(torch.from_numpy(x)).numpy())
    np.testing.assert_array_equal(y.numpy(), np.asarray(jexp.anchor_upsample(jnp.asarray(x), 2)))
    w = anchor_weights(3, 2)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jexp.anchor_weights(3, 2)))
    assert float(w.sum()) == 3 * 4
