"""The port's halo exchange (sesr_tpu_torch/ops/halo.py) on gloo ranks and
the rank launcher (sesr_tpu_torch/parallel/launch.py).

One world of four ranks starts once for the module and runs every check
(tests/test_torch_ranks.py ``halo_world``) on a (1, 4) and a (1, 2, 2)
mesh: the exchanged blocks against the zero-padded global array (the
edges' zeros included), the refusal of a halo wider than a block, and the
backward of a VALID conv on exchanged blocks against the gradient of the
monolithic SAME conv, in float64.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from sesr_tpu_torch.ops import halo
from sesr_tpu_torch.ops.conv import conv2d_nhwc
from sesr_tpu_torch.parallel.launch import spawn
from tests.test_torch_ranks import failing_rank, halo_world, sleeping_rank

X_SHAPE, C_OUT = (1, 8, 16, 3), 2


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return rng.standard_normal(X_SHAPE), rng.standard_normal(X_SHAPE[:3] + (C_OUT,))


@pytest.fixture(scope="module")
def world(inputs):
    return spawn(halo_world, 4, "gloo", *inputs)[0]


def _blocks(x, n_h, n_w, halo_h, halo_w):
    """The exchanged blocks of a (n_h, n_w) grid, laid side by side as the
    gather builds them: each block of the zero-padded array."""
    pad = np.pad(x, ((0, 0), (halo_h, halo_h), (halo_w, halo_w), (0, 0)))
    bh, bw = x.shape[1] // n_h, x.shape[2] // n_w
    return np.concatenate([np.concatenate(
        [pad[:, i * bh:(i + 1) * bh + 2 * halo_h, j * bw:(j + 1) * bw + 2 * halo_w]
         for j in range(n_w)], axis=2) for i in range(n_h)], axis=1)


@pytest.mark.parametrize("case,grid,halos", [("1d_ext", (1, 4), (0, 2)),
                                             ("1d_ext_h", (1, 4), (0, 1)),
                                             ("2d_ext", (2, 2), (1, 2))])
def test_exchange_values_and_edge_zeros(world, inputs, case, grid, halos):
    np.testing.assert_array_equal(world[case], _blocks(inputs[0], *grid, *halos))


def test_exchange_refuses_a_halo_wider_than_a_block(world):
    assert "exceeds the local shard extent 4" in world["1d_refused"]


@pytest.mark.parametrize("mesh", ["1d", "2d"])
def test_exchange_backward_equals_monolithic_gradient(world, inputs, mesh):
    x, g = (torch.as_tensor(a) for a in inputs)
    w5 = torch.as_tensor(np.random.default_rng(5).standard_normal((5, 5, X_SHAPE[3], C_OUT)))
    x.requires_grad_(True)
    y = conv2d_nhwc(x, w5)
    (y * g).sum().backward()
    np.testing.assert_allclose(world[f"{mesh}_y"], y.detach().numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(world[f"{mesh}_grad"], x.grad.numpy(), rtol=1e-12, atol=1e-12)


def test_exchange_without_group_zero_extends():
    x = torch.arange(24.0).reshape(1, 2, 4, 3)
    assert halo.halo_exchange(x, 0, None) is x
    np.testing.assert_array_equal(halo.halo_exchange_2d(x, (1, 2), None, None).numpy(),
                                  np.pad(x.numpy(), ((0, 0), (1, 1), (2, 2), (0, 0))))


def test_valid_conv_on_zero_extension_equals_same():
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal((1, 6, 9, 3)))
    w = torch.as_tensor(rng.standard_normal((3, 3, 3, 4)))
    ext = halo.halo_exchange_2d(x, 1, None, None)
    np.testing.assert_allclose(conv2d_nhwc(ext, w, w_valid=True, h_valid=True).numpy(),
                               conv2d_nhwc(x, w).numpy(), rtol=1e-12, atol=1e-12)


def test_a_group_takes_only_its_backends_device(monkeypatch):
    """A CPU tensor on an NCCL group, or a CUDA tensor on a gloo group,
    raises: it is never staged through the host."""
    monkeypatch.setattr(dist, "get_backend", lambda group: "nccl")
    with pytest.raises(ValueError, match="gloo takes CPU tensors"):
        halo.check_backend(torch.zeros(2), object())
    monkeypatch.setattr(dist, "get_backend", lambda group: "gloo")
    halo.check_backend(torch.zeros(2), object())


def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn(failing_rank, 2, "gloo", timeout=60)


def test_spawn_ends_ranks_that_run_past_the_timeout():
    with pytest.raises(TimeoutError):
        spawn(sleeping_rank, 1, "gloo", timeout=4)
