"""Per-layer halo exchange over the ranks of one mesh dimension.

Port of sesr_tpu/ops/halo.py on ``torch.distributed``. Sharded conv
execution exchanges k // 2 rows or columns with each spatial neighbour
before every conv, not one wide halo up front: the monolithic network
zero-pads each layer's input at the image borders, and a layer's output
inside a fetched halo is not zero (relu(bias) leaks in), so only a
per-layer exchange is exact. Ranks at the image edge have no neighbour on
that side and receive zeros: the monolithic SAME padding.

The integer path exchanges the zero-point-shifted tensor (q - zero), the
domain in which the reference's convolution zero-pads.

``halo_exchange_2d`` exchanges along H first, then along W on the
H-extended tensor: the columns a W-neighbour sends already hold the rows
it received from its own H-neighbour, so the corners arrive from the
diagonal neighbour in two hops.

The exchange is a ``torch.autograd.Function``: its backward sends each
received halo's gradient back to the rank it came from, which adds it into
its edge (the transpose of the exchange, which JAX derives from
``ppermute``). A group's tensors lie on its backend's device: CPU tensors
on gloo, CUDA tensors on NCCL; anything else raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def check_backend(x: torch.Tensor, group) -> None:
    """Raise ValueError unless ``group``'s backend takes ``x``'s device
    (gloo: CPU tensors, NCCL: CUDA tensors). A CUDA tensor is never staged
    through the host for a gloo group."""
    backend = dist.get_backend(group)
    if ("nccl" if x.is_cuda else "gloo") not in backend:
        raise ValueError(f"a {x.device.type} tensor on a {backend} group: gloo takes CPU "
                         "tensors, NCCL CUDA tensors")


def _swap(to_left: torch.Tensor, to_right: torch.Tensor, group):
    """Send ``to_left`` to the previous rank of ``group`` and ``to_right``
    to the next; return (from_left, from_right), zeros where there is no
    neighbour (the group does not wrap)."""
    n, i = group.size(), group.rank()
    from_left, from_right = torch.zeros_like(to_right), torch.zeros_like(to_left)
    ops = []
    if i > 0:
        left = dist.get_global_rank(group, i - 1)
        ops += [dist.P2POp(dist.isend, to_left, left, group),
                dist.P2POp(dist.irecv, from_left, left, group)]
    if i + 1 < n:
        right = dist.get_global_rank(group, i + 1)
        ops += [dist.P2POp(dist.isend, to_right, right, group),
                dist.P2POp(dist.irecv, from_right, right, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return from_left, from_right


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, halo, group, dim):
        ctx.halo, ctx.group, ctx.dim = halo, group, dim
        ext = x.shape[dim]
        low, high = _swap(x.narrow(dim, 0, halo).contiguous(),
                          x.narrow(dim, ext - halo, halo).contiguous(), group)
        return torch.cat([low, x, high], dim=dim)

    @staticmethod
    def backward(ctx, g):
        halo, dim = ctx.halo, ctx.dim
        ext = g.shape[dim] - 2 * halo
        grad = g.narrow(dim, halo, ext).clone()
        # the left neighbour's high halo was my low edge, the right one's
        # low halo my high edge
        from_left, from_right = _swap(g.narrow(dim, 0, halo).contiguous(),
                                      g.narrow(dim, halo + ext, halo).contiguous(), ctx.group)
        grad.narrow(dim, 0, halo).add_(from_left)
        grad.narrow(dim, ext - halo, halo).add_(from_right)
        return grad, None, None, None


def halo_exchange(x: torch.Tensor, halo: int, group=None, dim: int = 2) -> torch.Tensor:
    """Extend dim ``dim`` of ``x`` by ``halo`` on each side with the
    neighbouring ranks' data along ``group`` (a process group, or None: zero
    extension, the unsharded limit, as a group of one rank gives too).

    The exchange is one hop, so with more than one rank each must own at
    least ``halo`` elements along ``dim`` (ValueError otherwise)."""
    if halo == 0:
        return x
    if group is not None:
        check_backend(x, group)
    if group is None or group.size() == 1:
        pad = list(x.shape)
        pad[dim] = halo
        zeros = x.new_zeros(pad)
        return torch.cat([zeros, x, zeros], dim=dim)
    if x.shape[dim] < halo:
        raise ValueError(f"halo {halo} exceeds the local shard extent {x.shape[dim]} along "
                         f"dim {dim}: a single-hop neighbour exchange cannot source it")
    return _HaloExchange.apply(x, halo, group, dim)


def halo_exchange_w(x: torch.Tensor, halo: int, group) -> torch.Tensor:
    """(N, H, Wl, C) -> (N, H, Wl + 2 halo, C) along ``group``."""
    return halo_exchange(x, halo, group, dim=2)


def halo_exchange_2d(x: torch.Tensor, halo, h_group, w_group) -> torch.Tensor:
    """(N, Hl, Wl, C) -> (N, Hl + 2 halo_h, Wl + 2 halo_w, C): the H
    exchange, then the W exchange of the H-extended tensor (corners from
    the diagonal neighbour in two hops). ``halo``: one int for both axes or
    an (halo_h, halo_w) pair."""
    halo_h, halo_w = (halo, halo) if isinstance(halo, int) else halo
    x = halo_exchange(x, halo_h, h_group, dim=1)
    return halo_exchange(x, halo_w, w_group, dim=2)


def exchange_for_conv(x: torch.Tensor, k: int, halo_group):
    """``x`` extended by k // 2 along each sharded axis, and the conv's
    (w_valid, h_valid) flags. ``halo_group``, the hooks' argument: a group
    (W sharded), an (h_group, w_group) pair (the 2D mesh), or (None,
    w_group) (W over a flattened group of mesh dimensions)."""
    h_group, w_group = halo_group if isinstance(halo_group, tuple) else (None, halo_group)
    if h_group is not None:
        return halo_exchange_2d(x, k // 2, h_group, w_group), True, True
    return halo_exchange_w(x, k // 2, w_group), True, False
