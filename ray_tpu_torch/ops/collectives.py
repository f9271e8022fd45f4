"""Differentiable collectives for the tensor- and expert-parallel layers.

They come in conjugate pairs (Megatron's ``f`` and ``g``), so that a
gradient is summed exactly once over the ranks that split a product:

- ``copy_to``: a tensor every rank holds whole enters a split product:
  identity forward, all-reduce of the gradient backward (each rank's
  gradient covers only its part of the product);
- ``reduce_from``: the partial sums of a split product leave it:
  all-reduce forward, identity backward (every rank computes the same
  loss from the sum, so each part's gradient is the sum's);
- ``gather_from``: each rank's slice of a tensor along ``dim`` is
  gathered: all-gather forward, the rank's own slice of the gradient
  backward (the gathered tensor feeds the same computation on every rank).

The sequence- and pipeline-parallel exchanges are permutations, whose
transpose is the inverse permutation (JAX transposes ``ppermute`` and
``all_to_all`` so):

- ``ring_shift``: each rank's tensor moves to the next rank of the group
  (``lax.ppermute`` with ``perm = [(i, (i + 1) % n)]``), by
  ``batch_isend_irecv``; the gradient moves back to the previous rank;
- ``all_to_all``: ``lax.all_to_all(..., tiled=True)``: ``x`` is split in
  ``n`` along one dim, part ``j`` goes to rank ``j``, and the parts
  received are concatenated in rank order along another dim, by
  ``all_to_all_single`` on one contiguous buffer; the gradient takes the
  inverse exchange;
- ``all_gather``: the ranks' tensors concatenated along a dim, with no
  gradient (segment ids).

Every rank runs each exchange's backward in the order its forward ran
(one chain of exchanges a rank), so the collectives of the backward meet.

``groups`` is a sequence of process groups: a collective over several is
the same collective run over each in turn, which over the axes of a mesh
covers the ranks that share every other coordinate. A group of one rank
still runs its collective (a copy), so a one-rank mesh takes the path a
larger one takes.

Under ``torch.inference_mode`` (serving) there is no gradient to route:
``copy_to`` returns its input and ``reduce_from`` sums in place into its
input (a temporary of the layer that calls it), without the autograd
Function and the clone, whose host time a decode step pays once a
collective.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def _all_reduce(x: torch.Tensor, groups: Sequence, op=None) -> torch.Tensor:
    """The sum (or ``op``) of ``x`` over ``groups``, in a new tensor."""
    out = x.clone(memory_format=torch.contiguous_format)
    for group in groups:
        dist.all_reduce(out, op=op or dist.ReduceOp.SUM, group=group)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.groups), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        return _all_reduce(x, groups)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.rank, ctx.n, ctx.dim = dist.get_group_rank(
            group, dist.get_rank()), dist.get_world_size(group), dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.n, dim=ctx.dim)[ctx.rank].contiguous(), None, \
            None


def _ring_exchange(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """``x`` sent ``step`` (+1 or -1) places round the ring of ``group``;
    returns what the rank ``step`` places before it sent. A one-rank
    group sends to itself: a copy."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    if n == 1:
        return x.clone()
    rank = dist.get_group_rank(group, dist.get_rank())
    dst = dist.get_global_rank(group, (rank + step) % n)
    src = dist.get_global_rank(group, (rank - step) % n)
    out = torch.empty_like(x)
    for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, dst, group),
                                        dist.P2POp(dist.irecv, out, src,
                                                   group)]):
        work.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _ring_exchange(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _ring_exchange(grad, ctx.group, -1), None


def _exchange(x: torch.Tensor, group, split_dim: int,
              concat_dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    send = torch.stack(x.chunk(n, split_dim))      # [n, ...] contiguous
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return _exchange(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return (_exchange(grad.contiguous(), ctx.group, concat_dim,
                          split_dim), None, None, None)


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """The tensor of the previous rank of ``group`` (rank ``i`` sends to
    ``(i + 1) % n``); the gradient is shifted back. On a one-rank group
    the shift is a copy."""
    return _RingShift.apply(x, group)


def all_to_all(x: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """JAX's tiled ``all_to_all``: ``x`` split in ``n`` parts along
    ``split_dim``, part ``j`` sent to rank ``j``, the received parts
    concatenated along ``concat_dim`` in rank order (a new contiguous
    tensor); the gradient takes the inverse exchange."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (no
    gradient)."""
    n = dist.get_world_size(group)
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(n)]
    dist.all_gather(parts, x.detach().contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def copy_to(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over ``groups``."""
    if torch.is_inference_mode_enabled():
        return x
    return _CopyTo.apply(x, tuple(groups))


def reduce_from(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """``x`` summed over ``groups``; the gradient passes unchanged. Under
    inference mode the sum is taken in place: ``x`` is overwritten and
    returned."""
    if torch.is_inference_mode_enabled():
        for group in groups:
            dist.all_reduce(x, group=group)
        return x
    return _ReduceFrom.apply(x, tuple(groups))


def gather_from(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order; the
    gradient is the rank's own slice."""
    return _GatherFrom.apply(x, group, dim)


def all_reduce_max(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """The elementwise maximum of ``x`` over ``groups`` (no gradient)."""
    return _all_reduce(x.detach(), groups, dist.ReduceOp.MAX)


def all_reduce_sum(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """The sum of ``x`` over ``groups`` (no gradient)."""
    return _all_reduce(x.detach(), groups)
