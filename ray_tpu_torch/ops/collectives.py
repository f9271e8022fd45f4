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
        n = dist.get_world_size(group)
        ctx.rank, ctx.n, ctx.dim = dist.get_group_rank(
            group, dist.get_rank()), n, dim
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.n, dim=ctx.dim)[ctx.rank].contiguous(), None, \
            None


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
