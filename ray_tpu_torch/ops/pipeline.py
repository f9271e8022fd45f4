"""Pipeline parallelism: the GPipe microbatch schedule over the ``pp``
group, the counterpart of the JAX package's ``ops/pipeline.py``.

- The layer stack is split into S stages; each pp rank holds its stage's
  parameters (``stack_to_stages`` splits a state dict).
- The batch splits into M microbatches, and M + S - 1 ticks run on every
  rank: at each tick every rank applies its stage to its current
  activation and ``ring_shift`` moves the result to the next rank. Rank 0
  injects microbatch ``min(t, M - 1)`` at tick ``t``; the last rank's
  output at tick ``t`` is microbatch ``t - (S - 1)``.
- The last rank's outputs reach every pp rank by a float32 sum over the
  group (zeros elsewhere), so that the replicated loss and head run
  everywhere. It is ``reduce_from``: its gradient passes unchanged, so
  the cotangent that reaches the last rank's outputs is dL/dout once.

Autograd runs the backward: the cotangents go back round the ring through
``ring_shift``'s reverse shift. Every rank takes both branches of each
selection (``torch.where``, as JAX's ``jnp.where``), so every rank's
graph holds the same exchanges and runs their backward in the same order.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Mapping

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from .collectives import reduce_from, ring_shift


def gpipe(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
          num_stages: int, num_microbatches: int, group) -> Callable:
    """The per-rank GPipe loop over ``group`` (the pp group, of
    ``num_stages`` ranks). ``stage_fn(stage_params, x_mb) -> x_mb`` applies
    the rank's stage to one microbatch. Returns ``run(stage_params,
    x_microbatches)``: ``x_microbatches`` [M, mb, ...] (the same on every
    rank; only rank 0's injection matters) -> the last stage's outputs
    [M, mb, ...], equal on every rank after the float32 broadcast."""
    S, M = num_stages, num_microbatches
    T = M + S - 1
    if dist.get_world_size(group) != S:
        raise ValueError(f"pp group of {dist.get_world_size(group)} ranks, "
                         f"{S} stages")

    def run(stage_params, x_mb: torch.Tensor) -> torch.Tensor:
        rank = dist.get_group_rank(group, dist.get_rank())
        first = torch.tensor(rank == 0, device=x_mb.device)
        last = torch.tensor(rank == S - 1, device=x_mb.device)
        state = torch.zeros_like(x_mb[0])
        outs: List[torch.Tensor] = []
        for t in range(T):
            state_in = torch.where(first, x_mb[min(t, M - 1)], state)
            out = stage_fn(stage_params, state_in)
            if t >= S - 1:  # tick t carries microbatch t - (S - 1)
                outs.append(out)
            if t + 1 < T:  # the last tick's shift would go unused
                state = ring_shift(out, group)
        outputs = torch.where(last, torch.stack(outs), 0.0)
        return reduce_from(outputs.float(), (group,)).to(x_mb.dtype)

    return run


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, *,
                   group, num_microbatches: int,
                   remat: bool = True) -> torch.Tensor:
    """Apply a stage-split layer stack to [B, ...] activations with the
    GPipe schedule over ``group`` (the pp group; the rank holds
    ``stage_params``, its stage). With one stage the stack runs directly
    (no schedule, no checkpoint); otherwise each stage's call runs under
    ``torch.utils.checkpoint`` when ``remat``."""
    S = dist.get_world_size(group)
    M = num_microbatches
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    if S == 1:  # degenerate: no pipeline, just run the stack
        return stage_fn(stage_params, x)
    fn = stage_fn
    if remat:
        def fn(params, xb):
            return checkpoint(stage_fn, params, xb, use_reentrant=False)
    out = gpipe(fn, S, M, group)(stage_params,
                                 x.reshape((M, B // M) + x.shape[1:]))
    return out.reshape((B,) + out.shape[2:])


_LAYER = re.compile(r"^layers\.(\d+)\.")


def stack_to_stages(state_dict: Mapping[str, Any],
                    num_stages: int) -> List[Dict[str, Any]]:
    """A state dict split into ``num_stages`` stages: stage ``s`` holds the
    ``layers.{l}.*`` entries of layers ``s * L/S`` to ``(s + 1) * L/S - 1``
    under their names, and every other entry (held by every stage)."""
    layers = {int(m.group(1)) for m in map(_LAYER.match, state_dict) if m}
    L = len(layers)
    if layers != set(range(L)):
        raise ValueError(f"layers {sorted(layers)} are not 0..{L - 1}")
    if L % num_stages:
        raise ValueError(f"{L} layers not divisible into {num_stages} "
                         f"stages")
    per = L // num_stages
    stages: List[Dict[str, Any]] = [{} for _ in range(num_stages)]
    for name, value in state_dict.items():
        m = _LAYER.match(name)
        for s in ([int(m.group(1)) // per] if m else range(num_stages)):
            stages[s][name] = value
    return stages
