"""The training step: the counterpart of the JAX package's
``parallel/train_lib.py``.

``ShardedTrainer`` keeps the JAX signature (``init``, ``step``,
``eval_loss``) and numerics: the default loss is the next-token
cross-entropy of the model's fused chunked path plus, for a model with
experts, the router's load-balancing terms, and the default optimizer
is optax's ``chain(clip_by_global_norm, adamw)`` on a warmup-cosine
schedule, written out with ``torch._foreach_*`` ops. A step makes no
host sync: the schedule is read on the host from the step count, and the
metrics come back as device tensors.

Without a mesh the trainer takes one device. On a mesh
(``parallel.mesh.create_mesh``; one process per rank) the model's layers
hold the rank's tp and ep parts of the weights (``models/llama.py``), and
FSDP2's ``fully_shard`` over the ``(dp, fsdp)`` sub-mesh shards each
``DecoderLayer`` and the root (HSDP when dp > 1: replicated over dp,
sharded over fsdp). Each rank takes its rows of the global batch and,
with sp > 1, its block of the sequence (the targets are cut from the
global rows, so they cross into the next block); the loss it
differentiates is chosen so that FSDP's average over ``(dp, fsdp)``,
summed over sp (the parameters are replicated over sp, as JAX's rules
map no parameter axis to it), is the gradient of the global loss. Over
pp the work is replicated. AdamW runs on each rank's shards, so the
moments cost 1/fsdp a rank; the global norm sums each tensor's squares
over exactly the axes that split it.

Parameters live in the model, in its ``param_dtype``; the ``TrainState``
holds them by name, with the optimizer's moments, and a step updates them
in place (the JAX step donates its input state likewise).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.fsdp import fully_shard

from ..models.convert import init_params, load_params
from ..ops.collectives import all_reduce_sum
from ..ops.paged_attention import check_kernel_head_dim
from .mesh import (BATCH_AXES, active_mesh, batch_rows, mesh_sizes,
                   seq_columns)
from .sharding import shard_state_dict, split_dims


@dataclass
class TrainState:
    step: int                          # steps taken, counted on the host
    params: Dict[str, torch.Tensor]    # the model's parameters, by name
    opt_state: Any


def masked_mean(values: torch.Tensor, mask) -> torch.Tensor:
    if mask is None:
        return values.mean()
    mask = mask.to(values.dtype)
    return (values * mask).sum() / torch.clamp(mask.sum(), min=1)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    return masked_mean(nll, mask)


@dataclass(frozen=True)
class WarmupCosine:
    """optax.warmup_cosine_decay_schedule: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then a cosine decay to
    ``end_value`` at ``decay_steps`` (which counts the warmup)."""

    init_value: float
    peak_value: float
    warmup_steps: int
    decay_steps: int
    end_value: float = 0.0

    def __call__(self, count: int) -> float:
        if count < self.warmup_steps:
            frac = 1.0 - count / self.warmup_steps
            return (self.init_value - self.peak_value) * frac \
                + self.peak_value
        steps = self.decay_steps - self.warmup_steps
        count = min(count - self.warmup_steps, steps)
        alpha = (0.0 if self.peak_value == 0.0
                 else self.end_value / self.peak_value)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / steps))
        return self.peak_value * ((1.0 - alpha) * cosine + alpha)


@dataclass(frozen=True)
class AdamW:
    """optax ``chain(clip_by_global_norm(grad_clip), adamw(schedule, b1,
    b2, eps, weight_decay=...))``: the gradients are scaled by
    ``grad_clip / g_norm`` when their global norm reaches ``grad_clip``
    (optax's formula, no epsilon), then AdamW with bias-corrected moments
    and decoupled weight decay on every parameter, at the learning rate
    ``schedule(count)`` read at the count before the step."""

    schedule: Callable[[int], float]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 1e-4
    grad_clip: Optional[float] = None

    def init(self, params: List[torch.Tensor]) -> Dict[str, Any]:
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: Dict[str, Any],
               g_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Apply one step in place to ``params`` (and ``grads``, which are
        clipped in place); returns the global norm of the gradients before
        the clip, on the device: ``g_norm`` when given (the norm over every
        rank's shards, for shards of a larger model), else theirs."""
        if g_norm is None:
            g_norm = global_norm(grads)
        if self.grad_clip is not None:
            factor = torch.where(g_norm < self.grad_clip,
                                 torch.ones_like(g_norm),
                                 self.grad_clip / g_norm)
            torch._foreach_mul_(grads, factor)
        count = state["count"]
        lr = self.schedule(count)
        mu, nu = state["mu"], state["nu"]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        update = torch._foreach_div(mu, 1.0 - self.b1 ** (count + 1))
        denom = torch._foreach_div(nu, 1.0 - self.b2 ** (count + 1))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(update, denom)
        del denom
        if self.weight_decay:
            torch._foreach_add_(update, params, alpha=self.weight_decay)
        torch._foreach_add_(params, update, alpha=-lr)
        state["count"] = count + 1
        return g_norm


def sum_of_squares(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The sum of every entry's square. Not torch.linalg.vector_norm: on
    the CPU its float32 accumulation loses digits over tensors of millions
    of entries; torch.sum's pairwise one does not."""
    return torch.stack([t.square().sum() for t in tensors]).sum()


def sum_over(tensors: List[torch.Tensor], group) -> None:
    """Sum each of ``tensors`` over ``group``, in place, in one
    all-reduce of a flat buffer (nothing to do over one rank)."""
    if dist.get_world_size(group) == 1:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """optax's global_norm, the root of the summed squares."""
    return sum_of_squares(tensors).sqrt()


def default_optimizer(lr: float = 3e-4, weight_decay: float = 0.1,
                      warmup: int = 100, total_steps: int = 10000,
                      grad_clip: float = 1.0) -> AdamW:
    schedule = WarmupCosine(0.0, lr, warmup, max(total_steps, warmup + 1),
                            lr * 0.1)
    return AdamW(schedule, b1=0.9, b2=0.95, weight_decay=weight_decay,
                 grad_clip=grad_clip)


def _local(t: torch.Tensor) -> torch.Tensor:
    """The rank's shard of an FSDP2 DTensor (a view: in-place updates land
    in the parameter), or the tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


class ShardedTrainer:
    """Holds the model, the optimizer and the loss; one device, or a mesh.

    Usage (as in the JAX package):
        trainer = ShardedTrainer(model)                  # one device
        trainer = ShardedTrainer(model, create_mesh(MeshConfig(...)))
        state = trainer.init(generator, example_batch)
        state, metrics = trainer.step(state, batch)

    ``loss_fn(model, batch) -> scalar`` replaces the default loss; a batch
    is a dict of [B, S] arrays or tensors (``input_ids``, optionally
    ``loss_mask``) or the ``input_ids`` alone.

    On a mesh every rank runs the same calls with the same global batch,
    of which it takes its rows over ``(dp, fsdp)`` and its sequence block
    over sp; ``step`` and ``eval_loss`` return the global loss and grad
    norm on every rank. The model is rebuilt for the mesh if it was not
    built on it (``LlamaModel(..., mesh=)``): the trained model is
    ``trainer.model``. A ``loss_fn`` on a mesh gets the rank's batch,
    which also holds ``targets`` (the global rows shifted left) and
    ``weights`` (float32: the shifted ``loss_mask``, or ones, and zero at
    each row's global last position), and returns, on every rank, the
    global loss with gradients that FSDP's average over the batch axes,
    summed over sp, turns into the global loss's (as ``_mesh_loss``
    does). ``device`` defaults to "cuda", or to the mesh's device.
    """

    def __init__(self, model: torch.nn.Module, mesh=None,
                 optimizer: Optional[AdamW] = None,
                 loss_fn: Optional[Callable] = None, device=None):
        self.mesh = mesh
        if mesh is None:
            self.device = torch.device(device or "cuda")
        else:
            self.device = torch.device(mesh.device_type)
            if self.device.type == "cuda":
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            if device is not None and torch.device(device).type \
                    != self.device.type:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"({mesh.device_type})")
            if getattr(model, "mesh", None) is not mesh:
                with torch.device("meta"):
                    model = type(model)(model.cfg, model.dtype,
                                        model.param_dtype, mesh=mesh)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ShardedTrainer device is 'cuda' but no CUDA device is "
                "available (pass device='cpu' to run on the CPU)")
        cfg = getattr(model, "cfg", None)
        ring = (cfg is not None and cfg.attention_impl == "ring"
                and mesh is not None and mesh_sizes(mesh)["sp"] > 1)
        if cfg is not None and cfg.attention_impl != "reference" \
                and not ring:
            # the training path runs K2 forward and K3/K4 backward (with
            # Ulysses, and with ring or Ulysses on no sp mesh, too)
            check_kernel_head_dim(cfg.head_dim_, model.dtype, self.device,
                                  decode=False, owner="ShardedTrainer")
        self.model = model
        self.tx = optimizer or default_optimizer()
        self.loss_fn = loss_fn or (self._default_loss if mesh is None
                                   else self._mesh_loss)
        self._sharded = False

    # -------------------------------------------------------------- loss
    @staticmethod
    def _default_loss(model, batch) -> torch.Tensor:
        # forward over the full sequence; targets are the input shifted
        # left, wrapping around (the last position is dropped below)
        input_ids = batch["input_ids"]
        targets = torch.cat([input_ids[:, 1:], input_ids[:, :1]], dim=1)
        mask = batch.get("loss_mask")
        mask = mask[:, 1:] if mask is not None else None
        if getattr(model, "supports_fused_loss", False):
            # the nll stays pure cross-entropy; the MoE router terms
            # (summed over layers, zero for a dense model) are added to
            # the loss, as the JAX trainer adds the sown "losses"
            nll, aux = model(input_ids, targets=targets, return_aux=True)
            return masked_mean(nll[:, :-1], mask) + aux
        logits = model(input_ids)[:, :-1]
        return cross_entropy_loss(logits, input_ids[:, 1:], mask)

    @staticmethod
    def _mesh_loss(model, batch) -> torch.Tensor:
        """``_default_loss`` of the global batch, from a rank's part: the
        weighted mean over every rank's positions (the weights' count
        summed over dp, fsdp and sp) plus the router terms, which the
        layers compute from the global batch's fractions. Its value is the
        global loss on every rank; its gradient is the rank's share times
        the number of batch ranks, since FSDP averages over them (and the
        trainer sums over sp): the nll's weighted sum over the rank's
        positions over the global count, and the router terms' dependence
        on the rank's own tokens."""
        nll, aux = model(batch["input_ids"], targets=batch["targets"],
                         return_aux=True)
        weights = batch["weights"]
        total, count = (nll * weights).sum(), weights.sum()
        groups = model.place.data_groups
        count = torch.clamp(all_reduce_sum(count, groups), min=1)
        loss = all_reduce_sum(total, groups) / count + aux.detach()
        share = (total / count + aux) * model.place.data
        return loss + (share - share.detach())

    def _batch(self, batch) -> Dict[str, torch.Tensor]:
        """The batch on the device; on a mesh the rank's part of it, with
        ``targets`` and ``weights`` made from the rank's whole rows before
        its sequence block is cut (the dropped final position is the
        global last one, on the last sp rank only)."""
        if not isinstance(batch, Mapping):
            batch = {"input_ids": batch}
        out = {k: torch.as_tensor(v).to(self.device, non_blocking=True)
               for k, v in batch.items()}
        if self.mesh is None:
            return out
        out = {k: batch_rows(self.mesh, v) for k, v in out.items()}
        ids = out["input_ids"]
        out["targets"] = torch.cat([ids[:, 1:], ids[:, :1]], dim=1)
        mask = out.get("loss_mask")
        weights = (torch.ones(ids.shape, dtype=torch.float32,
                              device=ids.device) if mask is None
                   else torch.cat([mask[:, 1:], mask[:, :1]], dim=1).float())
        weights[:, -1] = 0.0
        out["weights"] = weights
        return {k: seq_columns(self.mesh, v) for k, v in out.items()}

    # -------------------------------------------------------------- init
    def init(self, generator: Optional[torch.Generator], example_batch,
             params: Optional[Mapping[str, torch.Tensor]] = None
             ) -> TrainState:
        """Seeded parameters (``init_params`` from ``generator``, in the
        model's ``param_dtype``), or ``params`` when given (a full state
        dict, e.g. ``params_from_flax`` of a JAX tree), placed on the
        device in train mode with gradients on, and fresh optimizer
        moments. ``example_batch`` is taken for the JAX signature: nothing
        here needs its shapes ahead of the first step.

        On a mesh each rank keeps its part of every tensor
        (``init_params(..., mesh=)`` or ``shard_state_dict``), then FSDP2
        shards each layer and the root over ``(dp, fsdp)``; a mesh
        trainer is initialised once."""
        del example_batch
        cfg, mesh = self.model.cfg, self.mesh
        if mesh is not None and self._sharded:
            raise RuntimeError("a mesh trainer's init runs once: its model "
                               "is sharded")
        if params is None:
            params = init_params(cfg, generator, self.device,
                                 self.model.param_dtype, mesh=mesh)
        elif mesh is not None:
            params = shard_state_dict(params, cfg, mesh)
        load_params(self.model, params, self.device)
        self.model.train().requires_grad_(True)
        if mesh is not None:
            # a layer's parameters are gathered for its forward and again
            # for its recompute and backward; over one fsdp rank the shard
            # is the whole tensor, and freeing it after the forward only
            # costs the gathers again
            data_mesh = mesh[BATCH_AXES]
            reshard = mesh_sizes(mesh)["fsdp"] > 1
            for layer in self.model.layers:
                fully_shard(layer, mesh=data_mesh,
                            reshard_after_forward=reshard)
            fully_shard(self.model, mesh=data_mesh)
            self._sharded = True
        named = dict(self.model.named_parameters())
        with torch.no_grad():
            local = [_local(p) for p in named.values()]
        return TrainState(step=0, params=named,
                          opt_state=self.tx.init(local))

    # -------------------------------------------------------------- step
    def step(self, state: TrainState,
             batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer step. Returns the new state (its tensors are the
        old state's, updated in place) and {"loss", "grad_norm"} as
        device tensors; ``grad_norm`` is the norm before the clip."""
        batch = self._batch(batch)
        names = list(state.params)
        params = list(state.params.values())
        for p in params:
            p.grad = None
        with self._ambient_mesh():
            loss = self.loss_fn(self.model, batch)
            loss.backward()
        with torch.no_grad():
            params = [_local(p) for p in params]
            grads = [_local(p.grad) if p.grad is not None
                     else torch.zeros_like(lp)
                     for p, lp in zip(state.params.values(), params)]
            if self.mesh is not None:  # parameters replicated over sp
                sum_over(grads, self.mesh.get_group("sp"))
        g_norm = None if self.mesh is None else self._global_norm(names,
                                                                  grads)
        g_norm = self.tx.update(params, grads, state.opt_state, g_norm)
        for p in state.params.values():
            p.grad = None
        return (dataclasses.replace(state, step=state.step + 1),
                {"loss": loss.detach(), "grad_norm": g_norm})

    @torch.no_grad()
    def _global_norm(self, names: List[str],
                     grads: List[torch.Tensor]) -> torch.Tensor:
        """optax's global_norm over every rank's shards: each tensor's
        squares summed over its fsdp shards and over the axes the layers
        split it on (tp, ep); a tensor that tp or ep ranks hold whole is
        counted once. Equal on every rank."""
        by_axes: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
        for name, g in zip(names, grads):
            by_axes.setdefault(tuple(sorted(split_dims(name))), []).append(g)
        parts = []
        for axes in sorted(by_axes):  # the same order on every rank
            groups = [self.mesh.get_group(a) for a in ("fsdp",) + axes]
            parts.append(all_reduce_sum(sum_of_squares(by_axes[axes]),
                                        groups))
        return torch.stack(parts).sum().sqrt()

    def eval_loss(self, state: TrainState, batch) -> torch.Tensor:
        del state  # the parameters live in the model
        with torch.no_grad(), self._ambient_mesh():
            return self.loss_fn(self.model, self._batch(batch))

    def _ambient_mesh(self):
        """The mesh as ``current_mesh()`` while the model runs, as the JAX
        trainer enters ``active_mesh``."""
        return (contextlib.nullcontext() if self.mesh is None
                else active_mesh(self.mesh))
