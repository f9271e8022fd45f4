"""Pipeline-parallel training for the Llama family: the counterpart of the
JAX package's ``parallel/pp_train.py``.

The decoder layers split into pp stages; each pp rank holds its stage
(``LayerStack``: layers ``s * L/S`` to ``(s + 1) * L/S - 1`` under the
full model's names) and microbatches stream through the GPipe schedule
(``ops/pipeline.py``). The embedding, the final norm, the LM head and the
loss are replicated over pp; the activations cross stages in float32,
while a stage computes in the model's ``dtype``.

The JAX trainer's state is ``P("pp")`` for the layers and ``P()`` for
the rest, and GSPMD lays out the other axes. Here the batch's rows split
over ``(dp, fsdp)`` (data parallel: the gradients are summed over those
ranks), and the work is replicated over sp, ep and tp: a rank holds
whole sequences, so no mesh is made ambient, and a model whose
``attention_impl`` is ring or Ulysses warns and attends densely, as the
JAX dispatcher does with no sp mesh.

Gradients: the last rank's outputs reach every pp rank by a sum whose
gradient passes unchanged, so the final norm's and head's gradients are
the same on every pp rank; only rank 0's injection reads the embedding,
so its gradient is rank 0's, summed over pp (zeros elsewhere). The grad
norm is optax's global norm over the whole tree: the layers' squares
summed over pp, each replicated leaf counted once.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from ..models.config import LlamaConfig
from ..models.convert import init_params, load_params
from ..models.llama import Dense, LayerStack, RMSNorm
from ..ops.collectives import all_reduce_sum
from ..ops.paged_attention import check_kernel_head_dim
from ..ops.pipeline import pipeline_apply
from .mesh import BATCH_AXES, batch_rows, mesh_sizes, pp_stage
from .train_lib import (AdamW, TrainState, default_optimizer,
                        sum_of_squares, sum_over)


class StageModule(nn.Module):
    """A pp rank's part of the model: the embedding, its stage's layers
    (``layers``, a ``LayerStack``), the final norm and the LM head, every
    parameter under its name in the full ``LlamaModel``."""

    def __init__(self, cfg: LlamaConfig, dtype: torch.dtype,
                 param_dtype: torch.dtype, first: int, count: int):
        super().__init__()
        self.cfg, self.dtype, self.param_dtype = cfg, dtype, param_dtype
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size,
                                              cfg.hidden_size,
                                              dtype=param_dtype))
        self.layers = LayerStack(cfg, dtype, param_dtype, first, count)
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype)
        self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size, dtype,
                             param_dtype)

    def stage(self, stack: LayerStack, x: torch.Tensor) -> torch.Tensor:
        """The stage's layers on float32 activations [b, S, H], computed
        in ``dtype``, returned in float32 (JAX's ``stage_fn``)."""
        positions = torch.arange(x.shape[1], device=x.device).expand(
            x.shape[:2])
        return stack(x.to(self.dtype), positions).float()


class PipelinedTrainer:
    """The model, its pp mesh and the GPipe train step.

    Usage mirrors ShardedTrainer:
        trainer = PipelinedTrainer(model, mesh, num_microbatches=4)
        state = trainer.init(generator, batch)
        state, metrics = trainer.step(state, batch)

    ``model`` is a ``LlamaModel`` (built on any device, the meta device
    included): its config, ``dtype`` and ``param_dtype`` are taken, and
    the rank's ``StageModule`` is built (``trainer.model``). Every rank
    runs the same calls with the same global batch, of which it takes its
    rows over ``(dp, fsdp)``; ``step`` and ``eval_loss`` return the
    global loss and grad norm on every rank, on the mesh's device.
    """

    def __init__(self, model, mesh, num_microbatches: int = 4,
                 optimizer: Optional[AdamW] = None):
        cfg = model.cfg
        self.cfg, self.mesh = cfg, mesh
        self.num_microbatches = num_microbatches
        self.tx = optimizer or default_optimizer()
        self.num_stages = mesh_sizes(mesh)["pp"]
        if not cfg.scan_layers:
            raise ValueError("PipelinedTrainer needs scan_layers=True")
        if cfg.num_layers % self.num_stages:
            raise ValueError(
                f"{cfg.num_layers} layers not divisible into "
                f"{self.num_stages} stages")
        if cfg.num_experts:
            raise ValueError("PipelinedTrainer v1 is dense-only (MoE "
                             "aux losses don't cross the pipeline yet)")
        self.layers_per_stage = cfg.num_layers // self.num_stages
        self.device = torch.device(mesh.device_type)
        if self.device.type == "cuda":  # the rank's card
            self.device = torch.device("cuda", torch.cuda.current_device())
        if cfg.attention_impl != "reference":  # K2-K4 in every stage
            check_kernel_head_dim(cfg.head_dim_, model.dtype, self.device,
                                  decode=False, owner="PipelinedTrainer")
        self.stage, _ = pp_stage(mesh)
        first = self.stage * self.layers_per_stage
        with torch.device("meta"):
            self.model = StageModule(cfg, model.dtype, model.param_dtype,
                                     first, self.layers_per_stage)
        self.param_dtype = model.param_dtype
        self._pp_group = mesh.get_group("pp")
        self._data_groups = [mesh.get_group(a) for a in BATCH_AXES]

    # -------------------------------------------------------------- init
    def init(self, generator: Optional[torch.Generator], example_batch,
             state_dict: Optional[Mapping[str, torch.Tensor]] = None
             ) -> TrainState:
        """Seeded parameters (every rank draws the full model's from
        ``generator``, as ``init_params`` does, and keeps its stage's and
        the replicated ones), or the same part of ``state_dict`` (a full
        state dict, or the rank's stage of one: ``ops.pipeline.
        stack_to_stages`` of ``params_from_flax(tree, cfg, num_stages)``
        for the JAX trainer's tree), placed on
        the device in train mode with gradients on, and fresh optimizer
        moments. ``example_batch`` is taken for the JAX signature."""
        del example_batch
        if state_dict is None:
            state_dict = init_params(self.cfg, generator, self.device,
                                     self.param_dtype)
        names = set(self.model.state_dict())
        load_params(self.model, {k: v for k, v in state_dict.items()
                                 if k in names}, self.device)
        self.model.train().requires_grad_(True)
        named = dict(self.model.named_parameters())
        return TrainState(step=0, params=named,
                          opt_state=self.tx.init(list(named.values())))

    # -------------------------------------------------------------- loss
    def loss(self, batch: Mapping[str, torch.Tensor],
             pipeline=None) -> torch.Tensor:
        """The global loss of the rank's rows ``batch`` (on the device),
        JAX's ``_loss``: the dense next-token cross-entropy of the
        pipelined model, a masked mean with ``loss_mask``. The value is
        the global loss on every rank; its gradient is the rank's share
        (its rows' sum over the global count), which ``step`` sums over
        the batch ranks. ``pipeline(stage_fn, params, x)`` replaces
        ``pipeline_apply`` (to run the schedule itself at one stage)."""
        model = self.model
        ids = batch["input_ids"]
        x = model.embed[ids.long()].float()
        if pipeline is None:
            x = pipeline_apply(model.stage, model.layers, x,
                               group=self._pp_group,
                               num_microbatches=self.num_microbatches)
        else:
            x = pipeline(model.stage, model.layers, x)
        logits = model.lm_head(model.final_norm(x.to(model.dtype)))
        targets = torch.cat([ids[:, 1:], ids[:, :1]], dim=1)
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        nll = -logp.gather(-1, targets[:, :-1, None].long())[..., 0]
        mask = batch.get("loss_mask")
        if mask is None:
            total = nll.sum()
            count = torch.full((), nll.numel(), dtype=nll.dtype,
                               device=nll.device)
        else:
            mask = mask[:, 1:].to(nll.dtype)
            total, count = (nll * mask).sum(), mask.sum()
        count = torch.clamp(all_reduce_sum(count, self._data_groups), min=1)
        share = total / count
        return all_reduce_sum(share, self._data_groups) + (
            share - share.detach())

    def _batch(self, batch) -> Dict[str, torch.Tensor]:
        if not isinstance(batch, Mapping):
            batch = {"input_ids": batch}
        return {k: batch_rows(self.mesh, torch.as_tensor(v).to(
            self.device, non_blocking=True)) for k, v in batch.items()}

    # -------------------------------------------------------------- step
    def step(self, state: TrainState,
             batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer step: the new state (updated in place) and
        {"loss", "grad_norm"} as device tensors, equal on every rank."""
        batch = self._batch(batch)
        params = list(state.params.values())
        for p in params:
            p.grad = None
        loss = self.loss(batch)
        loss.backward()
        with torch.no_grad():
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            for group in self._data_groups:
                sum_over(grads, group)
            embed = list(state.params).index("embed")
            sum_over(grads[embed:embed + 1], self._pp_group)
            g_norm = self._global_norm(list(state.params), grads)
        g_norm = self.tx.update(params, grads, state.opt_state, g_norm)
        for p in params:
            p.grad = None
        return (dataclasses.replace(state, step=state.step + 1),
                {"loss": loss.detach(), "grad_norm": g_norm})

    def _global_norm(self, names: List[str],
                     grads: List[torch.Tensor]) -> torch.Tensor:
        """optax's global norm of the whole tree: the stage's layers'
        squares summed over pp, the replicated leaves' once."""
        staged = [g for n, g in zip(names, grads) if n.startswith("layers.")]
        rest = [g for n, g in zip(names, grads)
                if not n.startswith("layers.")]
        squares = all_reduce_sum(sum_of_squares(staged), (self._pp_group,))
        return (squares + sum_of_squares(rest)).sqrt()

    def eval_loss(self, state: TrainState, batch) -> torch.Tensor:
        del state  # the parameters live in the model
        with torch.no_grad():
            return self.loss(self._batch(batch)).detach()
