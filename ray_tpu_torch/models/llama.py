"""Llama-family decoder in PyTorch: the serving and training paths of the
JAX package's ``models/llama.py``.

Numerics follow the JAX model: weights stored in ``param_dtype`` and cast
to the compute ``dtype`` at use (Flax ``DenseGeneral``), activations in
``dtype``, RMSNorm statistics and its scale in float32, the embedding
looked up in ``param_dtype`` and cast after the lookup, rotary angles in
float32, fused QKV (split q|k|v) and fused gate|up projections. Layers are
an ``nn.ModuleList`` run by a Python loop; with a ``PagedCache`` each
layer reads and writes its ``[l]`` slice of the ``[L, P, Hkv, page, 2D]``
pool, sending one-token steps to the paged decode kernel (K1) and prompts
to paged prefill (K2, with the cached-prefix merge). Without a cache,
attention is causal over the input (optionally segment-masked), through
``ops.attention.attention`` with ``cfg.attention_impl`` (flash attention,
K2-K4, by default).

With ``cfg.num_experts`` each layer's MLP is ``MoEMLP``, the JAX
package's Mixtral-style sparse FFN: float32 top-k routing over groups of
``moe_group_size`` tokens, capacity-bounded expert buffers, and the
router's load-balancing term, which a layer computes and returns beside
its output only when asked (``forward(..., return_aux=True)`` hands the
sum over layers to the trainer, the counterpart of asking JAX for the
sown ``losses`` collection; serving never asks).

Training: with ``cfg.remat`` each layer runs under
``torch.utils.checkpoint`` with the JAX policies ("nothing", "names",
"dots"), and ``forward(..., targets=)`` returns the per-position nll of
the fused chunked cross-entropy instead of logits.

On a mesh (``LlamaModel(..., mesh=)``, a ``DeviceMesh`` with the axes
of ``parallel/mesh.py``) the layers hold the rank's part of each weight
(``MeshPlace``): attention Hq/tp and Hkv/tp heads, the MLP F/tp, MoE
E/ep experts of F/tp each, the embedding and lm_head V/tp rows of the
vocabulary; the differentiable collectives of ``ops/collectives.py``
join the parts, and the loss is cross-entropy over the split vocabulary.
With sp > 1 a rank holds a block of the sequence: its positions are the
global ones, and attention is ring or Ulysses over the sp group
(``cfg.attention_impl``). ``LayerStack`` holds one pipeline stage's
layers under the full model's names (``parallel/pp_train.py``).
A fused weight keeps its layout on each rank: the rank's q, k and v rows
(gate and up columns), fused again in that order. Serving on a mesh (the
tp engine) hands each rank a ``PagedCache`` whose pool holds its Hkv/tp
heads of every page, and takes its logits from ``logits``, gathered over
tp. Without a mesh nothing of this runs.

Parameter names are the state-dict keys ``models/convert.py`` produces
from a Flax tree, e.g. ``layers.0.attn.qkv_proj.weight``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Mapping, Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops.attention import attention
from ..ops.collectives import (all_reduce_max, all_reduce_sum, copy_to,
                               gather_from, reduce_from)
from ..ops.paged_attention import (paged_attention_decode,
                                   paged_prefill_attention, paged_write)
from ..parallel.mesh import mesh_sizes
from .config import LlamaConfig, torch_dtype


class RMSNorm(nn.Module):
    """Float32 statistics and a float32 scale, output in ``dtype``."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.eps)
        return (y * self.scale).to(self.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Half-split rotary embedding. x: [B, S, H, D], positions: [B, S]."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    angles = positions[..., None].float() * freqs       # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@dataclasses.dataclass
class PagedCache:
    """Paged KV state handed to the model by the serving engine, which
    owns page allocation (serve/llm/cache.py)."""

    kv_pages: torch.Tensor      # [L, P, Hkv, page, 2*D], written in place
    block_tables: torch.Tensor  # [B, MP] int32 page ids
    total_lens: torch.Tensor    # [B] int32, length INCLUDING new tokens
    # number of block-table columns a cached prefix may span during
    # prefill (0 = no prefix part); decode ignores it
    ctx_pages: int = 0


@dataclasses.dataclass(frozen=True)
class MeshPlace:
    """A rank's place on a mesh as the layers see it: the sizes of tp, ep,
    sp and the batch axes (``data``: dp x fsdp), the rank's index on tp,
    ep and sp, and the process groups of tp and ep (None where only the
    layout is needed, as in ``parallel/sharding.py``'s pure functions)
    and of the axes that split the tokens (``data_groups``: dp, fsdp and
    sp)."""

    tp: int = 1
    tp_rank: int = 0
    ep: int = 1
    ep_rank: int = 0
    data: int = 1
    sp: int = 1
    sp_rank: int = 0
    tp_group: Any = None
    ep_group: Any = None
    data_groups: Tuple = ()

    @classmethod
    def of(cls, mesh) -> "MeshPlace":
        size = mesh_sizes(mesh)
        return cls(tp=size["tp"], tp_rank=mesh.get_local_rank("tp"),
                   ep=size["ep"], ep_rank=mesh.get_local_rank("ep"),
                   data=size["dp"] * size["fsdp"], sp=size["sp"],
                   sp_rank=mesh.get_local_rank("sp"),
                   tp_group=mesh.get_group("tp"),
                   ep_group=mesh.get_group("ep"),
                   data_groups=(mesh.get_group("dp"), mesh.get_group("fsdp"),
                                mesh.get_group("sp")))


def check_mesh(cfg: LlamaConfig, sizes: Mapping[str, int]) -> None:
    """Refuse a mesh the model cannot be split over: a tp that does not
    divide the kv heads (a rank holds whole kv heads and the q heads that
    read them), the MLP's width or the vocabulary, an ep that does not
    divide the experts, sp above 1 with an attention that is not ring or
    Ulysses (a rank's dense attention would see its own block of the
    sequence only; JAX's GSPMD gathers the sequence for it)."""
    tp, ep = sizes.get("tp", 1), sizes.get("ep", 1)
    if sizes.get("sp", 1) > 1 and cfg.attention_impl not in ("ring",
                                                             "ulysses"):
        raise ValueError(
            f"sp={sizes['sp']} splits the sequence: attention_impl must be "
            f"'ring' or 'ulysses', got {cfg.attention_impl!r}")
    if cfg.num_kv_heads % tp:
        raise ValueError(
            f"tp={tp} does not divide num_kv_heads={cfg.num_kv_heads}: each "
            f"tp rank holds whole kv heads and the q heads that read them")
    for field in ("intermediate_size", "vocab_size"):
        if getattr(cfg, field) % tp:
            raise ValueError(f"tp={tp} does not divide {field}="
                             f"{getattr(cfg, field)}")
    if cfg.num_experts and cfg.num_experts % ep:
        raise ValueError(f"ep={ep} does not divide num_experts="
                         f"{cfg.num_experts}")


def check_moe_groups(cfg: LlamaConfig, tokens: int, data: int,
                     sp: int = 1, seq: int = 0) -> None:
    """On a batch split over ``data`` > 1 ranks, a rank's ``tokens`` must
    be a multiple of ``moe_group_size``, and on a sequence split over
    ``sp`` > 1 ranks its block of ``seq`` positions: then its routing
    groups are the groups one device forms over the global [B, S] batch,
    with the same capacity and drops. Any other split routes other
    groups."""
    if sp > 1 and seq % cfg.moe_group_size:
        raise ValueError(
            f"a rank's sequence block of {seq} positions is not a multiple "
            f"of moe_group_size={cfg.moe_group_size}: its routing groups "
            f"would differ from the groups of the global batch over sp = "
            f"{sp} ranks (other tokens per group, other capacity and "
            f"drops)")
    if data > 1 and tokens % cfg.moe_group_size:
        raise ValueError(
            f"a rank's {tokens} tokens are not a multiple of moe_group_size="
            f"{cfg.moe_group_size}: its routing groups would differ from "
            f"the groups of the global batch over dp x fsdp = {data} ranks "
            f"(other tokens per group, other capacity and drops)")


class Dense(nn.Linear):
    """A bias-free ``nn.Linear`` whose weight is stored in ``param_dtype``
    and cast, with its input, to ``dtype`` at use (Flax ``DenseGeneral``;
    the casts are no-ops when the two types are equal)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, param_dtype: torch.dtype):
        super().__init__(in_features, out_features, bias=False,
                         dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.compute_dtype),
                        self.weight.to(self.compute_dtype))


class Attention(nn.Module):
    """Fused-QKV attention; on a mesh the rank's Hq/tp q heads and the
    Hkv/tp kv heads they read (column-parallel qkv_proj, row-parallel
    o_proj)."""

    def __init__(self, cfg: LlamaConfig, dtype: torch.dtype,
                 param_dtype: torch.dtype, place: Optional[MeshPlace] = None):
        super().__init__()
        self.cfg = cfg
        self.place = place
        tp = place.tp if place else 1
        hd = cfg.head_dim_
        self.nq, self.nkv = cfg.num_heads // tp, cfg.num_kv_heads // tp
        self.qkv_proj = Dense(cfg.hidden_size, (self.nq + 2 * self.nkv) * hd,
                              dtype, param_dtype)
        self.o_proj = Dense(self.nq * hd, cfg.hidden_size, dtype,
                            param_dtype)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[PagedCache] = None, layer: int = 0,
                segment_ids=None) -> torch.Tensor:
        cfg, place = self.cfg, self.place
        hd, nq, nkv = cfg.head_dim_, self.nq, self.nkv
        b, s = x.shape[:2]
        if place:
            x = copy_to(x, (place.tp_group,))
        q, k, v = self.qkv_proj(x).split([nq * hd, nkv * hd, nkv * hd],
                                         dim=-1)
        q = rope(q.reshape(b, s, nq, hd), positions, cfg.rope_theta)
        k = rope(k.reshape(b, s, nkv, hd), positions, cfg.rope_theta)
        v = v.reshape(b, s, nkv, hd)
        if cache is not None:
            pages = cache.kv_pages[layer]
            paged_write(pages, k, v, cache.block_tables, positions,
                        cache.total_lens)
            if s == 1:
                out = paged_attention_decode(
                    q[:, 0], pages, cache.block_tables,
                    cache.total_lens)[:, None]
            else:
                out = paged_prefill_attention(
                    q, k, v, pages, cache.block_tables, positions,
                    cache.total_lens, ctx_pages=cache.ctx_pages)
        else:
            out = attention(q, k, v, causal=True, segment_ids=segment_ids,
                            impl=cfg.attention_impl)
        out = self.o_proj(out.reshape(b, s, nq * hd))
        return reduce_from(out, (place.tp_group,)) if place else out


class MLP(nn.Module):
    """SiLU-gated MLP; on a mesh the rank's F/tp of the width."""

    def __init__(self, cfg: LlamaConfig, dtype: torch.dtype,
                 param_dtype: torch.dtype, place: Optional[MeshPlace] = None):
        super().__init__()
        self.place = place
        f = cfg.intermediate_size // (place.tp if place else 1)
        self.gate_up_proj = Dense(cfg.hidden_size, 2 * f, dtype, param_dtype)
        self.down_proj = Dense(f, cfg.hidden_size, dtype, param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        place = self.place
        if place:
            x = copy_to(x, (place.tp_group,))
        gate, up = self.gate_up_proj(x).chunk(2, dim=-1)
        out = self.down_proj(F.silu(gate) * up)
        return reduce_from(out, (place.tp_group,)) if place else out


def moe_capacity(cfg: LlamaConfig, group: int) -> int:
    """Slots per expert in a group of ``group`` tokens (the JAX
    expression, truncation included)."""
    return max(1, int(cfg.capacity_factor * cfg.num_experts_per_tok
                      * group / cfg.num_experts))


def moe_route(xg: torch.Tensor, router: torch.Tensor, k: int):
    """Top-k routing of grouped tokens ``xg`` [G, g, h] by the float32
    ``router`` [h, E]: returns the softmax ``probs`` [G, g, E], the
    renormalised ``gates`` [G, g, k] (float32), the expert ``idx``
    [G, g, k] and each assignment's ``slot`` [G, g, k] in its expert's
    buffer, counted over the group in token order and, within a token, in
    choice order. Ties go to the lower expert index, as in ``lax.top_k``."""
    G, g, h = xg.shape
    n_exp = router.shape[1]
    logits = (xg.reshape(G * g, h).float() @ router).reshape(G, g, n_exp)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :k], idx[..., :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    assigns = F.one_hot(idx, n_exp).reshape(G, g * k, n_exp)
    before = torch.cumsum(assigns, dim=1) - assigns
    slot = (before * assigns).sum(-1).reshape(G, g, k)
    return probs, gates, idx, slot


class MoEMLP(nn.Module):
    """Mixtral-style sparse FFN, the JAX ``MoEMLP``: tokens in groups of
    ``g = min(moe_group_size, T)`` (the tail zero-padded), float32 top-k
    routing, ``moe_capacity`` slots per expert and group (an assignment
    past them is dropped: it adds nothing and the residual carries the
    token), SiLU-gated experts ``[E, h, 2f]`` / ``[E, f, h]`` computed in
    ``dtype``, outputs combined with the gates rounded to ``dtype``.

    Tokens move by index instead of through JAX's one-hot dispatch
    tensor: each (expert, slot) holds at most one token, so the expert
    buffers ``[E, G*C, h]`` are a gather of token rows (empty slots read
    a zero row) and the combine is a gather of each token's k expert
    rows. Returns the output and, with ``with_aux`` (else None), the
    router's load-balancing term, ``coef * E * sum_e frac_tokens_e *
    frac_probs_e`` over the real tokens, ``frac_tokens`` counting the
    choices before the capacity drop: like JAX's ``sow``, which records
    it only when the caller asks for the ``losses`` collection, serving
    does not compute it.

    On a mesh every rank routes every token of its batch (the router is
    whole), and computes the buffers of its E/ep experts with F/tp of
    their width: the partial products are summed over tp and the experts'
    outputs gathered over ep before the combine. The router term's token
    counts and probability sums are summed over the batch axes first, so
    that it is the term of the global batch (every rank of dp, fsdp and
    sp)."""

    def __init__(self, cfg: LlamaConfig, dtype: torch.dtype,
                 param_dtype: torch.dtype, place: Optional[MeshPlace] = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.place = place
        h = cfg.hidden_size
        n_local = cfg.num_experts // (place.ep if place else 1)
        f = cfg.intermediate_size // (place.tp if place else 1)
        # this rank's experts: [first, first + n_local)
        self.first_expert = place.ep_rank * n_local if place else 0
        # float32 whatever param_dtype is (the JAX param's own type)
        self.router = nn.Parameter(torch.empty(h, cfg.num_experts,
                                               dtype=torch.float32))
        self.experts_gate_up = nn.Parameter(
            torch.empty(n_local, h, 2 * f, dtype=param_dtype))
        self.experts_down = nn.Parameter(
            torch.empty(n_local, f, h, dtype=param_dtype))

    def route(self, x: torch.Tensor):
        """The routing of ``x`` [B, S, h]: the token rows in ``dtype``
        (then the tail's padding and one zero row that empty slots read)
        and ``moe_route``'s outputs over groups of ``min(moe_group_size,
        T)``."""
        cfg, dtype = self.cfg, self.dtype
        b, s, h = x.shape
        T = b * s
        if self.place:
            check_moe_groups(cfg, T, self.place.data, self.place.sp, s)
        g = min(cfg.moe_group_size, T)
        pad = (-T) % g
        rows = torch.cat([x.reshape(T, h).to(dtype),
                          x.new_zeros((pad + 1, h), dtype=dtype)])
        return (rows, *moe_route(rows[:-1].view(-1, g, h), self.router,
                                 cfg.num_experts_per_tok))

    def forward(self, x: torch.Tensor, with_aux: bool = False):
        cfg, dtype, place = self.cfg, self.dtype, self.place
        n_exp, k = cfg.num_experts, cfg.num_experts_per_tok
        b, s, h = x.shape
        T = b * s
        rows, probs, gates, idx, slot = self.route(x)
        G, g = idx.shape[:2]
        cap = moe_capacity(cfg, g)
        n_rows = n_exp * G * cap
        group = torch.arange(G, device=x.device)[:, None, None]
        # each assignment's row in the [E, G, C] buffers; dropped ones
        # point at a spare row past the end
        dest = torch.where(slot < cap, (idx * G + group) * cap + slot,
                           n_rows).reshape(G * g * k)
        token = torch.arange(G * g * k, device=x.device) // k
        src = torch.full((n_rows + 1,), G * g, dtype=torch.long,
                         device=x.device)
        src.scatter_(0, dest, token)
        n_local = self.experts_gate_up.shape[0]
        lo = self.first_expert * G * cap
        ex_rows = copy_to(rows, (place.ep_group, place.tp_group)) \
            if place else rows
        ex_in = ex_rows[src[lo:lo + n_local * G * cap]].view(
            n_local, G * cap, h)
        gate_p, up_p = torch.bmm(
            ex_in, self.experts_gate_up.to(dtype)).chunk(2, dim=-1)
        ex_out = torch.bmm(F.silu(gate_p) * up_p,
                           self.experts_down.to(dtype))
        if place:
            ex_out = gather_from(reduce_from(ex_out, (place.tp_group,)),
                                 place.ep_group)
        ex_out = torch.cat([ex_out.reshape(n_rows, h),
                            ex_out.new_zeros((1, h))])
        picked = ex_out[dest].view(G * g, k, h)[:T]
        weight = gates.to(dtype).reshape(G * g, k, 1)[:T]
        out = (picked.float() * weight.float()).sum(1).to(dtype)
        if not with_aux:
            return out.view(b, s, h), None

        counts = F.one_hot(idx.reshape(G * g, k)[:T], n_exp).sum((0, 1))
        if place:
            # the global batch's fractions: counts and probability sums
            # over every rank of the batch axes
            counts = all_reduce_sum(counts, place.data_groups)
            prob_sum = reduce_from(probs.reshape(G * g, n_exp)[:T].sum(0),
                                   place.data_groups)
            T = T * place.data * place.sp
            frac_probs = prob_sum / T
        else:
            frac_probs = probs.reshape(G * g, n_exp)[:T].mean(0)
        frac_tokens = counts.float() / (T * k)
        aux = cfg.router_aux_loss_coef * n_exp * torch.sum(
            frac_tokens * frac_probs)
        return out.view(b, s, h), aux


class DecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype: torch.dtype,
                 param_dtype: torch.dtype, place: Optional[MeshPlace] = None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype)
        self.attn = Attention(cfg, dtype, param_dtype, place)
        self.mlp_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype)
        self.cfg = cfg
        # the JAX layer's names: "moe" with experts, else "mlp"
        if cfg.num_experts:
            self.moe = MoEMLP(cfg, dtype, param_dtype, place)
        else:
            self.mlp = MLP(cfg, dtype, param_dtype, place)

    def attn_block(self, x, positions, cache=None, layer: int = 0,
                   segment_ids=None):
        """The attention branch, ``attn_out`` of the JAX layer."""
        return self.attn(self.attn_norm(x), positions, cache, layer,
                         segment_ids)

    def mlp_block(self, x, with_aux: bool = False):
        """The MLP branch, ``mlp_out`` of the JAX layer, and its router
        term (None for a dense MLP or without ``with_aux``)."""
        if self.cfg.num_experts:
            return self.moe(self.mlp_norm(x), with_aux)
        return self.mlp(self.mlp_norm(x)), None

    def forward(self, x, positions, cache=None, layer: int = 0,
                segment_ids=None, with_aux: bool = False,
                checkpoint_branches: bool = False):
        """The layer's output and its router term (``mlp_block``); with
        ``checkpoint_branches`` each branch runs under its own checkpoint
        (remat policy "names"), inside the layer's call, where a sharded
        layer's parameters are gathered."""
        if checkpoint_branches:
            x = x + checkpoint(self.attn_block, x, positions, cache, layer,
                               segment_ids, use_reentrant=False)
            h, aux = checkpoint(self.mlp_block, x, with_aux,
                                use_reentrant=False)
            return x + h, aux
        x = x + self.attn_block(x, positions, cache, layer, segment_ids)
        h, aux = self.mlp_block(x, with_aux)
        return x + h, aux


# the projections' matrix products: what jax.checkpoint_policies'
# dots_with_no_batch_dims_saveable keeps (attention's products carry batch
# dims, and the kernels' launches are no aten ops)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_layer(layer: DecoderLayer, policy: str, x, positions,
                segment_ids=None, with_aux: bool = False):
    """One layer under ``torch.utils.checkpoint`` with a JAX remat policy
    (``_remat_policy``): "nothing" saves only the layer's input; "names"
    also keeps ``attn_out`` and ``mlp_out``, by checkpointing the two
    branches apart, so that the input of the MLP branch (x + attn_out) is
    what is kept and neither branch's output is recomputed for the other;
    "dots" saves every projection's matmul output (selective
    checkpointing). Returns the layer's output and its router term: an
    output of the checkpointed function, so the recompute in the
    backward neither counts it twice nor loses its graph. Every policy
    goes through the layer's call, so that a sharded layer (FSDP2's
    ``fully_shard``) gathers its parameters for the forward and for the
    recompute."""
    if policy == "names":
        return layer(x, positions, None, 0, segment_ids, with_aux,
                     checkpoint_branches=True)
    if policy == "dots":
        return checkpoint(layer, x, positions, None, 0, segment_ids,
                          with_aux, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _save_dots))
    if policy == "nothing":
        return checkpoint(layer, x, positions, None, 0, segment_ids,
                          with_aux, use_reentrant=False)
    raise ValueError(f"unknown remat policy {policy!r}")


class LayerStack(nn.ModuleDict):
    """One pipeline stage's decoder layers, the JAX ``LayerStack``:
    layers ``first`` to ``first + count - 1`` of the full model, under its
    names (``str(l)``, so the parameters are ``layers.{l}.*`` in a module
    that holds the stack as ``layers``), run in order with the model's
    remat policy."""

    def __init__(self, cfg: LlamaConfig, dtype: torch.dtype,
                 param_dtype: torch.dtype, first: int, count: int):
        super().__init__({str(first + j): DecoderLayer(cfg, dtype,
                                                       param_dtype)
                          for j in range(count)})
        self.cfg = cfg

    def forward(self, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
        remat = self.cfg.remat and torch.is_grad_enabled()
        for layer in self.values():
            if remat:
                x, _ = remat_layer(layer, self.cfg.remat_policy, x,
                                   positions)
            else:
                x, _ = layer(x, positions)
        return x


def _chunk_nll(x: torch.Tensor, targets: torch.Tensor,
               head: torch.Tensor) -> torch.Tensor:
    logits = F.linear(x, head).float()
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None].long())[..., 0]


def _chunk_nll_split(x: torch.Tensor, targets: torch.Tensor,
                     head: torch.Tensor, first: int,
                     group) -> torch.Tensor:
    """``_chunk_nll`` over a vocabulary split on ``group``: ``head`` holds
    rows ``[first, first + V/tp)``. The log-sum-exp takes the maximum and
    the sum of exponentials over every rank; the target's logit comes from
    the rank that holds it. nll = max + log(sum exp(logit - max)) -
    logit[target], which is ``-log_softmax`` at the target."""
    logits = F.linear(x, head).float()                  # [B, c, V/tp]
    top = all_reduce_max(logits.amax(-1, keepdim=True), (group,))
    sum_exp = reduce_from((logits - top).exp().sum(-1), (group,))
    local = targets.long() - first
    mine = (local >= 0) & (local < logits.shape[-1])
    picked = logits.gather(-1, local.clamp(0, logits.shape[-1] - 1)[..., None])
    target_logit = reduce_from(torch.where(mine, picked[..., 0], 0.0),
                               (group,))
    return top[..., 0] + torch.log(sum_exp) - target_logit


class LlamaModel(nn.Module):
    """Decoder-only Llama. ``dtype`` is the compute type (default: the
    config's ``dtype``) and ``param_dtype`` the type weights are stored in
    (default: the config's ``param_dtype``); norm scales stay float32.
    With ``mesh`` (a ``DeviceMesh`` with the axes of ``parallel/mesh.py``)
    the layers hold this rank's part of the weights (``MeshPlace``); the
    mesh is refused at construction if the model does not split over it
    (``check_mesh``). Training and serving both take a mesh; serving's is
    tp only (``parallel.mesh.serve_mesh``)."""

    # the trainer feature-detects the fused chunked-CE `targets=` path
    supports_fused_loss = True

    def __init__(self, cfg: LlamaConfig, dtype=None, param_dtype=None,
                 mesh=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = torch_dtype(dtype if dtype is not None else cfg.dtype)
        self.param_dtype = torch_dtype(param_dtype if param_dtype is not None
                                       else cfg.param_dtype)
        self.mesh = mesh
        place = None
        if mesh is not None:
            check_mesh(cfg, mesh_sizes(mesh))
            place = MeshPlace.of(mesh)
        self.place = place
        vocab = cfg.vocab_size // (place.tp if place else 1)
        # this rank's rows of the vocabulary: [first_token, + vocab)
        self.first_token = place.tp_rank * vocab if place else 0
        self.embed = nn.Parameter(torch.empty(vocab, cfg.hidden_size,
                                              dtype=self.param_dtype))
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, self.dtype, self.param_dtype, place)
            for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                  self.dtype)
        self.lm_head = Dense(cfg.hidden_size, vocab, self.dtype,
                             self.param_dtype)

    def _embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """The embedding rows of ``input_ids`` in ``param_dtype``; on a
        mesh each rank looks up the ids it holds, zeros elsewhere, and the
        rows are summed over tp (one rank's row and zeros: exact)."""
        if self.place is None:
            return self.embed[input_ids.long()]
        local = input_ids.long() - self.first_token
        mine = (local >= 0) & (local < self.embed.shape[0])
        rows = self.embed[torch.where(mine, local, 0)]
        rows = torch.where(mine[..., None], rows, 0.0)
        return reduce_from(rows, (self.place.tp_group,))

    def hidden(self, input_ids: torch.Tensor,
               positions: Optional[torch.Tensor] = None,
               cache: Optional[PagedCache] = None,
               segment_ids=None, return_aux: bool = False):
        """Final-normed hidden states [B, S, H] (before lm_head); with
        ``return_aux`` also the router terms summed over the layers (a
        float32 scalar, zero for a dense model)."""
        if positions is None:
            # on an sp shard, the global positions of the rank's block
            s = input_ids.shape[1]
            first = self.place.sp_rank * s if self.place else 0
            positions = torch.arange(first, first + s,
                                     device=input_ids.device)
            positions = positions.expand(input_ids.shape)
        x = self._embed(input_ids).to(self.dtype)
        remat = (self.cfg.remat and cache is None
                 and torch.is_grad_enabled())
        aux = []
        for i, layer in enumerate(self.layers):
            if remat:
                x, a = remat_layer(layer, self.cfg.remat_policy, x,
                                   positions, segment_ids, return_aux)
            else:
                x, a = layer(x, positions, cache, i, segment_ids,
                             return_aux)
            if a is not None:
                aux.append(a)
        x = self.final_norm(x)
        if not return_aux:
            return x
        return x, (torch.stack(aux).sum() if aux
                   else torch.zeros((), device=x.device))

    def forward(self, input_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[PagedCache] = None, *,
                segment_ids=None,
                targets: Optional[torch.Tensor] = None,
                return_aux: bool = False):
        """Logits [B, S, V], or with ``targets`` [B, S] the per-position
        nll [B, S] (float32) of the fused chunked cross-entropy, which
        stays pure cross-entropy; with ``return_aux`` a pair of that and
        the router terms summed over the layers (``hidden``). With a
        PagedCache, positions must hold the absolute positions of
        input_ids; the cache's pool is updated in place. segment_ids
        (cache-free path only): None, [B, S], or a (q, kv) pair."""
        x = self.hidden(input_ids, positions, cache, segment_ids,
                        return_aux)
        if return_aux:
            x, aux = x
        out = (self.fused_nll(x, targets) if targets is not None
               else self.logits(x))
        return (out, aux) if return_aux else out

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """``lm_head(x)`` over the whole vocabulary, in ``dtype``: on a
        mesh each rank projects onto its V/tp rows and the parts are
        gathered over tp, so every rank holds the same logits."""
        if self.place is None:
            return self.lm_head(x)
        group = self.place.tp_group
        return gather_from(self.lm_head(copy_to(x, (group,))), group, dim=-1)

    def fused_nll(self, x: torch.Tensor,
                  targets: torch.Tensor) -> torch.Tensor:
        """Cross-entropy of lm_head(x) against targets, one ``loss_chunk``
        of positions at a time, each under a checkpoint: a chunk's
        [B, chunk, V] float32 logits live only while it is projected,
        reduced and, in the backward, recomputed, so the [B, S, V] logits
        never exist whole. On a mesh with tp > 1 each rank projects onto
        its rows of the vocabulary (``_chunk_nll_split``); every rank runs
        the same chunks in the same order, so the collectives of the
        recompute meet. At tp 1 the rank holds the whole vocabulary."""
        head = self.lm_head.weight.to(self.dtype)
        chunk = min(self.cfg.loss_chunk, x.shape[1])
        fn = _chunk_nll
        if self.place is not None and self.place.tp > 1:
            x = copy_to(x, (self.place.tp_group,))
            fn = functools.partial(_chunk_nll_split, first=self.first_token,
                                   group=self.place.tp_group)
        nll = []
        for xc, tc in zip(x.split(chunk, dim=1), targets.split(chunk, dim=1)):
            if torch.is_grad_enabled():
                nll.append(checkpoint(fn, xc, tc, head, use_reentrant=False))
            else:
                nll.append(fn(xc, tc, head))
        return torch.cat(nll, dim=1)
