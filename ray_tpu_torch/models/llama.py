"""Llama-family decoder in PyTorch: the serving path of the JAX package's
``models/llama.py``.

Numerics follow the JAX model: activations in the config's dtype, RMSNorm
statistics and its scale in float32, rotary angles in float32, fused QKV
(split q|k|v) and fused gate|up projections. Layers are an
``nn.ModuleList`` run by a Python loop; with a ``PagedCache`` each layer
reads and writes its ``[l]`` slice of the ``[L, P, Hkv, page, 2D]`` pool,
sending one-token steps to the paged decode kernel (K1) and prompts to
paged prefill (K2, with the cached-prefix merge). Without a cache,
attention is causal flash attention over the input (K2).

Parameter names are the state-dict keys ``models/convert.py`` produces
from a Flax tree, e.g. ``layers.0.attn.qkv_proj.weight``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from ..ops.flash_attention import flash_attention
from ..ops.paged_attention import (paged_attention_decode,
                                   paged_prefill_attention, paged_write)
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


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        hd, nq, nkv = cfg.head_dim_, cfg.num_heads, cfg.num_kv_heads
        self.qkv_proj = nn.Linear(cfg.hidden_size, (nq + 2 * nkv) * hd,
                                  bias=False, dtype=dtype)
        self.o_proj = nn.Linear(nq * hd, cfg.hidden_size, bias=False,
                                dtype=dtype)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[PagedCache] = None,
                layer: int = 0) -> torch.Tensor:
        cfg = self.cfg
        hd, nq, nkv = cfg.head_dim_, cfg.num_heads, cfg.num_kv_heads
        b, s = x.shape[:2]
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
            out = flash_attention(q, k, v, causal=True)
        return self.o_proj(out.reshape(b, s, nq * hd))


class MLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype: torch.dtype):
        super().__init__()
        self.gate_up_proj = nn.Linear(cfg.hidden_size,
                                      2 * cfg.intermediate_size,
                                      bias=False, dtype=dtype)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size,
                                   bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate, up = self.gate_up_proj(x).chunk(2, dim=-1)
        return self.down_proj(F.silu(gate) * up)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype: torch.dtype):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype)
        self.attn = Attention(cfg, dtype)
        self.mlp_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype)
        self.mlp = MLP(cfg, dtype)

    def forward(self, x, positions, cache=None, layer: int = 0):
        x = x + self.attn(self.attn_norm(x), positions, cache, layer)
        return x + self.mlp(self.mlp_norm(x))


class LlamaModel(nn.Module):
    """Decoder-only Llama. ``dtype`` is the activation and weight type
    (default: the config's ``dtype``); norm scales stay float32."""

    def __init__(self, cfg: LlamaConfig, dtype=None):
        super().__init__()
        if cfg.num_experts:
            raise NotImplementedError("MoE layers are not ported yet")
        self.cfg = cfg
        self.dtype = torch_dtype(dtype if dtype is not None else cfg.dtype)
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size,
                                              cfg.hidden_size,
                                              dtype=self.dtype))
        self.layers = nn.ModuleList(DecoderLayer(cfg, self.dtype)
                                    for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                  self.dtype)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                 bias=False, dtype=self.dtype)

    def hidden(self, input_ids: torch.Tensor,
               positions: Optional[torch.Tensor] = None,
               cache: Optional[PagedCache] = None) -> torch.Tensor:
        """Final-normed hidden states [B, S, H] (before lm_head)."""
        if positions is None:
            positions = torch.arange(input_ids.shape[1],
                                     device=input_ids.device)
            positions = positions.expand(input_ids.shape)
        x = self.embed[input_ids.long()].to(self.dtype)
        for i, layer in enumerate(self.layers):
            x = layer(x, positions, cache, i)
        return self.final_norm(x)

    def forward(self, input_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[PagedCache] = None) -> torch.Tensor:
        """Logits [B, S, V]. With a PagedCache, positions must hold the
        absolute positions of input_ids; the cache's pool is updated in
        place."""
        return self.lm_head(self.hidden(input_ids, positions, cache))
