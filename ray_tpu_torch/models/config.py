"""Llama model configurations, mirrored field by field from the JAX
package's ``models/llama.py`` (``LlamaConfig`` and ``CONFIGS``).

Dtypes are strings (``"bfloat16"``, ``"float32"``) or torch dtypes;
``torch_dtype`` resolves either form. The training fields (remat and its
policy, the fused-loss chunk) are read by the training path; the MoE
fields (``num_experts`` and the rest) by ``models.llama.MoEMLP``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(dtype: Any) -> torch.dtype:
    """A torch dtype from a torch dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[str(dtype)]


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_layers: int = 22
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: Optional[int] = None
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    dtype: Any = "bfloat16"
    param_dtype: Any = "float32"
    remat: bool = True
    remat_policy: str = "nothing"
    loss_chunk: int = 512
    scan_layers: bool = True
    attention_impl: Optional[str] = None
    num_experts: int = 0
    num_experts_per_tok: int = 2
    capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.02
    moe_group_size: int = 2048

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    def num_params(self) -> int:
        h, f, v, l = (self.hidden_size, self.intermediate_size,
                      self.vocab_size, self.num_layers)
        hd = self.head_dim_
        attn = h * hd * (self.num_heads + 2 * self.num_kv_heads) \
            + self.num_heads * hd * h
        if self.num_experts:
            mlp = self.num_experts * 3 * h * f + h * self.num_experts
        else:
            mlp = 3 * h * f
        return l * (attn + mlp + 2 * h) + 2 * v * h + h

    def active_params(self) -> int:
        """Params touched per token (= num_params for dense models)."""
        if not self.num_experts:
            return self.num_params()
        h, f, l = self.hidden_size, self.intermediate_size, self.num_layers
        dense = self.num_params() - l * self.num_experts * 3 * h * f
        return dense + l * self.num_experts_per_tok * 3 * h * f


CONFIGS = {
    "tiny": LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                        num_layers=2, num_heads=4, num_kv_heads=2,
                        max_seq_len=256, remat=False),
    "debug-sharded": LlamaConfig(vocab_size=512, hidden_size=128,
                                 intermediate_size=256, num_layers=2,
                                 num_heads=8, num_kv_heads=4,
                                 max_seq_len=512, remat=False),
    "llama-500m": LlamaConfig(vocab_size=32000, hidden_size=1024,
                              intermediate_size=4096, num_layers=24,
                              num_heads=16, num_kv_heads=8),
    "llama-1b": LlamaConfig(vocab_size=32000, hidden_size=2048,
                            intermediate_size=5632, num_layers=22,
                            num_heads=32, num_kv_heads=8),
    "llama3-8b": LlamaConfig(vocab_size=128256, hidden_size=4096,
                             intermediate_size=14336, num_layers=32,
                             num_heads=32, num_kv_heads=8,
                             rope_theta=500000.0),
    "tiny-moe": LlamaConfig(vocab_size=256, hidden_size=64,
                            intermediate_size=128, num_layers=2,
                            num_heads=4, num_kv_heads=2, max_seq_len=256,
                            remat=False, num_experts=4,
                            num_experts_per_tok=2, moe_group_size=64),
    "mixtral-8x7b": LlamaConfig(vocab_size=32000, hidden_size=4096,
                                intermediate_size=14336, num_layers=32,
                                num_heads=32, num_kv_heads=8,
                                rope_theta=1e6, num_experts=8,
                                num_experts_per_tok=2),
}


def get_config(name: str, **overrides) -> LlamaConfig:
    return dataclasses.replace(CONFIGS[name], **overrides)
