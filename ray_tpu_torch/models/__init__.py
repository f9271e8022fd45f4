"""Llama model, configurations and parameter conversion."""

from .config import CONFIGS, LlamaConfig, get_config, torch_dtype
from .convert import build_model, init_params, params_from_flax
from .llama import (Attention, DecoderLayer, LlamaModel, MLP, PagedCache,
                    RMSNorm, rope)

__all__ = ["Attention", "CONFIGS", "DecoderLayer", "LlamaConfig",
           "LlamaModel", "MLP", "PagedCache", "RMSNorm", "build_model",
           "get_config", "init_params", "params_from_flax", "rope",
           "torch_dtype"]
