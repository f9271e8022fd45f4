"""Llama model, configurations and parameter conversion."""

from .config import CONFIGS, LlamaConfig, get_config, torch_dtype
from .convert import (build_model, flax_from_params, init_params,
                      load_params, params_from_flax)
from .llama import (Attention, DecoderLayer, Dense, LayerStack, LlamaModel,
                    MLP, MoEMLP, PagedCache, RMSNorm, rope)

__all__ = ["Attention", "CONFIGS", "DecoderLayer", "Dense", "LlamaConfig",
           "LlamaModel", "MLP", "MoEMLP", "PagedCache", "RMSNorm",
           "LayerStack", "build_model", "flax_from_params",
           "get_config", "init_params", "load_params", "params_from_flax",
           "rope", "torch_dtype"]
