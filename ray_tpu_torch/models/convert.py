"""Parameters for ``LlamaModel``: conversion from a Flax tree, a seeded
on-device init, and model construction from a state dict (the serving
form, or the training form with gradients on).

The Flax tree is the one the JAX package's engine builds
(``scan_layers=True``): leaves are stacked ``[L, ...]`` under
``layers/layer/...``, and ``DenseGeneral`` kernels are ``[in, out]``,
which transpose into ``nn.Linear.weight`` ``[out, in]``. The tree comes as
nested dicts of numpy arrays, so no JAX is needed here.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .config import LlamaConfig, torch_dtype
from .llama import LlamaModel

# Flax path inside layers/layer -> this package's name inside layers.{l}
_LAYER_LEAVES = {
    ("attn_norm", "scale"): ("attn_norm.scale", False),
    ("attn", "qkv_proj", "kernel"): ("attn.qkv_proj.weight", True),
    ("attn", "o_proj", "kernel"): ("attn.o_proj.weight", True),
    ("mlp_norm", "scale"): ("mlp_norm.scale", False),
    ("mlp", "gate_up_proj", "kernel"): ("mlp.gate_up_proj.weight", True),
    ("mlp", "down_proj", "kernel"): ("mlp.down_proj.weight", True),
}


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' numpy bfloat16
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _leaf(tree: Mapping, path) -> np.ndarray:
    for key in path:
        tree = tree[key]
    return tree


def params_from_flax(tree: Mapping, cfg: LlamaConfig) -> Dict[str, torch.Tensor]:
    """Flax param tree (nested dicts of numpy arrays) -> state dict."""
    layers = tree["layers"]["layer"]
    sd = {"embed": _tensor(tree["embed"]),
          "final_norm.scale": _tensor(tree["final_norm"]["scale"]),
          "lm_head.weight": _tensor(tree["lm_head"]["kernel"]).T.contiguous()}
    for path, (name, transpose) in _LAYER_LEAVES.items():
        stacked = _tensor(_leaf(layers, path))
        if stacked.shape[0] != cfg.num_layers:
            raise ValueError(f"{'/'.join(path)} stacks {stacked.shape[0]} "
                             f"layers, config has {cfg.num_layers}")
        for i in range(cfg.num_layers):
            w = stacked[i]
            sd[f"layers.{i}.{name}"] = w.T.contiguous() if transpose else w
    return sd


def init_params(cfg: LlamaConfig, generator: torch.Generator, device,
                param_dtype) -> Dict[str, torch.Tensor]:
    """Seeded random parameters made directly on ``device`` and stored in
    ``param_dtype``, with the Flax init's distributions: normal(0.02) for
    the embedding, lecun normal (normal truncated at two standard
    deviations, std sqrt(1/fan_in) before the truncation correction) for
    every projection, ones for the norm scales (float32)."""
    dtype = torch_dtype(param_dtype)
    h, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    hd, nq, nkv = cfg.head_dim_, cfg.num_heads, cfg.num_kv_heads

    def lecun(out_f: int, in_f: int) -> torch.Tensor:
        # truncated_normal(-2, 2) has std 0.8796...; flax rescales by it
        std = (1.0 / in_f) ** 0.5 / 0.87962566103423978
        w = torch.empty((out_f, in_f), dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                    generator=generator)
        return w.to(dtype)

    def ones() -> torch.Tensor:
        return torch.ones(h, dtype=torch.float32, device=device)

    embed = torch.empty((v, h), dtype=torch.float32, device=device)
    embed.normal_(0.0, 0.02, generator=generator)
    sd = {"embed": embed.to(dtype)}
    del embed
    for i in range(cfg.num_layers):
        sd[f"layers.{i}.attn_norm.scale"] = ones()
        sd[f"layers.{i}.attn.qkv_proj.weight"] = lecun((nq + 2 * nkv) * hd, h)
        sd[f"layers.{i}.attn.o_proj.weight"] = lecun(h, nq * hd)
        sd[f"layers.{i}.mlp_norm.scale"] = ones()
        sd[f"layers.{i}.mlp.gate_up_proj.weight"] = lecun(2 * f, h)
        sd[f"layers.{i}.mlp.down_proj.weight"] = lecun(h, f)
    sd["final_norm.scale"] = ones()
    sd["lm_head.weight"] = lecun(v, h)
    return sd


def load_params(model: LlamaModel, state_dict: Mapping[str, torch.Tensor],
                device) -> LlamaModel:
    """Place ``state_dict``'s values into ``model`` (built on any device,
    the meta device included) on ``device``: norm scales as float32,
    every other tensor in the model's ``param_dtype``."""
    placed = {}
    for name, t in state_dict.items():
        want = (torch.float32 if name.endswith(".scale")
                else model.param_dtype)
        placed[name] = t.to(device=device, dtype=want)
    model.load_state_dict(placed, strict=True, assign=True)
    return model


def build_model(cfg: LlamaConfig, state_dict: Mapping[str, torch.Tensor],
                device, dtype=None, param_dtype=None,
                train: bool = False) -> LlamaModel:
    """A LlamaModel on ``device`` holding ``state_dict``'s values. Weights
    are stored in ``param_dtype`` (default: ``dtype``, the serving form,
    where no cast happens at use) and computed in ``dtype`` (default: the
    config's). The serving form is in eval mode with gradients off; with
    ``train=True`` the model is in train mode with gradients on. The
    module is built on the meta device, so no weight is allocated twice."""
    dtype = torch_dtype(dtype if dtype is not None else cfg.dtype)
    with torch.device("meta"):
        model = LlamaModel(cfg, dtype,
                           param_dtype if param_dtype is not None else dtype)
    load_params(model, state_dict, device)
    if train:
        return model.train().requires_grad_(True)
    return model.eval().requires_grad_(False)
