"""Parameters for ``LlamaModel``: conversion from a Flax tree, a seeded
on-device init, and model construction from a state dict (the serving
form, or the training form with gradients on).

The Flax tree is the one the JAX package's engine builds
(``scan_layers=True``): leaves are stacked ``[L, ...]`` under
``layers/layer/...``, and ``DenseGeneral`` kernels are ``[in, out]``,
which transpose into ``nn.Linear.weight`` ``[out, in]``. MoE layers keep
``moe/{router, experts_gate_up, experts_down}`` in their JAX layouts
(``[h, E]``, ``[E, h, 2f]``, ``[E, f, h]``), which ``MoEMLP`` reads as
they are. The JAX ``PipelinedTrainer``'s tree stacks the layer leaves
``[S, L/S, ...]`` (``num_stages`` S); ``ops.pipeline.stack_to_stages``
then gives each pp rank its stage of the state dict, and
``flax_from_params`` goes back. The tree comes as nested dicts of numpy
arrays, so no JAX is needed here.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..parallel.sharding import shard_tensor
from .config import LlamaConfig, torch_dtype
from .llama import LlamaModel, MeshPlace

# Flax path inside layers/layer -> this package's name inside layers.{l}
_LAYER_LEAVES = {
    ("attn_norm", "scale"): ("attn_norm.scale", False),
    ("attn", "qkv_proj", "kernel"): ("attn.qkv_proj.weight", True),
    ("attn", "o_proj", "kernel"): ("attn.o_proj.weight", True),
    ("mlp_norm", "scale"): ("mlp_norm.scale", False),
    ("mlp", "gate_up_proj", "kernel"): ("mlp.gate_up_proj.weight", True),
    ("mlp", "down_proj", "kernel"): ("mlp.down_proj.weight", True),
}
# the same for a layer with experts: "moe" in place of "mlp"
_MOE_LAYER_LEAVES = {
    **{path: leaf for path, leaf in _LAYER_LEAVES.items()
       if path[0] != "mlp"},
    ("moe", "router"): ("moe.router", False),
    ("moe", "experts_gate_up"): ("moe.experts_gate_up", False),
    ("moe", "experts_down"): ("moe.experts_down", False),
}


def layer_leaves(cfg: LlamaConfig) -> Dict[tuple, tuple]:
    """Flax path -> (name, transpose) of one layer's leaves for ``cfg``."""
    return _MOE_LAYER_LEAVES if cfg.num_experts else _LAYER_LEAVES


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' numpy bfloat16
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _leaf(tree: Mapping, path) -> np.ndarray:
    for key in path:
        tree = tree[key]
    return tree


def params_from_flax(tree: Mapping, cfg: LlamaConfig,
                     num_stages: Optional[int] = None
                     ) -> Dict[str, torch.Tensor]:
    """Flax param tree (nested dicts of numpy arrays) -> state dict. With
    ``num_stages`` the layer leaves are staged, ``[S, L/S, ...]``."""
    layers = tree["layers"]["layer"]
    sd = {"embed": _tensor(tree["embed"]),
          "final_norm.scale": _tensor(tree["final_norm"]["scale"]),
          "lm_head.weight": _tensor(tree["lm_head"]["kernel"]).T.contiguous()}
    for path, (name, transpose) in layer_leaves(cfg).items():
        stacked = _tensor(_leaf(layers, path))
        if num_stages is not None:
            if stacked.shape[0] != num_stages:
                raise ValueError(f"{'/'.join(path)} has {stacked.shape[0]} "
                                 f"stages, not {num_stages}")
            stacked = stacked.flatten(0, 1)
        if stacked.shape[0] != cfg.num_layers:
            raise ValueError(f"{'/'.join(path)} stacks {stacked.shape[0]} "
                             f"layers, config has {cfg.num_layers}")
        for i in range(cfg.num_layers):
            w = stacked[i]
            sd[f"layers.{i}.{name}"] = w.T.contiguous() if transpose else w
    return sd


def flax_from_params(sd: Mapping[str, torch.Tensor], cfg: LlamaConfig,
                     num_stages: Optional[int] = None) -> Dict:
    """The inverse of ``params_from_flax``: a full state dict as the JAX
    model's Flax tree of numpy arrays (layers stacked ``[L, ...]``, or
    ``[S, L/S, ...]`` with ``num_stages``; dense kernels ``[in, out]``)."""
    def leaf(t, transpose):
        t = t.detach().cpu()
        return (t.T if transpose else t).contiguous().numpy()

    tree = {"embed": leaf(sd["embed"], False),
            "final_norm": {"scale": leaf(sd["final_norm.scale"], False)},
            "lm_head": {"kernel": leaf(sd["lm_head.weight"], True)},
            "layers": {"layer": {}}}
    for path, (name, transpose) in layer_leaves(cfg).items():
        node = tree["layers"]["layer"]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        stacked = np.stack([leaf(sd[f"layers.{i}.{name}"], transpose)
                            for i in range(cfg.num_layers)])
        if num_stages is not None:
            stacked = stacked.reshape((num_stages, -1) + stacked.shape[1:])
        node[path[-1]] = stacked
    return tree


def init_params(cfg: LlamaConfig, generator: torch.Generator, device,
                param_dtype, mesh=None) -> Dict[str, torch.Tensor]:
    """Seeded random parameters made directly on ``device`` and stored in
    ``param_dtype``, with the Flax init's distributions: normal(0.02) for
    the embedding and (float32) the MoE router, lecun normal (normal
    truncated at two standard deviations, std sqrt(1/fan_in) before the
    truncation correction) for every projection, ones for the norm scales
    (float32). An expert kernel's fan-in is Flax's for a 3-D kernel, whose
    leading expert axis counts as receptive field: E * h for
    ``experts_gate_up`` [E, h, 2f], E * f for ``experts_down`` [E, f, h].

    With ``mesh`` (a ``DeviceMesh``) every rank draws every tensor whole,
    in the same order from the same seeded ``generator``, and keeps its
    part (``parallel.sharding.shard_tensor``) before the next is drawn: a
    mesh run starts from the parameters of a one-device run."""
    if mesh is None:
        return dict(_draw_params(cfg, generator, device, param_dtype))
    place = MeshPlace.of(mesh)
    return {name: shard_tensor(name, t, cfg, place)
            for name, t in _draw_params(cfg, generator, device, param_dtype)}


def _draw_params(cfg, generator, device, param_dtype):
    """(name, tensor) of every parameter, drawn in order."""
    dtype = torch_dtype(param_dtype)
    h, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    hd, nq, nkv = cfg.head_dim_, cfg.num_heads, cfg.num_kv_heads

    def lecun(out_f: int, in_f: int, experts: int = 0) -> torch.Tensor:
        """[out_f, in_f], or with ``experts`` E the stacked [E, in_f,
        out_f] of an expert kernel."""
        fan_in = in_f * max(experts, 1)
        # truncated_normal(-2, 2) has std 0.8796...; flax rescales by it
        std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
        shape = (experts, in_f, out_f) if experts else (out_f, in_f)
        w = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                    generator=generator)
        return w.to(dtype)

    def ones() -> torch.Tensor:
        return torch.ones(h, dtype=torch.float32, device=device)

    embed = torch.empty((v, h), dtype=torch.float32, device=device)
    embed.normal_(0.0, 0.02, generator=generator)
    yield "embed", embed.to(dtype)
    del embed
    for i in range(cfg.num_layers):
        yield f"layers.{i}.attn_norm.scale", ones()
        yield f"layers.{i}.attn.qkv_proj.weight", lecun((nq + 2 * nkv) * hd,
                                                         h)
        yield f"layers.{i}.attn.o_proj.weight", lecun(h, nq * hd)
        yield f"layers.{i}.mlp_norm.scale", ones()
        if cfg.num_experts:
            n_exp = cfg.num_experts
            router = torch.empty((h, n_exp), dtype=torch.float32,
                                 device=device)
            yield f"layers.{i}.moe.router", router.normal_(
                0.0, 0.02, generator=generator)
            yield f"layers.{i}.moe.experts_gate_up", lecun(2 * f, h, n_exp)
            yield f"layers.{i}.moe.experts_down", lecun(h, f, n_exp)
        else:
            yield f"layers.{i}.mlp.gate_up_proj.weight", lecun(2 * f, h)
            yield f"layers.{i}.mlp.down_proj.weight", lecun(h, f)
    yield "final_norm.scale", ones()
    yield "lm_head.weight", lecun(v, h)


def load_params(model: LlamaModel, state_dict: Mapping[str, torch.Tensor],
                device) -> LlamaModel:
    """Place ``state_dict``'s values into ``model`` (built on any device,
    the meta device included) on ``device``: norm scales and MoE routers
    as float32, every other tensor in the model's ``param_dtype``. A model
    built on a mesh takes the rank's parts (``init_params(..., mesh=)``,
    ``parallel.sharding.shard_state_dict``)."""
    placed = {}
    for name, t in state_dict.items():
        want = (torch.float32 if name.endswith((".scale", ".router"))
                else model.param_dtype)
        placed[name] = t.to(device=device, dtype=want)
    model.load_state_dict(placed, strict=True, assign=True)
    return model


def build_model(cfg: LlamaConfig, state_dict: Mapping[str, torch.Tensor],
                device, dtype=None, param_dtype=None,
                train: bool = False, mesh=None) -> LlamaModel:
    """A LlamaModel on ``device`` holding ``state_dict``'s values. Weights
    are stored in ``param_dtype`` (default: ``dtype``, the serving form,
    where no cast happens at use) and computed in ``dtype`` (default: the
    config's). The serving form is in eval mode with gradients off; with
    ``train=True`` the model is in train mode with gradients on. The
    module is built on the meta device, so no weight is allocated twice.
    With ``mesh`` the model holds the rank's parts, which ``state_dict``
    must hold (``init_params(..., mesh=)``, ``shard_state_dict``)."""
    dtype = torch_dtype(dtype if dtype is not None else cfg.dtype)
    with torch.device("meta"):
        model = LlamaModel(cfg, dtype,
                           param_dtype if param_dtype is not None else dtype,
                           mesh=mesh)
    load_params(model, state_dict, device)
    if train:
        return model.train().requires_grad_(True)
    return model.eval().requires_grad_(False)
