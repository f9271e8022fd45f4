"""Which rank holds which part of each parameter: the counterpart of the
JAX package's ``parallel/sharding.py``.

``DEFAULT_RULES`` is the JAX rule table (logical axis -> mesh axes).
``LOGICAL_AXES`` names each of the port's parameters' dims by the JAX
model's logical axes (``ray_tpu/models/llama.py``), in the port's layout
(``nn.Linear`` weights are ``[out, in]``, the transpose of a Flax
kernel). The port splits the dims whose axis the rules put on ``tp`` or
``ep`` itself, in the model's layers (``models/llama.py``, ``MeshPlace``);
``fsdp`` and ``dp`` are FSDP2's (``fully_shard`` over ``(dp, fsdp)``),
which shards dim 0 of the rank's part where JAX shards the ``embed`` axis.

A fused dim is split segment by segment: ``qkv_proj``'s rows are
``[q | k | v]`` and each rank keeps its q heads, its kv heads and their v
rows, fused again in that order; ``gate_up``'s are ``[gate | up]``. JAX's
GSPMD splits the fused dim in one piece and moves data as it needs; the
numbers are the same either way.

``shard_state_dict`` gives a rank's part of a full state dict;
``merge_tensor`` puts the parts of every rank back together, and
``gather_state_dict`` does so on a live mesh through collectives.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Tuple

import torch
import torch.distributed as dist

from ..models.config import LlamaConfig
from ..models.llama import MeshPlace

# (logical axis name, mesh axis/axes or None): the JAX table as it is
DEFAULT_RULES: Tuple[Tuple[str, Any], ...] = (
    ("batch", ("dp", "fsdp")),
    ("seq", "sp"),
    ("expert", "ep"),       # MoE expert axis

    ("embed", "fsdp"),      # ZeRO-style parameter sharding
    ("qkv", "tp"),
    ("heads", "tp"),
    ("mlp", "tp"),
    ("vocab", "tp"),
    ("layers", None),       # scan axis never sharded (pipeline uses stages)
)

# the port's parameter name (inside ``layers.{l}.`` for a layer's) ->
# logical axes of its dims, in the port's layout
LOGICAL_AXES: Dict[str, Tuple[str, ...]] = {
    "embed": ("vocab", "embed"),
    "final_norm.scale": ("embed",),
    "lm_head.weight": ("vocab", "embed"),
    "attn_norm.scale": ("embed",),
    "mlp_norm.scale": ("embed",),
    "attn.qkv_proj.weight": ("qkv", "embed"),
    "attn.o_proj.weight": ("embed", "heads"),
    "mlp.gate_up_proj.weight": ("mlp", "embed"),
    "mlp.down_proj.weight": ("embed", "mlp"),
    "moe.router": ("embed", None),
    "moe.experts_gate_up": ("expert", "embed", "mlp"),
    "moe.experts_down": ("expert", "mlp", "embed"),
}

# the mesh axes the model's layers split themselves
SPLIT_AXES = ("ep", "tp")

_LAYER = re.compile(r"^layers\.\d+\.")


def logical_axes(name: str) -> Tuple[str, ...]:
    """The logical axes of parameter ``name``'s dims."""
    return LOGICAL_AXES[_LAYER.sub("", name)]


def _mesh_axis(logical) -> Any:
    return dict(DEFAULT_RULES).get(logical)


def split_dims(name: str) -> Dict[str, int]:
    """{mesh axis: dim} of the dims of ``name`` that the layers split over
    ``ep`` or ``tp``."""
    return {_mesh_axis(a): d for d, a in enumerate(logical_axes(name))
            if _mesh_axis(a) in SPLIT_AXES}


def _segments(name: str, axis: str, size: int,
              cfg: LlamaConfig) -> List[int]:
    """The fused segments of the dim of full length ``size`` that ``name``
    splits over ``axis``."""
    if axis != "tp":
        return [size]
    if name.endswith("qkv_proj.weight"):
        hd = cfg.head_dim_
        return [cfg.num_heads * hd, cfg.num_kv_heads * hd,
                cfg.num_kv_heads * hd]
    if "gate_up" in name:
        return [size // 2, size // 2]
    return [size]


def _place_of(axis: str, place: MeshPlace) -> Tuple[int, int]:
    return (place.tp, place.tp_rank) if axis == "tp" \
        else (place.ep, place.ep_rank)


def shard_tensor(name: str, full: torch.Tensor, cfg: LlamaConfig,
                 place: MeshPlace) -> torch.Tensor:
    """The rank's part of the full tensor ``name``."""
    t = full
    for axis, dim in split_dims(name).items():
        n, i = _place_of(axis, place)
        if n == 1:
            continue
        segs = t.split(_segments(name, axis, t.shape[dim], cfg), dim)
        t = torch.cat([seg.chunk(n, dim)[i] for seg in segs], dim)
    return t.contiguous()


def merge_tensor(name: str, parts: Mapping[Tuple[int, int], torch.Tensor],
                 cfg: LlamaConfig, tp: int, ep: int) -> torch.Tensor:
    """The full tensor ``name`` from every rank's part, keyed by the rank's
    (tp index, ep index)."""
    dims = split_dims(name)

    def merge(pieces, axis):
        dim = dims[axis]
        full = sum(p.shape[dim] for p in pieces)
        segs = [s // len(pieces) for s in _segments(name, axis, full, cfg)]
        split = [p.split(segs, dim) for p in pieces]
        return torch.cat([torch.cat([sp[j] for sp in split], dim)
                          for j in range(len(segs))], dim)

    by_ep = []
    for e in range(ep):
        pieces = [parts[t, e] for t in range(tp)]
        by_ep.append(merge(pieces, "tp") if "tp" in dims else pieces[0])
    return merge(by_ep, "ep") if "ep" in dims else by_ep[0]


def _place(mesh) -> MeshPlace:
    return mesh if isinstance(mesh, MeshPlace) else MeshPlace.of(mesh)


def shard_state_dict(full: Mapping[str, torch.Tensor], cfg: LlamaConfig,
                     mesh) -> Dict[str, torch.Tensor]:
    """The rank's part of every tensor of ``full`` (e.g.
    ``params_from_flax`` of a JAX tree): the state dict a model built on
    ``mesh`` (a ``DeviceMesh``, or a ``MeshPlace``) holds before FSDP2
    shards it."""
    place = _place(mesh)
    return {name: shard_tensor(name, t, cfg, place)
            for name, t in full.items()}


def gather_state_dict(state: Mapping[str, torch.Tensor], cfg: LlamaConfig,
                      mesh) -> Dict[str, torch.Tensor]:
    """The full tensors of a state sharded on ``mesh``, on every rank (a
    collective: every rank calls it). A DTensor (FSDP2's shard over
    ``(dp, fsdp)``) is gathered whole first, then the parts are gathered
    over ``tp`` and ``ep`` and merged."""
    place = MeshPlace.of(mesh)
    out = {}
    for name in sorted(state):
        t = state[name].detach()
        if hasattr(t, "full_tensor"):
            t = t.full_tensor()
        dims = split_dims(name)
        parts = {}
        tp_parts = _all_gather(t, place.tp_group, place.tp) \
            if "tp" in dims else [t] * place.tp
        for ti, part in enumerate(tp_parts):
            ep_parts = _all_gather(part, place.ep_group, place.ep) \
                if "ep" in dims else [part] * place.ep
            for ei, piece in enumerate(ep_parts):
                parts[ti, ei] = piece
        out[name] = merge_tensor(name, parts, cfg, place.tp, place.ep)
    return out


def _all_gather(t: torch.Tensor, group, n: int) -> List[torch.Tensor]:
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts
