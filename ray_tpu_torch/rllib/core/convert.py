"""RL module parameters across the frameworks: the Flax tree of the JAX
package's modules <-> the port's parameter dict.

Names follow the module structure: an ``MLPNet``'s layer i is Flax's
``Dense_i``; a child i of an ``nn.Sequential`` (DreamerV3's nets) is
``layers_i``; every other module keeps its name (``gru/ir``, ``enc/conv0``,
``dec/deconv_out``, ``pi``, ...). A Linear weight ``[out, in]`` is the
Dense kernel ``[in, out]`` transposed; a Conv2d weight ``[out, in, kh, kw]``
is the NHWC kernel ``[kh, kw, in, out]``; a ConvTranspose2d weight
``[in, out, kh, kw]`` is Flax's ``ConvTranspose`` kernel (``[kh, kw, in,
out]``, ``transpose_kernel=False``) with its spatial axes flipped, which
makes the two the same operation. Top-level leaves that are no module's
(SAC's ``log_alpha``) cross as they are. The tree is nested dicts of numpy
arrays, so no JAX is needed here.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from .rl_module import MLPNet


def flax_path(module: nn.Module, name: str) -> Tuple[Tuple[str, ...],
                                                     nn.Module]:
    """The Flax path of parameter ``name`` of ``module``, and the module
    that owns it."""
    parts = name.split(".")
    path = []
    parent = module
    i = 0
    while i < len(parts) - 1:
        part = parts[i]
        if isinstance(parent, MLPNet) and part == "layers":
            path.append(f"Dense_{parts[i + 1]}")
            parent = parent.layers[int(parts[i + 1])]
            i += 2
            continue
        path.append(f"layers_{part}" if isinstance(parent, nn.Sequential)
                    else part)
        parent = parent.get_submodule(part)
        i += 1
    path.append("kernel" if parts[-1] == "weight" else parts[-1])
    return tuple(path), parent


def _to_flax(owner: nn.Module, leaf: str, t: torch.Tensor) -> torch.Tensor:
    if leaf != "weight":
        return t
    if isinstance(owner, nn.ConvTranspose2d):
        return t.permute(2, 3, 0, 1).flip(0, 1)
    if isinstance(owner, nn.Conv2d):
        return t.permute(2, 3, 1, 0)
    return t.T


def _from_flax(owner: nn.Module, leaf: str, t: torch.Tensor) -> torch.Tensor:
    if leaf != "weight":
        return t
    if isinstance(owner, nn.ConvTranspose2d):
        return t.flip(0, 1).permute(2, 3, 0, 1)
    if isinstance(owner, nn.Conv2d):
        return t.permute(3, 2, 0, 1)
    return t.T


def rl_params_from_flax(module: nn.Module, tree: Mapping[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    """Flax param tree -> the port's parameter dict (float32, CPU), with
    the tree's top-level leaves that are not nets."""
    out: Dict[str, torch.Tensor] = {}
    for name, _ in module.named_parameters():
        path, owner = flax_path(module, name)
        leaf = tree
        for key in path:
            leaf = leaf[key]
        t = torch.from_numpy(np.array(leaf, np.float32))
        out[name] = _from_flax(owner, name.rsplit(".", 1)[-1],
                               t).contiguous()
    for key, leaf in tree.items():
        if not isinstance(leaf, Mapping):
            out[key] = torch.from_numpy(np.array(leaf, np.float32))
    return out


def flax_from_rl_params(module: nn.Module,
                        params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's parameter dict -> Flax param tree of numpy arrays;
    entries that are not the module's become top-level leaves."""
    tree: Dict[str, Any] = {}
    owned = dict(module.named_parameters())
    for name, t in params.items():
        t = t.detach().float().cpu()
        if name not in owned:
            tree[name] = t.numpy()
            continue
        path, owner = flax_path(module, name)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _to_flax(owner, name.rsplit(".", 1)[-1],
                                  t).contiguous().numpy()
    return tree
