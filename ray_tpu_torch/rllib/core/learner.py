"""Learner: owns a module's parameters and optimizer state and runs the
updates; the counterpart of the JAX package's ``rllib/core/learner.py``.

Subclasses define ``loss(params, batch) -> (loss, metrics)`` over a dict
of parameter tensors, running the module through ``rl_module.apply``
(``torch.func.functional_call``): JAX's ``stop_gradient(params[...])`` is
a ``.detach()`` of dict entries, and the target networks that
``prepare_batch`` puts into the batch are plain tensor dicts. The
optimizer is optax's ``chain(clip_by_global_norm(grad_clip), adam(lr))``:
the port's ``AdamW`` with b2 0.999, no weight decay and a constant
learning rate. ``get_weights`` and ``set_weights`` speak the Flax layout
as numpy (``core/convert.py``), so weights cross between a JAX learner or
env runner and this one both ways.

A batch is a dict of numpy arrays in the JAX learners' format (floats
become float32 tensors, integers int64) or of tensors. The module's
parameters are the learner's: ``params`` holds views of them, which the
optimizer updates in place.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from ...parallel.train_lib import AdamW
from .convert import flax_from_rl_params, rl_params_from_flax


def to_device(batch: Mapping[str, Any], device) -> Dict[str, Any]:
    """numpy arrays and tensors (nested dicts too) -> tensors on
    ``device``: floating values as float32, integers as int64."""
    out: Dict[str, Any] = {}
    for key, val in batch.items():
        if isinstance(val, Mapping):
            out[key] = to_device(val, device)
            continue
        t = val if torch.is_tensor(val) else torch.as_tensor(np.asarray(val))
        if t.is_floating_point():
            t = t.to(device=device, dtype=torch.float32)
        elif t.dtype != torch.bool:
            t = t.to(device=device, dtype=torch.int64)
        else:
            t = t.to(device)
        out[key] = t
    return out


def copy_params(params: Mapping[str, torch.Tensor],
                prefixes: Tuple[str, ...] = ("",)) -> Dict[str, torch.Tensor]:
    """Copies of the entries whose names start with one of ``prefixes``
    (a target network)."""
    return {k: v.detach().clone() for k, v in params.items()
            if k.startswith(prefixes)}


@torch.no_grad()
def polyak_(target: Dict[str, torch.Tensor],
            online: Mapping[str, torch.Tensor], tau: float) -> None:
    """target <- (1 - tau) * target + tau * online, in place."""
    ts = list(target.values())
    torch._foreach_mul_(ts, 1.0 - tau)
    torch._foreach_add_(ts, torch._foreach_mul(
        [online[k] for k in target], tau))


class Learner:
    def __init__(self, module, config: Dict[str, Any], seed: int = 0,
                 device: str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"{type(self).__name__} device is 'cuda' but no CUDA device "
                "is available (pass device='cpu' to run on the CPU)")
        self.module = module
        self.config = config
        self.seed = seed
        # drawn on the CPU, so a learner's init does not depend on its device
        module.init(torch.Generator().manual_seed(seed))
        module.to(self.device).requires_grad_(False)
        self.params: Dict[str, torch.Tensor] = {
            name: p.detach() for name, p in module.named_parameters()}
        lr = config.get("lr", 3e-4)
        self.tx = AdamW(lambda count: lr, b1=0.9, b2=0.999, eps=1e-8,
                        weight_decay=0.0,
                        grad_clip=config.get("grad_clip", 10.0))
        self.opt_state = self.tx.init(list(self.params.values()))

    # ------------------------------------------------------------- loss

    def loss(self, params, batch) -> Tuple[torch.Tensor,
                                           Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def prepare_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Hook to enrich the (device) batch before the gradients, so that
        both update() and compute_gradients() see it: DQN's target
        network, SAC's noise."""
        return batch

    # ----------------------------------------------------------- update

    def _grads(self, batch) -> Tuple[List[torch.Tensor],
                                     Dict[str, torch.Tensor]]:
        batch = self.prepare_batch(to_device(batch, self.device))
        live = {k: v.detach().requires_grad_(True)
                for k, v in self.params.items()}
        loss, metrics = self.loss(live, batch)
        grads = torch.autograd.grad(loss, list(live.values()),
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(live.values(), grads)]
        return grads, {**metrics, "total_loss": loss}

    def _host(self, metrics: Mapping[str, torch.Tensor]) -> Dict[str, float]:
        """Every metric to the host in one copy."""
        vals = torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                            device=self.device).reshape(())
                            for v in metrics.values()]).detach().cpu()
        return dict(zip(metrics, vals.tolist()))

    def update(self, batch) -> Dict[str, float]:
        """One update: gradients, then the clip and Adam; returns the
        loss's metrics with ``total_loss`` and ``grad_norm``."""
        grads, metrics = self._grads(batch)
        metrics["grad_norm"] = self.tx.update(list(self.params.values()),
                                              grads, self.opt_state)
        return self._host(metrics)

    def compute_gradients(self, batch) -> Tuple[Dict[str, torch.Tensor],
                                                Dict[str, float]]:
        """The gradients by parameter name, and the metrics."""
        grads, metrics = self._grads(batch)
        return dict(zip(self.params, grads)), self._host(metrics)

    def apply_gradients(self, grads: Mapping[str, torch.Tensor]) -> None:
        # copies: the clip scales its gradients in place
        self.tx.update(list(self.params.values()),
                       [grads[k].to(self.device, copy=True)
                        for k in self.params], self.opt_state)

    # ---------------------------------------------------------- weights

    def get_weights(self) -> Dict[str, Any]:
        """The parameters in the Flax layout, as numpy."""
        return flax_from_rl_params(self.module, self.params)

    @torch.no_grad()
    def set_weights(self, weights: Mapping[str, Any]) -> None:
        """Take parameters in the Flax layout (a JAX learner's
        ``get_weights``)."""
        new = rl_params_from_flax(self.module, weights)
        for k, v in self.params.items():
            v.copy_(new[k])

    def after_update(self) -> None:
        """Hook: DQN's target sync, the polyak averages."""
