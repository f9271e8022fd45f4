"""RL modules: the networks of the RL algorithms, the counterpart of the
JAX package's ``rllib/core/rl_module.py``.

Each module is an ``nn.Module`` built for an environment's spaces. A space
is any object with the attributes a module reads: ``.shape`` for
observations, ``.n`` for a discrete action space, ``.shape``, ``.low`` and
``.high`` for a box. ``init(generator)`` draws the parameters in place
from Flax's initialisers (``lecun_normal`` kernels, zero biases and
``normal(0.01)`` for the last layer of ``MLPNet``). The ``Learner`` owns
the parameters as a dict of tensors and runs a module on them through
``apply`` (``torch.func.functional_call``): a module's ``forward`` calls
the method named by ``method``.

The samplers take their noise as a tensor: ``squashed_gaussian_sample``
takes a standard normal ``eps`` and ``categorical_sample`` a Gumbel draw
(``argmax(logits + gumbel)``, which is what ``jax.random.categorical``
computes from its key). ``normal_noise``, ``gumbel_noise`` and
``uniform_noise`` draw such noise from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call


@dataclasses.dataclass
class RLModuleSpec:
    """Builds an RLModule for an environment's spaces."""

    module_class: Any = None
    hidden: Tuple[int, ...] = (64, 64)
    dueling: bool = False  # DQN: separate value and advantage streams
    config: Any = None     # module-specific kwargs (DreamerV3's sizes)

    def build(self, obs_space, act_space) -> "RLModule":
        cls = self.module_class or DiscreteMLPModule
        return cls(obs_space, act_space, self)


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """Flax's ``lecun_normal``: a normal truncated at two standard
    deviations, std sqrt(1 / fan_in) before the truncation's correction."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


@torch.no_grad()
def init_dense_(layer: nn.Linear, generator: torch.Generator) -> None:
    """Flax ``nn.Dense``'s defaults: lecun normal kernel, zero bias."""
    lecun_normal_(layer.weight, layer.in_features, generator)
    layer.bias.zero_()


class MLPNet(nn.Module):
    """tanh hidden layers, then a linear layer initialised normal(0.01)
    (the JAX package's ``_MLPNet``; layer i is Flax's ``Dense_i``)."""

    def __init__(self, in_dim: int, hidden: Sequence[int], out: int):
        super().__init__()
        dims = (in_dim, *hidden, out)
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for layer in self.layers[:-1]:
            init_dense_(layer, generator)
        last = self.layers[-1]
        last.weight.normal_(0.0, 0.01, generator=generator)
        last.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = torch.tanh(layer(x))
        return self.layers[-1](x)


def apply(module: nn.Module, params: Mapping[str, torch.Tensor], *args,
          method: str = "forward_train"):
    """``module.<method>(*args)`` computed with ``params`` in place of the
    module's own parameters (those missing from ``params`` keep theirs;
    entries that are not the module's are ignored)."""
    return functional_call(module, dict(params), args, {"method": method})


class RLModule(nn.Module):
    """Base: a network for given spaces. ``init`` draws the parameters;
    ``forward(*args, method=...)`` dispatches to a method, so ``apply``
    reaches every method through ``functional_call``."""

    def __init__(self, obs_space, act_space, spec: RLModuleSpec):
        super().__init__()
        self.obs_space = obs_space
        self.act_space = act_space
        self.spec = spec
        self.obs_dim = int(np.prod(obs_space.shape))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Draw every parameter in place, net by net in the order they
        were built; returns them by name."""
        for net in self.children():
            net.init(generator)
        return {name: p.detach() for name, p in self.named_parameters()}

    def forward(self, *args, method: str = "forward_train"):
        return getattr(self, method)(*args)

    def forward_train(self, obs) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def forward_inference(self, obs) -> Dict[str, torch.Tensor]:
        return self.forward_train(obs)


class DiscreteMLPModule(RLModule):
    """Categorical policy and value head for a discrete action space."""

    def __init__(self, obs_space, act_space, spec):
        super().__init__(obs_space, act_space, spec)
        self.n_actions = int(act_space.n)
        self.pi = MLPNet(self.obs_dim, spec.hidden, self.n_actions)
        self.vf = MLPNet(self.obs_dim, spec.hidden, 1)

    def forward_train(self, obs):
        return {"logits": self.pi(obs), "vf": self.vf(obs)[..., 0]}


class QMLPModule(RLModule):
    """Q-network for DQN, dueling or not."""

    def __init__(self, obs_space, act_space, spec):
        super().__init__(obs_space, act_space, spec)
        self.n_actions = int(act_space.n)
        if spec.dueling:
            self.adv = MLPNet(self.obs_dim, spec.hidden, self.n_actions)
            self.val = MLPNet(self.obs_dim, spec.hidden, 1)
        else:
            self.q = MLPNet(self.obs_dim, spec.hidden, self.n_actions)

    def forward_train(self, obs):
        if self.spec.dueling:
            adv = self.adv(obs)
            q = self.val(obs) + adv - adv.mean(-1, keepdim=True)
        else:
            q = self.q(obs)
        return {"q": q}


class _ContinuousActorModule(RLModule):
    """The tanh-Gaussian actor of a box action space: a 2 * act_dim net
    split into the mean and the clipped log std, and the action bounds
    the env runner rescales with."""

    LOG_STD_MIN = -20.0
    LOG_STD_MAX = 2.0

    def __init__(self, obs_space, act_space, spec):
        super().__init__(obs_space, act_space, spec)
        self.act_dim = int(np.prod(act_space.shape))
        self.act_low = np.asarray(act_space.low, np.float32)
        self.act_high = np.asarray(act_space.high, np.float32)
        self.pi = MLPNet(self.obs_dim, spec.hidden, 2 * self.act_dim)

    def _actor_forward(self, obs):
        mean, log_std = self.pi(obs).chunk(2, dim=-1)
        return mean, log_std.clamp(self.LOG_STD_MIN, self.LOG_STD_MAX)


class GaussianMLPModule(_ContinuousActorModule):
    """Tanh-squashed diagonal Gaussian policy and value head."""

    def __init__(self, obs_space, act_space, spec):
        super().__init__(obs_space, act_space, spec)
        self.vf = MLPNet(self.obs_dim, spec.hidden, 1)

    def forward_train(self, obs):
        mean, log_std = self._actor_forward(obs)
        return {"mean": mean, "log_std": log_std, "vf": self.vf(obs)[..., 0]}


class SACModule(_ContinuousActorModule):
    """Tanh-Gaussian actor and twin Q critics (the SACLearner keeps the
    critics' targets)."""

    def __init__(self, obs_space, act_space, spec):
        super().__init__(obs_space, act_space, spec)
        self.q1 = MLPNet(self.obs_dim + self.act_dim, spec.hidden, 1)
        self.q2 = MLPNet(self.obs_dim + self.act_dim, spec.hidden, 1)

    def forward_train(self, obs):
        mean, log_std = self._actor_forward(obs)
        return {"mean": mean, "log_std": log_std}

    def q_values(self, obs, actions):
        obs_act = torch.cat([obs, actions], dim=-1)
        return self.q1(obs_act)[..., 0], self.q2(obs_act)[..., 0]


# ------------------------------------------------------------ distributions

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def gaussian_logp(x, mean, log_std):
    std = torch.exp(log_std)
    return (-0.5 * torch.square((x - mean) / std) - log_std
            - _HALF_LOG_2PI).sum(-1)


def _tanh_correction(act):
    return torch.log(torch.clamp(1.0 - torch.square(act), min=1e-6)).sum(-1)


def squashed_gaussian_sample(mean, log_std, eps):
    """A tanh-squashed Gaussian action in [-1, 1] from the standard normal
    ``eps``; returns (action, logp) with the tanh change of variables."""
    pre = mean + torch.exp(log_std) * eps
    act = torch.tanh(pre)
    return act, gaussian_logp(pre, mean, log_std) - _tanh_correction(act)


def squashed_gaussian_logp(actions, mean, log_std):
    """logp of already-squashed actions in (-1, 1)."""
    pre = torch.atanh(torch.clamp(actions, -1.0 + 1e-6, 1.0 - 1e-6))
    return gaussian_logp(pre, mean, log_std) - _tanh_correction(actions)


def categorical_sample(logits, gumbel):
    return torch.argmax(logits + gumbel, dim=-1)


def categorical_logp(logits, actions):
    logp_all = torch.log_softmax(logits, dim=-1)
    return logp_all.gather(-1, actions[..., None].long())[..., 0]


def categorical_entropy(logits):
    logp = torch.log_softmax(logits, dim=-1)
    return -(torch.exp(logp) * logp).sum(-1)


def normal_noise(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard normals on the generator's device."""
    return torch.randn(shape, generator=generator,
                       device=generator.device)


def uniform_noise(shape, generator: torch.Generator, low: float = -1.0,
                  high: float = 1.0) -> torch.Tensor:
    """Uniforms in [low, high) on the generator's device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (high - low) + low


def gumbel_noise(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(u)) with u uniform in [tiny, 1)
    (as jax.random.gumbel takes it), on the generator's device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = u.clamp_(min=torch.finfo(u.dtype).tiny)
    return -torch.log(-torch.log(u))
