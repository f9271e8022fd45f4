"""PPO's learner: the clipped surrogate, the clipped value loss and the
entropy bonus of the JAX package's ``PPOLearner``. ``MultiAgentPPO``
keeps one ``PPOLearner`` a policy, so this covers it too."""

from __future__ import annotations

import math

import torch

from ..core.learner import Learner
from ..core.rl_module import (apply, categorical_entropy, categorical_logp,
                              squashed_gaussian_logp)

# the pre-tanh Gaussian's entropy per dimension, past log_std
_HALF_LOG_2PI_E = 0.5 * math.log(2.0 * math.pi * math.e)


class PPOLearner(Learner):
    def loss(self, params, batch):
        cfg = self.config
        fwd = apply(self.module, params, batch["obs"])
        if "logits" in fwd:
            logp = categorical_logp(fwd["logits"], batch["actions"])
            entropy = categorical_entropy(fwd["logits"])
        else:  # GaussianMLPModule (box actions, tanh-squashed)
            logp = squashed_gaussian_logp(batch["actions"], fwd["mean"],
                                          fwd["log_std"])
            # the pre-tanh Gaussian's entropy: a closed-form proxy for the
            # squashed distribution's, which has none
            entropy = (fwd["log_std"] + _HALF_LOG_2PI_E).sum(-1)
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["advantages"]
        clip = cfg.get("clip_param", 0.3)
        surrogate = torch.minimum(
            ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
        vf_loss = torch.square(fwd["vf"] - batch["value_targets"])
        vf_loss = torch.clamp(vf_loss, max=cfg.get("vf_clip_param", 10.0))
        total = (-surrogate.mean()
                 + cfg.get("vf_loss_coeff", 1.0) * vf_loss.mean()
                 - cfg.get("entropy_coeff", 0.0) * entropy.mean())
        return total, {
            "policy_loss": -surrogate.mean(),
            "vf_loss": vf_loss.mean(),
            "entropy": entropy.mean(),
            "mean_kl": (batch["logp"] - logp).mean(),
        }
