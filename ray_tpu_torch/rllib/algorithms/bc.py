"""MARWIL's learner, and BC as MARWIL with ``beta == 0``: the
exponentiated-advantage imitation weight and the value regression of the
JAX package's ``MARWILLearner``."""

from __future__ import annotations

import torch

from ..core.learner import Learner
from ..core.rl_module import apply, categorical_logp


class MARWILLearner(Learner):
    def loss(self, params, batch):
        cfg = self.config
        beta = cfg.get("beta", 1.0)
        fwd = apply(self.module, params, batch["obs"])
        logp = categorical_logp(fwd["logits"], batch["actions"])
        if beta == 0.0:  # pure BC: no critic, no weighting
            bc_loss = -logp.mean()
            return bc_loss, {"bc_loss": bc_loss, "logp_mean": logp.mean()}
        adv = batch["returns"] - fwd["vf"]
        # the advantage is cut from the weight's graph (the critic learns
        # from its own squared error only); adv_scale is a dataset-level
        # constant of the learner's config
        adv_scale = cfg.get("adv_scale", 1.0)
        weight = torch.exp(torch.clamp(
            beta * adv.detach() / max(adv_scale, 1e-8), -10.0, 10.0))
        pi_loss = -(weight * logp).mean()
        vf_loss = torch.square(adv).mean()
        total = pi_loss + cfg.get("vf_coeff", 1.0) * vf_loss
        return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                       "mean_weight": weight.mean(),
                       "logp_mean": logp.mean()}

