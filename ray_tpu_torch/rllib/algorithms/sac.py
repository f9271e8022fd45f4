"""SAC's learner: the critic TD loss against polyak-averaged target
critics, the actor loss and the temperature loss in one backward, each
cut from the others' parameters as the JAX package's ``SACLearner`` cuts
them with ``stop_gradient``. ``log_alpha`` is a trainable scalar of the
parameter dict.

The loss's noise arrives in the batch: ``batch["noise"]`` holds the
standard normals of the next-state action (``"next"``) and of the
current-state action (``"cur"``), [B, act_dim] each. ``prepare_batch``
draws them from the learner's generator (seeded ``seed + 7``) unless the
batch already has them."""

from __future__ import annotations

import math

import torch

from ..core.learner import Learner, copy_params, polyak_
from ..core.rl_module import apply, normal_noise, squashed_gaussian_sample

_CRITICS = ("q1.", "q2.")


class SACLearner(Learner):
    def __init__(self, module, config, seed: int = 0, device: str = "cuda"):
        super().__init__(module, config, seed=seed, device=device)
        # the learned temperature joins the trainable dict; the targets
        # stay out of it (put into each batch, as DQN's target)
        self.params["log_alpha"] = torch.tensor(
            math.log(config.get("initial_alpha", 1.0)), dtype=torch.float32,
            device=self.device)
        self.opt_state = self.tx.init(list(self.params.values()))
        self.target_params = copy_params(self.params, _CRITICS)
        self._tau = config.get("tau", 0.005)
        self.target_entropy = config.get("target_entropy",
                                         -float(module.act_dim))
        # on the CPU, so a CPU and a CUDA learner draw the same noise
        self._noise = torch.Generator().manual_seed(seed + 7)

    def loss(self, params, batch):
        gamma = self.config.get("gamma", 0.99)
        module = self.module
        noise = batch["noise"]
        alpha = torch.exp(params["log_alpha"])

        # critic: the TD target from the target critics and a fresh
        # next-state action
        fwd_next = apply(module, params, batch["next_obs"])
        a_next, logp_next = squashed_gaussian_sample(
            fwd_next["mean"], fwd_next["log_std"], noise["next"])
        tq1, tq2 = apply(module, batch["target"], batch["next_obs"], a_next,
                         method="q_values")
        q_target = torch.minimum(tq1, tq2) - alpha * logp_next
        td_target = batch["rewards"] + gamma * (1 - batch["dones"]) \
            * q_target.detach()
        q1, q2 = apply(module, params, batch["obs"], batch["actions"],
                       method="q_values")
        critic_loss = (torch.square(q1 - td_target).mean()
                       + torch.square(q2 - td_target).mean())

        # actor: min-Q of the reparameterised action less the entropy
        # cost, through frozen critics
        fwd = apply(module, params, batch["obs"])
        a_new, logp_new = squashed_gaussian_sample(
            fwd["mean"], fwd["log_std"], noise["cur"])
        frozen = {k: v.detach() for k, v in params.items()
                  if k.startswith(_CRITICS)}
        aq1, aq2 = apply(module, frozen, batch["obs"], a_new,
                         method="q_values")
        actor_loss = (alpha.detach() * logp_new
                      - torch.minimum(aq1, aq2)).mean()

        # temperature: drive the policy's entropy toward the target
        alpha_loss = (-params["log_alpha"] * (
            logp_new + self.target_entropy).detach()).mean()

        total = critic_loss + actor_loss + alpha_loss
        return total, {
            "critic_loss": critic_loss, "actor_loss": actor_loss,
            "alpha_loss": alpha_loss, "alpha": alpha,
            "entropy": -logp_new.mean(), "q_mean": q1.mean(),
        }

    def draw_noise(self, batch):
        """The loss's standard normals, from the learner's generator."""
        shape = (batch["obs"].shape[0], self.module.act_dim)
        return {"next": normal_noise(shape, self._noise),
                "cur": normal_noise(shape, self._noise)}

    def prepare_batch(self, batch):
        noise = batch.get("noise")
        if noise is None:
            noise = {k: v.to(self.device)
                     for k, v in self.draw_noise(batch).items()}
        return {**batch, "noise": noise, "target": self.target_params}

    def after_update(self):
        polyak_(self.target_params, self.params, self._tau)

    def set_weights(self, weights):
        super().set_weights(weights)
        self.target_params = copy_params(self.params, _CRITICS)
