"""DQN's learner: the double-Q TD loss (importance-weighted when the batch
has ``"weights"``, as prioritized replay gives it) against a target
network synced every ``target_update_freq`` updates; and the TD errors
that refresh prioritized replay's priorities."""

from __future__ import annotations

import torch

from ..core.learner import Learner, copy_params
from ..core.rl_module import apply


def _taken(q_all, actions):
    return q_all.gather(-1, actions[..., None].long())[..., 0]


class DQNLearner(Learner):
    def __init__(self, module, config, seed: int = 0, device: str = "cuda"):
        super().__init__(module, config, seed=seed, device=device)
        self.target_params = copy_params(self.params)
        self._updates = 0

    def loss(self, params, batch):
        gamma = self.config.get("gamma", 0.99)
        q = _taken(apply(self.module, params, batch["obs"])["q"],
                   batch["actions"])
        q_next_online = apply(self.module, params, batch["next_obs"])["q"]
        q_next_target = apply(self.module, batch["target"],
                              batch["next_obs"])["q"]
        # double-Q: the online net picks the action, the target net
        # evaluates it
        q_next = _taken(q_next_target, q_next_online.argmax(-1))
        target = batch["rewards"] + gamma * (1 - batch["dones"]) \
            * q_next.detach()
        td = q - target
        if "weights" in batch:  # prioritized replay: IS-corrected TD loss
            loss = (batch["weights"] * torch.square(td)).mean()
        else:
            loss = torch.square(td).mean()
        return loss, {"td_error_mean": td.abs().mean(), "q_mean": q.mean()}

    def prepare_batch(self, batch):
        return {**batch, "target": self.target_params}

    def after_update(self):
        self._updates += 1
        if self._updates % self.config.get("target_update_freq", 50) == 0:
            self.target_params = copy_params(self.params)

    def set_weights(self, weights):
        super().set_weights(weights)
        # a restored online net is the source of truth: the target follows
        self.target_params = copy_params(self.params)


@torch.no_grad()
def td_errors(module, params, batch, gamma: float = 0.99) -> torch.Tensor:
    """Prioritized replay's TD errors: the online net in both roles (a
    sampling heuristic, no double-Q target). ``batch`` holds tensors."""
    q = _taken(apply(module, params, batch["obs"])["q"], batch["actions"])
    q_next = apply(module, params, batch["next_obs"])["q"].max(-1).values
    return q - (batch["rewards"] + gamma * (1 - batch["dones"]) * q_next)
