"""IMPALA's and APPO's learners: V-trace over padded [B, T] sequences
(``episodes_to_sequences``' format) with the masked standardisation of
the policy-gradient advantages; APPO takes the clipped surrogate in place
of IMPALA's policy gradient."""

from __future__ import annotations

import torch

from ..core.learner import Learner
from ..core.rl_module import apply, categorical_entropy, categorical_logp


def last_step_mask(mask: torch.Tensor) -> torch.Tensor:
    """One-hot [B, T] mask of each row's last real (unpadded) step."""
    last = mask.cumsum(1) == mask.sum(1, keepdim=True)
    return last.to(mask.dtype) * mask


@torch.no_grad()
def vtrace_returns(values, bootstrap, rewards, discounts, rhos, mask,
                   clip_rho: float = 1.0, clip_c: float = 1.0,
                   is_last=None):
    """V-trace targets vs_t and policy-gradient advantages ([B, T] each,
    outside the graph).

    discounts[b, t] is the continuation discount into t + 1 (0 at terminal
    steps and in padding); bootstrap[b] closes the last real step.
    ``is_last`` (``last_step_mask``) may be passed when the caller has
    it: the two must agree on where each row ends."""
    B, T = values.shape
    if is_last is None:
        is_last = last_step_mask(mask)
    zero = values.new_zeros(B, 1)
    next_values = torch.cat([values[:, 1:], zero], 1)
    next_values = next_values * (1 - is_last) + bootstrap[:, None] * is_last
    rho_clipped = torch.clamp(rhos, max=clip_rho)
    c_clipped = torch.clamp(rhos, max=clip_c)
    deltas = rho_clipped * (rewards + discounts * next_values
                            - values) * mask
    acc = values.new_zeros(B)
    accs = [None] * T
    for t in range(T - 1, -1, -1):  # the reverse scan
        acc = deltas[:, t] + discounts[:, t] * c_clipped[:, t] * acc
        accs[t] = acc
    vs = values + torch.stack(accs, 1)
    next_vs = torch.cat([vs[:, 1:], zero], 1)
    next_vs = next_vs * (1 - is_last) + bootstrap[:, None] * is_last
    pg_adv = rho_clipped * (rewards + discounts * next_vs - values)
    return vs, pg_adv


class IMPALALearner(Learner):
    use_clipped_surrogate = False  # APPO sets it

    def loss(self, params, batch):
        cfg = self.config
        gamma = cfg.get("gamma", 0.99)
        B, T = batch["rewards"].shape
        fwd = apply(self.module, params, batch["obs"].reshape(B * T, -1))
        logits = fwd["logits"].reshape(B, T, -1)
        values = fwd["vf"].reshape(B, T)
        target_logp = categorical_logp(logits, batch["actions"])
        rhos = torch.exp(target_logp - batch["behavior_logp"])
        mask = batch["mask"]
        # the continuation discount into t + 1: zero at the true terminal
        is_last = last_step_mask(mask)
        discounts = gamma * mask * (
            1 - is_last * batch["terminated"][:, None])
        bootstrap = apply(self.module, params,
                          batch["bootstrap_obs"])["vf"].detach()
        bootstrap = bootstrap * (1 - batch["terminated"])
        vs, pg_adv = vtrace_returns(
            values.detach(), bootstrap, batch["rewards"], discounts,
            rhos.detach(), mask, clip_rho=cfg.get("vtrace_clip_rho", 1.0),
            clip_c=cfg.get("vtrace_clip_c", 1.0), is_last=is_last)
        denom = torch.clamp(mask.sum(), min=1.0)
        # standardised (masked) advantages keep the policy term O(1)
        adv_mean = (pg_adv * mask).sum() / denom
        adv_var = (torch.square(pg_adv - adv_mean) * mask).sum() / denom
        pg_adv = (pg_adv - adv_mean) / torch.clamp(torch.sqrt(adv_var),
                                                   min=1e-4)
        if self.use_clipped_surrogate:  # APPO
            clip = cfg.get("clip_param", 0.2)
            surrogate = torch.minimum(
                rhos * pg_adv, torch.clamp(rhos, 1 - clip, 1 + clip) * pg_adv)
            pi_loss = -(surrogate * mask).sum() / denom
        else:  # IMPALA: the V-trace policy gradient
            pi_loss = -(target_logp * pg_adv * mask).sum() / denom
        vf_loss = 0.5 * (torch.square(vs - values) * mask).sum() / denom
        entropy = (categorical_entropy(logits) * mask).sum() / denom
        total = (pi_loss + cfg.get("vf_loss_coeff", 0.5) * vf_loss
                 - cfg.get("entropy_coeff", 0.005) * entropy)
        return total, {
            "policy_loss": pi_loss, "vf_loss": vf_loss, "entropy": entropy,
            "mean_rho": (rhos * mask).sum() / denom,
        }


class APPOLearner(IMPALALearner):
    use_clipped_surrogate = True
