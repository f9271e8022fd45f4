"""CQL's learner: SAC's loss plus the conservative penalty

    cql_alpha * E_s[ logsumexp_a Q(s, a_candidates) - Q(s, a_data) ]

over ``cql_n_actions`` uniform candidates in the canonical [-1, 1] cube
and as many fresh policy samples a state, importance-weighted (the
uniform density 2^-d, the policy's exp(logp)), as the JAX package's
``CQLLearner`` computes it.

Its noise arrives in the batch too: SAC's, plus ``"unif"`` [B, N,
act_dim] (uniform in [-1, 1)) and ``"pol"`` [B * N, act_dim] (standard
normals of the policy candidates, state-major)."""

from __future__ import annotations

import math

import torch

from ..core.rl_module import (apply, normal_noise, squashed_gaussian_sample,
                              uniform_noise)
from .sac import SACLearner


class CQLLearner(SACLearner):
    def loss(self, params, batch):
        total, metrics = super().loss(params, batch)
        cfg = self.config
        n = cfg.get("cql_n_actions", 4)
        alpha_prime = cfg.get("cql_alpha", 1.0)
        module = self.module
        obs = batch["obs"]
        b = obs.shape[0]
        act_dim = module.act_dim
        noise = batch["noise"]

        # candidates: the uniform ones, then the policy's, in one Q forward
        # over 2 * b * n states
        fwd = apply(module, params, obs)
        mean = fwd["mean"][:, None, :].expand(b, n, act_dim)
        log_std = fwd["log_std"][:, None, :].expand(b, n, act_dim)
        pol, pol_logp = squashed_gaussian_sample(
            mean.reshape(-1, act_dim), log_std.reshape(-1, act_dim),
            noise["pol"])
        candidates = torch.cat([noise["unif"].reshape(-1, act_dim), pol], 0)
        obs_rep = torch.cat([obs.repeat_interleave(n, 0)] * 2, 0)
        cq1, cq2 = apply(module, params, obs_rep, candidates,
                         method="q_values")

        # importance weights: the uniform density 2^-d, the policy's
        # exp(logp)
        logw = torch.cat([
            torch.full((b * n,), act_dim * math.log(2.0),
                       device=obs.device),
            -pol_logp.detach()], 0)

        def penalty(q_all):
            # state-major within each half (index = half * b * n + s * n +
            # c): as (2, b, n), each state's logsumexp takes its own
            # candidates of both halves
            q = (q_all + logw).reshape(2, b, n)
            return torch.logsumexp(q, dim=(0, 2)) - math.log(2.0 * n)

        q1_data, q2_data = apply(module, params, obs, batch["actions"],
                                 method="q_values")
        cql_term = (penalty(cq1).mean() - q1_data.mean()
                    + penalty(cq2).mean() - q2_data.mean())
        return total + alpha_prime * cql_term, dict(metrics,
                                                    cql_penalty=cql_term)

    def draw_noise(self, batch):
        noise = super().draw_noise(batch)
        b = batch["obs"].shape[0]
        n = self.config.get("cql_n_actions", 4)
        d = self.module.act_dim
        noise["unif"] = uniform_noise((b, n, d), self._noise)
        noise["pol"] = normal_noise((b * n, d), self._noise)
        return noise
