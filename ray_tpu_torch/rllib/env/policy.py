"""The acting step: the compute the JAX package's env runners run each env
step (``SingleAgentEnvRunner.sample`` and its ``_value_of``, and
``MultiAgentEnvRunner``'s forward a policy). The env loop itself, and the
rescaling of canonical actions to a box's bounds, stay with the runner.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..core.rl_module import (apply, categorical_sample, gumbel_noise,
                              normal_noise, squashed_gaussian_sample)


@torch.no_grad()
def act(module, params: Mapping[str, torch.Tensor], obs, *,
        explore: bool = True, epsilon: float = 0.0,
        generator: Optional[torch.Generator] = None,
        np_rng: Optional[np.random.Generator] = None,
        state: Optional[Dict[str, torch.Tensor]] = None,
        noise: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
    """One step for N envs: ``obs`` [N, ...] (numpy) through ``module`` on
    ``params``; returns numpy ``actions``, ``logp`` and ``vf`` [N], and
    for a stateful module (DreamerV3) the new ``state``.

    - discrete policy: a categorical sample (``noise["gumbel"]`` [N,
      n_actions], else drawn from ``generator``), or the argmax when not
      exploring;
    - box policy: a squashed Gaussian sample in [-1, 1] (``noise["eps"]``
      [N, act_dim], else drawn), or ``tanh(mean)`` with logp 0 when not
      exploring;
    - Q module: epsilon-greedy from ``np_rng``, one uniform an env, then
      one random action an env, in the JAX runner's order;
    - stateful module: ``forward_inference`` from ``state`` (``noise``
      holds ``"z"`` and ``"a"``, else drawn), sampling whether exploring or
      not, as the JAX runner does; vf is 0.
    Noise drawn here comes from the CPU ``generator`` and moves to the
    params' device."""
    device = next(iter(params.values())).device
    obs_t = torch.as_tensor(np.asarray(obs, np.float32), device=device)
    n = obs_t.shape[0]
    out: Dict[str, Any] = {}

    def drawn(key, shape, draw):
        t = noise[key] if noise is not None else draw(shape, generator)
        return torch.as_tensor(t, dtype=torch.float32).to(device)

    if state is not None:  # DreamerV3
        shape_z = (n, module.stoch, module.classes)
        fwd = apply(module, params, obs_t, state, {
            "z": drawn("z", shape_z, gumbel_noise),
            "a": drawn("a", (n, module.act_dim), gumbel_noise)},
            method="forward_inference")
        actions = fwd["state"]["a"]
        logp = torch.log_softmax(fwd["logits"], -1).gather(
            -1, actions[:, None])[:, 0]
        packed = torch.stack([actions.float(), logp,
                              torch.zeros_like(logp)], 1)
        out["state"] = fwd["state"]
    else:
        fwd = apply(module, params, obs_t)
        if "mean" in fwd:
            if explore:
                acts, logp = squashed_gaussian_sample(
                    fwd["mean"], fwd["log_std"],
                    drawn("eps", fwd["mean"].shape, normal_noise))
            else:
                acts = torch.tanh(fwd["mean"])
                logp = torch.zeros(n, device=device)
            vf = fwd.get("vf", torch.zeros(n, device=device))
            packed = torch.cat([acts, logp[:, None], vf[:, None]], 1)
        elif "logits" in fwd:
            logits = fwd["logits"]
            acts = (categorical_sample(logits, drawn(
                "gumbel", logits.shape, gumbel_noise)) if explore
                else logits.argmax(-1))
            logp = torch.log_softmax(logits, -1).gather(
                -1, acts[:, None])[:, 0]
            vf = fwd.get("vf", torch.zeros(n, device=device))
            packed = torch.stack([acts.float(), logp, vf], 1)
        else:  # Q-values: epsilon-greedy on the host
            q = fwd["q"].cpu().numpy()
            actions = q.argmax(-1)
            rand = np_rng.random(n) < epsilon
            actions = np.where(rand, np_rng.integers(0, q.shape[-1], n),
                               actions)
            zeros = np.zeros(n, np.float32)
            return {"actions": actions, "logp": zeros, "vf": zeros.copy()}
    host = packed.cpu().numpy()  # one copy of everything
    if "mean" in fwd:
        out["actions"] = np.ascontiguousarray(host[:, :-2])
    else:
        out["actions"] = host[:, 0].astype(np.int64)
    out["logp"] = np.ascontiguousarray(host[:, -2])
    out["vf"] = np.ascontiguousarray(host[:, -1])
    return out
