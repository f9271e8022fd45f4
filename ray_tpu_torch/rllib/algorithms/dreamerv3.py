"""DreamerV3: an RSSM world model with an actor and a critic learned in
imagination; the counterpart of the JAX package's ``dreamerv3.py`` (its
primitives, ``DreamerV3Module`` and ``DreamerV3Learner``).

One update is the world model's loss over the observation scan, then the
actor's and the critic's over the imagination scan, in one backward: the
world model is frozen (detached) in imagination, where only the actor's
parameters stay live; the start states, the lambda-return targets and the
slow critic are detached, as the JAX learner cuts them with
``stop_gradient``. The two scans are Python loops. Work that does not feed
the next step (the encoder over every observation, the priors, the reward
and continue heads of imagined states) runs once over all steps, and
heads a loss never reads are not computed.

Noise arrives in the batch (``batch["noise"]``): Gumbel draws for the
observation scan's latents (``"obs"`` [T, B, stoch, classes]) and for the
imagination's actions (``"act"`` [H, N, act_dim]) and latents (``"z"``
[H, N, stoch, classes]), N = B * T. ``prepare_batch`` draws them from the
learner's generator (seeded ``seed + 13``) unless the batch has them.
Given JAX's own draws (``jax.random.gumbel`` under the keys its scans
split), the port samples JAX's latents and actions.

The nets take flat observations ``[..., obs_dim]`` at every boundary; an
image (H, W, C) is flat in HWC order. Its encoder is a stride-2 CNN
(depths double per level while both sides are even and above 4; one
stride-1 level otherwise) and its decoder a stack of transposed
convolutions, computed NCHW with Flax's "SAME" padding, which is uneven
for a kernel of 4 at stride 1.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..core.learner import Learner, copy_params, polyak_
from ..core.rl_module import (RLModule, RLModuleSpec, apply,
                              categorical_sample, gumbel_noise, init_dense_,
                              lecun_normal_)

# ------------------------------------------------------------ primitives


def symlog(x):
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x):
    return torch.sign(x) * torch.expm1(torch.abs(x))


def twohot(x, bins):
    """Two-hot encoding of scalar targets over ``bins`` [K]."""
    x = torch.clamp(x, bins[0], bins[-1])
    idx_hi = torch.clamp(torch.searchsorted(bins, x.contiguous()), 1,
                         len(bins) - 1)
    idx_lo = idx_hi - 1
    lo, hi = bins[idx_lo], bins[idx_hi]
    w_hi = torch.where(hi > lo, (x - lo) / torch.clamp(hi - lo, min=1e-8),
                       torch.ones_like(x))
    k = len(bins)
    return (F.one_hot(idx_lo, k) * (1 - w_hi)[..., None]
            + F.one_hot(idx_hi, k) * w_hi[..., None])


def twohot_mean(logits, bins):
    return (torch.softmax(logits, -1) * bins).sum(-1)


def st_sample(logits, gumbel):
    """Straight-through sample of discrete latents from Gumbel noise: the
    one-hot forward, the softmax's gradients."""
    probs = torch.softmax(logits, -1)
    hot = F.one_hot(categorical_sample(logits, gumbel), logits.shape[-1])
    return hot + probs - probs.detach()


def kl_categorical(p_logits, q_logits):
    """KL(p || q) of [..., stoch, classes] categoricals, summed over the
    latent dims."""
    p = torch.log_softmax(p_logits, -1)
    q = torch.log_softmax(q_logits, -1)
    return (torch.exp(p) * (p - q)).sum(-1).sum(-1)


# ----------------------------------------------------------------- nets


def _mlp(in_dim: int, hidden: int, out: int) -> nn.Sequential:
    """Flax's ``nn.Sequential([Dense(hidden), silu, Dense(out)])``: its
    children 0 and 2 are Flax's ``layers_0`` and ``layers_2``."""
    return nn.Sequential(nn.Linear(in_dim, hidden), nn.SiLU(),
                         nn.Linear(hidden, out))


def _same_pads(size: int, k: int, stride: int):
    """Flax's "SAME" padding (before, after) of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """``nn.Conv`` with "SAME" padding, on NCHW."""

    def forward(self, x):
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        top, bottom = _same_pads(x.shape[-2], kh, sh)
        left, right = _same_pads(x.shape[-1], kw, sw)
        return F.conv2d(F.pad(x, (left, right, top, bottom)), self.weight,
                        self.bias, self.stride)


def _deconv(cin: int, cout: int) -> nn.ConvTranspose2d:
    """``nn.ConvTranspose(cout, (4, 4), (2, 2))`` with "SAME" padding: the
    dilated input padded by 2 on each side, which a transposed convolution
    with padding 1 computes (its weight is Flax's kernel flipped,
    ``core/convert.py``)."""
    return nn.ConvTranspose2d(cin, cout, 4, stride=2, padding=1)


class CNNEncoder(nn.Module):
    def __init__(self, img, bottom, depths, hidden: int):
        super().__init__()
        self.img, self.bottom = img, bottom
        cin = img[2]
        h = img[0]
        for i, d in enumerate(depths):
            stride = 2 if h > bottom[0] else 1
            self.add_module(f"conv{i}", SameConv2d(cin, d, 4, stride))
            cin, h = d, -(-h // stride)
        self.n_levels = len(depths)
        self.proj = nn.Linear(bottom[0] * bottom[1] * depths[-1], hidden)

    def forward(self, flat):
        lead = flat.shape[:-1]
        x = flat.reshape(-1, *self.img).permute(0, 3, 1, 2)  # NCHW
        for i in range(self.n_levels):
            x = F.silu(getattr(self, f"conv{i}")(x))
        x = x.permute(0, 2, 3, 1).reshape(*lead, -1)  # NHWC order
        return self.proj(x)


class CNNDecoder(nn.Module):
    def __init__(self, img, bottom, depths, feat: int):
        super().__init__()
        self.img, self.bottom = img, bottom
        self.proj = nn.Linear(feat, bottom[0] * bottom[1] * bottom[2])
        cin, h = bottom[2], bottom[0]
        self.n_deconv = len(depths) - 1
        for i, d in enumerate(reversed(depths[:-1])):
            self.add_module(f"deconv{i}", _deconv(cin, d))
            cin, h = d, 2 * h
        if h != img[0]:
            self.deconv_out = _deconv(cin, img[2])
        else:
            self.conv_out = SameConv2d(cin, img[2], 3, 1)

    def forward(self, feat):
        lead = feat.shape[:-1]
        x = self.proj(feat).reshape(-1, *self.bottom).permute(0, 3, 1, 2)
        for i in range(self.n_deconv):
            x = F.silu(getattr(self, f"deconv{i}")(x))
        out = (self.deconv_out if hasattr(self, "deconv_out")
               else self.conv_out)
        return out(x).permute(0, 2, 3, 1).reshape(*lead, -1)


class GRUCell(nn.Module):
    """Flax's ``GRUCell``: one bias a gate (the input kernels ``ir``,
    ``iz``, ``in`` carry it; of the recurrent ones only ``hn``), lecun
    normal input kernels and orthogonal recurrent ones."""

    def __init__(self, in_dim: int, features: int):
        super().__init__()
        for g in ("ir", "iz", "in"):
            self.add_module(g, nn.Linear(in_dim, features))
        self.hr = nn.Linear(features, features, bias=False)
        self.hz = nn.Linear(features, features, bias=False)
        self.hn = nn.Linear(features, features)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for g in ("ir", "iz", "in"):
            init_dense_(getattr(self, g), generator)
        for g in ("hr", "hz", "hn"):
            nn.init.orthogonal_(getattr(self, g).weight, generator=generator)
        self.hn.bias.zero_()

    def forward(self, h, x):
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(getattr(self, "in")(x) + r * self.hn(h))
        return (1.0 - z) * n + z * h


class DreamerV3Module(RLModule):
    """The world model, the actor and the critic. Acting is stateful: the
    env runner carries the RSSM's deterministic state and the previous
    (z, a) across steps (``initial_state``, ``reset_state_row``,
    ``forward_inference``)."""

    def __init__(self, obs_space, act_space, spec: RLModuleSpec):
        super().__init__(obs_space, act_space, spec)
        self.obs_shape = tuple(obs_space.shape)
        self.act_dim = int(act_space.n)
        cfg = dict(spec.config or {})
        hidden = cfg.get("hidden", 128)
        deter = self.deter = cfg.get("deter", 128)
        stoch = self.stoch = cfg.get("stoch", 8)
        classes = self.classes = cfg.get("classes", 8)
        bins = cfg.get("bins", 41)
        depth = cfg.get("cnn_depth", 16)
        # the value and reward bins, in symlog space
        self.register_buffer("bins", torch.linspace(-10.0, 10.0, bins),
                             persistent=False)
        latent = stoch * classes
        feat = deter + latent

        if len(self.obs_shape) == 3:
            h0, w0, c0 = self.obs_shape
            depths = []
            h, w, d = h0, w0, depth
            while min(h, w) > 4 and h % 2 == 0 and w % 2 == 0:
                depths.append(d)
                h, w, d = h // 2, w // 2, d * 2
            if not depths:  # a tiny image: one stride-1 level
                depths = [depth]
                h, w = h0, w0
            img, bottom = (h0, w0, c0), (h, w, depths[-1])
            self.enc = CNNEncoder(img, bottom, depths, hidden)
        else:
            self.enc = _mlp(self.obs_dim, hidden, hidden)
        self.gru = GRUCell(latent + self.act_dim, deter)
        self.prior = _mlp(deter, hidden, latent)
        self.post = _mlp(deter + hidden, hidden, latent)
        self.dec = (CNNDecoder(img, bottom, depths, feat)
                    if len(self.obs_shape) == 3
                    else _mlp(feat, hidden, self.obs_dim))
        self.rew = _mlp(feat, hidden, bins)
        self.cont = _mlp(feat, hidden, 1)
        self.actor = _mlp(feat, hidden, self.act_dim)
        self.critic = _mlp(feat, hidden, bins)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Flax's initialisers: lecun normal kernels (a convolution's fan-in
        is kh * kw * in), zero biases, orthogonal recurrent kernels."""
        for net in self.children():
            if isinstance(net, GRUCell):
                net.init(generator)
                continue
            for mod in net.modules():
                if isinstance(mod, nn.Linear):
                    init_dense_(mod, generator)
                elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                    kh, kw = mod.kernel_size
                    lecun_normal_(mod.weight, mod.in_channels * kh * kw,
                                  generator)
                    mod.bias.zero_()
        return {name: p.detach() for name, p in self.named_parameters()}

    # ------------------------------------------------------ the RSSM

    def step_h(self, h, z_prev, a_prev):
        """One transition: advance h with (z_prev, a_prev)."""
        x = torch.cat([z_prev.flatten(-2),
                       F.one_hot(a_prev.long(), self.act_dim).to(h.dtype)],
                      -1)
        return self.gru(h, x)

    def _latent(self, net, x):
        return net(x).reshape(*x.shape[:-1], self.stoch, self.classes)

    def prior_logits(self, h):
        return self._latent(self.prior, h)

    def post_logits(self, h, embed):
        return self._latent(self.post, torch.cat([h, embed], -1))

    def embed(self, obs):
        return self.enc(symlog(obs))

    def feat(self, h, z):
        return torch.cat([h, z.flatten(-2)], -1)

    def wm_heads(self, h, z):
        """The world model's heads: reconstruction, reward and continue
        logits."""
        feat = self.feat(h, z)
        return {"recon": self.dec(feat), "reward": self.rew(feat),
                "cont": self.cont(feat)[..., 0]}

    def actor_logits(self, h, z):
        return self.actor(self.feat(h, z))

    def critic_logits(self, h, z):
        return self.critic(self.feat(h, z))

    def observe(self, obs_bt, a_prev, is_first, gumbel):
        """The observation scan over [B, T] sequences: returns the states,
        latents, priors and posteriors, [T, B, ...] each."""
        B, T = obs_bt.shape[:2]
        embeds = self.embed(obs_bt)  # [B, T, hidden]: every step at once
        h = obs_bt.new_zeros(B, self.deter)
        z = obs_bt.new_zeros(B, self.stoch, self.classes)
        hs, zs, posts = [], [], []
        for t in range(T):
            keep = 1.0 - is_first[:, t]
            h = h * keep[:, None]
            z = z * keep[:, None, None]
            h = self.step_h(h, z, a_prev[:, t] * keep.long())
            post = self.post_logits(h, embeds[:, t])
            z = st_sample(post, gumbel[t])
            hs.append(h)
            zs.append(z)
            posts.append(post)
        hs = torch.stack(hs)
        return hs, torch.stack(zs), self.prior_logits(hs), torch.stack(posts)

    def imagine(self, h, z, gumbel_a, gumbel_z):
        """The imagination scan from start states [N, ...]: returns the
        imagined states, latents, rewards and continues [H, N, ...], and
        the actions' log-probs and the policy's entropies [H, N]."""
        hs, zs, logps, ents = [], [], [], []
        for t in range(gumbel_a.shape[0]):
            logits = self.actor_logits(h, z)
            act = categorical_sample(logits, gumbel_a[t])
            log_probs = torch.log_softmax(logits, -1)
            logps.append(log_probs.gather(-1, act[:, None])[:, 0])
            ents.append(-(torch.softmax(logits, -1) * log_probs).sum(-1))
            h = self.step_h(h, z, act)
            z = st_sample(self.prior_logits(h), gumbel_z[t])
            hs.append(h)
            zs.append(z)
        hs, zs = torch.stack(hs), torch.stack(zs)
        feat = self.feat(hs, zs)
        reward = symexp(twohot_mean(self.rew(feat), self.bins))
        cont = torch.sigmoid(self.cont(feat)[..., 0])
        return hs, zs, reward, cont, torch.stack(logps), torch.stack(ents)

    # ------------------------------------------------- stateful acting

    def initial_state(self, n_envs: int) -> Dict[str, torch.Tensor]:
        dev = self.bins.device
        return {"h": torch.zeros(n_envs, self.deter, device=dev),
                "z": torch.zeros(n_envs, self.stoch, self.classes,
                                 device=dev),
                "a": torch.zeros(n_envs, dtype=torch.int64, device=dev)}

    def reset_state_row(self, state, i: int):
        out = {k: v.clone() for k, v in state.items()}
        for v in out.values():
            v[i] = 0
        return out

    def forward_inference(self, obs, state, noise):
        """One acting step: advance h with the previous (z, a), infer the
        posterior from the new observation, sample an action. ``noise``
        holds Gumbel draws for the latent (``"z"`` [N, stoch, classes])
        and the action (``"a"`` [N, act_dim])."""
        obs = obs.reshape(obs.shape[0], -1)  # image obs arrive unflattened
        h = self.step_h(state["h"], state["z"], state["a"])
        post = self.post_logits(h, self.embed(obs))
        z = st_sample(post, noise["z"])
        logits = self.actor_logits(h, z)
        action = categorical_sample(logits, noise["a"])
        return {"logits": logits, "state": {"h": h, "z": z, "a": action}}

    def forward_train(self, obs):
        raise NotImplementedError("DreamerV3 trains on sequences")


# ---------------------------------------------------------------- learner


class DreamerV3Learner(Learner):
    """The world model, the actor and the critic in one update."""

    def __init__(self, module, config: Dict[str, Any], seed: int = 0,
                 device: str = "cuda"):
        super().__init__(module, config, seed=seed, device=device)
        # on the CPU, so a CPU and a CUDA learner draw the same noise
        self._noise = torch.Generator().manual_seed(seed + 13)
        # the critic's EMA regulariser pulls toward a slow copy
        self.slow_critic = copy_params(self.params, ("critic.",))
        self._ret_scale = 1.0

    def loss(self, params, batch):
        cfg = self.config
        module = self.module
        bins = module.bins
        B, T = batch["obs"].shape[:2]
        obs_bt = batch["obs"].reshape(B, T, -1)  # flat at module edges
        gamma = cfg.get("gamma", 0.99)
        lam = cfg.get("lambda_", 0.95)
        entropy_coef = cfg.get("entropy_coef", 3e-3)
        noise = batch["noise"]
        H = noise["act"].shape[0]

        # ---------------- the observation scan (world-model learning)
        actions = batch["actions"]
        a_prev = torch.cat([torch.zeros_like(actions[:, :1]),
                            actions[:, :-1]], 1)
        hs, zs, priors, posts = apply(module, params, obs_bt, a_prev,
                                      batch["is_first"], noise["obs"],
                                      method="observe")
        heads = apply(module, params, hs, zs, method="wm_heads")
        obs_t = obs_bt.transpose(0, 1)
        recon_loss = torch.square(heads["recon"] - symlog(obs_t)).sum(-1)
        rew_target = twohot(symlog(batch["rewards"].T), bins)
        rew_loss = -(rew_target * torch.log_softmax(heads["reward"], -1)
                     ).sum(-1)
        cont_target = 1.0 - batch["dones"].T
        cont_loss = -(cont_target * F.logsigmoid(heads["cont"])
                      + (1 - cont_target) * F.logsigmoid(-heads["cont"]))
        free = cfg.get("free_bits", 1.0)
        dyn_kl = torch.clamp(kl_categorical(posts.detach(), priors),
                             min=free)
        rep_kl = torch.clamp(kl_categorical(posts, priors.detach()),
                             min=free)
        wm_loss = (recon_loss + rew_loss + cont_loss
                   + 1.0 * dyn_kl + 0.1 * rep_kl).mean()

        # ---------------- imagination (actor-critic learning)
        # the world model frozen: the actor learns through its actions'
        # log-probs (reinforce), the critic through its head only
        frozen = {k: (v if k.startswith("actor.") else v.detach())
                  for k, v in params.items()}
        h_flat = hs.detach().reshape(B * T, -1)
        z_flat = zs.detach().reshape(B * T, module.stoch, module.classes)
        im_h, im_z, im_r, im_c, im_logp, im_ent = apply(
            module, frozen, h_flat, z_flat, noise["act"], noise["z"],
            method="imagine")

        # s_0 is the (detached) start state; step i takes a_i at s_i and
        # gives (s_{i+1}, r_{i+1}, c_{i+1}). The values cover s_0..s_H and
        # the lambda-return R_i belongs to s_i:
        #   R_H = v(s_H);  R_i = r_{i+1} + g c_{i+1} ((1 - lam) v(s_{i+1})
        #                                            + lam R_{i+1})
        all_h = torch.cat([h_flat[None], im_h], 0)  # [H + 1, N]
        all_z = torch.cat([z_flat[None], im_z], 0)
        v_logits = apply(module, params, all_h, all_z,
                         method="critic_logits")
        values = symexp(twohot_mean(v_logits, bins))
        disc = gamma * im_c
        rets = [None] * H
        nxt = values[H]
        for t in range(H - 1, -1, -1):
            nxt = im_r[t] + disc[t] * ((1 - lam) * values[t + 1] + lam * nxt)
            rets[t] = nxt
        lam_rets = torch.stack(rets)  # [H, N]: the returns of s_0..s_{H-1}

        # critic: twohot cross-entropy toward the detached returns, plus
        # the slow critic's regulariser
        log_v = torch.log_softmax(v_logits[:H], -1)
        ce = -(twohot(symlog(lam_rets).detach(), bins) * log_v).sum(-1)
        with torch.no_grad():
            slow_logits = apply(module, batch["slow_critic"], all_h[:H],
                                all_z[:H], method="critic_logits")
        reg = -(torch.softmax(slow_logits, -1) * log_v).sum(-1)
        critic_loss = (ce + 0.3 * reg).mean()

        # actor: reinforce on advantages scaled by the host's percentile
        # EMA, plus the entropy bonus
        adv = ((lam_rets - values[:H])
               / torch.clamp(batch["ret_scale"], min=1.0)).detach()
        actor_loss = (-adv * im_logp - entropy_coef * im_ent).mean()

        # the return spread, for the host's percentile EMA
        flat = lam_rets.detach().reshape(-1)
        spread = torch.quantile(flat, 0.95) - torch.quantile(flat, 0.05)

        total = wm_loss + critic_loss + actor_loss
        return total, {
            "wm_loss": wm_loss, "critic_loss": critic_loss,
            "actor_loss": actor_loss, "kl": dyn_kl.mean(),
            "recon": recon_loss.mean(), "entropy": im_ent.mean(),
            "ret_spread": spread, "value_mean": values.mean(),
        }

    # ------------------------------------------------------------ hooks

    def draw_noise(self, batch, horizon: int) -> Dict[str, torch.Tensor]:
        """The loss's Gumbel draws, from the learner's generator."""
        m = self.module
        B, T = batch["obs"].shape[:2]
        latent = (m.stoch, m.classes)
        g = self._noise
        return {"obs": gumbel_noise((T, B, *latent), g),
                "act": gumbel_noise((horizon, B * T, m.act_dim), g),
                "z": gumbel_noise((horizon, B * T, *latent), g)}

    def prepare_batch(self, batch):
        noise = batch.get("noise")
        if noise is None:
            noise = {k: v.to(self.device) for k, v in self.draw_noise(
                batch, self.config.get("imagine_horizon", 8)).items()}
        return {**batch, "noise": noise, "slow_critic": self.slow_critic,
                "ret_scale": torch.tensor(self._ret_scale,
                                          dtype=torch.float32,
                                          device=self.device)}

    def _note_spread(self, metrics):
        # the percentile return normalisation's EMA
        self._ret_scale = 0.99 * self._ret_scale + 0.01 * max(
            metrics.get("ret_spread", 1.0), 1.0)

    def update(self, batch):
        metrics = super().update(batch)
        self._note_spread(metrics)
        return metrics

    def compute_gradients(self, batch):
        # the data-parallel path calls no update(): the EMA advances here
        grads, metrics = super().compute_gradients(batch)
        self._note_spread(metrics)
        return grads, metrics

    def after_update(self):
        polyak_(self.slow_critic, self.params, 0.02)

    def set_weights(self, weights):
        super().set_weights(weights)
        self.slow_critic = copy_params(self.params, ("critic.",))

