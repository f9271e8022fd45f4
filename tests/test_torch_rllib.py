"""Parity of ray_tpu_torch's RL learners' compute with the JAX package's
``rllib``: the modules, the distributions, V-trace, every algorithm's
learner and the acting step.

Both sides start from the same float32 parameters (the JAX init, carried
across by ``rl_params_from_flax``), take the same numpy batches and, where
a loss or a sampler draws noise, the same noise: the JAX learner's or env
runner's own draws under its keys (``jax.random.normal``, ``gumbel``,
``uniform``), handed to the port in the batch. Widths are small: hidden
(16, 16); DreamerV3 hidden 16, deter 16, stoch 4 x 4, 11 bins, B 2 x T 4,
horizon 3, on a vector and on an 8 x 8 x 3 image.

Tolerances (float32; the two frameworks sum in other orders): module
forwards 1e-5; one update's loss and metrics rtol 1e-5 (atol 1e-5 for
values near 0), grad norm rtol 1e-4, parameters 1e-5 absolute; the same
after an ``after_update`` and a second update. DreamerV3's metrics and
parameters are held to the same numbers.

The JAX side starts from the port's init (its modules' ``init`` returns
the port's parameters in the Flax layout; ``jax.eval_shape`` of the JAX
init checks the layout), and its programs are compiled with ``FAST``
options: the same programs, compiled in a fraction of the time, which
keeps the file within a minute on one core.
"""

import copy
import functools

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib.algorithms import bc as jbc
from ray_tpu.rllib.algorithms import cql as jcql
from ray_tpu.rllib.algorithms import dqn as jdqn
from ray_tpu.rllib.algorithms import dreamerv3 as jdv3
from ray_tpu.rllib.algorithms import impala as jimpala
from ray_tpu.rllib.algorithms import ppo as jppo
from ray_tpu.rllib.algorithms import sac as jsac
from ray_tpu.rllib.core import rl_module as jrm
from ray_tpu.rllib.env.env_runner import SingleAgentEnvRunner
from ray_tpu_torch.data import device_batches
from ray_tpu_torch.rllib.algorithms import bc, cql, dqn, dreamerv3, impala
from ray_tpu_torch.rllib.algorithms import ppo, sac
from ray_tpu_torch.rllib.core import rl_module as rm
from ray_tpu_torch.rllib.core.convert import (flax_from_rl_params,
                                              rl_params_from_flax)
from ray_tpu_torch.rllib.env.policy import act

ATOL_FWD = 1e-5
RTOL_LOSS = 1e-5
RTOL_GNORM = 1e-4
ATOL_PARAM = 1e-5

HIDDEN = (16, 16)
DV3 = dict(hidden=16, deter=16, stoch=4, classes=4, bins=11, cnn_depth=4)
B_DV3, T_DV3, H_DV3 = 2, 4, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs files in
    parallel workers, and tiny shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _box(*shape, low=-np.inf, high=np.inf):
    return gym.spaces.Box(low, high, shape, np.float32)


DISC = gym.spaces.Discrete(3)
ACT_BOX = _box(2, low=-1.0, high=1.0)


def _tree_close(a, b, atol):
    flat_a, tree_a = jax.tree_util.tree_flatten(a)
    flat_b, tree_b = jax.tree_util.tree_flatten(b)
    assert tree_a == tree_b
    for x, y in zip(flat_a, flat_b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=0,
                                   atol=atol)


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


# XLA's CPU compile options for the JAX side: the same programs, compiled
# several times faster (no LLVM optimisation, the classic fusion emitter)
FAST = {"xla_backend_optimization_level": 0,
        "xla_cpu_use_fusion_emitters": False}


def _fast_jit(fn, **kw):
    return jax.jit(fn, compiler_options=FAST, **kw)


def _port_init(module, tree):
    """A JAX module whose ``init`` returns ``tree`` (fresh arrays)."""
    module.init = lambda rng: jax.tree.map(jnp.asarray, tree)
    return module


class _PortInitSpec(jrm.RLModuleSpec):
    """Builds JAX modules that start from ``self.tree``."""

    def build(self, obs_space, act_space):
        return _port_init(super().build(obs_space, act_space), self.tree)


# ---------------------------------------------------------------- modules

MODULES = {
    "discrete": (jrm.DiscreteMLPModule, rm.DiscreteMLPModule, _box(5),
                 DISC, {}),
    "q": (jrm.QMLPModule, rm.QMLPModule, _box(5), DISC, {}),
    "q-dueling": (jrm.QMLPModule, rm.QMLPModule, _box(5), DISC,
                  dict(dueling=True)),
    "gaussian": (jrm.GaussianMLPModule, rm.GaussianMLPModule, _box(5),
                 ACT_BOX, {}),
    "sac": (jrm.SACModule, rm.SACModule, _box(5), ACT_BOX, {}),
    "dreamerv3-vector": (jdv3.DreamerV3Module, dreamerv3.DreamerV3Module,
                         _box(6), DISC, dict(config=DV3)),
    # the encoder halves twice (16 -> 8 -> 4): two strided convolutions,
    # a transposed one and deconv_out
    "dreamerv3-image-16": (jdv3.DreamerV3Module, dreamerv3.DreamerV3Module,
                           _box(16, 16, 3, low=0.0, high=1.0), DISC,
                           dict(config=DV3)),
    # the sides never halve (odd): one stride-1 level with Flax's uneven
    # "SAME" padding, and conv_out
    "dreamerv3-image-5": (jdv3.DreamerV3Module, dreamerv3.DreamerV3Module,
                          _box(5, 5, 3, low=0.0, high=1.0), DISC,
                          dict(config=DV3)),
}


def _dreamer_outs(jm, params, obs, h, z, a):
    """Every net of JAX's DreamerV3 bundle on one input each."""
    nets = jm.nets
    return {"embed": nets.apply(params, "embed", obs),
            "step_h": nets.apply(params, "step_h", h, z, a),
            "prior_logits": nets.apply(params, "prior_logits", h),
            "post_logits": nets.apply(params, "post_logits", h, h),
            **nets.apply(params, "heads", h, z)}


@pytest.mark.parametrize("case", list(MODULES))
def test_module_forward_matches_jax(case):
    """Each module's forward equals JAX's on the same parameters; the
    port's init has the JAX init's Flax structure and shapes, and the
    Flax layout round-trips exactly."""
    jcls, pcls, obs_space, act_space, kw = MODULES[case]
    jm = jrm.RLModuleSpec(module_class=jcls, hidden=HIDDEN, **kw).build(
        obs_space, act_space)
    pm = rm.RLModuleSpec(module_class=pcls, hidden=HIDDEN, **kw).build(
        obs_space, act_space)
    pp = pm.init(torch.Generator().manual_seed(1))
    jp = flax_from_rl_params(pm, pp)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(1))
    assert jax.tree_util.tree_structure(jp) == \
        jax.tree_util.tree_structure(shapes)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda x, y: x.shape == y.shape, jp, shapes))
    back = rl_params_from_flax(pm, jp)
    for k, v in pp.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)

    rng = np.random.default_rng(0)
    n = 7
    obs = rng.normal(size=(n, jm.obs_dim)).astype(np.float32)
    obs_t = torch.from_numpy(obs)
    if case.startswith("dreamerv3"):
        h = rng.normal(size=(n, 16)).astype(np.float32)
        z = rng.normal(size=(n, 4, 4)).astype(np.float32)
        a = rng.integers(0, 3, n)
        want = _fast_jit(functools.partial(_dreamer_outs, jm))(jp, obs, h, z,
                                                               a)
        h_t, z_t = torch.from_numpy(h), torch.from_numpy(z)
        got = {"embed": rm.apply(pm, pp, obs_t, method="embed"),
               "step_h": rm.apply(pm, pp, h_t, z_t, torch.from_numpy(a),
                                  method="step_h"),
               "prior_logits": rm.apply(pm, pp, h_t,
                                        method="prior_logits"),
               "post_logits": rm.apply(pm, pp, h_t, h_t,
                                       method="post_logits"),
               **rm.apply(pm, pp, h_t, z_t, method="wm_heads"),
               "actor": rm.apply(pm, pp, h_t, z_t, method="actor_logits"),
               "critic": rm.apply(pm, pp, h_t, z_t, method="critic_logits")}
    else:
        fwd = (lambda p, o, a: (jm.forward_train(p, o),
                                jm.q_values(p, o, a))) if case == "sac" \
            else (lambda p, o, a: (jm.forward_train(p, o),))
        acts = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
        outs = _fast_jit(fwd)(jp, obs, acts)
        want = dict(outs[0])
        got = rm.apply(pm, pp, obs_t)
        if case == "sac":
            want.update(q1=outs[1][0], q2=outs[1][1])
            got["q1"], got["q2"] = rm.apply(pm, pp, obs_t,
                                            torch.from_numpy(acts),
                                            method="q_values")
    assert sorted(got) == sorted(want)
    for key in want:
        w = np.asarray(want[key])
        assert got[key].shape == w.shape, key
        assert np.abs(w).max() > 1e-4, key  # not an all-zero output
        np.testing.assert_allclose(_np(got[key]), w, rtol=0, atol=ATOL_FWD,
                                   err_msg=key)


def test_init_draws_flax_distributions():
    """lecun normal (truncated at 2 std, std sqrt(1/fan_in)), normal(0.01)
    last layers, zero biases, orthogonal recurrent kernels."""
    pm = rm.RLModuleSpec(module_class=rm.DiscreteMLPModule,
                         hidden=(256, 256)).build(_box(400), DISC)
    p = pm.init(torch.Generator().manual_seed(0))
    w = p["pi.layers.1.weight"]
    assert abs(float(w.std()) - (1 / 256) ** 0.5) < 2e-3
    assert float(w.abs().max()) <= 2 * (1 / 256) ** 0.5 / 0.8796 + 1e-6
    assert abs(float(p["pi.layers.2.weight"].std()) - 0.01) < 1e-3
    assert float(p["vf.layers.0.bias"].abs().max()) == 0.0
    m = dreamerv3.DreamerV3Module(_box(6), DISC, rm.RLModuleSpec(config=DV3))
    p = m.init(torch.Generator().manual_seed(0))
    hr = p["gru.hr.weight"]
    torch.testing.assert_close(hr @ hr.T, torch.eye(16), atol=1e-5, rtol=0)


# ---------------------------------------------------------- distributions

@_fast_jit
def _jax_distributions(key, mean, log_std, logits, act):
    samp = jrm.categorical_sample(key, logits)
    return {"normal": jax.random.normal(key, mean.shape),
            "gumbel": jax.random.gumbel(key, logits.shape), "samp": samp,
            "categorical_logp": jrm.categorical_logp(logits, samp),
            "entropy": jrm.categorical_entropy(logits),
            "squashed_logp": jrm.squashed_gaussian_logp(act, mean, log_std),
            "gaussian_logp": jrm.gaussian_logp(act, mean, log_std)}


def test_distributions_match_jax_given_its_noise():
    rng = np.random.default_rng(3)
    mean = rng.normal(size=(6, 2)).astype(np.float32)
    log_std = rng.normal(scale=0.5, size=(6, 2)).astype(np.float32)
    logits = rng.normal(size=(6, 5)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    # the sample op by op, as the JAX env runner takes it: a fused tanh
    # may round an ulp otherwise, which log(1 - tanh^2) amplifies near +-1
    act_j, logp_j = jax.device_get(jrm.squashed_gaussian_sample(key, mean,
                                                                log_std))
    want = jax.device_get(_jax_distributions(key, mean, log_std, logits,
                                             act_j))
    t = torch.from_numpy
    act, logp = rm.squashed_gaussian_sample(t(mean), t(log_std),
                                            t(want["normal"]))
    np.testing.assert_allclose(_np(act), act_j, atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(logp), logp_j, atol=1e-5, rtol=0)
    samp = rm.categorical_sample(t(logits), t(want["gumbel"]))
    np.testing.assert_array_equal(_np(samp), want["samp"])
    np.testing.assert_allclose(_np(rm.categorical_logp(t(logits), samp)),
                               want["categorical_logp"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(rm.categorical_entropy(t(logits))),
                               want["entropy"], atol=1e-6, rtol=0)
    acts = t(act_j)
    np.testing.assert_allclose(
        _np(rm.squashed_gaussian_logp(acts, t(mean), t(log_std))),
        want["squashed_logp"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        _np(rm.gaussian_logp(acts, t(mean), t(log_std))),
        want["gaussian_logp"], atol=1e-5, rtol=0)


@_fast_jit
def _jax_primitives(key, x, logits, q):
    bins = jnp.linspace(-10.0, 10.0, 11)
    return {"bins": bins, "symlog": jdv3.symlog(x),
            "symexp": jdv3.symexp(x / 4), "twohot": jdv3.twohot(x, bins),
            "twohot_mean": jdv3.twohot_mean(logits, bins[:5]),
            "kl": jdv3._kl_categorical(logits, q),
            "gumbel": jax.random.gumbel(key, logits.shape),
            "st_sample": jdv3._st_sample(key, logits)}


def test_dreamer_primitives_match_jax():
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.normal(scale=5, size=20),
                        [-20, -10, 0, 4, 10, 30]]).astype(np.float32)
    logits = rng.normal(size=(3, 4, 5)).astype(np.float32)
    q = rng.normal(size=(3, 4, 5)).astype(np.float32)
    want = jax.device_get(_jax_primitives(jax.random.PRNGKey(5), x, logits,
                                          q))
    t = torch.from_numpy
    bins = torch.linspace(-10.0, 10.0, 11)
    got = {"bins": bins, "symlog": dreamerv3.symlog(t(x)),
           "symexp": dreamerv3.symexp(t(x / 4)),
           "twohot": dreamerv3.twohot(t(x), bins),
           "twohot_mean": dreamerv3.twohot_mean(t(logits), bins[:5]),
           "kl": dreamerv3.kl_categorical(t(logits), t(q)),
           "st_sample": dreamerv3.st_sample(t(logits), t(want["gumbel"]))}
    for key, val in got.items():
        np.testing.assert_allclose(_np(val), want[key], atol=1e-5, rtol=1e-6,
                                   err_msg=key)


@functools.partial(jax.jit, static_argnums=(6, 7), compiler_options=FAST)
def _jax_vtrace(values, bootstrap, rewards, rhos, mask, terminated,
                clip_rho, clip_c):
    is_last = jimpala.last_step_mask(mask)
    discounts = 0.99 * mask * (1 - is_last * terminated[:, None])
    vs, pg_adv = jimpala.vtrace_returns(values, bootstrap, rewards,
                                        discounts, rhos, mask, clip_rho,
                                        clip_c)
    return is_last, discounts, vs, pg_adv


def test_vtrace_on_padded_rows_matches_jax():
    rng = np.random.default_rng(5)
    B, T = 4, 7
    lengths = np.array([7, 5, 1, 3])
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    values = rng.normal(size=(B, T)).astype(np.float32)
    rewards = rng.normal(size=(B, T)).astype(np.float32) * mask
    rhos = np.exp(rng.normal(scale=0.5, size=(B, T))).astype(np.float32)
    terminated = np.array([1, 0, 0, 1], np.float32)
    bootstrap = rng.normal(size=B).astype(np.float32) * (1 - terminated)
    t = torch.from_numpy
    for clip_rho, clip_c in ((1.0, 1.0), (0.8, 1.2)):
        is_last, discounts, vs, pg_adv = jax.device_get(_jax_vtrace(
            values, bootstrap, rewards, rhos, mask, terminated, clip_rho,
            clip_c))
        np.testing.assert_array_equal(_np(impala.last_step_mask(t(mask))),
                                      is_last)
        got = impala.vtrace_returns(t(values), t(bootstrap), t(rewards),
                                    t(discounts), t(rhos), t(mask), clip_rho,
                                    clip_c)
        for w, g in zip((vs, pg_adv), got):
            np.testing.assert_allclose(_np(g), w, atol=1e-5, rtol=0)


# ---------------------------------------------------------------- learners

def _transitions(rng, n, obs_dim, act):
    if isinstance(act, int):
        actions = rng.integers(0, act, n).astype(np.int32)
    else:
        actions = rng.uniform(-0.95, 0.95, (n, act[0])).astype(np.float32)
    return {"obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
            "actions": actions,
            "rewards": rng.normal(size=n).astype(np.float32),
            "next_obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
            "dones": (rng.random(n) < 0.2).astype(np.float32)}


def _ppo_batch(rng, n, obs_dim, act):
    b = _transitions(rng, n, obs_dim, act)
    return {"obs": b["obs"], "actions": b["actions"],
            "logp": (rng.normal(scale=0.3, size=n) - 1.0).astype(np.float32),
            "advantages": rng.normal(size=n).astype(np.float32),
            "value_targets": rng.normal(scale=3, size=n).astype(np.float32)}


def _sequences(rng, B=4, T=6, obs_dim=5, n_act=3):
    lengths = np.array([6, 4, 6, 2])
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    return {"obs": rng.normal(size=(B, T, obs_dim)).astype(np.float32) *
            mask[..., None],
            "actions": (rng.integers(0, n_act, (B, T)) * mask).astype(
                np.int32),
            "rewards": rng.normal(size=(B, T)).astype(np.float32) * mask,
            "behavior_logp": (rng.normal(scale=0.3, size=(B, T)) - 1.1
                              ).astype(np.float32) * mask,
            "mask": mask,
            "bootstrap_obs": rng.normal(size=(B, obs_dim)).astype(
                np.float32),
            "terminated": np.array([0, 1, 0, 1], np.float32),
            "length": lengths.astype(np.int32)}


def _offline(rng, n=24, obs_dim=5):
    return {"obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
            "actions": rng.integers(0, 3, n).astype(np.int32),
            "returns": rng.normal(scale=2, size=n).astype(np.float32)}


def _dreamer_batch(rng, obs_shape):
    B, T = B_DV3, T_DV3
    is_first = np.zeros((B, T), np.float32)
    is_first[:, 0] = 1.0
    is_first[1, 2] = 1.0  # a new episode mid-sequence
    obs = rng.normal(size=(B, T, *obs_shape)).astype(np.float32)
    if len(obs_shape) == 3:
        obs = rng.uniform(0, 255, (B, T, *obs_shape)).astype(np.float32)
    return {"obs": obs,
            "actions": rng.integers(0, 3, (B, T)).astype(np.int32),
            "rewards": rng.normal(scale=2, size=(B, T)).astype(np.float32),
            "dones": (rng.random((B, T)) < 0.2).astype(np.float32),
            "is_first": is_first}


@functools.partial(jax.jit, static_argnums=(1, 2, 3),
                   compiler_options=FAST)
def _sac_noise(sub, b, d, n=0):
    """SAC's normals under the learner's key; with ``n``, CQL's uniform
    and policy candidates too."""
    r_next, r_cur = jax.random.split(sub)
    noise = {"next": jax.random.normal(r_next, (b, d)),
             "cur": jax.random.normal(r_cur, (b, d))}
    if n:
        r_unif, r_pol = jax.random.split(jax.random.fold_in(sub, 13))
        noise["unif"] = jax.random.uniform(r_unif, (b, n, d), minval=-1.0,
                                           maxval=1.0)
        noise["pol"] = jax.random.normal(r_pol, (b * n, d))
    return noise


@functools.partial(jax.jit, static_argnums=range(1, 7),
                   compiler_options=FAST)
def _dreamer_noise(sub, T, B, H, S, C, A):
    """The Gumbel draws of the JAX learner's scans under its key."""
    rngs = jax.random.split(sub, T + 1)
    obs = jnp.stack([jax.random.gumbel(rngs[t], (B, S, C))
                     for t in range(T)])
    act, z = [], []
    for rng_t in jax.random.split(rngs[T], H):
        r_a, r_z = jax.random.split(rng_t)
        act.append(jax.random.gumbel(r_a, (B * T, A)))
        z.append(jax.random.gumbel(r_z, (B * T, S, C)))
    return {"obs": obs, "act": jnp.stack(act), "z": jnp.stack(z)}


def _jax_noise(case, jl, batch):
    """The noise the JAX learner's next update draws (its key splits in
    prepare_batch), for the port's batch; None where a loss draws none."""
    if not hasattr(jl, "_host_rng"):
        return None
    _, sub = jax.random.split(jl._host_rng)
    if case.startswith("dreamerv3"):
        B, T = batch["obs"].shape[:2]
        nets = jl.module.nets
        noise = _dreamer_noise(sub, T, B, jl.config["imagine_horizon"],
                               nets.stoch, nets.classes, jl.module.act_dim)
    else:
        noise = _sac_noise(sub, batch["obs"].shape[0], jl.module.act_dim,
                           jl.config.get("cql_n_actions", 0))
    return jax.device_get(noise)


def _dv3_spec(mod):
    return dict(module_class=mod.DreamerV3Module, config=DV3)


LR = dict(lr=3e-3)
LEARNERS = {
    # case: (JAX learner, port learner, module specs (jax, port), spaces,
    #        config, batch maker)
    "ppo-discrete": (jppo.PPOLearner, ppo.PPOLearner,
                     (dict(module_class=jrm.DiscreteMLPModule),
                      dict(module_class=rm.DiscreteMLPModule)),
                     (_box(4), gym.spaces.Discrete(2)),
                     dict(LR, entropy_coeff=0.01),
                     lambda r: _ppo_batch(r, 32, 4, 2)),
    "ppo-gaussian": (jppo.PPOLearner, ppo.PPOLearner,
                     (dict(module_class=jrm.GaussianMLPModule),
                      dict(module_class=rm.GaussianMLPModule)),
                     (_box(5), ACT_BOX), dict(LR, entropy_coeff=0.01),
                     lambda r: _ppo_batch(r, 32, 5, (2,))),
    "dqn": (jdqn.DQNLearner, dqn.DQNLearner,
            (dict(module_class=jrm.QMLPModule),
             dict(module_class=rm.QMLPModule)),
            (_box(5), DISC), dict(LR, target_update_freq=1),
            lambda r: _transitions(r, 32, 5, 3)),
    "dqn-dueling-weighted": (
        jdqn.DQNLearner, dqn.DQNLearner,
        (dict(module_class=jrm.QMLPModule, dueling=True),
         dict(module_class=rm.QMLPModule, dueling=True)),
        (_box(5), DISC), dict(LR, target_update_freq=1),
        lambda r: {**_transitions(r, 32, 5, 3),
                   "weights": r.uniform(0.2, 1.0, 32).astype(np.float32)}),
    "impala": (jimpala.IMPALALearner, impala.IMPALALearner,
               (dict(module_class=jrm.DiscreteMLPModule),
                dict(module_class=rm.DiscreteMLPModule)),
               (_box(5), DISC), dict(LR), _sequences),
    "appo": (jimpala.APPOLearner, impala.APPOLearner,
             (dict(module_class=jrm.DiscreteMLPModule),
              dict(module_class=rm.DiscreteMLPModule)),
             (_box(5), DISC), dict(LR, clip_param=0.2), _sequences),
    "bc": (jbc.MARWILLearner, bc.MARWILLearner,
           (dict(module_class=jrm.DiscreteMLPModule),
            dict(module_class=rm.DiscreteMLPModule)),
           (_box(5), DISC), dict(LR, beta=0.0), _offline),
    "marwil": (jbc.MARWILLearner, bc.MARWILLearner,
               (dict(module_class=jrm.DiscreteMLPModule),
                dict(module_class=rm.DiscreteMLPModule)),
               (_box(5), DISC), dict(LR, beta=1.0, adv_scale=2.3),
               _offline),
    "sac": (jsac.SACLearner, sac.SACLearner,
            (dict(module_class=jrm.SACModule),
             dict(module_class=rm.SACModule)),
            (_box(5), ACT_BOX), dict(LR, tau=0.1),
            lambda r: _transitions(r, 16, 5, (2,))),
    "cql": (jcql.CQLLearner, cql.CQLLearner,
            (dict(module_class=jrm.SACModule),
             dict(module_class=rm.SACModule)),
            (_box(5), ACT_BOX), dict(LR, tau=0.1, cql_n_actions=3),
            lambda r: _transitions(r, 16, 5, (2,))),
    "dreamerv3-vector": (jdv3.DreamerV3Learner, dreamerv3.DreamerV3Learner,
                         (_dv3_spec(jdv3), _dv3_spec(dreamerv3)),
                         (_box(6), DISC), dict(LR, imagine_horizon=H_DV3),
                         lambda r: _dreamer_batch(r, (6,))),
    "dreamerv3-image": (jdv3.DreamerV3Learner, dreamerv3.DreamerV3Learner,
                        (_dv3_spec(jdv3), _dv3_spec(dreamerv3)),
                        (_box(8, 8, 3, low=0.0, high=255.0), DISC),
                        dict(LR, imagine_horizon=H_DV3),
                        lambda r: _dreamer_batch(r, (8, 8, 3))),
}
# these also take an after_update and a second update
TWICE = ("dqn", "dqn-dueling-weighted", "sac", "cql", "dreamerv3-vector",
         "dreamerv3-image")


def _learners(case, seed=0):
    """A JAX and a port learner from the port's init (the JAX learner's
    update compiled at FAST)."""
    jcls, pcls, (jspec, pspec), (obs_space, act_space), cfg, _ = \
        LEARNERS[case]
    pm = rm.RLModuleSpec(hidden=HIDDEN, **pspec).build(obs_space, act_space)
    pl = pcls(pm, dict(cfg), seed=seed, device="cpu")
    tree = pl.get_weights()
    tree.pop("log_alpha", None)  # SAC's learner adds its own
    jm = _port_init(jrm.RLModuleSpec(hidden=HIDDEN, **jspec).build(
        obs_space, act_space), tree)
    jl = jcls(jm, dict(cfg), seed=seed)
    if "log_alpha" in jl.params:
        # a strongly typed scalar, as the update returns it (a weakly
        # typed one compiles the update twice)
        jl.params["log_alpha"] = jnp.asarray(jl.params["log_alpha"],
                                             jnp.float32)
        jl.opt_state = jl.tx.init(jl.params)
    jl._jit_update = _fast_jit(jl._update_impl, donate_argnums=(0, 1))
    if hasattr(jl, "_jit_polyak"):
        jl._jit_polyak = _fast_jit(jl._jit_polyak.__wrapped__)
    return jl, pl


def _assert_metrics(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        rtol = RTOL_GNORM if key == "grad_norm" else RTOL_LOSS
        np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                   atol=RTOL_LOSS, err_msg=key)


def _update_both(case, jl, pl, rng):
    batch = LEARNERS[case][5](rng)
    noise = _jax_noise(case, jl, batch)
    port_batch = dict(batch) if noise is None else {**batch, "noise": noise}
    want = jl.update(batch)
    got = pl.update(port_batch)
    _assert_metrics(got, want)
    _tree_close(pl.get_weights(), jax.device_get(jl.get_weights()),
                atol=ATOL_PARAM)
    return batch, port_batch


@pytest.mark.parametrize("case", list(LEARNERS))
def test_learner_update_matches_jax(case):
    """One update (loss, metrics, parameters) equals the JAX learner's;
    DQN, SAC, CQL and DreamerV3 then take after_update and a second
    update, their targets held too."""
    jl, pl = _learners(case)
    rng = np.random.default_rng(7)
    _update_both(case, jl, pl, rng)
    if case not in TWICE:
        return
    jl.after_update()
    pl.after_update()
    for name in ("target_params", "slow_critic"):
        if hasattr(jl, name):
            want = jax.device_get(getattr(jl, name))
            got = flax_from_rl_params(pl.module, getattr(pl, name))
            if name == "slow_critic":
                got = got["critic"]
            _tree_close(got, want, atol=ATOL_PARAM)
    if case.startswith("dreamerv3"):
        assert pl._ret_scale == pytest.approx(jl._ret_scale, rel=1e-6)
    _update_both(case, jl, pl, rng)


@pytest.mark.parametrize("case", ["ppo-discrete", "cql", "dreamerv3-vector"])
def test_compute_then_apply_gradients_equals_update(case):
    _, a = _learners(case)
    _, b = _learners(case)
    batch = LEARNERS[case][5](np.random.default_rng(2))
    got = a.update(batch)
    grads, metrics = b.compute_gradients(batch)
    b.apply_gradients(grads)
    assert {k: v for k, v in got.items() if k != "grad_norm"} == metrics
    for k in a.params:
        torch.testing.assert_close(a.params[k], b.params[k], rtol=0, atol=0)


@pytest.mark.parametrize("case", ["sac", "dreamerv3-image"])
def test_weights_round_trip_with_a_jax_learner(case):
    """get_weights / set_weights cross both ways: the port's weights load
    into a JAX learner and come back unchanged."""
    jl, pl = _learners(case, seed=3)
    fresh = LEARNERS[case][1](pl.module, dict(LEARNERS[case][4]), seed=9,
                              device="cpu")
    jl.set_weights(fresh.get_weights())
    _tree_close(jax.device_get(jl.get_weights()), fresh.get_weights(),
                atol=0)
    pl.set_weights(jax.device_get(jl.get_weights()))
    for k in pl.params:
        torch.testing.assert_close(pl.params[k], fresh.params[k], rtol=0,
                                   atol=0)


def test_learner_refuses_cuda_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    module = rm.RLModuleSpec().build(_box(4), DISC)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ppo.PPOLearner(module, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(device_batches([{"x": np.zeros(2)}]))


def test_device_batches_on_the_cpu():
    batches = [{"x": np.arange(6, dtype=np.int64).reshape(2, 3),
                "y": np.ones(2)}]
    out = list(device_batches(batches, device="cpu",
                              dtypes={"x": np.int32}))
    assert out[0]["x"].dtype == torch.int32
    assert out[0]["y"].dtype == torch.float64
    np.testing.assert_array_equal(out[0]["x"].numpy(), batches[0]["x"])


# ------------------------------------------------------------------ acting

ACTING = {
    # case: (env, JAX module spec, port module spec, config, kwargs)
    "discrete": ("CartPole-v1", dict(module_class=jrm.DiscreteMLPModule),
                 dict(module_class=rm.DiscreteMLPModule), {}),
    "discrete-greedy": ("CartPole-v1",
                        dict(module_class=jrm.DiscreteMLPModule),
                        dict(module_class=rm.DiscreteMLPModule),
                        dict(explore=False)),
    "gaussian": ("Pendulum-v1", dict(module_class=jrm.GaussianMLPModule),
                 dict(module_class=rm.GaussianMLPModule), {}),
    "sac-greedy": ("Pendulum-v1", dict(module_class=jrm.SACModule),
                   dict(module_class=rm.SACModule), dict(explore=False)),
    "q-epsilon": ("CartPole-v1", dict(module_class=jrm.QMLPModule),
                  dict(module_class=rm.QMLPModule), dict(epsilon=0.5)),
    "dreamerv3": ("CartPole-v1", _dv3_spec(jdv3), _dv3_spec(dreamerv3), {}),
}


@pytest.mark.parametrize("case", list(ACTING))
def test_act_matches_the_jax_env_runner(case):
    """One step of 4 envs: the JAX runner samples, and act() given its
    noise (under the runner's key) and a copy of its numpy generator
    returns its actions, log-probs and values (and DreamerV3's state)."""
    env, jspec, pspec, kw = ACTING[case]
    spaces = gym.make(env)
    pm = rm.RLModuleSpec(hidden=HIDDEN, **pspec).build(
        spaces.observation_space, spaces.action_space)
    params = pm.init(torch.Generator().manual_seed(0))
    spec = _PortInitSpec(hidden=HIDDEN, **jspec)
    spec.tree = flax_from_rl_params(pm, params)
    runner = SingleAgentEnvRunner(env, spec, {"num_envs_per_env_runner": 4},
                                  seed=5)
    runner._jit_fwd = _fast_jit(runner.module.forward_train)
    if case == "dreamerv3":
        runner._jit_fwd_state = _fast_jit(runner.module.forward_inference)
    obs = np.stack(runner._cur_obs)
    np_rng = copy.deepcopy(runner._np_rng)
    _, sub = jax.random.split(runner._rng)
    state = None
    if case == "dreamerv3":
        r_z, r_a = jax.random.split(sub)
        noise = {"z": np.asarray(jax.random.gumbel(r_z, (4, 4, 4))),
                 "a": np.asarray(jax.random.gumbel(r_a, (4, 2)))}
        state = pm.initial_state(4)
    elif case == "gaussian":
        noise = {"eps": np.asarray(jax.random.normal(sub, (4, 1)))}
    else:
        noise = {"gumbel": np.asarray(jax.random.gumbel(sub, (4, 2)))}
    got = act(pm, params, obs, np_rng=np_rng, state=state, noise=noise, **kw)
    episodes = runner.sample(4, explore=kw.get("explore", True),
                             epsilon=kw.get("epsilon", 0.0))
    assert len(episodes) == 4
    want_actions = np.stack([np.asarray(ep.actions[0]) for ep in episodes])
    if case in ("gaussian", "sac-greedy"):
        np.testing.assert_allclose(got["actions"], want_actions, atol=1e-6,
                                   rtol=0)
    else:
        np.testing.assert_array_equal(got["actions"], want_actions)
    np.testing.assert_allclose(got["logp"], [ep.logp[0] for ep in episodes],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["vf"],
                               [ep.vf_preds[0] for ep in episodes],
                               atol=1e-5, rtol=0)
    if case == "dreamerv3":
        want = jax.device_get(runner._act_state)
        for key in ("h", "z", "a"):
            np.testing.assert_allclose(_np(got["state"][key]), want[key],
                                       atol=1e-5, rtol=0)
        reset = pm.reset_state_row(got["state"], 1)
        assert float(reset["h"][1].abs().sum()) == 0.0
        assert float(got["state"]["h"][1].abs().sum()) > 0.0
