"""Parity of ray_tpu_torch's Mixtral-style MoE with the JAX package's.

The same float32 parameters (a JAX init carried across by
``params_from_flax``) and the same numpy inputs go through the JAX
``MoEMLP``, model, trainer and engine and through the port's, on the
``tiny-moe`` config (h 64, E 4, k 2, groups of 64). Routing must be
identical: the same experts and the same capacity slots for every
(token, choice). Tolerances (float32; the frameworks sum in different
orders): MoE output 1e-5, router and expert gradients 5e-5, logits 1e-4,
the router term 1e-6, the trainer's loss rtol 1e-5, grad norm rtol 1e-4
and parameters 1e-5 after three steps; engine greedy tokens exactly, each
engine mode against the JAX engine in the same mode.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.sharded_serve import ENGINE_CFG, parity_prompts
from ray_tpu.models.llama import LlamaModel as JaxLlama
from ray_tpu.models.llama import MoEMLP as JaxMoEMLP
from ray_tpu.models.llama import get_config as jax_config
from ray_tpu.parallel import train_lib as jax_train
from ray_tpu.parallel.train_lib import TrainState
from ray_tpu.parallel.mesh import MeshConfig, create_mesh
from ray_tpu.serve.llm import EngineConfig as JaxEngineConfig
from ray_tpu.serve.llm import LLMEngine as JaxLLMEngine
from ray_tpu.serve.llm import SamplingParams as JaxSamplingParams
from ray_tpu_torch.models.config import get_config
from ray_tpu_torch.models.convert import (build_model, init_params,
                                          layer_leaves, params_from_flax)
from ray_tpu_torch.models.llama import (LlamaModel, MoEMLP, moe_capacity,
                                        moe_route)
from ray_tpu_torch.parallel import train_lib
from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine, SamplingParams

F32 = dict(dtype="float32", param_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs files in
    parallel workers, and tiny shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_routing(xg, router, cfg):
    """The JAX MoEMLP's routing lines (ray_tpu/models/llama.py:292-302),
    on its own inputs: expert indices and capacity slots [G, g, k]."""
    logits = jnp.einsum("Gth,he->Gte", xg.astype(jnp.float32), router)
    probs = jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(probs, cfg.num_experts_per_tok)
    assigns = jax.nn.one_hot(idx, cfg.num_experts, dtype=jnp.int32).reshape(
        xg.shape[0], -1, cfg.num_experts)
    pos = ((jnp.cumsum(assigns, axis=1) - assigns) * assigns).sum(-1)
    return np.asarray(idx), np.asarray(pos).reshape(idx.shape)


def _moe_pair(capacity_factor):
    """A JAX MoEMLP and the port's on the same float32 params, drawn with
    numpy as Flax's initializers draw them (router normal(0.02), experts
    with the fan-in E*h and E*f), and a [3, 30, h] input: 90 tokens, two
    groups of 64 with a padded tail."""
    cfg_j = jax_config("tiny-moe", dtype=jnp.float32,
                       capacity_factor=capacity_factor)
    n_exp, h, f = (cfg_j.num_experts, cfg_j.hidden_size,
                   cfg_j.intermediate_size)
    rng = np.random.default_rng(3)
    params = {"router": 0.02 * rng.standard_normal((h, n_exp)),
              "experts_gate_up": rng.standard_normal((n_exp, h, 2 * f))
              / np.sqrt(n_exp * h),
              "experts_down": rng.standard_normal((n_exp, f, h))
              / np.sqrt(n_exp * f)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = np.random.default_rng(1).standard_normal(
        (3, 30, h)).astype(np.float32)
    cfg = get_config("tiny-moe", capacity_factor=capacity_factor, **F32)
    mod = MoEMLP(cfg, torch.float32, torch.float32)
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()},
                        strict=True)
    return cfg_j, JaxMoEMLP(cfg_j), params, cfg, mod, x


@functools.lru_cache(maxsize=None)
def _jax_moe(capacity_factor):
    """The JAX MoEMLP's output, sown router term and the gradients of
    ``sum(out * r) + term`` (r a seeded [3, 30, h] array), from one
    compiled function for both tests of a capacity factor."""
    _, mod_j, params, _, _, x = _moe_pair(capacity_factor)
    r = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def loss(p):
        out, sown = mod_j.apply({"params": p}, jnp.asarray(x),
                                mutable=["losses"])
        term = sown["losses"]["router_aux_scaled"]
        return jnp.sum(out * r) + term, (out, term)

    (_, (out, term)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    return np.asarray(out), float(term), jax.tree.map(np.asarray, grads), r


@pytest.mark.parametrize("capacity_factor", [1.25, 0.1])
def test_moe_mlp_matches_jax(capacity_factor):
    """Routing (experts and capacity slots), output and router term of
    one MoEMLP; at capacity factor 0.1 most assignments are dropped. The
    term is computed only when asked for, as JAX sows it only into a
    ``losses`` collection the caller asks for."""
    cfg_j, _, params, cfg, mod, x = _moe_pair(capacity_factor)
    want, want_aux, _, _ = _jax_moe(capacity_factor)
    with torch.no_grad():
        got, aux = mod(torch.from_numpy(x), with_aux=True)
        got_plain, no_aux = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(float(aux), want_aux, atol=1e-6)
    assert no_aux is None and torch.equal(got_plain, got)

    g = cfg.moe_group_size
    xg = np.zeros((2 * g, cfg.hidden_size), np.float32)
    xg[:90] = x.reshape(90, -1)
    xg = xg.reshape(2, g, -1)
    idx_j, slot_j = _jax_routing(jnp.asarray(xg), params["router"], cfg_j)
    _, _, idx, slot = moe_route(torch.from_numpy(xg), mod.router.detach(),
                                cfg.num_experts_per_tok)
    np.testing.assert_array_equal(idx.numpy(), idx_j)
    np.testing.assert_array_equal(slot.numpy(), slot_j)
    real = np.concatenate([slot_j[0], slot_j[1, :90 - g]])
    dropped = float((real >= moe_capacity(cfg, g)).mean())
    assert (dropped > 0.5) == (capacity_factor < 1), dropped


@pytest.mark.parametrize("capacity_factor", [1.25, 0.1])
def test_moe_mlp_grads_match_jax(capacity_factor):
    """Gradients of the router and the expert kernels through a scalar
    loss of the output and the router term."""
    _, _, _, _, mod, x = _moe_pair(capacity_factor)
    _, _, grads_j, r = _jax_moe(capacity_factor)
    out, aux = mod(torch.from_numpy(x), with_aux=True)
    (out * torch.from_numpy(r)).sum().add(aux).backward()
    for name, p in mod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads_j[name],
                                   atol=5e-5, err_msg=name)


def _flax_tree(sd, cfg):
    """The inverse of ``params_from_flax``: a state dict as the Flax tree
    of the JAX engine (layers stacked, dense kernels [in, out])."""
    def leaf(t, transpose):
        return jnp.asarray((t.T if transpose else t).numpy())

    tree = {"embed": leaf(sd["embed"], False),
            "final_norm": {"scale": leaf(sd["final_norm.scale"], False)},
            "lm_head": {"kernel": leaf(sd["lm_head.weight"], True)},
            "layers": {"layer": {}}}
    for path, (name, transpose) in layer_leaves(cfg).items():
        node = tree["layers"]["layer"]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = jnp.stack([leaf(sd[f"layers.{i}.{name}"], transpose)
                                    for i in range(cfg.num_layers)])
    return tree


def _tiny_moe_params(seed):
    """Seeded float32 tiny-moe parameters as the JAX model's Flax tree
    (the port's init, whose distributions are Flax's)."""
    cfg = get_config("tiny-moe")
    sd = init_params(cfg, torch.Generator().manual_seed(seed), "cpu",
                     torch.float32)
    return _flax_tree(sd, cfg)


@pytest.fixture(scope="module")
def tiny_moe():
    """The JAX tiny-moe model (float32, loss chunk 8), its params, and a
    [2, 40] batch: 80 tokens, two groups of 64 with a padded tail."""
    cfg_j = jax_config("tiny-moe", dtype=jnp.float32, loss_chunk=8)
    ids = np.random.default_rng(0).integers(
        0, cfg_j.vocab_size, (2, 40)).astype(np.int32)
    return cfg_j, JaxLlama(cfg_j), _tiny_moe_params(0), ids


def _port_model(params, **overrides):
    cfg = get_config("tiny-moe", loss_chunk=8, **F32, **overrides)
    sd = params_from_flax(jax.tree.map(np.asarray, params), cfg)
    return build_model(cfg, sd, "cpu", torch.float32, train=True)


def test_moe_model_logits_nll_and_aux_match_jax(tiny_moe):
    """Logits, the fused nll (pure cross-entropy: the same with and
    without the router terms asked for) and the router terms summed over
    layers, against JAX's sown values."""
    _, model_j, params, ids = tiny_moe
    targets = np.roll(ids, -1, axis=1)
    logits_j, (nll_j, sown) = jax.jit(lambda p: (
        model_j.apply({"params": p}, ids),
        model_j.apply({"params": p}, ids, targets=targets,
                      mutable=["losses"])))(params)
    aux_j = sum(float(jnp.sum(leaf))
                for leaf in jax.tree.leaves(sown["losses"]))
    model = _port_model(params)
    ids_t, targets_t = torch.from_numpy(ids), torch.from_numpy(targets)
    with torch.no_grad():
        logits = model(ids_t)
        nll = model(ids_t, targets=targets_t)
        nll_aux, aux = model(ids_t, targets=targets_t, return_aux=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                               atol=1e-4)
    np.testing.assert_allclose(nll.numpy(), np.asarray(nll_j), atol=1e-5)
    assert torch.equal(nll, nll_aux)
    np.testing.assert_allclose(float(aux), aux_j, atol=1e-6)


def test_moe_trainer_loss_adds_router_terms(tiny_moe):
    """tests/test_moe.py:42-76 for the port: against the same model with
    the coefficient zeroed, the trainer's loss is higher by the router
    terms' total, which is at least coef per layer."""
    cfg_j, _, params, ids = tiny_moe
    losses, aux = {}, {}
    for coef in (cfg_j.router_aux_loss_coef, 0.0):
        model = _port_model(params, router_aux_loss_coef=coef)
        trainer = train_lib.ShardedTrainer(model, device="cpu")
        losses[coef] = float(trainer.eval_loss(None, {"input_ids": ids}))
        with torch.no_grad():
            aux[coef] = float(model(torch.from_numpy(ids),
                                    return_aux=True)[1])
    coef = cfg_j.router_aux_loss_coef
    assert aux[0.0] == 0.0
    assert aux[coef] >= coef * cfg_j.num_layers * 0.99
    assert losses[coef] > losses[0.0]
    np.testing.assert_allclose(losses[coef] - losses[0.0], aux[coef],
                               rtol=1e-3)


def test_moe_trainer_matches_jax_sharded_trainer():
    """Three steps of both trainers from the same parameters, remat
    "nothing" on both sides: a router term counted twice by the recompute
    would show in the loss and the gradients."""
    over = dict(loss_chunk=8, remat=True, remat_policy="nothing")
    cfg_j = jax_config("tiny-moe", dtype=jnp.float32, **over)
    mesh = create_mesh(MeshConfig(), devices=jax.devices()[:1])
    opt = dict(lr=1e-3, warmup=1, total_steps=10)
    trainer_j = jax_train.ShardedTrainer(
        JaxLlama(cfg_j), mesh, optimizer=jax_train.default_optimizer(**opt))
    rng = np.random.default_rng(2)
    batches = []
    for _ in range(3):
        mask = np.ones((2, 40), np.int32)
        mask[1, 25:] = 0
        batches.append({"input_ids": rng.integers(
            0, cfg_j.vocab_size, (2, 40)).astype(np.int32),
            "loss_mask": mask})
    # the state JAX's init would make, from the port's seeded init
    # (trainer_j.init would compile the model's init for nothing), laid
    # out as the step's outputs are, so that the step compiles once
    params_j = _tiny_moe_params(1)
    state_j = jax.device_put(
        TrainState(step=jnp.zeros((), jnp.int32), params=params_j,
                   opt_state=trainer_j.tx.init(params_j)),
        trainer_j.state_shardings(batches[0]))
    cfg = get_config("tiny-moe", **F32, **over)
    sd = params_from_flax(jax.tree.map(np.asarray, state_j.params), cfg)
    with torch.device("meta"):
        model = LlamaModel(cfg)
    trainer = train_lib.ShardedTrainer(
        model, optimizer=train_lib.default_optimizer(**opt), device="cpu")
    state = trainer.init(None, batches[0], params=sd)
    for i, batch in enumerate(batches):
        state_j, m_j = trainer_j.step(state_j, batch)
        state, m = trainer.step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]),
                                   rtol=1e-5, err_msg=f"loss, step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(m_j["grad_norm"]), rtol=1e-4,
                                   err_msg=f"grad norm, step {i}")
    want = params_from_flax(jax.tree.map(np.asarray, state_j.params), cfg)
    for name, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-5, err_msg=name)


# the engine modes, as in tests/test_torch_engine_sched.py: speculative
# decoding one dispatch deep, where every greedy slot may draft
MODES = {"legacy": {}, "chunked": dict(prefill_chunk_tokens=16),
         "spec": dict(spec_lookahead=4, pipeline_depth=1),
         "chunked_spec": dict(prefill_chunk_tokens=16, spec_lookahead=4,
                              pipeline_depth=1)}
# capacity is short in every mode: 16 slots per expert for a prefill
# group of 64 tokens (32 choices per expert on average), 1 for decode's 4
# slots. Padding rows and columns and idle decode slots are routed, and
# take slots ahead of later real tokens, so the tokens agree only if both
# engines route the same rows in the same order.
MOE_ENGINE_CFG = dict(ENGINE_CFG, model="tiny-moe", model_overrides=dict(
    ENGINE_CFG["model_overrides"], capacity_factor=0.5))
PROMPTS = {**{f"g{i}": p for i, p in enumerate(parity_prompts())},
           "pattern": [5, 6, 7, 8] * 4}
MAX_TOKENS = {"g0": 3, "g1": 12, "g2": 8, "pattern": 16}


@pytest.fixture(scope="module")
def moe_params():
    """Seeded float32 tiny-moe parameters of the port, as a state dict."""
    cfg = get_config("tiny-moe", **MOE_ENGINE_CFG["model_overrides"])
    return init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                       torch.float32)


@pytest.fixture(scope="module")
def jax_moe_engine(moe_params):
    """One JAX engine for the module: its compiled functions depend only
    on shapes, so a mode is set on its config between runs."""
    return JaxLLMEngine(JaxEngineConfig(**MOE_ENGINE_CFG),
                        params=_flax_tree(moe_params, get_config("tiny-moe")))


def _serve(engine, sampling_cls):
    for rid, p in PROMPTS.items():
        engine.add_request(rid, p,
                           sampling_cls(max_tokens=MAX_TOKENS[rid]))
    out = {rid: [] for rid in PROMPTS}
    for _ in range(500):
        if not engine.has_work():
            return out
        for d in engine.step():
            out[d.request_id].extend(d.new_token_ids)
    raise AssertionError(f"unfinished: {out}")


@pytest.mark.parametrize("mode", list(MODES))
def test_moe_engine_greedy_identical_to_jax(jax_moe_engine, moe_params,
                                           mode):
    """Greedy tokens of tiny-moe through the JAX engine and the port in
    the same mode, on the same parameters, are identical: idle decode
    slots and padding rows and columns are routed on both sides alike, so
    they take the same capacity (requests end at different steps, so
    slots idle while others decode)."""
    engine_j = jax_moe_engine
    while engine_j.has_work():
        engine_j.step()
    # a new mode is a new config, an empty prefix cache, and a fresh
    # engine's pool and decode carry (an idle slot's stale id is routed,
    # and takes capacity)
    cfg = MOE_ENGINE_CFG
    engine_j.config = JaxEngineConfig(**cfg, **MODES[mode])
    engine_j.allocator = type(engine_j.allocator)(
        cfg["num_pages"], cfg["page_size"])
    engine_j.kv_pages = jnp.zeros_like(engine_j.kv_pages)
    engine_j.slot_ids = jnp.zeros_like(engine_j.slot_ids)
    want = _serve(engine_j, JaxSamplingParams)
    engine = LLMEngine(EngineConfig(**cfg, **MODES[mode], device="cpu"),
                       params=moe_params)
    assert _serve(engine, SamplingParams) == want
    if "spec" in mode:
        assert engine.stats()["spec_accepted_total"] > 0


@pytest.mark.parametrize("name,fan_in", [("experts_gate_up", "E*h"),
                                         ("experts_down", "E*f")])
def test_moe_init_expert_std_is_flax_fan_in(name, fan_in):
    """Flax's lecun_normal counts a 3-D kernel's leading expert axis as
    receptive field: std sqrt(1/(E*h)) and sqrt(1/(E*f))."""
    cfg = get_config("tiny-moe")
    sd = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                     torch.float32)
    n = cfg.num_experts * (cfg.hidden_size if fan_in == "E*h"
                           else cfg.intermediate_size)
    std = float(sd[f"layers.0.moe.{name}"].std())
    assert abs(std / n ** -0.5 - 1) < 0.05, (std, n ** -0.5)
    router = sd["layers.0.moe.router"]
    assert router.dtype == torch.float32
    assert abs(float(router.std()) / 0.02 - 1) < 0.1


def test_moe_router_stays_float32_in_bf16_model():
    """A bf16 model (the serving form) keeps the router float32, as the
    JAX param is declared, and routes in float32."""
    cfg = get_config("tiny-moe")
    sd = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                     torch.bfloat16)
    assert sd["layers.0.moe.router"].dtype == torch.float32
    model = build_model(cfg, sd, "cpu", torch.bfloat16)
    assert model.layers[0].moe.router.dtype == torch.float32
    assert model.layers[0].moe.experts_gate_up.dtype == torch.bfloat16
    with torch.device("meta"):
        train_form = LlamaModel(dataclasses.replace(cfg,
                                                    param_dtype="bfloat16"))
    assert train_form.layers[1].moe.router.dtype == torch.float32
    ids = torch.arange(12)[None] % cfg.vocab_size
    with torch.no_grad():
        out = model(ids)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
