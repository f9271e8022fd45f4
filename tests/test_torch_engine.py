"""ray_tpu_torch's Serve-LLM engine: greedy token identity with the JAX
package's engine on shared parameters, the scheduler's behaviours
(prefix caching, page-pressure preemption, fused multi-step decode), the
sampling key contract, the refusals, and import hygiene. Engines run on
the CPU (device="cpu") in float32 on the tiny config; tokens must match
exactly.
"""

import ast
import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.sharded_serve import ENGINE_CFG, greedy_collect, \
    parity_prompts
from ray_tpu.serve.llm import EngineConfig as JaxEngineConfig
from ray_tpu.serve.llm import LLMEngine as JaxLLMEngine
from ray_tpu.serve.llm import SamplingParams as JaxSamplingParams
from ray_tpu_torch.models.config import get_config
from ray_tpu_torch.models.convert import (flax_from_params, init_params,
                                          params_from_flax)
from ray_tpu_torch.serve.llm import (EngineConfig, LLMEngine, Request,
                                     SamplingParams)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_CFG = dict(ENGINE_CFG, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs files in
    parallel workers, and tiny shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _collect(engine, prompts, sampling=None, max_steps=500):
    """Run {rid: prompt} to completion; returns {rid: token ids}. Each
    request gets its own copy of `sampling` (preemption edits it)."""
    for rid, p in prompts.items():
        sp = dataclasses.replace(sampling) if sampling else \
            SamplingParams(max_tokens=8)
        engine.add_request(rid, p, sp)
    out = {rid: [] for rid in prompts}
    done = set()
    for _ in range(max_steps):
        for d in engine.step():
            out[d.request_id].extend(d.new_token_ids)
            if d.finished:
                done.add(d.request_id)
        if done == set(prompts):
            return out
    raise AssertionError(f"unfinished after {max_steps} steps: {out}")


def test_greedy_tokens_identical_to_jax_engine():
    """The repo's parity oracle: parity_prompts() through the JAX engine
    (benchmarks/sharded_serve.py ENGINE_CFG) and through the port on the
    JAX engine's own parameters give identical greedy tokens."""
    jax_engine = JaxLLMEngine(JaxEngineConfig(**ENGINE_CFG))
    want = greedy_collect(jax_engine, parity_prompts())
    params = params_from_flax(jax.tree.map(np.asarray, jax_engine.params),
                              jax_engine.model_cfg)
    engine = LLMEngine(EngineConfig(**CPU_CFG), params=params)
    got = _collect(engine, {f"g{i}": p
                            for i, p in enumerate(parity_prompts())})
    assert got == want


def test_greedy_tokens_identical_to_jax_engine_at_head_dim_96():
    """The same oracle at Phi-3-mini's head dim, 96 (tiny's 4 q heads then
    make a q width of 384 beside a hidden size of 64), float32, on the
    port's seeded parameters given to both engines (the JAX engine skips
    its Flax init): identical greedy tokens."""
    overrides = dict(ENGINE_CFG["model_overrides"], head_dim=96)
    cfg = dict(ENGINE_CFG, model_overrides=overrides)
    model_cfg = get_config("tiny", **overrides)
    params = init_params(model_cfg, torch.Generator().manual_seed(0), "cpu",
                         torch.float32)
    jax_engine = JaxLLMEngine(JaxEngineConfig(**cfg), params=jax.tree.map(
        jnp.asarray, flax_from_params(params, model_cfg)))
    want = greedy_collect(jax_engine, parity_prompts())
    engine = LLMEngine(EngineConfig(**dict(cfg, device="cpu")),
                       params=params)
    got = _collect(engine, {f"g{i}": p
                            for i, p in enumerate(parity_prompts())})
    assert got == want


def test_prefix_cache_reuse_identical_output():
    engine = LLMEngine(EngineConfig(**CPU_CFG))
    shared = list(np.random.default_rng(2).integers(0, 500, 24))
    out_a = _collect(engine, {"a": shared + [7]})["a"]
    hits_before = engine.allocator.stats["cache_hits"]
    out_b = _collect(engine, {"b": shared + [7]})["b"]
    assert engine.allocator.stats["cache_hits"] > hits_before
    assert out_a == out_b


@pytest.mark.parametrize("num_pages,n,prompt_len,max_tokens,preempts",
                         [(12, 5, 17, 8, False), (10, 4, 15, 20, True)])
def test_page_pressure_queues_preempts_and_completes(
        num_pages, n, prompt_len, max_tokens, preempts):
    """More requests than the page pool holds at once: the engine queues
    (and, when decode outgrows the pool, preempts and recomputes) and
    still completes every request, with the tokens each gets alone."""
    cfg = dict(CPU_CFG, num_pages=num_pages, max_model_len=64,
               prefill_buckets=(16, 32, 64))
    rng = np.random.default_rng(3)
    prompts = {f"p{i}": list(rng.integers(0, 500, prompt_len))
               for i in range(n)}
    sp = lambda: SamplingParams(max_tokens=max_tokens)  # noqa: E731
    engine = LLMEngine(EngineConfig(**cfg))
    out = _collect(engine, prompts, sp())
    assert all(len(v) == max_tokens for v in out.values())
    assert (engine.stats()["preempted_total"] > 0) == preempts
    assert engine.allocator.num_free() == num_pages - 1
    for rid in ("p0", f"p{n - 1}"):
        solo = _collect(LLMEngine(EngineConfig(**cfg)),
                        {rid: prompts[rid]}, sp())
        assert solo[rid] == out[rid], rid


def test_multi_step_decode_matches_single_step():
    rng = np.random.default_rng(9)
    prompts = {f"r{i}": list(rng.integers(0, 500, 10)) for i in range(3)}
    outs = [_collect(LLMEngine(EngineConfig(
        **CPU_CFG, decode_steps_per_dispatch=k, pipeline_depth=depth)),
        prompts) for k, depth in ((1, 1), (4, 2), (3, 3))]
    assert outs[0] == outs[1] == outs[2]


def test_sampling_key_contract():
    """Keys are the JAX engine's (request id, seed, count) keys, and a
    sampled request's tokens do not depend on what else is batched."""
    batch = [Request("x", [1, 2], SamplingParams(temperature=0.7, seed=5)),
             Request("y", [3], SamplingParams(top_k=9))]
    jax_batch = [types.SimpleNamespace(
        request_id=r.request_id, slot=i, output_ids=[4] * i, planned_out=i,
        sampling=JaxSamplingParams(temperature=r.sampling.temperature,
                                   top_k=r.sampling.top_k,
                                   seed=r.sampling.seed))
        for i, r in enumerate(batch)]
    for i, r in enumerate(batch):
        r.output_ids, r.planned_out, r.slot = [4] * i, i, i
    cfg = types.SimpleNamespace(config=types.SimpleNamespace(seed=11))
    for kw in (dict(), dict(counter_offset=2, slot_layout=True,
                            base="planned")):
        got = LLMEngine._sampling_arrays(cfg, batch, 4, **kw)
        want = JaxLLMEngine._sampling_arrays(cfg, jax_batch, 4, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    sp = SamplingParams(max_tokens=12, temperature=0.9, top_k=20, seed=3)
    prompt = {"s": [5, 6, 7, 8, 9]}
    alone = _collect(LLMEngine(EngineConfig(**CPU_CFG)), prompt, sp)
    rng = np.random.default_rng(4)
    crowd = dict(prompt, **{f"o{i}": list(rng.integers(0, 500, 11))
                            for i in range(3)})
    batched = _collect(LLMEngine(EngineConfig(
        **CPU_CFG, decode_steps_per_dispatch=3)), crowd, sp)
    assert alone["s"] == batched["s"]
    assert len(set(alone["s"])) > 1  # actually sampled, not greedy


def test_cuda_engine_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine(EngineConfig(**ENGINE_CFG))


@pytest.mark.parametrize("option", [dict(tp=2), dict(pp=2)])
def test_unported_engine_options_are_refused(option):
    """tp and pp are ported, on worlds of tp and pp x tp ranks
    (tests/test_torch_tp_serve.py, tests/test_torch_pp_serve.py): without
    one the engine is refused at construction. The pipelined engine also
    refuses pp below 2 with the JAX engine's guard."""
    if "pp" in option:
        from ray_tpu.serve.llm import PipelinedEngine as JaxPipelinedEngine
        from ray_tpu_torch.serve.llm import PipelinedEngine

        with pytest.raises(ValueError, match="pp >= 2") as err:
            PipelinedEngine(EngineConfig(**CPU_CFG))
        with pytest.raises(ValueError) as jax_err:
            JaxPipelinedEngine(JaxEngineConfig(**ENGINE_CFG))
        assert str(err.value) == str(jax_err.value)
        with pytest.raises(RuntimeError, match="initialised world of 2 "
                           "ranks"):
            PipelinedEngine(EngineConfig(**CPU_CFG, **option))
    else:
        with pytest.raises(RuntimeError, match="initialised world of 2 "
                           "ranks"):
            LLMEngine(EngineConfig(**CPU_CFG, **option))


def test_package_imports_no_jax_and_nothing_of_ray_tpu():
    """No file of ray_tpu_torch, nor chip_smoke.py or chip_variants.py,
    imports jax, flax, optax, gymnasium or ray_tpu (relative imports stay
    inside ray_tpu_torch); the card's machine has none of them."""
    files = [os.path.join(REPO, n) for n in ("chip_smoke.py",
                                             "chip_variants.py")]
    for root, _, names in os.walk(os.path.join(REPO, "ray_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    banned = ("jax", "flax", "optax", "gymnasium", "ray_tpu")
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in banned, (path, mod)
