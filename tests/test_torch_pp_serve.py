"""Pipeline-parallel serving in ray_tpu_torch, held to the JAX package's
engine (the counterpart of ``tests/test_llm_pp.py``).

The port's ``PipelinedEngine`` runs at pp 2 on one world of two gloo CPU
ranks (``parallel.distributed.spawn`` of ``entry.serve_on_mesh``: rank 0
schedules and runs stage 0, rank 1 runs stage 1 and samples), from the
same float32 parameters as the JAX single engine in this process; greedy
tokens are compared exactly. pp 2 x tp 2 runs in the 4-rank world of
``tests/test_torch_sp_pp.py``.

- construction guards with the JAX engine's messages, and ``make_engine``;
- stage parameters are literal slices, and ``StageModel``s chained give
  the full model's logits;
- greedy tokens identical to the JAX single engine at pp 2, and under
  preemption (each request alone on the JAX engine);
- steady decode moves only activation frames down the pipeline (decode
  ticks of [S, 1, H] hidden states) and tokens back, and
  ``0 <= pp_bubble_frac <= 1`` (the port's counterpart of JAX's "zero
  control RPCs" test).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.serve.llm import EngineConfig as JaxEngineConfig
from ray_tpu.serve.llm import LLMEngine as JaxLLMEngine
from ray_tpu.serve.llm import PipelinedEngine as JaxPipelinedEngine
from ray_tpu.serve.llm import SamplingParams as JaxSamplingParams
from ray_tpu_torch import entry
from ray_tpu_torch.models.config import get_config
from ray_tpu_torch.models.convert import (build_model, flax_from_params,
                                          init_params, load_params)
from ray_tpu_torch.models.llama import StageModel
from ray_tpu_torch.parallel.distributed import spawn
from ray_tpu_torch.serve.llm import (EngineConfig, LLMEngine,
                                     PipelinedEngine, make_engine,
                                     stage_params)

PP = 2
DEADLINE_S = 120  # a world that hangs fails its tests, not the suite
# the JAX test's engine settings (tests/test_llm_pp.py ENGINE_CFG)
ENGINE_CFG = dict(
    model="tiny", page_size=8, num_pages=64, max_model_len=128,
    max_batch=4, prefill_buckets=(16, 32, 64, 128), dtype="float32",
    model_overrides={"vocab_size": 512})
PREEMPT_CFG = dict(ENGINE_CFG, num_pages=12, max_model_len=64, max_batch=2,
                   prefill_buckets=(16, 32, 64))
_rng = np.random.default_rng(0)
PROMPTS = {f"r{i}": [int(t) for t in _rng.integers(0, 500, 11 + 7 * i)]
           for i in range(3)}
_rng = np.random.default_rng(4)
PREEMPT_PROMPTS = {f"p{i}": [int(t) for t in _rng.integers(0, 500, 17)]
                   for i in range(2)}
_rng = np.random.default_rng(7)
STEADY = dict(prompts=[[int(t) for t in _rng.integers(0, 500, 12)]
                       for _ in range(4)], max_tokens=30, steps=12)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return get_config("tiny", **ENGINE_CFG["model_overrides"])


@pytest.fixture(scope="module")
def tiny_params():
    return init_params(_cfg(), torch.Generator().manual_seed(0), "cpu",
                       torch.float32)


def _jax_serve(engine, prompts, max_tokens):
    for rid, p in prompts.items():
        engine.add_request(rid, p, JaxSamplingParams(max_tokens=max_tokens))
    out = {rid: [] for rid in prompts}
    for _ in range(1000):
        if not engine.has_work():
            return out
        for d in engine.step():
            out[d.request_id].extend(int(t) for t in d.new_token_ids)
    raise AssertionError(f"unfinished: {out}")


def _wave(prompts, max_tokens):
    return [(rid, p, {"max_tokens": max_tokens}, None)
            for rid, p in prompts.items()]


@pytest.fixture(scope="module")
def world(tiny_params):
    """The JAX single engine's tokens, and the port's runs at pp 2."""
    flax = jax.tree.map(jnp.asarray, flax_from_params(tiny_params, _cfg()))
    want = _jax_serve(JaxLLMEngine(JaxEngineConfig(**ENGINE_CFG),
                                   params=flax), PROMPTS, 6)
    solo_engine = JaxLLMEngine(JaxEngineConfig(**PREEMPT_CFG), params=flax)
    solo = {}
    for rid, p in PREEMPT_PROMPTS.items():  # each request alone
        solo.update(_jax_serve(solo_engine, {rid: p}, 40))
    runs = [{"engine": dict(ENGINE_CFG, pp=PP),
             "waves": [_wave(PROMPTS, 6)], "count_waves": (0, 1),
             "warmup": dict(prompt_buckets=(16,))},
            {"engine": dict(PREEMPT_CFG, pp=PP),
             "waves": [_wave(PREEMPT_PROMPTS, 40)]},
            {"engine": dict(ENGINE_CFG, pp=PP, pp_microbatches=4),
             "steady": STEADY}]
    ranks = spawn(entry.serve_on_mesh, PP, "cpu", DEADLINE_S,
                  args=(runs,),
                  kwargs=dict(params={k: v.numpy()
                                      for k, v in tiny_params.items()},
                              device="cpu"))
    return types.SimpleNamespace(want=want, solo=solo, ranks=ranks)


# ------------------------------------------------------------ pure units
@pytest.mark.parametrize("case", ["pp1", "spec", "layers", "mesh"])
def test_pp_config_guards_raise_the_jax_errors(case):
    """Invalid pp configs fail at construction, before any world is
    needed, with the JAX engine's ValueError and message."""
    over, kw = {"pp1": (dict(pp=1), {}),
                "spec": (dict(pp=2, spec_lookahead=3), {}),
                "layers": (dict(pp=4), {}),  # tiny has 2 layers
                "mesh": (dict(pp=2), dict(mesh=2))}[case]
    with pytest.raises(ValueError) as jax_err:
        JaxPipelinedEngine(JaxEngineConfig(**ENGINE_CFG, **over), **kw)
    with pytest.raises(ValueError) as err:
        PipelinedEngine(EngineConfig(**ENGINE_CFG, **over, device="cpu"),
                        **kw)
    assert str(err.value) == str(jax_err.value)


def test_make_engine_dispatches_on_pp():
    engine = make_engine(EngineConfig(**ENGINE_CFG, device="cpu"))
    assert type(engine) is LLMEngine
    with pytest.raises(ValueError, match="spec_lookahead"):
        make_engine(EngineConfig(pp=2, spec_lookahead=2, **ENGINE_CFG,
                                 device="cpu"))
    # a valid pp engine is a collective of pp x tp ranks
    with pytest.raises(RuntimeError, match="initialised world of 2 ranks"):
        make_engine(EngineConfig(pp=2, **ENGINE_CFG, device="cpu"))
    cfg = EngineConfig(pp=2, **ENGINE_CFG, device="cpu")
    assert (cfg.pp_microbatches, cfg.pp_fetch_timeout_s) == (0, 60.0)


def test_stage_params_are_literal_slices_and_stages_chain(tiny_params):
    """Stage state dicts are the full one's tensors under the same names
    (layers split on their index, embed on stage 0, final norm and head
    on the last), the names of the StageModels; the stages chained give
    the full model's logits, bit for bit."""
    cfg = _cfg()
    stages = [stage_params(tiny_params, s, PP, cfg.num_layers)
              for s in range(PP)]
    assert sorted(stages[0]) == sorted(
        ["embed"] + [n for n in tiny_params if n.startswith("layers.0.")])
    assert sorted(stages[1]) == sorted(
        ["final_norm.scale", "lm_head.weight"]
        + [n for n in tiny_params if n.startswith("layers.1.")])
    for sd in stages:
        for n, t in sd.items():
            assert t is tiny_params[n]
    assert set(stages[0]) | set(stages[1]) == set(tiny_params)
    models = []
    for s, sd in enumerate(stages):
        with torch.device("meta"):
            m = StageModel(cfg, 1, offset=s, first=s == 0, last=s == PP - 1,
                           dtype=torch.float32, param_dtype=torch.float32)
        assert sorted(m.state_dict()) == sorted(sd)
        models.append(load_params(m, sd, "cpu"))
    ids = torch.from_numpy(np.asarray([PROMPTS["r1"]]))
    pos = torch.arange(ids.shape[1])[None]
    with torch.inference_mode():
        got = models[1](models[0](ids, pos), pos)
        want = build_model(cfg, tiny_params, "cpu", torch.float32)(ids)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_drive_marks_bracket_the_count_waves(tiny_params):
    """``drive(count_waves=(1, 2))`` marks "count_start" after wave 0 has
    run and before wave 1 is added, and "count_end" once wave 1 has run
    to the end, before wave 2."""
    engine = LLMEngine(EngineConfig(**ENGINE_CFG, device="cpu"),
                       params=tiny_params)
    seen = []
    engine.on_mark = seen.append
    add = engine.add_request

    def add_request(rid, *args):
        seen.append(rid)
        add(rid, *args)

    engine.add_request = add_request
    waves = [_wave({rid: PROMPTS[rid]}, 3) for rid in PROMPTS]
    out = entry.drive(engine, waves, count_waves=(1, 2))
    assert seen == ["r0", "count_start", "r1", "count_end", "r2"]
    assert all(len(t) == 3 for t in out["tokens"].values())


# --------------------------------------------------------- 2 gloo ranks
def test_pp2_greedy_tokens_identical_to_the_jax_single_engine(world):
    out = world.ranks[0][0]
    assert out["tokens"] == world.want
    assert set(out["finish"].values()) == {"length"}
    assert out["warmup_shapes"] == 3  # a prefill for cp 0 and full, decode
    stats = out["stats"]
    assert stats["pp"] == PP and stats["pp_ticks"] > 0
    assert stats["pp_microbatches"] == 2
    assert [r[0]["stage"] for r in world.ranks] == [0, 1]
    # the count window's marks reached both stages; on the CPU the
    # wrappers run their plain versions, which count no launch
    for r in world.ranks:
        assert r[0]["launches"] == {"paged_decode": 0, "flash_fwd_self": 0,
                                    "flash_fwd_ctx": 0}


def test_pp2_preemption_token_identical(world):
    """Page pressure mid-decode under pp: preempt, prefill again and go on,
    with each request's tokens those of the JAX engine serving it alone;
    every page but the dummy one returns."""
    out = world.ranks[0][1]
    assert out["stats"]["preempted_total"] >= 1
    assert out["tokens"] == world.solo
    assert out["free_pages"] == PREEMPT_CFG["num_pages"] - 1


def test_pp2_steady_decode_moves_only_activation_frames(world):
    """In steady decode every frame down the pipeline is a decode tick
    carrying [S, 1, H] float32 hidden states, and only token frames come
    back; the window's bubble counters are JAX's keys, every stage read,
    and 0 <= pp_bubble_frac <= 1."""
    out = world.ranks[0][2]
    steady = out["steady"]
    cfg = _cfg()
    assert steady["tokens"] > 0
    assert steady["kinds"] == {"decode": steady["frames"]}
    assert steady["activation_bytes"] == steady["frames"] * (
        ENGINE_CFG["max_batch"] * cfg.hidden_size * 4)
    assert steady["frames_home"] > 0
    stats = steady["pp_stats"]
    assert stats["pp"] == PP and stats["pp_microbatches"] == 4
    assert len(stats["per_stage"]) == PP
    assert all(s["reads"] > 0 for s in stats["per_stage"])
    assert stats["reads"] > 0
    assert 0.0 <= stats["pp_bubble_frac"] <= 1.0
    assert stats["per_stage"][0]["starved_reads"] == 0  # fed inline
    # depth raised to cover the fill + drain window
    assert out["pipeline_depth"] >= 4
