"""Tensor-parallel serving in ray_tpu_torch, held to the JAX package's
engine.

The port's ``LLMEngine`` runs at tp 2 on worlds of two gloo CPU ranks
(``parallel.distributed.spawn`` of ``entry.serve_on_mesh``: rank 0 drives
each engine, rank 1 follows its frames). One world serves ``tiny`` (Hkv
2) in several engines in turn, one serves ``tiny-moe``; the JAX engine
runs in this process on one device. Everything is float32 and every
comparison is exact: greedy tokens, MoE experts and capacity slots, the
page accounting, each rank's decode carry against rank 0's.

The JAX reference is its legacy engine: its chunked, fused and
speculative modes give its legacy greedy tokens by its own contract, and
``tests/test_torch_engine*.py`` hold the port's one-device modes to the
JAX engine mode by mode.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.sharded_serve import ENGINE_CFG, parity_prompts
from ray_tpu.serve.llm import EngineConfig as JaxEngineConfig
from ray_tpu.serve.llm import LLMEngine as JaxLLMEngine
from ray_tpu.serve.llm import SamplingParams as JaxSamplingParams
from ray_tpu_torch import entry
from ray_tpu_torch.models.config import get_config
from ray_tpu_torch.models.convert import init_params, layer_leaves
from ray_tpu_torch.parallel.distributed import spawn
from ray_tpu_torch.parallel.mesh import check_serve_mesh
from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine
from ray_tpu_torch.serve.llm.sharding import pages_for_budget

TP = 2
DEADLINE_S = 120  # a world that hangs fails its test, not the suite
PATTERN = [5, 6, 7, 8] * 4  # repeats: speculative drafts are accepted
SHARED = [int(t) for t in np.random.default_rng(2).integers(0, 500, 24)]
PD_PROMPT = list(range(1, 30))
# request id -> (prompt, max_tokens)
PROMPTS = {**{f"g{i}": (p, 8) for i, p in enumerate(parity_prompts())},
           "pattern": (PATTERN, 16)}
MODES = {"legacy": {}, "chunked": dict(prefill_chunk_tokens=8),
         "fused": dict(decode_steps_per_dispatch=2, pipeline_depth=2),
         "spec": dict(spec_lookahead=4, pipeline_depth=1)}
MOE_ENGINE_CFG = dict(ENGINE_CFG, model="tiny-moe", model_overrides=dict(
    ENGINE_CFG["model_overrides"], capacity_factor=0.5))
MOE_MAX_TOKENS = {"g0": 3, "g1": 12, "g2": 8, "pattern": 16}


def _wave(prompts, **sampling):
    return [(rid, p, dict(max_tokens=n, **sampling), None)
            for rid, (p, n) in prompts.items()]


def _jax_serve(engine, prompts, **sampling):
    """{rid: tokens} of ``prompts`` ({rid: (prompt, max_tokens)}) through
    a JAX engine."""
    for rid, (p, n) in prompts.items():
        engine.add_request(rid, p, JaxSamplingParams(max_tokens=n,
                                                     **sampling))
    out = {rid: [] for rid in prompts}
    for _ in range(500):
        if not engine.has_work():
            return out
        for d in engine.step():
            out[d.request_id].extend(int(t) for t in d.new_token_ids)
    raise AssertionError(f"unfinished: {out}")


def _jax_inject(engine, blob):
    engine.inject_request("x", blob, JaxSamplingParams(max_tokens=8))
    out = []
    while engine.has_work():
        for d in engine.step():
            out.extend(int(t) for t in d.new_token_ids)
    return out


def _tiny_runs(jax_blob):
    """The tiny world's engines, in turn."""
    cfg = ENGINE_CFG
    runs = {f"mode_{m}": {"engine": dict(cfg, **kw), "waves": [_wave(PROMPTS)]}
            for m, kw in MODES.items()}
    # warmup() first and measure_prefill() last: frames like any dispatch
    runs["mode_legacy"].update(warmup=dict(prompt_buckets=(16,)),
                               measure_prefill=dict(seq_len=16, iters=2))
    runs["prefix"] = {"engine": cfg, "waves": [
        _wave({"a": (SHARED + [7], 4)}), _wave({"b": (SHARED + [7], 4)})]}
    runs["deadline"] = {"engine": cfg, "waves": [
        [("late", PROMPTS["g0"][0], dict(max_tokens=100), 0.3)],
        _wave({"g0": PROMPTS["g0"]})]}
    runs["pd_prefill"] = {"engine": cfg, "waves": [
        _wave({"pd": (PD_PROMPT, 8)}, prefill_only=True)]}
    runs["pd_port"] = {"engine": cfg,
                       "inject": [("pd2", "pd", dict(max_tokens=8))]}
    runs["pd_jax"] = {"engine": cfg,
                      "inject": [("pdj", jax_blob, dict(max_tokens=8))]}
    runs["serve_tier"] = entry.serve_tier_run()
    return runs


@pytest.fixture(scope="module")
def tiny_params():
    """Seeded float32 tiny parameters of the port, as a state dict."""
    cfg = get_config("tiny", **ENGINE_CFG["model_overrides"])
    return init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                       torch.float32)


@pytest.fixture(scope="module")
def tiny_world(tiny_params):
    """The JAX engine's references, and every run of the tiny world on
    each rank. After the world, the port's tp-2 blob goes into the JAX
    engine."""
    cfg = get_config("tiny", **ENGINE_CFG["model_overrides"])
    engine_j = JaxLLMEngine(JaxEngineConfig(**ENGINE_CFG),
                            params=_flax_tree(tiny_params, cfg))
    want = _jax_serve(engine_j, {**PROMPTS, "shared": (SHARED + [7], 4),
                                 "pd": (PD_PROMPT, 8)})
    _jax_serve(engine_j, {"pd": (PD_PROMPT, 8)}, prefill_only=True)
    jax_blob = engine_j.pop_extracted("pd")
    jax_blob = {**jax_blob, "kv": np.asarray(jax_blob["kv"])}
    runs = _tiny_runs(jax_blob)
    ranks = spawn(entry.serve_on_mesh, TP, "cpu", DEADLINE_S,
                  args=(list(runs.values()),),
                  kwargs=dict(params={k: v.numpy()
                                      for k, v in tiny_params.items()},
                              device="cpu"))
    by_run = [dict(zip(runs, r)) for r in ranks]
    port_blob = by_run[0]["pd_prefill"]["blobs"]["pd"]
    jax_from_port = _jax_inject(engine_j, port_blob)
    return types.SimpleNamespace(want=want, jax_blob=jax_blob, ranks=by_run,
                                 jax_from_port=jax_from_port,
                                 port_blob=port_blob)


@pytest.mark.parametrize("mode", list(MODES))
def test_tp2_greedy_tokens_identical_to_jax_engine(tiny_world, mode):
    out = tiny_world.ranks[0][f"mode_{mode}"]
    assert out["tokens"] == {rid: tiny_world.want[rid] for rid in PROMPTS}
    assert out["mesh"]["tp"] == TP
    if mode == "spec":
        assert out["stats"]["spec_drafted_total"] > 0
        assert out["stats"]["spec_accepted_total"] > 0


def test_tp2_warmup_measure_prefill_and_param_count(tiny_world,
                                                    tiny_params):
    """warmup() runs the JAX engine's count of shapes (a prefill for
    cp in {0, full}, the decode chunk) and leaves the tokens as they were
    (the legacy mode's test); measure_prefill counts the global parameters
    on every rank."""
    out = tiny_world.ranks[0]["mode_legacy"]
    assert out["warmup_shapes"] == 3
    assert out["measure_prefill"]["seq_len"] == 16
    for rank in tiny_world.ranks:
        assert rank["mode_legacy"]["param_count"] == sum(
            t.numel() for t in tiny_params.values())


def test_tp2_prefix_cache_hit_gives_the_same_tokens(tiny_world):
    out = tiny_world.ranks[0]["prefix"]
    assert out["tokens"]["a"] == out["tokens"]["b"] == \
        tiny_world.want["shared"]
    assert out["stats"]["cache_hits"] > 0


@pytest.mark.parametrize("way", ["port_to_port", "jax_to_port",
                                 "port_to_jax"])
def test_tp2_pd_handoff_gives_the_single_engine_tokens(tiny_world, way):
    """A blob holds every kv head whatever the tp that wrote it: prefill
    on one engine, decode on another, the tokens of one engine alone."""
    rank0, want = tiny_world.ranks[0], tiny_world.want["pd"]
    port_first = rank0["pd_prefill"]["tokens"]["pd"]
    assert port_first == want[:1]
    assert rank0["pd_prefill"]["finish"]["pd"] == "prefill_done"
    assert tiny_world.port_blob["kv"].shape[2] == 2  # every kv head
    if way == "port_to_port":
        got = port_first + rank0["pd_port"]["tokens"]["pd2"]
    elif way == "jax_to_port":
        got = [int(t) for t in tiny_world.jax_blob["output_ids"]] + \
            rank0["pd_jax"]["tokens"]["pdj"]
    else:
        got = port_first + tiny_world.jax_from_port
    assert got == want


def test_tp2_sharding_stats_equal_the_jax_tp2_engine(tiny_world,
                                                     tiny_params):
    """Through the virtual CPU devices of tests/conftest.py."""
    cfg = get_config("tiny", **ENGINE_CFG["model_overrides"])
    engine_j = JaxLLMEngine(JaxEngineConfig(**ENGINE_CFG, tp=TP),
                            params=_flax_tree(tiny_params, cfg))
    want = engine_j.stats()["sharding"]
    for name, out in tiny_world.ranks[0].items():
        if "stats" in out:
            assert out["stats"]["sharding"] == want, name
            assert out["stats"]["shard_degree"] == TP, name
    assert pages_for_budget(2**20, 8, cfg, 4, tp=2) == \
        2 * pages_for_budget(2**20, 8, cfg, 4)


def test_tp2_expired_deadline_returns_every_page_on_every_rank(tiny_world):
    """The deadline passes mid-decode on rank 0 alone; the ranks stay in
    step (the next request's tokens are right) and no page is held."""
    out = tiny_world.ranks[0]["deadline"]
    assert out["finish"]["late"] == "expired"
    assert 0 < len(out["tokens"]["late"]) < 100
    assert out["stats"]["expired_total"] == 1
    assert out["tokens"]["g0"] == tiny_world.want["g0"]
    for rank in tiny_world.ranks:
        assert rank["deadline"]["free_pages"] == ENGINE_CFG["num_pages"] - 1


def test_decode_carries_agree_across_ranks(tiny_world):
    for name, out in tiny_world.ranks[0].items():
        for r, rank in enumerate(tiny_world.ranks[1:], 1):
            np.testing.assert_array_equal(rank[name]["carry"], out["carry"],
                                          err_msg=f"{name}, rank {r}")


def test_dryrun_serve_tier(tiny_world):
    """The serve/tp tier of ``entry.dryrun_multichip``: its run, served in
    the tiny world."""
    line = entry.serve_tier_line(TP, tiny_world.ranks[0]["serve_tier"])
    assert line.startswith(
        "dryrun_multichip(2) serve/tp: mesh={'pp': 1, 'dp': 1, 'fsdp': 1, "
        "'sp': 1, 'ep': 1, 'tp': 2} greedy parity ok (24 tokens, 1 "
        "kv-heads/shard, page 2048B/shard)")


def test_parity_set_is_the_jax_package_s():
    assert entry.PARITY_ENGINE_CFG == ENGINE_CFG
    assert [list(map(int, p)) for p in entry.parity_prompts()] == \
        [list(map(int, p)) for p in parity_prompts()]


def test_tp4_on_tiny_is_refused_with_the_jax_message():
    with pytest.raises(ValueError) as port_err:
        LLMEngine(EngineConfig(**ENGINE_CFG, device="cpu", tp=4))
    with pytest.raises(ValueError) as jax_err:
        JaxLLMEngine(JaxEngineConfig(**ENGINE_CFG, tp=4))
    assert str(port_err.value) == str(jax_err.value)
    assert "num_kv_heads=2" in str(port_err.value) and "tp=4" in \
        str(port_err.value)


def test_serve_mesh_needs_a_tp_axis_and_nothing_else():
    with pytest.raises(ValueError, match="'tp' axis"):
        check_serve_mesh(types.SimpleNamespace(mesh_dim_names=("x",),
                                               shape=(2,)))
    with pytest.raises(ValueError, match="tp only"):
        check_serve_mesh(types.SimpleNamespace(
            mesh_dim_names=("dp", "tp"), shape=(2, 2)))
    assert check_serve_mesh(types.SimpleNamespace(
        mesh_dim_names=("dp", "tp"), shape=(1, 4))) == 4


def test_serve_on_mesh_and_entry_refuse_cuda_without_cuda():
    """Both default to the card: without CUDA they raise rather than run
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.serve_on_mesh([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()


def test_world_past_its_deadline_fails():
    """Rank 0 holds its engine for 30 s (it sleeps past a request's
    deadline) while rank 1 waits in follow(): the world is killed at its
    1 s deadline and the call fails."""
    run = {"engine": ENGINE_CFG, "seeded": True,
           "waves": [[("r", PD_PROMPT, dict(max_tokens=4), 30.0)]]}
    with pytest.raises(TimeoutError, match="had not finished after 1.0 s"):
        spawn(entry.serve_on_mesh, TP, "cpu", 1.0, args=([run],),
              kwargs=dict(device="cpu"))


# ------------------------------------------------------------ tiny-moe

def _flax_tree(sd, cfg):
    """A state dict as the JAX engine's Flax tree (layers stacked, dense
    kernels [in, out])."""
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


def _jax_routing(xg, router, cfg):
    """The JAX MoEMLP's routing lines (ray_tpu/models/llama.py:292-302):
    expert indices and capacity slots [G, g, k]."""
    logits = jnp.einsum("Gth,he->Gte", jnp.asarray(xg), jnp.asarray(router))
    probs = jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(probs, cfg.num_experts_per_tok)
    assigns = jax.nn.one_hot(idx, cfg.num_experts, dtype=jnp.int32).reshape(
        xg.shape[0], -1, cfg.num_experts)
    pos = ((jnp.cumsum(assigns, axis=1) - assigns) * assigns).sum(-1)
    return np.asarray(idx), np.asarray(pos).reshape(idx.shape)


def test_tp2_moe_tokens_and_routing_match_jax_engine():
    cfg = get_config("tiny-moe", **MOE_ENGINE_CFG["model_overrides"])
    sd = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                     torch.float32)
    engine_j = JaxLLMEngine(JaxEngineConfig(**MOE_ENGINE_CFG),
                            params=_flax_tree(sd, cfg))
    prompts = {rid: (p, MOE_MAX_TOKENS[rid]) for rid, (p, _) in
               PROMPTS.items()}
    want = _jax_serve(engine_j, prompts)
    run = {"engine": MOE_ENGINE_CFG, "waves": [_wave(prompts)],
           "routing": 4}
    ranks = spawn(entry.serve_on_mesh, TP, "cpu", DEADLINE_S, args=([run],),
                  kwargs=dict(params={k: v.numpy() for k, v in sd.items()},
                              device="cpu"))
    assert ranks[0][0]["tokens"] == want
    routing = ranks[0][0]["routing"]
    assert len(routing) == cfg.num_layers
    for layer, seen in enumerate(routing):
        router = sd[f"layers.{layer}.moe.router"].numpy()
        # the three prefill waves (buckets 16 and 32, two rows a wave),
        # then the first decode over the four slots
        assert len(seen) == 4
        for call, rec in enumerate(seen):
            idx, slot = _jax_routing(rec["groups"], router, cfg)
            np.testing.assert_array_equal(rec["experts"], idx,
                                          err_msg=f"layer {layer} {call}")
            np.testing.assert_array_equal(rec["slots"], slot,
                                          err_msg=f"layer {layer} {call}")
            for r, rank in enumerate(ranks[1:], 1):
                other = rank[0]["routing"][layer][call]
                for key in rec:
                    np.testing.assert_array_equal(other[key], rec[key],
                                                  err_msg=f"rank {r} {key}")
    for r, rank in enumerate(ranks[1:], 1):
        np.testing.assert_array_equal(rank[0]["carry"], ranks[0][0]["carry"],
                                      err_msg=f"rank {r}")
