"""Parity of ray_tpu_torch's sequence- and pipeline-parallel training with
the JAX package's.

Inputs are made from seeds with numpy; everything is float32. The JAX
side runs on the virtual CPU devices of ``tests/conftest.py`` (ring and
Ulysses attention under ``shard_map``, ``pipeline_apply`` and the
``PipelinedTrainer`` on a mesh of 4 devices, the dense trainer on one);
the port runs on 4 gloo CPU ranks, in one world
(``parallel.distributed.spawn`` of ``entry.in_turn``) that takes every
check in turn.

- Ring and Ulysses attention at sp 4 (and Ulysses at sp 2, whose 4 kv
  heads split over the ranks and are exchanged raw; tiny's 2 kv heads at
  sp 4 are repeated first), causal and not, GQA and packed segment ids
  whose documents cross the ranks' blocks: every rank's output block and
  its q/k/v gradients within 1e-5 of JAX's.
- ``pipeline_apply`` at pp 4 (4 microbatches, remat) and the one-stage
  bypass, against JAX's, and at one stage the GPipe loop itself (its
  one-rank shift, a copy, and broadcast): outputs and each stage's
  gradients within 1e-5.
- ``ShardedTrainer`` on tiny at sp 2 with ring attention x fsdp 2
  (remat "nothing": the recompute runs the ring again), with Ulysses x
  tp 2 and with ring x pp 2 (the work replicated over pp), and on
  tiny-moe at sp 2 with ring x fsdp 2 (rows of 128 tokens: the router
  term counted over sp, routing on a rank's block), against the JAX
  trainer on one device with dense attention
  (the JAX package's own sharded ring trainer test is an xfail): 3 steps
  with a loss mask that ends inside a rank's block, loss rtol 1e-5, grad
  norm rtol 1e-4, parameters after the steps 1e-5 absolute.
- The pipelined engine at pp 2 x tp 2 (``serve/llm/pp.py``): greedy
  tokens identical to the JAX single engine's.
- ``PipelinedTrainer`` on tiny at pp 2 x dp 2 (2 microbatches) against
  the JAX ``PipelinedTrainer`` on 4 devices from its own init (the
  staged tree carried across): ``eval_loss``, then 3 steps' loss and
  grad norm on every rank and every rank's parameters, under the same
  tolerances; and JAX's refusals, with its messages.
"""

import functools
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from ray_tpu.models.llama import LlamaModel as JaxLlama
from ray_tpu.models.llama import get_config as jax_config
from ray_tpu.ops import pipeline as jax_pipeline
from ray_tpu.ops.ring_attention import ring_attention as jax_ring
from ray_tpu.ops.ring_attention import ulysses_attention as jax_ulysses
from ray_tpu.ops.shard_map_compat import shard_map
from ray_tpu.parallel import mesh as jax_mesh
from ray_tpu.parallel import train_lib as jax_train
from ray_tpu.parallel.pp_train import PipelinedTrainer as JaxPipelinedTrainer
from ray_tpu.parallel.train_lib import TrainState
from ray_tpu.serve.llm import EngineConfig as JaxEngineConfig
from ray_tpu.serve.llm import LLMEngine as JaxLLMEngine
from ray_tpu.serve.llm import SamplingParams as JaxSamplingParams
from ray_tpu_torch.entry import (in_turn, ops_on_mesh, serve_on_mesh,
                                 train_on_mesh, train_pipelined_on_mesh)
from ray_tpu_torch.models.config import get_config
from ray_tpu_torch.models.convert import (flax_from_params, init_params,
                                          params_from_flax)
from ray_tpu_torch.models.llama import LlamaModel
from ray_tpu_torch.ops.pipeline import stack_to_stages
from ray_tpu_torch.parallel.distributed import spawn
from ray_tpu_torch.parallel.mesh import AXES
from ray_tpu_torch.parallel.pp_train import PipelinedTrainer

TOL = dict(rtol=1e-5, atol=1e-5)
WORLD = 4
DEADLINE_S = 120  # a world that hangs fails its tests, not the suite
F32 = dict(dtype="float32", param_dtype="float32", loss_chunk=8,
           remat=False)
OPT = dict(lr=1e-3, warmup=1, total_steps=10)

# name -> op, port mesh, sp, q heads, kv heads, causal, segment ids
ATTENTION = {
    "ring-causal-gqa-segments": ("ring", dict(sp=4, fsdp=1), 4, 4, 2, True,
                                 True),
    "ring-full": ("ring", dict(sp=4, fsdp=1), 4, 4, 4, False, False),
    # tiny's heads: 2 kv heads do not split over 4 ranks, repeated first
    "ulysses-repeat-first": ("ulysses", dict(sp=4, fsdp=1), 4, 4, 2, True,
                             True),
    # 4 kv heads split over 2 ranks: exchanged raw
    "ulysses-raw-kv": ("ulysses", dict(dp=2, sp=2, fsdp=1), 2, 8, 4, False,
                       True),
}
B, S, D = 2, 16, 16
# name -> port mesh, stages, layers, batch, width, microbatches
PIPELINES = {"gpipe": (dict(pp=4, fsdp=1), 4, 8, 8, 16, 4),
             "single-stage": (dict(pp=1, fsdp=4), 1, 4, 4, 8, 2)}
# name -> model, port mesh and model overrides of the ShardedTrainer runs
TRAINERS = {"ring-fsdp": ("tiny", dict(fsdp=2, sp=2),
                          dict(attention_impl="ring", remat=True,
                               remat_policy="nothing")),
            "ulysses-tp": ("tiny", dict(fsdp=1, tp=2, sp=2),
                           dict(attention_impl="ulysses")),
            # ShardedTrainer replicates its work over pp
            "ring-pp": ("tiny", dict(pp=2, fsdp=1, sp=2),
                        dict(attention_impl="ring")),
            # experts on a sequence split: rows of 128 tokens, so that a
            # rank's block (64) and tokens (2 x 64) are whole routing
            # groups of moe_group_size 64
            "moe-ring-fsdp": ("tiny-moe", dict(fsdp=2, sp=2),
                              dict(attention_impl="ring"))}
WIDTH = {"tiny": 16, "tiny-moe": 128}
PP_MESH = dict(pp=2, dp=2, fsdp=1)
# the pipelined engine at pp 2 x tp 2 (tests/test_llm_pp.py's :196 case;
# pp 2 alone is tests/test_torch_pp_serve.py's)
PP_SERVE_CFG = dict(model="tiny", page_size=8, num_pages=64,
                    max_model_len=128, max_batch=4,
                    prefill_buckets=(16, 32, 64, 128), dtype="float32",
                    model_overrides={"vocab_size": 512})
_rng = np.random.default_rng(1)
PP_SERVE_PROMPTS = {f"r{i}": [int(t) for t in _rng.integers(0, 500,
                                                             9 + 5 * i)]
                    for i in range(2)}


def _attention_inputs(name):
    _, _, _, hq, hkv, causal, segs = ATTENTION[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    case = {n: rng.normal(size=(B, S, h, D)).astype(np.float32)
            for n, h in (("q", hq), ("k", hkv), ("v", hkv), ("do", hq))}
    case["causal"] = causal
    if segs:
        # documents of 5, 6 and 5 tokens (and 3, 13): they cross the
        # ranks' blocks of 4 and 8
        case["segment_ids"] = np.stack([
            np.repeat(np.arange(3), [5, 6, 5]),
            np.repeat(np.arange(2), [3, 13])]).astype(np.int32)
    return case


def _pipeline_inputs(name):
    _, _, layers, batch, d, m = PIPELINES[name]
    rng = np.random.default_rng(len(name))
    return dict(w=(rng.normal(size=(layers, d, d)) * 0.3).astype(np.float32),
                x=rng.normal(size=(batch, d)).astype(np.float32),
                microbatches=m)


def _batches(cfg, seed=3, width=16):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        ids = rng.integers(0, cfg.vocab_size, (4, width)).astype(np.int32)
        # row 1's targets end inside sp block 0; row 2's inside block 1
        mask = np.ones((4, width), np.int32)
        mask[1, width * 5 // 16:] = 0
        mask[2, width * 11 // 16:] = 0
        out.append({"input_ids": ids, "loss_mask": mask})
    return out


def _trainer_inputs(model):
    """The seeded float32 parameters and the batches of ``model``'s
    trainer runs."""
    cfg = get_config(model, **F32)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            torch.float32), _batches(cfg, width=WIDTH[model])


@pytest.fixture(scope="module")
def jax_pp():
    """The JAX PipelinedTrainer at pp 2 x dp 2 and its initial state."""
    cfg = get_config("tiny", **F32)
    trainer = _jax_pp_trainer()
    return trainer, trainer.init(jax.random.PRNGKey(0), _batches(cfg)[0])


@pytest.fixture(scope="module")
def world(jax_pp):
    """Every port check, in one world of 4 gloo ranks; the pp run starts
    from the JAX PipelinedTrainer's initial tree."""
    cfg, sd0, batches = _trainer_inputs("tiny")
    # a copy: the JAX steps donate the state
    pp_params = jax.tree.map(np.array, jax_pp[1].params)
    cases = [{"op": ATTENTION[n][0], "mesh": ATTENTION[n][1],
              **_attention_inputs(n)} for n in ATTENTION]
    cases += [{"op": "pipeline", "mesh": PIPELINES[n][0],
               **_pipeline_inputs(n)} for n in PIPELINES]
    calls = [(ops_on_mesh, (cases,), {})]
    for model, mesh, over in TRAINERS.values():
        _, params, model_batches = _trainer_inputs(model)
        calls.append((train_on_mesh, (model, mesh, model_batches),
                      dict(overrides={**F32, **over}, optimizer=OPT,
                           gather=True,
                           params={k: v.numpy() for k, v in params.items()})))
    calls.append((train_pipelined_on_mesh, ("tiny", PP_MESH, batches),
                  dict(num_microbatches=2, overrides=F32, optimizer=OPT,
                       flax_params=pp_params)))
    serve_cfg = get_config("tiny", **PP_SERVE_CFG["model_overrides"])
    serve_params = init_params(serve_cfg, torch.Generator().manual_seed(0),
                               "cpu", torch.float32)
    calls.append((serve_on_mesh, ([{
        "engine": dict(PP_SERVE_CFG, pp=2, tp=2),
        "waves": [[(rid, p, {"max_tokens": 5}, None)
                   for rid, p in PP_SERVE_PROMPTS.items()]]}],),
        dict(params={k: v.numpy() for k, v in serve_params.items()},
             device="cpu")))
    ranks = spawn(in_turn, WORLD, "cpu", DEADLINE_S, args=(calls,))
    ops = [r[0] for r in ranks]
    return {"cfg": cfg, "batches": batches, "sd0": sd0,
            "pp_params": pp_params, "serve_params": serve_params,
            "attention": {n: [o[i] for o in ops]
                          for i, n in enumerate(ATTENTION)},
            "pipeline": {n: [o[len(ATTENTION) + i] for o in ops]
                         for i, n in enumerate(PIPELINES)},
            "trainers": {n: [r[1 + i] for r in ranks]
                         for i, n in enumerate(TRAINERS)},
            "pp": [r[-2] for r in ranks],
            "pp_serve": [r[-1][0] for r in ranks]}


# ------------------------------------------------------------ attention
def _jax_attention(name):
    op, _, sp, _, _, causal, _ = ATTENTION[name]
    case = _attention_inputs(name)
    mesh = Mesh(np.asarray(jax.devices()[:sp]), ("sp",))
    spec, seg_spec = P(None, "sp", None, None), P(None, "sp")
    fn = functools.partial(jax_ring if op == "ring" else jax_ulysses,
                           axis_name="sp", causal=causal)
    seg = case.get("segment_ids")
    if seg is None:
        sharded = shard_map(lambda q, k, v: fn(q, k, v), mesh=mesh,
                            in_specs=(spec,) * 3, out_specs=spec,
                            check_vma=False)
    else:
        inner = shard_map(lambda q, k, v, s: fn(q, k, v, segment_ids=s),
                          mesh=mesh, in_specs=(spec,) * 3 + (seg_spec,),
                          out_specs=spec, check_vma=False)

        def sharded(q, k, v):
            return inner(q, k, v, jnp.asarray(seg))

    @jax.jit
    def run(q, k, v, do):
        out, vjp = jax.vjp(lambda q, k, v: sharded(q, k, v), q, k, v)
        return out, vjp(do)

    out, grads = run(*(jnp.asarray(case[n]) for n in ("q", "k", "v", "do")))
    return sp, np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", list(ATTENTION))
def test_sequence_parallel_attention_matches_jax(world, name):
    sp, out, (dq, dk, dv) = _jax_attention(name)
    blk = S // sp
    for r, got in enumerate(world["attention"][name]):
        i = got["sp_rank"]
        cols = slice(i * blk, (i + 1) * blk)
        for what, want in (("out", out), ("dq", dq), ("dk", dk),
                           ("dv", dv)):
            np.testing.assert_allclose(got[what], want[:, cols], **TOL,
                                       err_msg=f"{what}, rank {r}")


# ------------------------------------------------------------- pipeline
def _jax_apply_layers(w_stack, x):
    def body(x, wi):
        return jnp.tanh(x @ wi), None

    return jax.lax.scan(body, x, w_stack)[0]


@pytest.mark.parametrize("name", list(PIPELINES))
def test_pipeline_apply_matches_jax(world, name):
    _, n_stages, layers, _, d, m = PIPELINES[name]
    case = _pipeline_inputs(name)
    mesh = jax_mesh.create_mesh(
        jax_mesh.MeshConfig(pp=n_stages, dp=1, fsdp=1, sp=1, ep=1, tp=1),
        devices=jax.devices()[:n_stages])
    w = jax_pipeline.stack_to_stages(jnp.asarray(case["w"]), n_stages)
    x = jnp.asarray(case["x"])

    def fwd(w):
        return jax_pipeline.pipeline_apply(_jax_apply_layers, w, x,
                                           mesh=mesh, num_microbatches=m)

    @jax.jit
    def run(w):
        out, vjp = jax.vjp(fwd, w)
        return out, vjp(2 * out)[0]  # the gradient of sum(out ** 2)

    out, grads = (np.asarray(a) for a in run(w))
    grads = grads.reshape(layers, d, d)
    per = layers // n_stages
    # at one stage the GPipe loop itself too (the one-rank shift and
    # broadcast), which pipeline_apply bypasses there as JAX's does
    prefixes = [""] + (["schedule_"] if n_stages == 1 else [])
    for r, got in enumerate(world["pipeline"][name]):
        s = got["stage"]
        for prefix in prefixes:
            np.testing.assert_allclose(got[f"{prefix}out"], out, **TOL,
                                       err_msg=f"{prefix}out, rank {r}")
            assert sorted(got[f"{prefix}grads"]) == sorted(
                f"layers.{l}.w" for l in range(s * per, (s + 1) * per))
            for n, g in got[f"{prefix}grads"].items():
                np.testing.assert_allclose(g, grads[int(n.split(".")[1])],
                                           **TOL,
                                           err_msg=f"{prefix}{n}, rank {r}")


def test_stack_to_stages_splits_a_state_dict_as_jax_splits_the_stack():
    sd = {f"layers.{l}.w": torch.full((2,), float(l)) for l in range(6)}
    sd["embed"] = torch.zeros(3)
    stages = stack_to_stages(sd, 3)
    for s, stage in enumerate(stages):
        assert sorted(stage) == sorted(["embed", f"layers.{2 * s}.w",
                                        f"layers.{2 * s + 1}.w"])
    with pytest.raises(ValueError, match="6 layers not divisible into 4"):
        stack_to_stages(sd, 4)
    with pytest.raises(ValueError, match="6 layers not divisible into 4"):
        jax_pipeline.stack_to_stages(jnp.zeros((6, 2)), 4)


# ------------------------------------------------------ sharded trainer
@pytest.fixture(scope="module")
def jax_dense_run(world):
    """Three steps of the JAX trainer on one device, dense attention, from
    the port's seeded parameters of a model: each step's loss and grad
    norm and the parameters after the steps (as a state dict); one run a
    model, on first use."""
    runs = {}

    def run(model):
        if model in runs:
            return runs[model]
        cfg, sd0, batches = _trainer_inputs(model)
        cfg_j = jax_config(model, **{**F32, "dtype": jnp.float32,
                                     "param_dtype": jnp.float32})
        mesh = jax_mesh.create_mesh(jax_mesh.MeshConfig(),
                                    devices=jax.devices()[:1])
        trainer = jax_train.ShardedTrainer(
            JaxLlama(cfg_j), mesh,
            optimizer=jax_train.default_optimizer(**OPT))
        params = flax_from_params(sd0, cfg)
        state = jax.device_put(
            TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=trainer.tx.init(params)),
            trainer.state_shardings(batches[0]))
        losses, norms = [], []
        for batch in batches:
            state, m = trainer.step(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        runs[model] = (losses, norms, params_from_flax(
            jax.tree.map(np.asarray, state.params), cfg))
        return runs[model]

    return run


@pytest.mark.parametrize("name", list(TRAINERS))
def test_sequence_parallel_trainer_matches_jax(world, jax_dense_run, name):
    model, mesh, _ = TRAINERS[name]
    losses, norms, final = jax_dense_run(model)
    ranks = world["trainers"][name]
    assert ranks[0]["mesh"] == {"pp": 1, "dp": 1, "ep": 1, "tp": 1,
                                "fsdp": 1, **mesh}
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["losses"], losses, rtol=1e-5,
                                   err_msg=f"losses, rank {r}")
        np.testing.assert_allclose(out["grad_norms"], norms, rtol=1e-4,
                                   err_msg=f"grad norms, rank {r}")
    for n, want in final.items():
        np.testing.assert_allclose(ranks[0]["params"][n], want.numpy(),
                                   atol=1e-5, err_msg=n)


# ---------------------------------------------------- pipelined trainer
def _jax_pp_trainer(mesh_devices=4, **over):
    cfg_j = jax_config("tiny", **{**F32, "dtype": jnp.float32,
                                  "param_dtype": jnp.float32, **over})
    mesh = jax_mesh.create_mesh(
        jax_mesh.MeshConfig(pp=2, dp=mesh_devices // 2, fsdp=1, sp=1, ep=1,
                            tp=1), devices=jax.devices()[:mesh_devices])
    return JaxPipelinedTrainer(JaxLlama(cfg_j), mesh, num_microbatches=2,
                               optimizer=jax_train.default_optimizer(**OPT))


@pytest.fixture(scope="module")
def jax_pp_run(world, jax_pp):
    trainer, state = jax_pp
    eval_loss = float(trainer.eval_loss(state, world["batches"][0]))
    losses, norms = [], []
    for batch in world["batches"]:
        state, m = trainer.step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    final = params_from_flax(jax.tree.map(np.asarray, state.params),
                             world["cfg"], num_stages=2)
    return eval_loss, losses, norms, stack_to_stages(final, 2)


def test_pipelined_trainer_matches_jax(world, jax_pp_run):
    eval_loss, losses, norms, stages = jax_pp_run
    for r, out in enumerate(world["pp"]):
        assert out["mesh"] == {"pp": 2, "dp": 2, "fsdp": 1, "sp": 1,
                               "ep": 1, "tp": 1}
        assert out["stage"] == r // 2  # pp is the outer axis
        np.testing.assert_allclose(out["eval_loss"], eval_loss, rtol=1e-5,
                                   err_msg=f"eval loss, rank {r}")
        np.testing.assert_allclose(out["losses"], losses, rtol=1e-5,
                                   err_msg=f"losses, rank {r}")
        np.testing.assert_allclose(out["grad_norms"], norms, rtol=1e-4,
                                   err_msg=f"grad norms, rank {r}")
        want = stages[out["stage"]]
        assert sorted(out["params"]) == sorted(want)
        for n, w in want.items():
            np.testing.assert_allclose(out["params"][n], w.numpy(),
                                       atol=1e-5, err_msg=f"{n}, rank {r}")


def test_pipelined_engine_at_pp2_tp2_matches_jax_single_engine(world):
    """The pipelined engine with tp 2 inside each of its 2 stages (4 gloo
    ranks: stage 0 on ranks 0-1, stage 1 on 2-3) gives the JAX single
    engine's greedy tokens on the same parameters; its page accounting
    is per tp shard."""
    engine_j = JaxLLMEngine(
        JaxEngineConfig(**PP_SERVE_CFG),
        params=jax.tree.map(jnp.asarray, flax_from_params(
            world["serve_params"],
            get_config("tiny", **PP_SERVE_CFG["model_overrides"]))))
    for rid, p in PP_SERVE_PROMPTS.items():
        engine_j.add_request(rid, p, JaxSamplingParams(max_tokens=5))
    want = {rid: [] for rid in PP_SERVE_PROMPTS}
    while engine_j.has_work():
        for d in engine_j.step():
            want[d.request_id].extend(int(t) for t in d.new_token_ids)
    out = world["pp_serve"]
    assert out[0]["tokens"] == want
    assert out[0]["stats"]["shard_degree"] == 2
    assert out[0]["stats"]["pp"] == 2
    assert [r["stage"] for r in out] == [0, 0, 1, 1]


def test_staged_tree_converts_both_ways(world):
    cfg = world["cfg"]
    full = params_from_flax(world["pp_params"], cfg, num_stages=2)
    back = flax_from_params(full, cfg, num_stages=2)
    jax.tree.map(np.testing.assert_array_equal, back, world["pp_params"])
    with pytest.raises(ValueError, match="has 2 stages, not 3"):
        params_from_flax(world["pp_params"], cfg, num_stages=3)


@pytest.mark.parametrize("over", [dict(num_experts=4), dict(num_layers=3),
                                  dict(scan_layers=False)])
def test_pipelined_trainer_refuses_what_jax_refuses(over):
    """MoE, layers that do not divide into stages, and an unscanned model
    are refused with the JAX trainer's messages (no process group is
    needed for the checks)."""
    with pytest.raises(ValueError) as jax_err:
        _jax_pp_trainer(mesh_devices=2, **over)
    mesh = types.SimpleNamespace(mesh_dim_names=AXES,
                                 shape=(2, 1, 1, 1, 1, 1))
    with torch.device("meta"):
        model = LlamaModel(get_config("tiny", **over))
    with pytest.raises(ValueError) as err:
        PipelinedTrainer(model, mesh)
    assert str(err.value) == str(jax_err.value)


def test_moe_groups_on_an_sp_split():
    """On sp > 1 a rank's sequence block must be a multiple of
    moe_group_size, so that its routing groups are the global batch's
    (JAX takes any split; ROADMAP queue 3)."""
    from ray_tpu_torch.models.llama import check_moe_groups

    cfg = get_config("tiny-moe")  # groups of 64
    with pytest.raises(ValueError, match="sequence block of 32"):
        check_moe_groups(cfg, 128, 1, sp=2, seq=32)
    check_moe_groups(cfg, 128, 1, sp=2, seq=64)
    check_moe_groups(cfg, 64, 1, sp=1, seq=32)  # one sp rank: global


def test_dense_attention_on_an_sp_mesh_is_refused():
    """A model whose attention is not ring or Ulysses is refused on sp >
    1: its dense attention would see the rank's block only (JAX's GSPMD
    gathers the sequence for it). ROADMAP queue 3."""
    from ray_tpu_torch.models.llama import check_mesh

    with pytest.raises(ValueError, match="attention_impl must be"):
        check_mesh(get_config("tiny"), {"sp": 2})
    for impl in ("ring", "ulysses"):
        check_mesh(get_config("tiny", attention_impl=impl), {"sp": 2,
                                                             "pp": 2})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        check_mesh(get_config("tiny"), {"pp": 2})
