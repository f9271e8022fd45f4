"""Parity of ray_tpu_torch's training path with the JAX package's.

Both sides start from the same float32 parameters (the JAX init, carried
across by ``params_from_flax``) and take the same numpy batches. On the
CPU the port's attention runs the plain versions of K2-K4. Tolerances
(float32; the two frameworks sum in different orders): nll 1e-5; the
trainer's loss rtol 1e-5 and grad norm rtol 1e-4 at every step, and the
parameters after three steps 1e-5 absolute; remat policies against no
remat 1e-6 (the same operations, recomputed).
"""

import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tpu.models.llama import LlamaModel as JaxLlama
from ray_tpu.models.llama import get_config as jax_config
from ray_tpu.parallel import train_lib as jax_train
from ray_tpu.parallel.mesh import MeshConfig, create_mesh
from ray_tpu_torch.models.config import get_config
from ray_tpu_torch.models.convert import (build_model, params_from_flax,
                                          train_state_from_flax)
from ray_tpu_torch.models.llama import LlamaModel, check_mesh
from ray_tpu_torch.parallel import train_lib
from ray_tpu_torch.parallel.mesh import MeshConfig as PortMeshConfig
from ray_tpu_torch.parallel.mesh import create_mesh as create_port_mesh


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs files in
    parallel workers, and tiny shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tiny in float32, with a loss chunk that splits the sequence unevenly
OVERRIDES = dict(dtype="float32", param_dtype="float32", loss_chunk=8)


def _batch(rng, cfg, b=2, s=19):
    ids = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, 12:] = 0
    return {"input_ids": ids, "loss_mask": mask}


def _jax_params(cfg_j, s=8):
    model = JaxLlama(cfg_j)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, s), jnp.int32))["params"]
    return model, nn.meta.unbox(params)


def _port_model(name, jax_params, train=True, **overrides):
    cfg = get_config(name, **{**OVERRIDES, **overrides})
    sd = params_from_flax(jax.tree.map(np.asarray, jax_params), cfg)
    return build_model(cfg, sd, "cpu", param_dtype=torch.float32,
                       train=train)


def test_fused_nll_matches_jax():
    cfg_j = jax_config("tiny", dtype=jnp.float32, loss_chunk=8)
    model_j, params = _jax_params(cfg_j)
    batch = _batch(np.random.default_rng(0), cfg_j)
    ids = batch["input_ids"]
    targets = np.roll(ids, -1, axis=1)
    want = jax.jit(lambda p: model_j.apply({"params": p}, jnp.asarray(ids),
                                           targets=jnp.asarray(targets)))(
        params)
    model = _port_model("tiny", params, train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(ids), targets=torch.from_numpy(targets))
        logits = model(torch.from_numpy(ids))
    assert got.shape == (2, 19) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the same nll as the unfused logits' cross-entropy
    dense = -torch.log_softmax(logits, -1).gather(
        -1, torch.from_numpy(targets).long()[..., None])[..., 0]
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-5)


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _loss_and_grads(model, batch):
    with _CountMatmuls() as count:
        loss = train_lib.ShardedTrainer._default_loss(model, batch)
        loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads, count.n


@pytest.mark.parametrize("policy", ["nothing", "names", "dots"])
def test_remat_policies_give_the_no_remat_loss_and_grads(policy):
    """Each policy recomputes and gives the no-remat loss and grads, and
    reruns only the matmuls its JAX counterpart does not save."""
    _, params = _jax_params(jax_config("tiny", dtype=jnp.float32))
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(np.random.default_rng(1),
                                get_config("tiny")).items()}
    base = _port_model("tiny", params, remat=False)
    loss0, grads0, mm0 = _loss_and_grads(base, batch)
    model = _port_model("tiny", params, remat=True, remat_policy=policy)
    calls = []
    for layer in model.layers:
        layer.attn.register_forward_pre_hook(lambda *a: calls.append(1))
    loss, grads, mm = _loss_and_grads(model, batch)
    assert abs(loss - loss0) <= 1e-6
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), grads0[name].numpy(),
                                   atol=1e-6, err_msg=name)
    assert len(calls) == 2 * model.cfg.num_layers  # forward + recompute
    # matmuls recomputed per layer; a recompute stops at the last tensor
    # the backward needs, so down_proj (whose output only feeds the
    # residual add) never reruns: "nothing" reruns qkv, o and gate_up;
    # "names" keeps attn_out (o_proj's product) and reruns qkv and
    # gate_up; "dots" keeps every product
    rerun = {"nothing": 3, "names": 2, "dots": 0}[policy]
    assert mm == mm0 + rerun * model.cfg.num_layers


def test_trainer_matches_jax_sharded_trainer_on_tiny():
    cfg_j = jax_config("tiny", dtype=jnp.float32, loss_chunk=8)
    mesh = create_mesh(MeshConfig(), devices=jax.devices()[:1])
    opt = dict(lr=1e-3, warmup=1, total_steps=10)
    trainer_j = jax_train.ShardedTrainer(
        JaxLlama(cfg_j), mesh, optimizer=jax_train.default_optimizer(**opt))
    rng = np.random.default_rng(2)
    batches = [_batch(rng, cfg_j) for _ in range(3)]
    state_j = trainer_j.init(jax.random.PRNGKey(0), batches[0])
    sd = params_from_flax(jax.tree.map(np.asarray, state_j.params),
                          get_config("tiny", **OVERRIDES))

    cfg = get_config("tiny", **OVERRIDES)
    with torch.device("meta"):
        model = LlamaModel(cfg)
    trainer = train_lib.ShardedTrainer(
        model, optimizer=train_lib.default_optimizer(**opt), device="cpu")
    state = trainer.init(None, batches[0], params=sd)
    assert state.params["embed"].dtype == torch.float32
    for i, batch in enumerate(batches):
        state_j, m_j = trainer_j.step(state_j, batch)
        state, m = trainer.step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]),
                                   rtol=1e-5, err_msg=f"loss, step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(m_j["grad_norm"]), rtol=1e-4,
                                   err_msg=f"grad norm, step {i}")
    assert state.step == 3 and state.opt_state["count"] == 3
    want = params_from_flax(jax.tree.map(np.asarray, state_j.params), cfg)
    for name, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(
        float(trainer.eval_loss(state, batches[0])),
        float(trainer_j.eval_loss(state_j, batches[0])), rtol=1e-5)


def test_trainer_step_at_head_dim_256_matches_jax_trainer():
    """One ShardedTrainer step at head dim 256 (Gemma's; tiny's 4 q heads
    then make a q width of 1024 beside a hidden size of 64) from the JAX
    trainer's init, on one batch: the loss (rtol 1e-5), the grad norm
    (rtol 1e-4) and every gradient agree with the JAX trainer's. The
    gradients are read from AdamW's first moment after the step, mu =
    0.1 g (g clipped), on both sides: rtol 1e-4, atol 1e-7 (float32 sums
    over the batch's 31 tokens in another order)."""
    cfg_j = jax_config("tiny", dtype=jnp.float32, loss_chunk=8,
                       head_dim=256)
    mesh = create_mesh(MeshConfig(), devices=jax.devices()[:1])
    opt = dict(lr=1e-3, warmup=0, total_steps=10)
    trainer_j = jax_train.ShardedTrainer(
        JaxLlama(cfg_j), mesh, optimizer=jax_train.default_optimizer(**opt))
    batch = _batch(np.random.default_rng(5), cfg_j)
    state_j = trainer_j.init(jax.random.PRNGKey(0), batch)
    cfg = get_config("tiny", **OVERRIDES, head_dim=256)
    sd = params_from_flax(jax.tree.map(np.asarray, state_j.params), cfg)
    with torch.device("meta"):
        model = LlamaModel(cfg)
    trainer = train_lib.ShardedTrainer(
        model, optimizer=train_lib.default_optimizer(**opt), device="cpu")
    state = trainer.init(None, batch, params=sd)
    assert state.params["layers.0.attn.qkv_proj.weight"].shape[0] == \
        (4 + 2 * 2) * 256
    state_j, m_j = trainer_j.step(state_j, batch)
    state, m = trainer.step(state, batch)
    np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(m_j["grad_norm"]), rtol=1e-4)
    want = train_state_from_flax(jax.tree.map(np.asarray, state_j),
                                 cfg).opt_state["mu"]
    mus = state.opt_state["mu"]  # in the order of the parameters
    assert len(mus) == len(state.params) == len(want)
    for name, mu in zip(state.params, mus):
        np.testing.assert_allclose(mu.numpy() / 0.1,
                                   want[name].numpy() / 0.1, rtol=1e-4,
                                   atol=1e-7, err_msg=name)


def test_schedule_matches_optax():
    import optax

    for warmup, total in ((0, 10), (1, 10), (3, 20), (5, 5)):
        mine = train_lib.default_optimizer(lr=2e-3, warmup=warmup,
                                           total_steps=total).schedule
        ref = optax.warmup_cosine_decay_schedule(
            0.0, 2e-3, warmup, max(total, warmup + 1), 2e-4)
        for count in range(total + 3):
            np.testing.assert_allclose(mine(count), float(ref(count)),
                                       rtol=1e-6, atol=1e-12)
    assert mine(0) == 0.0  # the first step of the default schedule


def test_trainer_loss_decreases_on_debug_sharded():
    """The single-device counterpart of the JAX package's sharded
    loss-decrease test: debug-sharded, bf16 compute over float32 params,
    10 steps of default_optimizer(lr=1e-3) on one batch."""
    cfg = get_config("debug-sharded")
    model = LlamaModel(cfg)
    trainer = train_lib.ShardedTrainer(
        model, optimizer=train_lib.default_optimizer(lr=1e-3), device="cpu")
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, cfg.vocab_size, (8, 33),
                                       dtype=np.int32)}
    state = trainer.init(torch.Generator().manual_seed(0), batch)
    assert model.embed.dtype == torch.float32
    assert model.layers[0].attn.qkv_proj.compute_dtype == torch.bfloat16
    losses = []
    for _ in range(10):
        state, metrics = trainer.step(state, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_trainer_refuses_a_mesh_and_moe():
    """sp and pp, once refused (ROADMAP item 9), are taken: create_mesh
    goes on to ask for a process group, and a model splits over sp when
    its attention is ring or Ulysses (tests/test_torch_sp_pp.py trains
    on such meshes). On sp a rank's batch is its block of the sequence,
    with targets cut from the whole rows (so they cross into the next
    block) and the weight of the global last position zero on the last
    sp rank only. An MoE model, once refused, now builds (its parity is
    tests/test_torch_moe.py's)."""
    for axis in ("sp", "pp"):
        with pytest.raises(RuntimeError, match="initialised process group"):
            create_port_mesh(PortMeshConfig(**{axis: 2}))
    with pytest.raises(ValueError, match="attention_impl must be"):
        check_mesh(get_config("tiny"), {"sp": 2, "tp": 1})
    check_mesh(get_config("tiny", attention_impl="ulysses"), {"sp": 2,
                                                              "pp": 2})

    class RankPlace:  # the sizes and place a DeviceMesh reports
        mesh_dim_names = ("pp", "dp", "fsdp", "sp", "ep", "tp")

        def __init__(self, sp_rank):
            self.sp_rank = sp_rank

        def size(self, dim):
            return 2 if self.mesh_dim_names[dim] == "sp" else 1

        def get_local_rank(self, axis):
            return self.sp_rank if axis == "sp" else 0

    rng = np.random.default_rng(2)
    batch = _batch(rng, get_config("tiny"), b=2, s=8)
    batch["loss_mask"][1, 3:] = 0  # row 1's targets end in sp block 0
    parts = [train_lib.ShardedTrainer._batch(
        types.SimpleNamespace(mesh=RankPlace(r), device="cpu"), batch)
        for r in range(2)]
    ids, mask = batch["input_ids"], batch["loss_mask"]
    want = {"input_ids": ids,
            "targets": np.concatenate([ids[:, 1:], ids[:, :1]], 1),
            "weights": np.concatenate([mask[:, 1:], 0 * mask[:, :1]], 1)}
    for key, value in want.items():
        got = torch.cat([p[key] for p in parts], dim=1)
        np.testing.assert_array_equal(got.numpy(), value, err_msg=key)
    assert parts[0]["weights"].dtype == torch.float32
    model = LlamaModel(get_config("tiny-moe"))
    assert all(hasattr(layer, "moe") and not hasattr(layer, "mlp")
               for layer in model.layers)
