"""Parity of ray_tpu_torch's mesh trainer with the JAX package's trainer.

The same float32 parameters (a seeded init laid out as the JAX tree,
carried across by ``params_from_flax``) and the same seeded numpy
batches go through the
JAX ``ShardedTrainer`` on one device and through the port's
``ShardedTrainer`` on a mesh of four gloo CPU ranks
(``parallel.distributed.spawn``: one world per mesh, every number of that
mesh computed in it and returned to the test). Three steps each.
Tolerances (float32; the frameworks and the ranks sum in different
orders): loss rtol 1e-5 and grad norm rtol 1e-4 at every step, on every
rank; the gathered parameters after three steps 1e-5 absolute; MoE
routing identical (expert and capacity slot of every token and choice)
and the router terms rtol 1e-5.

Meshes: debug-sharded (8 heads, 4 kv heads) on fsdp 2 x tp 2; tiny on
dp 2 x tp 2 (HSDP and tp) with a loss mask whose count differs between
the dp halves; tiny-moe on ep 2 x tp 2. Each world has a deadline, and
the ranks meet through a file store, never a port.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models.llama import LlamaModel as JaxLlama
from ray_tpu.models.llama import get_config as jax_config
from ray_tpu.parallel import mesh as jax_mesh
from ray_tpu.parallel import train_lib as jax_train
from ray_tpu.parallel.train_lib import TrainState
from ray_tpu_torch.entry import dryrun_multichip, train_on_mesh
from ray_tpu_torch.models.config import get_config
from ray_tpu_torch.models.convert import (init_params, layer_leaves,
                                          params_from_flax)
from ray_tpu_torch.models.llama import (MeshPlace, check_mesh,
                                        check_moe_groups)
from ray_tpu_torch.ops.flash_attention import _check_inputs
from ray_tpu_torch.parallel import mesh as port_mesh
from ray_tpu_torch.parallel.distributed import spawn
from ray_tpu_torch.parallel.sharding import (logical_axes, merge_tensor,
                                             shard_state_dict)

F32 = dict(dtype="float32", param_dtype="float32", loss_chunk=8)
OPT = dict(lr=1e-3, warmup=1, total_steps=10)
WORLD = 4
DEADLINE_S = 120  # a world that hangs fails its test, not the suite

# name -> mesh, global batch shape, whether a loss mask is given, remat
# policy on both sides (FSDP gathers a layer again in the recompute)
MESHES = {
    "debug-sharded": (dict(dp=1, fsdp=2, tp=2), (8, 33), False, "nothing"),
    "tiny": (dict(dp=2, fsdp=1, tp=2), (4, 17), True, "names"),
    "tiny-moe": (dict(dp=1, fsdp=1, ep=2, tp=2), (4, 64), False, None),
}


def _overrides(remat):
    return dict(F32, remat=remat is not None, remat_policy=remat or "nothing")


def _batches(cfg, shape, masked, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        batch = {"input_ids": rng.integers(0, cfg.vocab_size,
                                           shape).astype(np.int32)}
        if masked:
            # rows 0-1 are dp rank 0's, rows 2-3 dp rank 1's: of the 16
            # target positions a row, 16 + 10 count against 5 + 16
            mask = np.ones(shape, np.int32)
            mask[1, 11:] = 0
            mask[2, 6:] = 0
            batch["loss_mask"] = mask
        out.append(batch)
    return out


def _flax_tree(sd, cfg):
    """The inverse of ``params_from_flax``: a state dict as the JAX
    model's Flax tree (layers stacked, dense kernels [in, out])."""
    def leaf(t, transpose):
        return (t.T if transpose else t).numpy()

    tree = {"embed": leaf(sd["embed"], False),
            "final_norm": {"scale": leaf(sd["final_norm.scale"], False)},
            "lm_head": {"kernel": leaf(sd["lm_head.weight"], True)},
            "layers": {"layer": {}}}
    for path, (name, transpose) in layer_leaves(cfg).items():
        node = tree["layers"]["layer"]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack([leaf(sd[f"layers.{i}.{name}"], transpose)
                                   for i in range(cfg.num_layers)])
    return tree


def _jax_routing(x, router, cfg):
    """The JAX MoEMLP's routing (ray_tpu/models/llama.py:292-302) of a
    layer input x [B, S, h]: experts and capacity slots [G, g, k]."""
    T = x.shape[0] * x.shape[1]
    g = min(cfg.moe_group_size, T)
    xg = x.reshape(-1, g, x.shape[-1])
    probs = jax.nn.softmax(jnp.einsum("Gth,he->Gte", xg, router), axis=-1)
    _, idx = jax.lax.top_k(probs, cfg.num_experts_per_tok)
    assigns = jax.nn.one_hot(idx, cfg.num_experts, dtype=jnp.int32).reshape(
        xg.shape[0], -1, cfg.num_experts)
    pos = ((jnp.cumsum(assigns, axis=1) - assigns) * assigns).sum(-1)
    return np.asarray(idx), np.asarray(pos).reshape(idx.shape)


def _jax_moe_reference(name, params, ids):
    """Each layer's routing of ``ids`` and the sown router terms, from the
    unscanned JAX model (its intermediates are reachable) on the same
    parameters."""
    cfg_u = jax_config(name, dtype=jnp.float32, loss_chunk=8,
                       scan_layers=False)
    stacked = params["layers"]["layer"]
    unscanned = {k: v for k, v in params.items() if k != "layers"}
    for i in range(cfg_u.num_layers):
        unscanned[f"layer_{i}"] = jax.tree.map(lambda a, i=i: a[i], stacked)
    targets = np.roll(ids, -1, axis=1)
    _, state = jax.jit(lambda p: JaxLlama(cfg_u).apply(
        {"params": p}, ids, targets=targets,
        capture_intermediates=lambda mdl, _: mdl.name == "mlp_norm",
        mutable=["losses", "intermediates"]))(unscanned)
    routing = [_jax_routing(
        state["intermediates"][f"layer_{i}"]["mlp_norm"]["__call__"][0],
        stacked["moe"]["router"][i], cfg_u)
        for i in range(cfg_u.num_layers)]
    terms = sum(float(jnp.sum(leaf))
                for leaf in jax.tree.leaves(state["losses"]))
    return routing, terms


def _jax_trainer_run(name, batches, over):
    """Three steps of the JAX trainer on one device from seeded
    parameters (the port's init, whose distributions are Flax's: the JAX
    init would compile for nothing): the parameters as a Flax tree and as
    the port's state dict, each step's loss and grad norm, and the
    parameters after the steps."""
    cfg_j = jax_config(name, **{**over, "dtype": jnp.float32,
                                "param_dtype": jnp.float32})
    mesh = jax_mesh.create_mesh(jax_mesh.MeshConfig(),
                                devices=jax.devices()[:1])
    trainer = jax_train.ShardedTrainer(
        JaxLlama(cfg_j), mesh, optimizer=jax_train.default_optimizer(**OPT))
    cfg = get_config(name, **over)
    params = _flax_tree(init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu", torch.float32), cfg)
    # laid out as the step's outputs are, so that the step compiles once
    state = jax.device_put(
        TrainState(step=jnp.zeros((), jnp.int32), params=params,
                   opt_state=trainer.tx.init(params)),
        trainer.state_shardings(batches[0]))
    losses, norms = [], []
    for batch in batches:
        state, m = trainer.step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    final = params_from_flax(jax.tree.map(np.asarray, state.params), cfg)
    return params, params_from_flax(params, cfg), losses, norms, final


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_trainer_matches_jax_trainer(name):
    mesh, shape, masked, remat = MESHES[name]
    over = _overrides(remat)
    cfg = get_config(name, **over)
    batches = _batches(cfg, shape, masked)
    params_j, sd0, losses_j, norms_j, final_j = _jax_trainer_run(
        name, batches, over)
    moe = bool(cfg.num_experts)
    ranks = spawn(train_on_mesh, WORLD, "cpu", DEADLINE_S,
                  args=(name, mesh, batches),
                  kwargs=dict(overrides=over, optimizer=OPT, gather=True,
                              params={k: v.numpy() for k, v in sd0.items()},
                              trace_routing=moe))
    assert ranks[0]["mesh"] == {"pp": 1, "sp": 1, "ep": 1, **mesh}
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["losses"], losses_j, rtol=1e-5,
                                   err_msg=f"losses, rank {r}")
        np.testing.assert_allclose(out["grad_norms"], norms_j, rtol=1e-4,
                                   err_msg=f"grad norms, rank {r}")
    for n, want in final_j.items():
        np.testing.assert_allclose(ranks[0]["params"][n], want.numpy(),
                                   atol=1e-5, err_msg=n)
    if moe:
        routing_j, terms_j = _jax_moe_reference(
            name, params_j, batches[0]["input_ids"])
        for r, out in enumerate(ranks):
            np.testing.assert_allclose(out["router_terms"], terms_j,
                                       rtol=1e-5, err_msg=f"rank {r}")
            for layer, (got, (idx, pos)) in enumerate(zip(out["routing"],
                                                          routing_j)):
                np.testing.assert_array_equal(got["experts"], idx,
                                              err_msg=f"layer {layer}")
                np.testing.assert_array_equal(got["slots"], pos,
                                              err_msg=f"layer {layer}")


def test_mesh_config_resolution_matches_jax():
    """tests/test_model_parallel.py:14-19 and more, against the JAX
    function: the same sizes, and the same cases refused."""
    cases = [(dict(dp=2, fsdp=2, sp=1, tp=2), 8),
             (dict(dp=1, fsdp=-1, sp=1, tp=2), 8),
             (dict(dp=3, fsdp=1, sp=1, tp=1), 8),
             (dict(), 4), (dict(fsdp=1), 1), (dict(ep=2, tp=2), 8),
             (dict(dp=-1, fsdp=-1), 4), (dict(fsdp=2, tp=2), 8)]
    for kwargs, n in cases:
        try:
            want = jax_mesh.MeshConfig(**kwargs).resolved(n)
        except ValueError:
            with pytest.raises(ValueError):
                port_mesh.MeshConfig(**kwargs).resolved(n)
            continue
        assert port_mesh.MeshConfig(**kwargs).resolved(n) == want, kwargs
    assert port_mesh.AXES == jax_mesh.AXES


@pytest.mark.parametrize("name", ["tiny", "tiny-moe"])
def test_logical_axes_match_jax_partition_specs(name):
    """Each of the port's parameters carries the logical axes of its JAX
    leaf (``nn.get_partition_spec``), the scan axis dropped and a
    transposed kernel's axes reversed."""
    cfg_j = jax_config(name)
    abstract = jax.eval_shape(lambda: JaxLlama(cfg_j).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    spec = nn.get_partition_spec(abstract)["params"]
    cfg = get_config(name)
    want = {"embed": tuple(spec["embed"]),
            "final_norm.scale": tuple(spec["final_norm"]["scale"]),
            "lm_head.weight": tuple(spec["lm_head"]["kernel"])[::-1]}
    for path, (leaf, transpose) in layer_leaves(cfg).items():
        node = spec["layers"]["layer"]
        for key in path:
            node = node[key]
        axes = tuple(node)
        assert axes[0] == "layers"
        want[f"layers.0.{leaf}"] = axes[1:][::-1] if transpose else axes[1:]
    sd = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                     torch.float32)
    names = [n for n in sd if not n.startswith("layers.") or
             n.startswith("layers.0.")]
    assert sorted(names) == sorted(want)
    for n in names:
        assert logical_axes(n) == want[n], n
        assert len(logical_axes(n)) == sd[n].dim(), n


@pytest.mark.parametrize("name,mesh", [
    *((name, spec[0]) for name, spec in MESHES.items()),
    ("debug-sharded", dict())])  # one rank: the card's mesh
def test_shard_then_merge_gives_the_full_state(name, mesh):
    """Every rank's part (shard_state_dict) merged back (merge_tensor, the
    merge gather_state_dict makes after its collectives) is the full state
    dict, for every mesh of the tests and a one-rank mesh; a rank's fused
    qkv rows are its q heads, then its k and v heads."""
    cfg = get_config(name)
    tp, ep = mesh.get("tp", 1), mesh.get("ep", 1)
    full = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                       torch.float32)
    parts = {(t, e): shard_state_dict(full, cfg, MeshPlace(
        tp=tp, tp_rank=t, ep=ep, ep_rank=e)) for t in range(tp)
        for e in range(ep)}
    for k in full:
        merged = merge_tensor(k, {key: sd[k] for key, sd in parts.items()},
                              cfg, tp, ep)
        assert torch.equal(merged, full[k]), k
    hd, nq, nkv = cfg.head_dim_, cfg.num_heads, cfg.num_kv_heads
    qkv = full["layers.0.attn.qkv_proj.weight"]
    q, k, v = qkv.split([nq * hd, nkv * hd, nkv * hd])
    for t in range(tp):
        local = parts[t, 0]["layers.0.attn.qkv_proj.weight"]
        assert torch.equal(local, torch.cat([q.chunk(tp)[t], k.chunk(tp)[t],
                                             v.chunk(tp)[t]]))
        assert parts[t, 0]["embed"].shape[0] == cfg.vocab_size // tp


def test_unported_axes_and_unsplittable_models_are_refused():
    """sp and pp, once refused, are taken: create_mesh goes on to ask for
    a process group (tests/test_torch_sp_pp.py builds sp and pp meshes on
    4 ranks), and a model splits over them when its attention is ring or
    Ulysses (its dense attention would see a rank's sequence block only).
    Models that do not split are refused."""
    for axis in ("sp", "pp"):
        with pytest.raises(RuntimeError, match="initialised process group"):
            port_mesh.create_mesh(port_mesh.MeshConfig(**{axis: 2}))
    with pytest.raises(ValueError, match="attention_impl must be"):
        check_mesh(get_config("tiny"), {"sp": 2, "tp": 1})
    check_mesh(get_config("tiny", attention_impl="ring"), {"sp": 2, "tp": 2,
                                                           "pp": 2})
    # debug-sharded has 8 q heads and 4 kv heads: tp 8 splits the q heads
    # but not the kv heads
    with pytest.raises(ValueError, match="num_kv_heads=4"):
        check_mesh(get_config("debug-sharded"), {"tp": 8})
    check_mesh(get_config("debug-sharded"), {"tp": 4})
    with pytest.raises(ValueError, match="num_experts"):
        check_mesh(get_config("tiny-moe"), {"ep": 3})
    cfg = get_config("tiny-moe")  # groups of 64
    with pytest.raises(ValueError, match="routing groups"):
        check_moe_groups(cfg, 96, 2)
    check_moe_groups(cfg, 128, 2)
    check_moe_groups(cfg, 96, 1)  # one batch rank: the global groups


@pytest.mark.parametrize("name", ["debug-sharded", "llama-1b"])
def test_tp_local_qkv_views_meet_the_kernels_strides(name):
    """q, k and v are views of a rank's fused qkv_proj output: at each tp
    the tests and the card use they still meet the bf16 kernels' rule
    (16-byte aligned base, strides of 16 bytes)."""
    cfg = get_config(name)
    hd = cfg.head_dim_
    for tp in (1, 2):
        nq, nkv = cfg.num_heads // tp, cfg.num_kv_heads // tp
        out = torch.zeros(2, 16, (nq + 2 * nkv) * hd, dtype=torch.bfloat16)
        q, k, v = out.split([nq * hd, nkv * hd, nkv * hd], dim=-1)
        _check_inputs("flash_fwd", q.reshape(2, 16, nq, hd),
                      k.reshape(2, 16, nkv, hd), v.reshape(2, 16, nkv, hd))


def test_dryrun_multichip_prints_its_two_tiers(capsys):
    """The dense tier at sp 2 (ring attention), the MoE/ep tier, the
    pipeline tier and the serve/tp tier, and the two-host tier's line."""
    dryrun_multichip(WORLD, timeout_s=DEADLINE_S)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("dryrun_multichip(4): mesh={'pp': 1, 'dp': 1, "
                               "'fsdp': 1, 'sp': 2, 'ep': 1, 'tp': 2} loss=")
    assert lines[1].startswith("dryrun_multichip(4) MoE/ep: mesh={'pp': 1, "
                               "'dp': 1, 'fsdp': 1, 'sp': 1, 'ep': 2, "
                               "'tp': 2} loss=")
    assert lines[2].startswith("dryrun_multichip(4) PP: mesh={'pp': 2, "
                               "'dp': 2, 'fsdp': 1, 'sp': 1, 'ep': 1, "
                               "'tp': 1} loss=")
    assert lines[3].startswith("dryrun_multichip(4) serve/tp: mesh={'pp': 1, "
                               "'dp': 1, 'fsdp': 1, 'sp': 1, 'ep': 1, "
                               "'tp': 2} greedy parity ok")
    assert "two-host tier is not run" in lines[4]
    for line in lines[:3]:
        assert np.isfinite(float(line.rsplit("loss=", 1)[1]))


def test_active_mesh_is_the_ambient_mesh_of_its_thread():
    """``active_mesh`` nests and unwinds as JAX's; the trainer enters its
    mesh around each step."""
    outer, inner = object(), object()
    assert port_mesh.current_mesh() is None
    with port_mesh.active_mesh(outer):
        with port_mesh.active_mesh(inner) as got:
            assert got is inner and port_mesh.current_mesh() is inner
        assert port_mesh.current_mesh() is outer
    assert port_mesh.current_mesh() is None
