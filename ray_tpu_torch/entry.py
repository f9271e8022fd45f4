"""Multi-rank dry run of the mesh trainer: the counterpart of the JAX
package's ``dryrun_multichip`` (``__graft_entry__.py``), on gloo CPU
ranks.

    python -c "from ray_tpu_torch.entry import dryrun_multichip; \
dryrun_multichip(4)"

``train_on_mesh`` is the body every rank runs: it builds the mesh, the
model and the ``ShardedTrainer`` and takes a step on each batch. Tests run
it through ``parallel.distributed.spawn`` against the JAX trainer.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .models.config import get_config
from .models.llama import LlamaModel
from .parallel.mesh import MeshConfig, batch_shard, create_mesh, mesh_sizes
from .parallel.sharding import gather_state_dict
from .parallel.train_lib import ShardedTrainer, default_optimizer


def train_on_mesh(model: str, mesh_config: Mapping[str, int],
                  batches: Sequence[Mapping[str, np.ndarray]], *,
                  overrides: Optional[Mapping[str, Any]] = None,
                  optimizer: Optional[Mapping[str, Any]] = None,
                  params: Optional[Mapping[str, np.ndarray]] = None,
                  seed: int = 0, gather: bool = False,
                  trace_routing: bool = False) -> Dict[str, Any]:
    """On each rank of an initialised world: the config ``model`` with
    ``overrides`` on ``create_mesh(MeshConfig(**mesh_config))``, trained by
    ``ShardedTrainer`` with ``default_optimizer(**optimizer)`` from
    ``params`` (a full state dict of arrays) or from ``init_params`` seeded
    with ``seed``, one step on each global batch.

    Returns the mesh's sizes and each step's global loss and grad norm;
    with ``gather`` the parameters after the steps, whole (rank 0 only);
    with ``trace_routing`` (a model with experts) the router terms of the
    first batch before any step and each layer's routing of the rank's
    rows, (expert, capacity slot) per token and choice as arrays [G, g,
    k]."""
    cfg = get_config(model, **(overrides or {}))
    mesh = create_mesh(MeshConfig(**mesh_config))
    with torch.device("meta"):
        net = LlamaModel(cfg, mesh=mesh)
    trainer = ShardedTrainer(net, mesh,
                             optimizer=default_optimizer(**(optimizer or {})))
    device = trainer.device
    generator = None
    if params is None:
        generator = torch.Generator(device).manual_seed(seed)
    else:
        params = {k: torch.from_numpy(np.asarray(v))
                  for k, v in params.items()}
    state = trainer.init(generator, batches[0], params=params)
    out: Dict[str, Any] = {"mesh": mesh_sizes(mesh)}
    if trace_routing:
        out.update(_trace_routing(trainer, mesh, batches[0]))
    losses, norms = [], []
    for batch in batches:
        state, metrics = trainer.step(state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    out.update(losses=losses, grad_norms=norms)
    if gather:
        full = gather_state_dict(state.params, cfg, mesh)
        if torch.distributed.get_rank() == 0:
            out["params"] = {k: v.cpu().numpy() for k, v in full.items()}
    return out


def _trace_routing(trainer, mesh, batch) -> Dict[str, Any]:
    """The router terms of ``batch`` and each MoE layer's routing of the
    rank's rows, from one forward without gradients."""
    model = trainer.model
    routing: List[Dict[str, np.ndarray]] = []

    def record(mod, args):
        _, _, _, idx, slot = mod.route(args[0])
        routing.append({"experts": idx.cpu().numpy(),
                        "slots": slot.cpu().numpy()})

    hooks = [layer.moe.register_forward_pre_hook(record)
             for layer in model.layers]
    ids = batch_shard(mesh, torch.as_tensor(np.asarray(
        batch["input_ids"])).to(trainer.device))
    targets = torch.cat([ids[:, 1:], ids[:, :1]], dim=1)
    try:
        with torch.no_grad():
            _, aux = model(ids, targets=targets, return_aux=True)
    finally:
        for hook in hooks:
            hook.remove()
    return {"router_terms": float(aux), "routing": routing}


def dryrun_multichip(n_devices: int, timeout_s: float = 300.0) -> None:
    """One training step of the dense tier (debug-sharded on dp x fsdp x
    tp) and of the MoE tier (tiny-moe on dp x fsdp x ep x tp) over
    ``n_devices`` gloo CPU ranks, with the JAX function's mesh arithmetic
    and sp fixed at 1; prints one line per tier. The JAX function's
    pipeline, tensor-parallel serving and two-host tiers are not run."""
    from .parallel.distributed import spawn

    # tp must divide the model's heads and widths (powers of two); any
    # leftover (odd) factor goes to dp, which only divides the batch
    tp = 2 if n_devices % 2 == 0 else 1
    rem = n_devices // tp
    fsdp = 1
    while rem % 2 == 0 and fsdp < 4:
        fsdp *= 2
        rem //= 2
    dp = rem
    rng = np.random.default_rng(0)
    cfg = get_config("debug-sharded")
    batch = {"input_ids": rng.integers(0, cfg.vocab_size,
                                       (2 * dp * fsdp, 32), dtype=np.int32)}
    mesh = dict(dp=dp, fsdp=fsdp, sp=1, tp=tp)
    out = spawn(train_on_mesh, n_devices, "cpu", timeout_s,
                args=("debug-sharded", mesh, [batch]),
                kwargs=dict(optimizer=dict(lr=1e-3)))[0]
    loss = out["losses"][0]
    assert np.isfinite(loss), f"non-finite loss {loss}"
    print(f"dryrun_multichip({n_devices}): mesh={out['mesh']} "
          f"loss={loss:.4f}")

    # expert parallelism: the experts split over ep, tokens gathered back
    ep = 2 if n_devices % 2 == 0 else 1
    rem = n_devices // ep
    moe_tp = 2 if rem % 2 == 0 else 1
    rem //= moe_tp
    moe_fsdp = 1
    while rem % 2 == 0 and moe_fsdp < 4:
        moe_fsdp *= 2
        rem //= 2
    moe_dp = rem
    moe_cfg = get_config("tiny-moe", num_experts=max(ep, 2))
    moe_batch = {"input_ids": rng.integers(
        0, moe_cfg.vocab_size, (2 * moe_dp * moe_fsdp, 64), dtype=np.int32)}
    moe_mesh = dict(dp=moe_dp, fsdp=moe_fsdp, sp=1, ep=ep, tp=moe_tp)
    out = spawn(train_on_mesh, n_devices, "cpu", timeout_s,
                args=("tiny-moe", moe_mesh, [moe_batch]),
                kwargs=dict(overrides=dict(num_experts=max(ep, 2)),
                            optimizer=dict(lr=1e-3), seed=1))[0]
    moe_loss = out["losses"][0]
    assert np.isfinite(moe_loss), f"non-finite MoE loss {moe_loss}"
    print(f"dryrun_multichip({n_devices}) MoE/ep: mesh={out['mesh']} "
          f"loss={moe_loss:.4f}")
    print(f"dryrun_multichip({n_devices}): the pipeline (pp), "
          f"tensor-parallel serving and two-host tiers are not run: they "
          f"wait for ROADMAP queue 1 items 7-9")
