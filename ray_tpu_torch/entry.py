"""The entry points of the JAX package's ``__graft_entry__.py``:
``entry()``, a forward step of the Llama model on one device (the card
unless "cpu" is asked for), and the multi-rank dry run of the mesh
trainers and of the tensor-parallel engine (``dryrun_multichip``), on
gloo CPU ranks.

    python -c "from ray_tpu_torch.entry import dryrun_multichip; \
dryrun_multichip(8)"

``train_on_mesh``, ``train_pipelined_on_mesh``, ``resume_on_mesh`` and
``serve_on_mesh`` are the bodies every rank runs: the first two build the
mesh, the model and the ``ShardedTrainer`` (or the ``PipelinedTrainer``)
and take a step on each batch; the third also saves the state after all
but the last step and resumes it on other meshes; the last serves runs of
requests through a tp or a pp engine (rank 0 drives, the others
follow). Tests run them through ``parallel.distributed.spawn`` against
the JAX trainers and engine.
"""

from __future__ import annotations

import functools
import time
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from .models.config import get_config
from .models.llama import LlamaModel
from .models.convert import build_model, init_params, params_from_flax
from .ops.pipeline import stack_to_stages
from .parallel.mesh import (MeshConfig, batch_shard, create_mesh,
                            mesh_sizes, serve_mesh)
from .parallel.pp_train import PipelinedTrainer
from .parallel.sharding import gather_state_dict
from .parallel.train_lib import ShardedTrainer, default_optimizer
from .serve.llm import EngineConfig, LLMEngine, SamplingParams, make_engine

# the greedy parity contract of the JAX package's benchmarks/sharded_serve.py
# (ENGINE_CFG, parity_prompts), kept here: this package imports nothing of
# the JAX package or of benchmarks/
PARITY_ENGINE_CFG = dict(model="tiny", page_size=8, num_pages=64,
                         max_model_len=128, max_batch=4,
                         prefill_buckets=(16, 32, 64), dtype="float32",
                         model_overrides={"vocab_size": 512})


def parity_prompts() -> List[List[int]]:
    """The fixed prompt set of the greedy parity contract."""
    return [list(np.random.default_rng(s).integers(0, 500, n))
            for s, n in ((0, 13), (1, 9), (2, 21))]


def _refuse_missing_cuda(what: str, device) -> None:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what} device is 'cuda' but no CUDA device is "
                           "available (pass device='cpu' to run on the CPU)")


def entry(device: str = "cuda") -> Tuple[Callable, Tuple[Dict[str,
                                                              torch.Tensor],
                                                         torch.Tensor]]:
    """The single-device entry point, the counterpart of the JAX package's
    ``__graft_entry__.entry()``: returns ``(fn, (params, input_ids))``,
    where ``fn(params, input_ids)`` is a forward step of ``LlamaModel`` at
    ``get_config("llama-500m", vocab_size=8192, num_layers=8,
    max_seq_len=2048)`` and gives the logits [2, 256, 8192]. ``params`` is
    the model's state dict (float32, seeded init on ``device``), computed
    in bfloat16 (the config's dtype); ``input_ids`` [2, 256] come from
    ``np.random``. On the card the attention runs K2; ``fn`` given CPU
    parameters and ids runs the plain path on the CPU."""
    _refuse_missing_cuda("entry", device)
    cfg = get_config("llama-500m", vocab_size=8192, num_layers=8,
                     max_seq_len=2048)
    params = init_params(cfg, torch.Generator(device).manual_seed(0), device,
                         cfg.param_dtype)
    model = build_model(cfg, params, device, param_dtype=cfg.param_dtype)
    input_ids = torch.from_numpy(np.random.randint(
        0, cfg.vocab_size, (2, 256), dtype=np.int32)).to(device)

    def fwd(params, input_ids):
        with torch.inference_mode():
            return functional_call(model, params, (input_ids,))

    return fwd, (params, input_ids)


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


def train_pipelined_on_mesh(model: str, mesh_config: Mapping[str, int],
                            batches: Sequence[Mapping[str, np.ndarray]], *,
                            num_microbatches: int = 4,
                            overrides: Optional[Mapping[str, Any]] = None,
                            optimizer: Optional[Mapping[str, Any]] = None,
                            flax_params: Optional[Mapping] = None,
                            seed: int = 0) -> Dict[str, Any]:
    """On each rank of an initialised world: the config ``model`` with
    ``overrides`` on ``create_mesh(MeshConfig(**mesh_config))``, trained by
    ``PipelinedTrainer`` with ``default_optimizer(**optimizer)`` from
    ``flax_params`` (the JAX ``PipelinedTrainer``'s tree, layer leaves
    ``[S, L/S, ...]``) or from ``init_params`` seeded with ``seed``: the
    global loss of the first batch before any step (``eval_loss``), then
    one step on each global batch. Returns the mesh's sizes, the rank's
    stage, that loss, each step's loss and grad norm, and the rank's
    parameters after the steps (its stage and the replicated ones)."""
    cfg = get_config(model, **(overrides or {}))
    mesh = create_mesh(MeshConfig(**mesh_config))
    with torch.device("meta"):
        net = LlamaModel(cfg)
    trainer = PipelinedTrainer(net, mesh, num_microbatches=num_microbatches,
                               optimizer=default_optimizer(
                                   **(optimizer or {})))
    generator, state_dict = None, None
    if flax_params is None:
        generator = torch.Generator(trainer.device).manual_seed(seed)
    else:
        full = params_from_flax(flax_params, cfg,
                                num_stages=trainer.num_stages)
        state_dict = stack_to_stages(full, trainer.num_stages)[trainer.stage]
    state = trainer.init(generator, batches[0], state_dict)
    out: Dict[str, Any] = {"mesh": mesh_sizes(mesh), "stage": trainer.stage,
                           "eval_loss": float(trainer.eval_loss(state,
                                                                batches[0]))}
    losses, norms = [], []
    for batch in batches:
        state, metrics = trainer.step(state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    out.update(losses=losses, grad_norms=norms,
               params={k: v.detach().cpu().numpy()
                       for k, v in state.params.items()})
    return out


def _trainer_on(mesh_config: Mapping[str, int], model: str, pipelined: bool,
                overrides, optimizer, num_microbatches: int):
    """A fresh ShardedTrainer (or PipelinedTrainer) of config ``model`` on
    ``create_mesh(MeshConfig(**mesh_config))``."""
    cfg = get_config(model, **(overrides or {}))
    mesh = create_mesh(MeshConfig(**mesh_config))
    opt = default_optimizer(**(optimizer or {}))
    if pipelined:
        with torch.device("meta"):
            net = LlamaModel(cfg)
        return PipelinedTrainer(net, mesh, num_microbatches=num_microbatches,
                                optimizer=opt)
    with torch.device("meta"):
        net = LlamaModel(cfg, mesh=mesh)
    return ShardedTrainer(net, mesh, optimizer=opt)


def resume_on_mesh(model: str, mesh_config: Mapping[str, int],
                   batches: Sequence[Mapping[str, np.ndarray]], path: str,
                   *, targets: Sequence[Mapping[str, int]] = (),
                   pipelined: bool = False, num_microbatches: int = 2,
                   overrides: Optional[Mapping[str, Any]] = None,
                   optimizer: Optional[Mapping[str, Any]] = None,
                   params: Optional[Mapping[str, np.ndarray]] = None,
                   seed: int = 0) -> Dict[str, Any]:
    """On each rank of an initialised world: the config ``model`` on
    ``create_mesh(MeshConfig(**mesh_config))``, trained by
    ``ShardedTrainer`` (``PipelinedTrainer`` with ``pipelined``) from
    ``params`` (a full state dict of arrays) or a seeded init, one step on
    each batch but the last; the state is saved into the checkpoint
    directory ``path`` (``train.checkpoint.save_train_state``) and the
    last step taken (the uninterrupted run). Then for each mesh of
    ``targets`` a fresh trainer of the same kind on it loads the
    checkpoint and takes the last step.

    Returns the runs' last step, source first: its loss and grad norm on
    every rank, and on rank 0 the whole parameters after it; on rank 0
    also the checkpoint's metadata."""
    from .train.checkpoint import (full_train_state, load_train_state,
                                   save_train_state)

    def last_step(trainer, state):
        state, m = trainer.step(state, batches[-1])
        full = full_train_state(trainer, state)
        return {"mesh": mesh_sizes(trainer.mesh),
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "params": None if full is None else {
                    k: v.float().numpy() for k, v in full.params.items()}}

    make = functools.partial(_trainer_on, model=model, pipelined=pipelined,
                             overrides=overrides, optimizer=optimizer,
                             num_microbatches=num_microbatches)
    trainer = make(mesh_config)
    generator = None
    if params is None:
        generator = torch.Generator(trainer.device).manual_seed(seed)
    else:
        params = {k: torch.from_numpy(np.asarray(v))
                  for k, v in params.items()}
    if pipelined:
        state = trainer.init(generator, batches[0], params)
    else:
        state = trainer.init(generator, batches[0], params=params)
    for batch in batches[:-1]:
        state, _ = trainer.step(state, batch)
    meta = save_train_state(trainer, state, path)
    runs = [last_step(trainer, state)]
    for target in targets:
        fresh = make(target)
        runs.append(last_step(fresh, load_train_state(fresh, path)))
    return {"runs": runs, "metadata": meta}


def in_turn(calls: Sequence[Tuple[Callable, Sequence, Mapping]]) -> List:
    """On each rank of an initialised world: each ``(fn, args, kwargs)``
    of ``calls`` in turn (several bodies in one world); their results."""
    return [fn(*args, **kwargs) for fn, args, kwargs in calls]


def _tanh_layers(params: Mapping[str, torch.Tensor],
                 x: torch.Tensor) -> torch.Tensor:
    """A stack of ``tanh(x @ w)`` layers, ``params`` named
    ``layers.{l}.w``, applied in layer order."""
    for name in sorted(params, key=lambda n: int(n.split(".")[1])):
        x = torch.tanh(x @ params[name])
    return x


def ops_on_mesh(cases: Sequence[Mapping[str, Any]]) -> List[Dict[str, Any]]:
    """On each rank of an initialised world: each case on
    ``create_mesh(MeshConfig(**case["mesh"]))``, forward and backward, from
    global numpy inputs. An attention case (``op`` "ring" or "ulysses":
    ``q``, ``k``, ``v``, ``do``, ``causal``, optionally ``segment_ids``)
    runs ``ring_attention`` or ``ulysses_attention`` over the sp group on
    the rank's sequence blocks and returns its place on sp, the output
    block and the gradients of ``sum(out * do)`` in q, k and v. A
    pipeline case (``op`` "pipeline": stacked layers ``w`` [L, d, d],
    ``x`` [B, d], ``microbatches``) runs ``pipeline_apply`` of
    ``_tanh_layers`` over the pp group with the rank's stage of ``w``
    and returns its stage, the output and the gradients of
    ``sum(out ** 2)`` in its layers; at one stage also those of the
    GPipe loop itself, ``gpipe(_tanh_layers, 1, M)`` (``schedule``), which
    ``pipeline_apply`` bypasses there."""
    from .ops.pipeline import gpipe, pipeline_apply
    from .ops.ring_attention import ring_attention, ulysses_attention
    from .parallel.mesh import pp_stage, seq_columns

    results = []
    for case in cases:
        mesh = create_mesh(MeshConfig(**case["mesh"]))
        if case["op"] == "pipeline":
            stage, n_stages = pp_stage(mesh)
            group, m = mesh.get_group("pp"), case["microbatches"]
            x = torch.from_numpy(case["x"])
            runs = {"": functools.partial(pipeline_apply, group=group,
                                          num_microbatches=m)}
            if n_stages == 1:
                run = gpipe(_tanh_layers, 1, m, group)
                runs["schedule_"] = lambda fn, params, x: run(
                    params, x.reshape((m, -1) + x.shape[1:])).reshape(x.shape)
            result = {"stage": stage}
            for prefix, apply in runs.items():
                w = torch.from_numpy(case["w"])
                params = stack_to_stages({f"layers.{l}.w": w[l].clone()
                                          .requires_grad_()
                                          for l in range(w.shape[0])},
                                         n_stages)[stage]
                out = apply(_tanh_layers, params, x)
                (out ** 2).sum().backward()
                result.update({f"{prefix}out": out.detach().numpy(),
                               f"{prefix}grads": {k: p.grad.numpy()
                                                  for k, p in params.items()}})
            results.append(result)
            continue
        fn = ring_attention if case["op"] == "ring" else ulysses_attention
        q, k, v = (seq_columns(mesh, torch.from_numpy(case[n]))
                   .clone().requires_grad_() for n in "qkv")
        seg = case.get("segment_ids")
        if seg is not None:
            seg = seq_columns(mesh, torch.from_numpy(seg))
        out = fn(q, k, v, group=mesh.get_group("sp"), causal=case["causal"],
                 segment_ids=seg)
        (out * seq_columns(mesh, torch.from_numpy(case["do"]))).sum() \
            .backward()
        results.append({"sp_rank": mesh.get_local_rank("sp"),
                        "out": out.detach().numpy(),
                        **{f"d{n}": t.grad.numpy()
                           for n, t in zip("qkv", (q, k, v))}})
    return results


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


def serve_on_mesh(runs: Sequence[Mapping[str, Any]],
                  params: Optional[Mapping[str, np.ndarray]] = None,
                  device: str = "cuda") -> List[Dict[str, Any]]:
    """On each rank of an initialised world: each run of ``runs`` in turn
    through ``make_engine``: an ``LLMEngine`` on ``serve_mesh(world
    size)``, or with the engine's ``pp`` > 1 a ``PipelinedEngine`` over
    the world's pp x tp ranks; rank 0 drives it (``drive``, then
    ``steady_decode``) and closes it, the others ``follow()``. A run is a
    dict: ``engine`` (EngineConfig kwargs), ``seeded`` (a seeded init
    instead of ``params``, a full state dict of arrays), ``waves``,
    ``inject``, ``warmup``, ``measure_prefill`` and ``count_waves`` (as
    ``drive`` takes them), ``steady`` (``steady_decode``'s kwargs, run
    after the waves), ``single`` (rank 0 also serves the waves on a
    one-device engine from the same parameters), ``routing`` (record the
    first n routings of each MoE layer: its input groups, experts and
    capacity slots).

    Returns each run's result: on every rank the mesh's sizes (the stage
    under pp), the decode carry (none under pp), the free pages, the
    global parameter count, the routing and, with ``count_waves``, the
    serving kernels' launches on the rank in those waves; on rank 0 also
    ``drive``'s output, ``steady`` (and ``single_tokens``; under pp the
    engine's ``pp_stats()``, ``link_stats()`` and pipeline depth). A
    prefill_only request's blob is kept under its request id for later
    runs' ``inject``. The engines run on ``device``, the card unless
    "cpu" is asked for (on a world of gloo CPU ranks)."""
    _refuse_missing_cuda("serve_on_mesh", device)
    mesh = None
    blobs: Dict[str, Any] = {}
    results = []
    for run in runs:
        cfg = EngineConfig(**run["engine"], device=device)
        full = None if run.get("seeded") or params is None else {
            k: torch.from_numpy(np.asarray(v)) for k, v in params.items()}
        pipelined = int(cfg.pp) > 1
        if not pipelined and mesh is None:
            mesh = serve_mesh(dist.get_world_size(), device)
        engine = make_engine(cfg, params=full,
                             mesh=None if pipelined else mesh)
        routing = _record_routing(engine.model, run.get("routing", 0))
        window: Dict[str, Dict[str, int]] = {}
        engine.on_mark = lambda tag: window.__setitem__(
            tag, _kernel_launches(reset=tag == "count_start"))
        out: Dict[str, Any] = ({"stage": engine.stage} if pipelined
                               else {"mesh": mesh_sizes(mesh)})
        if dist.get_rank() == 0:
            try:
                out.update(drive(engine, run.get("waves", ()),
                                 run.get("inject", ()), blobs,
                                 warmup=run.get("warmup"),
                                 measure_prefill=run.get("measure_prefill"),
                                 count_waves=run.get("count_waves")))
                if run.get("steady"):
                    out["steady"] = steady_decode(engine, **run["steady"])
                if pipelined:
                    out.update(pp_stats=engine.pp_stats(),
                               links=engine.link_stats(),
                               pipeline_depth=engine.config.pipeline_depth)
            finally:
                engine.close()
            if run.get("single"):
                single = LLMEngine(cfg, params=full)
                out["single_tokens"] = drive(single, run.get("waves", ()),
                                             (), {})["tokens"]
        else:
            engine.follow()
        if engine.slot_ids is not None:
            out["carry"] = engine.slot_ids.cpu().numpy()
        out.update(free_pages=engine.allocator.num_free(),
                   param_count=engine.param_count(), routing=routing)
        if "count_end" in window:
            out["launches"] = window["count_end"]
        results.append(out)
        del engine
    return results


def _kernel_launches(reset: bool = False) -> Dict[str, int]:
    """The serving kernels' launch counters (K1; K2 on the self and the
    ctx part), set to 0 first with ``reset``."""
    from .ops.flash_attention import flash_attention
    from .ops.paged_attention import paged_attention_decode

    if reset:
        paged_attention_decode.launches = 0
        flash_attention.launches = flash_attention.segment_launches = 0
    return {"paged_decode": paged_attention_decode.launches,
            "flash_fwd_self": flash_attention.launches
            - flash_attention.segment_launches,
            "flash_fwd_ctx": flash_attention.segment_launches}


def fill_slots(engine: LLMEngine, prompts: Sequence[Sequence[int]],
               max_tokens: int) -> List[str]:
    """Add ``prompts`` as requests ``w0``, ``w1``, ... and step until
    every one has its first token and decodes; returns their ids."""
    rids = [f"w{i}" for i in range(len(prompts))]
    for rid, p in zip(rids, prompts):
        engine.add_request(rid, [int(t) for t in p],
                           SamplingParams(max_tokens=max_tokens))
    seen: set = set()
    for _ in range(10000):
        seen.update(d.request_id for d in engine.step() if d.new_token_ids)
        if len(seen) == len(rids) and all(r.decode_ready
                                          for r in engine.running):
            return rids
    raise RuntimeError("the requests did not all reach decode")


def decode_window(engine: LLMEngine, steps: int) -> Dict[str, Any]:
    """``steps`` engine steps, timed on the host between two waits for
    the device: their tokens, seconds, ms a step and tokens/s; on a
    pipelined engine also the frames rank 0 sent down the pipeline in
    them (count, kinds, bytes, activation bytes, host ms a step) and read
    back, and the window's ``pp_stats()``."""
    links = getattr(engine, "link_stats", None)
    if links is not None:
        engine.pp_stats(reset=True)
        before = links()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    t0 = time.perf_counter()
    toks = sum(len(d.new_token_ids) for _ in range(steps)
               for d in engine.step())
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    dt = time.perf_counter() - t0
    out = {"tokens": toks, "seconds": dt, "step_ms": dt / steps * 1e3,
           "tok_s": toks / dt}
    if links is not None:
        after = links()
        out.update({k: after[k] - before[k]
                    for k in ("frames", "bytes", "activation_bytes",
                              "frames_home")})
        out["kinds"] = {k: n - before["kinds"].get(k, 0)
                        for k, n in after["kinds"].items()
                        if n != before["kinds"].get(k, 0)}
        out["host_ms_per_step"] = (after["host_s"] - before["host_s"]) \
            / steps * 1e3
        out["pp_stats"] = engine.pp_stats()
    return out


def drain(engine: LLMEngine, rids: Sequence[str]) -> None:
    """Abort ``rids`` and step until the engine is idle."""
    for rid in rids:
        engine.abort(rid)
    while engine.has_work():
        engine.step()


def steady_decode(engine: LLMEngine, prompts: Sequence[Sequence[int]],
                  max_tokens: int, steps: int) -> Dict[str, Any]:
    """Steady decode: ``prompts`` decode together (``fill_slots``), then
    a ``decode_window`` of ``steps`` engine steps, whose result this
    returns; then the requests are aborted and the engine drained."""
    rids = fill_slots(engine, prompts, max_tokens)
    out = decode_window(engine, steps)
    drain(engine, rids)
    return out


def drive(engine: LLMEngine, waves=(), inject=(),
          blobs: Optional[Dict[str, Any]] = None,
          warmup: Optional[Mapping[str, Any]] = None,
          measure_prefill: Optional[Mapping[str, Any]] = None,
          count_waves: Optional[Tuple[int, int]] = None,
          max_steps: int = 2000) -> Dict[str, Any]:
    """Serve ``waves`` in turn, each a list of (request id, prompt,
    SamplingParams kwargs, deadline in seconds from now or None), every
    request of a wave finished before the next is added; ``inject`` are
    (request id, blob or the id of a blob in ``blobs``, SamplingParams
    kwargs) queued first. Once a request with a deadline has a token, the
    host sleeps past the deadline, so that it expires mid-decode.
    ``warmup`` and ``measure_prefill`` are kwargs of the engine's
    methods, run first and last (None: not run). ``count_waves`` (start,
    stop): the engine's marks "count_start" before wave ``start`` is
    added and "count_end" once waves ``start`` to ``stop - 1`` have run
    to the end (the engine drained).
    Returns each request's tokens and finish reason, the engine's stats
    and those calls' results; the blobs of prefill_only requests go into
    ``blobs`` and the output."""
    blobs = {} if blobs is None else blobs
    out: Dict[str, Any] = {}
    if warmup is not None:
        out["warmup_shapes"] = engine.warmup(**warmup)
    tokens: Dict[str, List[int]] = {}
    finish: Dict[str, str] = {}
    for rid, blob, sp in inject:
        engine.inject_request(rid, blobs[blob] if isinstance(blob, str)
                              else blob, SamplingParams(**sp))
        tokens[rid] = []
    start, stop = count_waves or (None, None)
    for i, wave in enumerate([[]] + list(waves), -1):
        if i == start:
            engine.mark("count_start")
        deadlines = {}
        for rid, prompt, sp, deadline_s in wave:
            deadline = None if deadline_s is None else time.time() + deadline_s
            engine.add_request(rid, prompt, SamplingParams(**sp), deadline)
            tokens[rid] = []
            if deadline is not None:
                deadlines[rid] = deadline
        for _ in range(max_steps):
            if set(tokens) <= set(finish):
                break
            for d in engine.step():
                tokens[d.request_id].extend(int(t) for t in d.new_token_ids)
                if d.finished:
                    finish[d.request_id] = d.finish_reason
            for rid in [r for r in deadlines if tokens[r]]:
                time.sleep(max(0.0, deadlines.pop(rid) - time.time()) + 0.01)
        else:
            raise RuntimeError(f"unfinished after {max_steps} steps: "
                               f"{sorted(set(tokens) - set(finish))}")
        if stop is not None and i == stop - 1:
            while engine.has_work():
                engine.step()
            engine.mark("count_end")
    while engine.has_work():
        engine.step()
    out_blobs = {rid: engine.pop_extracted(rid)
                 for rid, why in finish.items() if why == "prefill_done"}
    blobs.update(out_blobs)
    if measure_prefill is not None:
        out["measure_prefill"] = engine.measure_prefill(**measure_prefill)
    out.update(tokens=tokens, finish=finish, stats=engine.stats(),
               blobs=out_blobs)
    return out


def _record_routing(model, n: int) -> List[List[Dict[str, np.ndarray]]]:
    """Per MoE layer, a list that a forward pre-hook fills with the first
    ``n`` routings: the token groups [G, g, h] and the experts and
    capacity slots [G, g, k]."""
    if not n or not model.cfg.num_experts:
        return []
    routing: List[List[Dict[str, np.ndarray]]] = []
    for layer in model.layers:
        seen: List[Dict[str, np.ndarray]] = []
        routing.append(seen)

        def record(mod, args, seen=seen):
            if len(seen) < n:
                rows, _, _, idx, slot = mod.route(args[0])
                groups = rows[:-1].view(*idx.shape[:2], rows.shape[-1])
                seen.append({"groups": groups.float().cpu().numpy(),
                             "experts": idx.cpu().numpy(),
                             "slots": slot.cpu().numpy()})

        layer.moe.register_forward_pre_hook(record)
    return routing


def serve_tier_run() -> Dict[str, Any]:
    """The serve/tp tier's run: ``parity_prompts()`` greedily, 8 tokens
    each, through PARITY_ENGINE_CFG from a seeded init, on the mesh and on
    one device (``serve_on_mesh``)."""
    return {"engine": PARITY_ENGINE_CFG, "seeded": True, "single": True,
            "waves": [[(f"g{i}", p, {"max_tokens": 8}, None)
                       for i, p in enumerate(parity_prompts())]]}


def serve_tier_line(n_devices: int, out: Mapping[str, Any]) -> str:
    """The serve/tp tier's line from rank 0's result of
    ``serve_tier_run``; raises if the mesh's tokens differ from the one
    device's."""
    if out["tokens"] != out["single_tokens"]:
        raise AssertionError(f"tp={out['mesh']['tp']} greedy decode "
                             f"diverged from one device: {out['tokens']} "
                             f"!= {out['single_tokens']}")
    acct = out["stats"]["sharding"]
    n_toks = sum(len(v) for v in out["tokens"].values())
    return (f"dryrun_multichip({n_devices}) serve/tp: mesh={out['mesh']} "
            f"greedy parity ok ({n_toks} tokens, "
            f"{acct['kv_heads_per_shard']} kv-heads/shard, "
            f"page {acct['page_bytes_per_shard']}B/shard)")


def dryrun_multichip(n_devices: int, timeout_s: float = 300.0) -> None:
    """The JAX function's tiers over ``n_devices`` gloo CPU ranks, one
    line each: one training step of the dense tier (debug-sharded on dp x
    fsdp x sp x tp, ring attention over sp when sp > 1), of the MoE tier
    (tiny-moe on dp x fsdp x ep x tp) and of the pipeline tier (tiny in 2
    stages on pp 2 x dp, GPipe with 2 microbatches), with the JAX
    function's mesh arithmetic; and the serve/tp tier (greedy decode of
    the tp=2 engine on 2 of the ranks equals one device's, on
    ``parity_prompts``). The JAX function's two-host tier is not run."""
    from .parallel.distributed import spawn

    # tp/sp/fsdp must divide the model's hidden dims / sequence (powers
    # of two); any leftover (odd) factor goes to dp, which only divides
    # the batch
    tp = 2 if n_devices % 2 == 0 else 1
    sp = 2 if n_devices % 4 == 0 else 1  # exercises ring attention
    rem = n_devices // (tp * sp)
    fsdp = 1
    while rem % 2 == 0 and fsdp < 4:
        fsdp *= 2
        rem //= 2
    dp = rem
    rng = np.random.default_rng(0)
    cfg = get_config("debug-sharded")
    batch = {"input_ids": rng.integers(0, cfg.vocab_size,
                                       (2 * dp * fsdp, 32 * sp),
                                       dtype=np.int32)}
    mesh = dict(dp=dp, fsdp=fsdp, sp=sp, tp=tp)
    out = spawn(train_on_mesh, n_devices, "cpu", timeout_s,
                args=("debug-sharded", mesh, [batch]),
                kwargs=dict(optimizer=dict(lr=1e-3), overrides=dict(
                    attention_impl="ring" if sp > 1 else None)))[0]
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

    if n_devices % 2 == 0:
        # pipeline parallelism: tiny's 2 layers in 2 stages over pp, the
        # GPipe schedule of ring shifts
        pp, pp_dp = 2, n_devices // 2
        pp_cfg = get_config("tiny", remat=False)
        pp_batch = {"input_ids": rng.integers(
            0, pp_cfg.vocab_size, (2 * pp_dp, 32), dtype=np.int32)}
        out = spawn(train_pipelined_on_mesh, n_devices, "cpu", timeout_s,
                    args=("tiny", dict(pp=pp, dp=pp_dp, fsdp=1),
                          [pp_batch]),
                    kwargs=dict(num_microbatches=2, seed=2,
                                overrides=dict(remat=False),
                                optimizer=dict(lr=1e-3)))[0]
        pp_loss = out["losses"][0]
        assert np.isfinite(pp_loss), f"non-finite PP loss {pp_loss}"
        print(f"dryrun_multichip({n_devices}) PP: mesh={out['mesh']} "
              f"loss={pp_loss:.4f}")

        # tensor-parallel serving: greedy tokens of the tp engine equal
        # one device's (the JAX tier's contract)
        out = spawn(serve_on_mesh, 2, "cpu", timeout_s,
                    args=([serve_tier_run()],),
                    kwargs=dict(device="cpu"))[0][0]
        print(serve_tier_line(n_devices, out))
    print(f"dryrun_multichip({n_devices}): the two-host tier is not run: "
          f"it is out of the port (ROADMAP item 5)")
