"""Tensor-parallel sharding for the Serve-LLM engine: the counterpart of
the JAX package's ``serve/llm/sharding.py`` over a torch ``DeviceMesh``
with a ``tp`` axis (``parallel.mesh.serve_mesh``).

What each tp rank holds (``models/llama.py``, ``MeshPlace``): Hq/tp q
heads and the Hkv/tp kv heads they read, F/tp of each MLP (and of each
expert), V/tp rows of the embedding and of ``lm_head``; and of the paged
KV pool ``[L, P, Hkv, page, 2*D]`` the Hkv/tp heads of EVERY page, so the
block tables (page ids) stay global: one host-side allocator drives all
shards, and continuous batching, prefix caching and preemption need no
shard-local bookkeeping.

The JAX engine is one process under GSPMD; torch has no such thing, so
the port's tp engine is one process per rank. Rank 0 owns the scheduler
(admission, the allocator, the prefix cache, deadlines, preemption,
drafting, the token fetch) and sends each dispatch to the other ranks as
a frame (``FrameChannel``): an opcode and the dispatch's host arrays,
pickled and broadcast over a gloo group beside the tp group, so frames
never touch the card's stream. The followers run the same dispatches in
the same order on their shard (``LLMEngine.follow``): they read no clock
and decide nothing, so the collectives inside the layers always meet
their partners. Each rank runs K1 and K2 on its own heads, where the JAX
tp engine runs its reference einsums under GSPMD.

Per-shard page accounting: splitting the Hkv axis divides each page's
bytes by tp, so a fixed per-card budget affords tp x the pages;
``page_accounting`` reports both views and ``pages_for_budget`` sizes
``num_pages`` from a per-card byte budget.
"""

from __future__ import annotations

import dataclasses
import datetime
import pickle
import time
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ...parallel.mesh import check_serve_mesh, serve_mesh
from ...parallel.sharding import shard_state_dict

# seconds a follower waits for rank 0's next frame before it raises: an
# idle server sends none, and a rank 0 that is gone is seen at once (its
# connection closes)
FOLLOW_TIMEOUT_S = 24 * 3600.0


@dataclasses.dataclass
class ServeSharding:
    """Resolved sharding context for one engine: the mesh and the tp
    degree. Which dims of each parameter tp splits is the train-side
    table's (``parallel.sharding``), applied by the model's layers."""

    mesh: Any                       # DeviceMesh
    tp: int

    def shard_params(self, params: Dict[str, torch.Tensor],
                     model_cfg) -> Dict[str, torch.Tensor]:
        """The rank's part of a full state dict (placed shard by shard)."""
        return shard_state_dict(params, model_cfg, self.mesh)

    # ------------------------------------------------------- validation

    def validate(self, model_cfg) -> None:
        """The Hkv axis of the page pool is the tp shard: it must divide
        evenly (a ragged head split would mis-tile every page), and so
        must the query heads feeding it."""
        _validate(model_cfg, self.tp)

    # ------------------------------------------------------- accounting

    def page_accounting(self, config, model_cfg) -> Dict[str, Any]:
        """Per-shard view of the page pool (the number operators size
        device memory against): sharding Hkv divides each page's bytes by
        tp."""
        itemsize = 2 if config.dtype == "bfloat16" else 4
        page_bytes = (model_cfg.num_layers * model_cfg.num_kv_heads
                      * config.page_size * 2 * model_cfg.head_dim_
                      * itemsize)
        return {
            "tp": self.tp,
            "kv_heads_per_shard": model_cfg.num_kv_heads // self.tp,
            "page_bytes_global": page_bytes,
            "page_bytes_per_shard": page_bytes // self.tp,
            "pool_bytes_per_shard": (page_bytes // self.tp
                                     * config.num_pages),
        }


def _validate(model_cfg, tp: int) -> None:
    if model_cfg.num_kv_heads % tp != 0:
        raise ValueError(
            f"num_kv_heads={model_cfg.num_kv_heads} is not divisible "
            f"by tp={tp}: the paged KV cache shards its Hkv axis "
            f"over tp, so tp must divide the kv head count (use tp in "
            f"{_divisors(model_cfg.num_kv_heads)})")
    if model_cfg.num_heads % tp != 0:
        raise ValueError(
            f"num_heads={model_cfg.num_heads} is not divisible by "
            f"tp={tp}: attention query heads shard over tp")


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def pages_for_budget(hbm_bytes_per_chip: int, page_size: int,
                     model_cfg, dtype_bytes: int = 2,
                     tp: int = 1) -> int:
    """num_pages affordable from a per-card KV byte budget: each card
    holds Hkv/tp heads of every page, so the budget buys tp x the pages
    one card could hold."""
    page_bytes = (model_cfg.num_layers * model_cfg.num_kv_heads
                  * page_size * 2 * model_cfg.head_dim_ * dtype_bytes)
    return max(1, hbm_bytes_per_chip * tp // page_bytes)


def resolve_serve_mesh(mesh=None, tp: int = 1,
                       device_type: Optional[str] = None,
                       model_cfg=None) -> Optional[ServeSharding]:
    """Normalize the engine's mesh input into a ServeSharding (or None
    for the single-device path). With ``model_cfg`` the degree is
    validated before any mesh is built.

    Accepts:
    - None with tp <= 1: single-device engine (no sharding machinery);
    - an int tp (or tp=): ``serve_mesh(tp)`` over the initialised world,
      which must have exactly tp ranks;
    - a ``DeviceMesh``: must carry a "tp" axis (``parallel.mesh.AXES``),
      every other axis 1; its tp extent is the shard degree. Unlike the
      JAX function, a one-rank mesh keeps the mesh path (frames, the
      tp-local layers and their collectives at tp 1).
    """
    if isinstance(mesh, int):  # LLMEngine(mesh=4) shorthand
        tp, mesh = mesh, None
    if mesh is None and tp <= 1:
        return None
    if mesh is None:
        if model_cfg is not None:
            _validate(model_cfg, tp)
        if not dist.is_initialized():
            raise RuntimeError(
                f"tp={tp} needs an initialised world of {tp} ranks "
                f"(parallel.distributed.init_process_group), one process "
                f"per rank")
        if dist.get_world_size() != tp:
            raise ValueError(f"tp={tp} needs a world of {tp} ranks, found "
                             f"{dist.get_world_size()}")
        mesh = serve_mesh(tp, device_type)
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh or int tp degree, got "
                        f"{type(mesh).__name__}")
    sharding = ServeSharding(mesh=mesh, tp=check_serve_mesh(mesh))
    if model_cfg is not None:
        sharding.validate(model_cfg)
    return sharding


class FrameChannel:
    """Rank 0's dispatches to the other ranks of a tp group: each frame
    is a pickled ``(opcode, args)`` broadcast from the group's first rank
    over a gloo group of the same ranks (two broadcasts: the length, then
    the bytes). Sending counts frames, bytes and host seconds. A follower
    whose source is gone raises from ``recv`` (gloo's connection closes),
    or after FOLLOW_TIMEOUT_S without a frame."""

    def __init__(self, ranks: Sequence[int]):
        ranks = sorted(ranks)
        self.group = dist.new_group(
            ranks, backend="gloo",
            timeout=datetime.timedelta(seconds=FOLLOW_TIMEOUT_S))
        self.src = ranks[0]
        self.is_source = dist.get_rank() == self.src
        self.frames = 0
        self.bytes = 0
        self.seconds = 0.0

    def send(self, op: str, *args) -> None:
        t0 = time.perf_counter()
        payload = pickle.dumps((op, args), protocol=pickle.HIGHEST_PROTOCOL)
        dist.broadcast(torch.tensor([len(payload)], dtype=torch.int64),
                       self.src, group=self.group)
        dist.broadcast(torch.frombuffer(bytearray(payload),
                                        dtype=torch.uint8),
                       self.src, group=self.group)
        self.frames += 1
        self.bytes += len(payload)
        self.seconds += time.perf_counter() - t0

    def recv(self) -> tuple:
        n = torch.empty(1, dtype=torch.int64)
        dist.broadcast(n, self.src, group=self.group)
        buf = torch.empty(int(n), dtype=torch.uint8)
        dist.broadcast(buf, self.src, group=self.group)
        return pickle.loads(buf.numpy().tobytes())

    def scatter(self, parts: Optional[List[torch.Tensor]],
                shape: Sequence[int]) -> torch.Tensor:
        """This rank's float32 CPU tensor of ``shape``: the source passes
        one part per rank, in rank order, the others None."""
        out = torch.empty(tuple(shape), dtype=torch.float32)
        dist.scatter(out, [p.float().contiguous() for p in parts]
                     if self.is_source else None, self.src,
                     group=self.group)
        return out
