"""Paged-KV continuous-batching LLM engine on PyTorch.

Counterpart of the JAX package's ``serve/llm/engine.py``: the host
scheduler is that engine's, line for line and under the same names, and
the jitted compute is replaced by eager PyTorch on one device behind three
compute seams, ``_compute_prefill``, ``_compute_verify`` and
``_compute_decode`` (the ``prefill``, ``verify`` and ``decode`` jits).

Device rules:
- the page pool ``[L, P, Hkv, page, 2*D]`` and the decode carry
  ``slot_ids`` stay on the device and are updated in place;
- inputs go up from pinned host memory without blocking; sampled tokens
  come back by a non-blocking copy into pinned memory plus a recorded
  CUDA event, which ``_fetch_tokens`` waits on at harvest; nothing inside
  a dispatch reads a device value on the host;
- ``EngineConfig.device`` defaults to ``"cuda"``; with no card the engine
  raises instead of falling back to the CPU, and a CUDA engine refuses at
  construction a head dim its kernels lack (K1 and K2 take 16, 32, 64,
  96, 128 and 256).

Scheduling, as in the JAX engine:
- legacy (``prefill_chunk_tokens == 0``): admit and prefill whole prompts
  first in strict FIFO order, then fill the pipeline with fused decode
  chunks, then harvest the oldest dispatch;
- token budget (``prefill_chunk_tokens > 0``, scheduler v2): decode first,
  then at most one prefill dispatch of at most the budgeted prompt tokens
  (chunk k > 0 of a long prompt attends to the pages chunks 0..k-1 wrote
  through K2's cached-prefix part), then harvest down to the pipeline
  depth; admission looks past a page-blocked queue head for requests
  whose prefix is cached (bounded by ``_HEAD_OVERTAKE_CAP``);
- ``spec_lookahead > 0``: prompt-lookup speculative decoding, greedy only
  and bit-exact with plain greedy: one prefill-shaped dispatch verifies a
  draft with the argmax at every position taken on the device.

Also ported: request deadlines (``add_request(deadline=)``, pruning with
the typed ``"expired"`` delta), the P/D KV handoff (``prefill_only``,
``extract_kv``, ``pop_extracted``, ``release_request``,
``inject_request``; a blob of either package injects into the other),
``warmup`` and ``measure_prefill``.

Tensor parallelism (``EngineConfig.tp``, or ``LLMEngine(mesh=)``): one
process per tp rank (``serve/llm/sharding.py``). Every rank builds the
engine; rank 0 runs the scheduler and calls ``step()``, the other ranks
call ``follow()``, which runs rank 0's dispatches, sent as frames, on
their shard until rank 0's ``close()``. The weights and the pool
``[L, P, Hkv/tp, page, 2*D]`` are split over tp, the block tables stay
global, the logits are gathered over tp before the sampler, and every
rank samples with the same (request, seed, count) keys, so every rank's
decode carry holds the same tokens. A P/D blob holds every kv head
whatever the tp of the engine that wrote it. Pipeline parallelism
(``EngineConfig.pp``) is ``serve/llm/pp.py``'s ``PipelinedEngine``, a
subclass that rebinds the compute seams (``make_engine`` picks it).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ...models.config import get_config, torch_dtype
from ...models.convert import build_model, init_params
from ...models.llama import PagedCache
from ...ops.collectives import gather_from
from ...ops.paged_attention import check_kernel_head_dim
from ...parallel.sharding import split_dims
from .cache import OutOfPages, PageAllocator
from .sharding import FrameChannel, resolve_serve_mesh

WAITING, RUNNING, FINISHED = "WAITING", "RUNNING", "FINISHED"


@dataclasses.dataclass
class SamplingParams:
    max_tokens: int = 64
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0            # 0 => full vocab; bounded by 64
    stop_token_ids: tuple = ()
    seed: Optional[int] = None  # None => engine-level seed
    # disaggregation: stop after the first token and stash the request's
    # KV blob for pop_extracted() (gathered inside step(), on the driver
    # thread)
    prefill_only: bool = False


@dataclasses.dataclass
class Request:
    request_id: str
    prompt_ids: List[int]
    sampling: SamplingParams
    state: str = WAITING
    pages: List[int] = dataclasses.field(default_factory=list)
    n_cached: int = 0            # tokens restored from the prefix cache
    output_ids: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None
    last_page_hash: Optional[int] = None
    n_hashed: int = 0            # tokens already entered into prefix cache
    arrival_t: float = dataclasses.field(default_factory=time.monotonic)
    dispatched_t: Optional[float] = None  # first prefill dispatch (TTFT
                                          # queue/prefill split)
    # absolute expiry in the time.monotonic() domain (converted from the
    # wall-clock deadline at add_request)
    deadline_mono: Optional[float] = None
    slot: int = -1               # decode slot while RUNNING
    planned_out: int = 0         # tokens dispatched (>= len(output_ids))
    decode_ready: bool = False   # prefill harvested; slot may decode
    # prompt tokens whose KV is dispatched into pages (cache-restored +
    # prefilled chunks); < len(prompt_ids) while a chunked prefill runs
    n_prefilled: int = 0
    # a speculative verify dispatch is in flight for this slot: verify
    # does not update the device carry, so no other decode dispatch may
    # touch the slot until the harvest resolves acceptance
    spec_inflight: bool = False

    @property
    def total_len(self) -> int:
        return len(self.prompt_ids) + len(self.output_ids)


def _cap_total(req: Request, max_model_len: int) -> int:
    """Hard ceiling on a request's cache-visible length: decode clamps
    positions and totals below it, so a chunk running past the stop never
    indexes past the allocated block-table range."""
    return min(len(req.prompt_ids) + req.sampling.max_tokens + 1,
               max_model_len)


@dataclasses.dataclass
class OutputDelta:
    request_id: str
    new_token_ids: List[int]
    finished: bool
    finish_reason: Optional[str] = None


@dataclasses.dataclass
class EngineConfig:
    model: str = "tiny"
    model_overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)
    page_size: int = 16
    num_pages: int = 256
    max_model_len: int = 512
    max_batch: int = 8
    prefill_buckets: tuple = (32, 64, 128, 256, 512)
    eos_token_id: Optional[int] = None
    seed: int = 0
    dtype: str = "bfloat16"
    # decode steps fused into ONE dispatch; a request may compute up to
    # K-1 tokens past its stop condition (dropped at harvest)
    decode_steps_per_dispatch: int = 1
    # decode dispatches kept in flight ahead of the harvest point
    pipeline_depth: int = 2
    # rows per prefill dispatch (a burst prefills in waves of this many).
    # None => max_batch // 2
    prefill_wave_size: Optional[int] = None
    # token-budget scheduling: >0 caps each step's prefill work at this
    # many prompt tokens (rounded up to a page multiple, clamped to the
    # largest bucket) and runs it AFTER the running slots' fused decode;
    # 0 = legacy prefill-priority scheduling (whole prompts first)
    prefill_chunk_tokens: int = 0
    # prompt-lookup speculative decoding: >0 drafts up to this many
    # tokens per idle greedy slot from its own prompt+output n-grams and
    # verifies the draft in ONE prefill-shaped dispatch. 0 = off
    spec_lookahead: int = 0
    # "cuda" (default) or "cpu"; a cuda engine with no card raises
    device: str = "cuda"
    # tensor-parallel degree: > 1 splits the weights and the pool's Hkv
    # axis over serve_mesh(tp) of the initialised world, one process per
    # rank (serve/llm/sharding.py). 1 = single-device engine. An explicit
    # mesh passed to LLMEngine(mesh=...) overrides this degree. Under pp,
    # the degree inside each stage.
    tp: int = 1
    # pipeline parallelism (serve/llm/pp.py PipelinedEngine, make_engine):
    # > 1 splits the layer stack into pp stages, one process (a tp group)
    # each, on a world of pp x tp ranks; rank 0 keeps the scheduler and
    # only the compute seams change. pp must divide num_layers.
    pp: int = 1
    # decode slot groups under pp: the microbatches that keep the stages
    # busy (a slot's next input token is its previous tick's output, so
    # one group's ticks never overlap; different groups' do). 0 =>
    # max(2, 2*(pp-1)), the fill + drain bound. Ignored when pp == 1.
    pp_microbatches: int = 0
    # bound on one pipelined token fetch on rank 0; past it the fetch
    # raises TimeoutError. Ignored when pp == 1.
    pp_fetch_timeout_s: float = 60.0

    def __post_init__(self):
        if self.tp < 1:
            raise ValueError(f"EngineConfig.tp={self.tp!r}: must be >= 1")
        if self.pp < 1:
            raise ValueError(f"EngineConfig.pp={self.pp!r}: must be >= 1")


_MAX_TOP_K = 64


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds the largest bucket {buckets[-1]}")


def _kv_from_blob(handoff: Dict[str, Any]) -> torch.Tensor:
    """A blob's ``kv`` as a CPU tensor. A JAX bf16 blob (a numpy array of
    ``ml_dtypes.bfloat16``) is reinterpreted bit for bit, without
    importing ml_dtypes; float32 comes as is (the port's bf16 blob holds
    bf16 values widened, which the pool's cast rounds back exactly)."""
    arr = np.array(handoff["kv"])  # a writable copy (blobs may be views)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class LLMEngine:
    """The engine. Not thread-safe except `add_request`/`abort`/
    `inject_request`/`pop_extracted` (which only touch state under the
    intake lock); one thread calls `step()`.

    params: a full state dict (e.g. from ``models.convert.params_from_flax``;
    a tp engine keeps its rank's part) or None for a seeded random init
    made on the device (a tp rank draws each tensor whole and keeps its
    part, so it holds a slice of the one-device engine's weights). mesh:
    None, an int tp degree or a ``DeviceMesh`` with a tp axis
    (``serve/llm/sharding.py``, ``resolve_serve_mesh``); on a mesh every
    rank constructs the engine, rank 0 drives it and the others
    ``follow()``."""

    # each rank's hook for ``mark``: called with the mark's tag
    on_mark: Optional[Callable[[str], None]] = None

    def __init__(self, config: EngineConfig,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 mesh=None):
        self.config = config
        self._build_compute(params, mesh)
        self.max_pages_per_seq = config.max_model_len // config.page_size
        self.allocator = PageAllocator(
            config.num_pages, config.page_size,
            shard_degree=(self.sharding.tp if self.sharding else 1))
        self._init_host_state()

    def _build_compute(self, params, mesh) -> None:
        config = self.config
        self.device = torch.device(config.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "EngineConfig.device is 'cuda' but no CUDA device is "
                "available (pass device='cpu' to run on the CPU)")
        dtype = torch_dtype(config.dtype)
        self.model_cfg = get_config(
            config.model, scan_layers=True, remat=False, dtype=config.dtype,
            param_dtype=config.dtype, max_seq_len=config.max_model_len,
            **config.model_overrides)
        # before the world or the device is touched: a degree that does
        # not divide the heads fails at construction
        self.sharding = resolve_serve_mesh(mesh, config.tp,
                                           self.device.type, self.model_cfg)
        mesh = self.sharding.mesh if self.sharding else None
        tp = self.sharding.tp if self.sharding else 1
        # before any weight is made: the paged path runs K1 and K2
        check_kernel_head_dim(self.model_cfg.head_dim_, dtype, self.device,
                              decode=True, owner="LLMEngine")
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(config.seed)
            params = init_params(self.model_cfg, gen, self.device, dtype,
                                 mesh=mesh)
        elif self.sharding is not None:
            params = self.sharding.shard_params(params, self.model_cfg)
        self.model = build_model(self.model_cfg, params, self.device, dtype,
                                 mesh=mesh)
        cfg_m = self.model_cfg
        # page-major combined layout [L, P, Hkv, page, 2*D]; a tp rank
        # holds Hkv/tp heads of every page
        self.kv_pages = torch.zeros(
            (cfg_m.num_layers, config.num_pages, cfg_m.num_kv_heads // tp,
             config.page_size, 2 * cfg_m.head_dim_),
            dtype=dtype, device=self.device)
        self._frames = None
        if self.sharding is not None:
            self._frames = FrameChannel(
                dist.get_process_group_ranks(self.model.place.tp_group))
        # device-resident last-sampled token per slot: the decode carry
        self.slot_ids = torch.zeros((config.max_batch, 1), dtype=torch.long,
                                    device=self.device)
        self._rng = torch.Generator(device=self.device)

    def _init_host_state(self) -> None:
        config = self.config
        self._intake: List[Request] = []
        self._intake_lock = threading.Lock()
        self._aborted: set = set()
        self._injections: List[tuple] = []
        self.extracted: Dict[str, Dict[str, Any]] = {}
        # unclaimed prefill KV blobs are dropped after a TTL or past a
        # count cap: a decode caller that aborts between prefill_done and
        # pop_extracted must not leak dense KV on a long-lived replica
        self._extracted_order: List[tuple] = []  # (request_id, ts)
        self.extracted_ttl_s: float = 120.0
        self.extracted_max: int = 64
        self.waiting: List[Request] = []
        self.running: List[Request] = []
        self.requests: Dict[str, Request] = {}
        # requests pruned for an expired deadline, WAITING or RUNNING
        self._expired_total = 0
        # scheduler counters (stats() keys): page-pressure preemptions
        # and speculative draft/accept volumes
        self._preempted_total = 0
        self._spec_drafted_total = 0
        self._spec_accepted_total = 0
        # (head request_id, times passed): bounds prefix-aware skip-ahead
        # unfairness against one page-blocked queue head
        self._head_overtaken: tuple = (None, 0)
        self._pending_deltas: List[OutputDelta] = []
        # rows per prefill dispatch (the single row count per bucket)
        self._wave_rb: int = (config.prefill_wave_size
                              or max(1, config.max_batch // 2))
        self._free_slots: List[int] = list(range(config.max_batch))
        self._slot_req: Dict[int, Request] = {}
        # pending-first-decode override: slot -> host-known pending token
        # (set after prefill harvest / injection / speculative harvest)
        self._slot_override: Dict[int, int] = {}
        # FIFO of in-flight dispatches awaiting harvest
        self._inflight: List[dict] = []

    # ----------------------------------------------------------- intake

    def add_request(self, request_id: str, prompt_ids: List[int],
                    sampling: Optional[SamplingParams] = None,
                    deadline: Optional[float] = None) -> None:
        """``deadline`` is the request's ABSOLUTE wall-clock expiry
        (time.time() domain); it is converted to the engine's monotonic
        domain here so pruning is immune to wall-clock steps."""
        sampling = sampling or SamplingParams()
        if len(prompt_ids) + 1 > self.config.max_model_len:
            raise ValueError(
                f"prompt of {len(prompt_ids)} tokens exceeds max_model_len "
                f"{self.config.max_model_len}")
        if sampling.top_k > _MAX_TOP_K:
            raise ValueError(
                f"top_k={sampling.top_k} exceeds the on-device sampler "
                f"bound of {_MAX_TOP_K}")
        req = Request(request_id, [int(t) for t in prompt_ids], sampling)
        if deadline is not None:
            req.deadline_mono = time.monotonic() + (deadline - time.time())
        with self._intake_lock:
            self._intake.append(req)

    def abort(self, request_id: str) -> None:
        with self._intake_lock:
            self._aborted.add(request_id)
            # drop any unclaimed prefill KV for this request now
            if self.extracted.pop(request_id, None) is not None:
                self._extracted_order[:] = [
                    e for e in self._extracted_order if e[0] != request_id]

    def _evict_extracted(self) -> None:
        now = time.monotonic()
        with self._intake_lock:
            while self._extracted_order and (
                    len(self._extracted_order) > self.extracted_max
                    or now - self._extracted_order[0][1]
                    > self.extracted_ttl_s):
                rid, _ = self._extracted_order.pop(0)
                self.extracted.pop(rid, None)

    def has_work(self) -> bool:
        with self._intake_lock:
            if self._intake or self._injections:
                return True
        return bool(self.waiting or self.running or self._inflight
                    or self._pending_deltas)

    # ------------------------------------------------------------- step

    def step(self) -> List[OutputDelta]:
        """One scheduler iteration. Two modes share the dispatch/harvest
        machinery:

        - legacy (prefill_chunk_tokens == 0): admit + prefill whole
          prompts first, fill the pipeline with fused decode chunks,
          harvest the oldest in-flight dispatch (blocking only when its
          tokens have not landed yet).
        - token budget (prefill_chunk_tokens > 0): decode FIRST, then at
          most one prefill dispatch of at most the budgeted prompt
          tokens, then harvest enough dispatches to keep the backlog
          under the pipeline depth, so a running slot's inter-token gap
          is one decode chunk + one prefill chunk instead of one whole
          prompt.

        On a mesh only rank 0 steps; the other ranks ``follow()``.
        """
        if self._frames is not None and not self._frames.is_source:
            raise RuntimeError(
                f"rank {dist.get_rank()} follows the tp group's first rank: "
                f"call follow(), not step()")
        deltas: List[OutputDelta] = list(self._pending_deltas)
        self._pending_deltas.clear()
        self._drain_intake(deltas)
        self._prune_expired_running(deltas)
        self._prune_expired_waiting(deltas)
        self._try_admit_injection(deltas)
        chunked = self.config.prefill_chunk_tokens > 0
        depth = max(1, int(self.config.pipeline_depth))
        if not chunked:
            self._dispatch_prefills()
        while (len(self._inflight) < depth
               and (self._dispatch_spec()
                    or self._dispatch_decode_chunk())):
            pass
        if chunked:
            self._dispatch_prefill_chunks()
            if self._inflight:
                self._harvest(self._inflight.pop(0), deltas)
            while len(self._inflight) >= depth:
                self._harvest(self._inflight.pop(0), deltas)
        elif self._inflight:
            self._harvest(self._inflight.pop(0), deltas)
        return deltas

    def _drain_pipeline(self, deltas: List[OutputDelta]) -> None:
        """Harvest every in-flight dispatch (no new dispatches), so host
        bookkeeping is complete before a read or write of the pages
        (extract/inject). The device needs no drain: stream order already
        puts an eager page copy after every dispatch enqueued before it."""
        while self._inflight:
            self._harvest(self._inflight.pop(0), deltas)

    def _drain_intake(self, deltas: List[OutputDelta]) -> None:
        with self._intake_lock:
            intake, self._intake = self._intake, []
            aborted, self._aborted = self._aborted, set()
        self.waiting.extend(intake)
        for req in intake:
            self.requests[req.request_id] = req
        for rid in aborted:
            req = self.requests.get(rid)
            if req and req.state != FINISHED:
                self._finish(req, "aborted")
                deltas.append(OutputDelta(rid, [], True, "aborted"))

    def _prune_expired_running(self, deltas: List[OutputDelta]) -> None:
        """Shed RUNNING requests whose deadline has passed: free the slot
        and pages at step start and emit the typed "expired" delta.
        Dispatches already in flight for the slot are discarded at
        harvest, as for abort, and their page writes land beyond any live
        request's visible range. The port has no Serve admission module,
        so no shed metric is bumped here (the JAX engine's
        ``_count_engine_expired``): ``stats()["expired_total"]`` is the
        count; Serve hosting is out of the port (ROADMAP item 5)."""
        if not self.running:
            return
        now = time.monotonic()
        expired = [r for r in self.running
                   if r.deadline_mono is not None
                   and now >= r.deadline_mono]
        for req in expired:
            self._finish(req, "expired")
            self._expired_total += 1
            deltas.append(OutputDelta(req.request_id, [], True, "expired"))

    def _prune_expired_waiting(self, deltas: List[OutputDelta]) -> None:
        """Shed expired WAITING entries before admission: a request whose
        deadline passed in the queue never reaches prefill. Touches only
        queue bookkeeping (WAITING entries hold no pages or slots).
        Counted in ``expired_total`` as above."""
        if not self.waiting:
            return
        now = time.monotonic()
        kept: List[Request] = []
        for req in self.waiting:
            if req.deadline_mono is not None and now >= req.deadline_mono:
                req.state = FINISHED
                req.finish_reason = "expired"
                self.requests.pop(req.request_id, None)
                self._expired_total += 1
                deltas.append(OutputDelta(req.request_id, [], True,
                                          "expired"))
            else:
                kept.append(req)
        self.waiting[:] = kept

    # bounded admission lookahead: how far past the head of the waiting
    # queue prefix-aware admission may scan when the head does not fit
    # the page budget (only cached-prefix requests may skip ahead)
    _ADMIT_LOOKAHEAD = 32
    # bounded unfairness: how many requests may pass ONE blocked head
    # before skip-ahead pauses
    _HEAD_OVERTAKE_CAP = 32

    def _admit_one(self, burst_prefixes: set = None) -> Optional[Request]:
        """Admit one waiting request (slot + page budget permitting)
        WITHOUT prefilling; returns the request or None.

        FIFO first: the head of the queue is always tried. In scheduler
        v2 (prefill_chunk_tokens > 0), when the head does not fit the
        page headroom, requests further back whose prompt prefix is
        already cached may admit ahead of it, at most _HEAD_OVERTAKE_CAP
        of them per blocked head. With prefill_chunk_tokens == 0
        admission is strict FIFO (head only), the legacy order.

        A request whose leading page matches one admitted THIS step is
        deferred: next step its prefix pages are computed and cached, so
        it shares them instead of prefilling the same content in
        parallel (in v2 a twin whose prefix is ALREADY cached co-admits
        instead of deferring)."""
        if not self.waiting or not self._free_slots:
            return None
        page = self.config.page_size
        legacy = self.config.prefill_chunk_tokens <= 0
        lookahead = 1 if legacy else self._ADMIT_LOOKAHEAD
        head_id = self.waiting[0].request_id
        if self._head_overtaken[0] != head_id:
            self._head_overtaken = (head_id, 0)
        for qi in range(min(len(self.waiting), lookahead)):
            req = self.waiting[qi]
            if qi > 0 and self._head_overtaken[1] >= \
                    self._HEAD_OVERTAKE_CAP:
                return None  # head has been passed enough; let it age in
            first_hash = None
            if burst_prefixes is not None and len(req.prompt_ids) >= page:
                first_hash = self.allocator.chain_hash(
                    None, req.prompt_ids[:page])
                if first_hash in burst_prefixes:
                    continue  # wait one step; the prefix cache will hit
            cached_pages, n_cached = self.allocator.match_prefix(
                req.prompt_ids)
            if qi > 0 and not cached_pages:
                continue  # only prefix-sharers may pass a blocked head
            need = (-(-(len(req.prompt_ids) + 1) // page)
                    - len(cached_pages))
            if self.allocator.num_free() < need:
                self.allocator.release(cached_pages)
                self.allocator.stats["cache_hits"] -= len(cached_pages)
                continue  # page budget: scan on for a cached-prefix fit
            if first_hash is not None and (legacy or not cached_pages):
                # this admission will COMPUTE the prefix: defer same-
                # prefix twins one step so they share it from the cache
                burst_prefixes.add(first_hash)
            if qi > 0:
                self._head_overtaken = (head_id,
                                        self._head_overtaken[1] + 1)
            else:
                self._head_overtaken = (None, 0)
            self.waiting.pop(qi)
            self.allocator.note_prefix_lookup(len(req.prompt_ids), n_cached)
            req.pages = cached_pages + self.allocator.allocate(need)
            req.n_cached = n_cached
            req.n_prefilled = n_cached
            req.n_hashed = n_cached
            req.last_page_hash = None
            if cached_pages:
                # recompute the chain hash up to the cached boundary
                h = None
                for i in range(len(cached_pages)):
                    h = self.allocator.chain_hash(
                        h, req.prompt_ids[i * page:(i + 1) * page])
                req.last_page_hash = h
            req.state = RUNNING
            req.slot = self._free_slots.pop(0)
            req.planned_out = 0
            self._slot_req[req.slot] = req
            self.running.append(req)
            return req
        return None

    # ---------------------------------------------------------- compute

    def _h2d(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without blocking the host (staged
        through pinned memory on a card)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _to_host_async(self, t: torch.Tensor):
        """Start the device->host copy of sampled tokens; the handle is
        resolved by _fetch_tokens at harvest."""
        if self.device.type != "cuda":
            return t, None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _fetch_tokens(self, handle) -> np.ndarray:
        """Host tokens of a dispatch (waits for its copy to land)."""
        host, event = handle
        if event is not None:
            event.synchronize()
        return host.numpy()

    def _sample(self, rows: torch.Tensor, temperature: np.ndarray,
                top_k: np.ndarray, keys: np.ndarray) -> torch.Tensor:
        """Greedy when temperature == 0, else temperature + (clamped)
        top-k categorical. rows: [B, V] float32 logits. A sampled row draws
        from a generator seeded by its own (request, seed, count) key, so
        its token never depends on the rest of the batch."""
        greedy = rows.argmax(dim=-1)
        sampled = np.flatnonzero(temperature > 0)
        if sampled.size == 0:
            return greedy
        temp_t = self._h2d(np.maximum(temperature, 1e-6).astype(np.float32))
        topk_t = self._h2d(top_k.astype(np.int64))
        scaled = rows / temp_t[:, None]
        topv = scaled.topk(min(_MAX_TOP_K, rows.shape[-1]), dim=-1).values
        k_idx = torch.clamp(topk_t - 1, 0, topv.shape[-1] - 1)
        kth = topv.gather(1, k_idx[:, None])
        masked = scaled.masked_fill((topk_t[:, None] > 0) & (scaled < kth),
                                    float("-inf"))
        probs = torch.softmax(masked, dim=-1)
        out = greedy.clone()
        for i in sampled:
            self._rng.manual_seed(int(keys[i, 0]) | (int(keys[i, 1]) << 32))
            # exponential race: argmax p/E with E ~ Exp(1) samples from p
            race = torch.empty_like(probs[i]).exponential_(
                generator=self._rng)
            out[i] = (probs[i] / race).argmax()
        return out

    def _dispatch(self, op: str, *args):
        """Run dispatch ``op`` (``_run_<op>``) on this rank, after sending
        it to the followers as a frame on a mesh."""
        if self._frames is not None:
            self._frames.send(op, *args)
        return getattr(self, "_run_" + op)(*args)

    def _compute_prefill(self, *args):
        """One prefill dispatch (``_run_prefill``); returns the handle of
        its [rb] tokens."""
        return self._to_host_async(self._dispatch("prefill", *args))

    def _compute_verify(self, *args):
        """One speculative verify dispatch (``_run_verify``); returns the
        handle of its [rb, sb] tokens."""
        return self._to_host_async(self._dispatch("verify", *args))

    def _compute_decode(self, *args):
        """One fused K-step decode dispatch (``_run_decode``); returns the
        handle of its [K, S] tokens."""
        return self._to_host_async(self._dispatch("decode", *args))

    def _run_prefill(self, rb, cp, bt, total, ids, positions, gather, temp,
                     topk, keys) -> torch.Tensor:
        """The prefill dispatch's [rb] tokens. cp (0 or max_pages_per_seq)
        is the cached-prefix width: rows starting past position 0 (a
        prefix-cache hit, or chunk k > 0) attend to their earlier pages
        through K2's ctx part."""
        with torch.inference_mode():
            cache = PagedCache(self.kv_pages, self._h2d(bt),
                               self._h2d(total), ctx_pages=cp)
            h = self.model.hidden(self._h2d(ids), self._h2d(positions),
                                  cache)
            # project only each row's last prompt position
            rows = h[torch.arange(rb, device=self.device),
                     self._h2d(gather).long()]
            logits = self.model.logits(rows).float()
            return self._sample(logits, temp, topk, keys)

    def _run_verify(self, bt, total, ids, positions) -> torch.Tensor:
        """The speculative verify dispatch (the ``verify`` jit): shaped
        like a prefill whose rows start at total-1 (not a page multiple),
        attending to every earlier page through K2's ctx part, with the
        greedy token after EVERY input column. The float32 argmax runs on
        the device, so only int tokens come back: [rb, sb]."""
        with torch.inference_mode():
            cache = PagedCache(self.kv_pages, self._h2d(bt),
                               self._h2d(total),
                               ctx_pages=self.max_pages_per_seq)
            h = self.model.hidden(self._h2d(ids), self._h2d(positions),
                                  cache)
            return self.model.logits(h).float().argmax(dim=-1)

    def _run_decode(self, k_steps, bt, total, caps, positions,
                    override_mask, override_ids, temp, topk,
                    keys_steps) -> torch.Tensor:
        """The fused K-step decode dispatch over the full slot set: its
        [K, S] tokens; the decode carry is updated in place."""
        with torch.inference_mode():
            bt_t = self._h2d(bt)
            tot = self._h2d(total)
            caps_t = self._h2d(caps)
            pos = self._h2d(positions)
            active = tot > 0
            ids = torch.where(self._h2d(override_mask)[:, None],
                              self._h2d(override_ids).long(), self.slot_ids)
            toks = []
            for k in range(k_steps):
                cache = PagedCache(self.kv_pages, bt_t, tot)
                h = self.model.hidden(ids, pos, cache)
                logits = self.model.logits(h[:, 0]).float()
                tok = self._sample(logits, temp, topk, keys_steps[k])
                toks.append(tok)
                # caps clamp: past a slot's ceiling positions freeze at
                # cap-1 and totals at cap; inactive slots never write
                tot = torch.where(active, torch.minimum(tot + 1, caps_t),
                                  tot)
                pos = torch.minimum(pos + 1, caps_t[:, None] - 1)
                ids = tok[:, None]
            # carry the last sampled token forward for ACTIVE slots only
            self.slot_ids.copy_(torch.where(active[:, None], ids,
                                            self.slot_ids))
            return torch.stack(toks)

    def _dispatch_prefills(self) -> None:
        """Legacy (prefill-priority) mode: admit as many waiting requests
        as slots/pages allow and launch one whole-prompt prefill dispatch
        per length bucket and wave."""
        admitted = []
        burst_prefixes: set = set()
        while len(self.running) < self.config.max_batch:
            req = self._admit_one(burst_prefixes)
            if req is None:
                break
            admitted.append(req)
        if not admitted:
            return
        wave = self._wave_rb
        by_bucket: Dict[int, List[tuple]] = {}
        for req in admitted:
            n_new = len(req.prompt_ids) - req.n_prefilled
            sb = _bucket(n_new, self.config.prefill_buckets)
            by_bucket.setdefault(sb, []).append((req, n_new))
        for sb, group in by_bucket.items():
            for i in range(0, len(group), wave):
                self._dispatch_prefill_batch(sb, group[i:i + wave])

    def _chunk_tokens(self) -> int:
        """prefill_chunk_tokens rounded UP to a page multiple (chunk
        boundaries stay page-aligned so every completed chunk's full
        pages enter the prefix cache) and clamped to the largest length
        bucket (a chunk must fit one prefill shape)."""
        page = self.config.page_size
        c = max(1, int(self.config.prefill_chunk_tokens))
        return max(page, min(-(-c // page) * page,
                             self.config.prefill_buckets[-1]))

    def _dispatch_prefill_chunks(self) -> None:
        """Token-budget mode: admit new requests and advance mid-prefill
        requests, together bounded by the per-step budget, in ONE
        dispatch per step (rows share the chunk's length bucket).

        NEW admissions take the budget FIRST, so a short prompt arriving
        while a long one is mid-prefill starts inside this step's budget;
        the leftover is split evenly across continuing mid-prefill
        requests (page-aligned shares, the remainder to the first)."""
        budget = self._chunk_tokens()
        page = self.config.page_size

        def grant(req: Request, tokens: int) -> int:
            """Tokens this row may prefill now: a FINAL chunk takes its
            exact remainder; a non-final chunk rounds DOWN to a page
            multiple so every chunk boundary stays page-aligned."""
            remaining = len(req.prompt_ids) - req.n_prefilled
            if remaining <= tokens:
                return remaining
            return tokens // page * page

        rows: List[tuple] = []
        used = 0
        burst_prefixes: set = set()
        while (used < budget and len(rows) < self._wave_rb
               and len(self.running) < self.config.max_batch):
            req = self._admit_one(burst_prefixes)
            if req is None:
                break
            n_new = grant(req, budget - used)
            if n_new > 0:
                rows.append((req, n_new))
                used += n_new
            # n_new == 0: admitted with < 1 page of budget left; it holds
            # its slot/pages and continues in the next step's wave
        continuing = [r for r in self.running
                      if r.state == RUNNING and not r.decode_ready
                      and 0 < len(r.prompt_ids) - r.n_prefilled
                      and all(r is not q for q, _ in rows)]
        if continuing and used < budget:
            share = max(page,
                        (budget - used) // len(continuing) // page * page)
            extra = max(0, (budget - used) - share * len(continuing))
            for idx, req in enumerate(continuing):
                if used >= budget or len(rows) >= self._wave_rb:
                    break
                n_new = grant(req, min(share + (extra if idx == 0 else 0),
                                       budget - used))
                if n_new <= 0:
                    continue
                rows.append((req, n_new))
                used += n_new
        if not rows:
            return
        sb = _bucket(max(n for _, n in rows), self.config.prefill_buckets)
        self._dispatch_prefill_batch(sb, rows)

    def _dispatch_prefill_batch(self, sb: int, group: List[tuple]) -> None:
        """One prefill dispatch. ``group`` rows are (request, n_new): each
        prefills n_new prompt tokens from the request's n_prefilled mark,
        the whole remaining prompt in legacy mode, one chunk in
        token-budget mode. Rows whose start is > 0 attend to their earlier
        pages through the ctx part; only rows whose FINAL chunk this is
        sample a token that reaches the request."""
        rb = self._wave_rb  # rows pad to the wave size
        ids = np.zeros((rb, sb), np.int32)
        positions = np.zeros((rb, sb), np.int32)
        bt = np.zeros((rb, self.max_pages_per_seq), np.int32)
        total = np.zeros((rb,), np.int32)
        gather = np.zeros((rb,), np.int32)
        rows = []
        for i, (req, n_new) in enumerate(group):
            start = req.n_prefilled
            ids[i, :n_new] = req.prompt_ids[start:start + n_new]
            positions[i] = start + np.arange(sb, dtype=np.int32)
            bt[i, :len(req.pages)] = req.pages
            total[i] = start + n_new
            gather[i] = n_new - 1
            final = start + n_new >= len(req.prompt_ids)
            rows.append((req.request_id, req.slot, start + n_new, final))
        now = time.monotonic()
        for req, _ in group:
            if req.dispatched_t is None:
                req.dispatched_t = now
        # ctx_pages buckets to {0, full}: a fresh-prompt wave reads no pages
        cp = (self.max_pages_per_seq
              if any(req.n_prefilled for req, _ in group) else 0)
        temp, topk, keys = self._sampling_arrays(
            [req for req, _ in group], rb)
        tokens = self._compute_prefill(rb, cp, bt, total, ids, positions,
                                       gather, temp, topk, keys)
        for req, n_new in group:
            req.n_prefilled += n_new
            if req.n_prefilled >= len(req.prompt_ids):
                req.planned_out = 1
        self._inflight.append({"kind": "prefill", "toks": tokens,
                               "group": rows})

    @staticmethod
    def _prompt_lookup_draft(req: Request, max_len: int) -> List[int]:
        """Prompt-lookup (n-gram) draft: find the most recent earlier
        occurrence of the sequence's trailing n-gram in prompt+output and
        propose the tokens that followed it. Longer n-grams first."""
        seq = req.prompt_ids + req.output_ids
        for n in (3, 2):
            if len(seq) < n + 1:
                continue
            tail = seq[-n:]
            # backwards: the MOST RECENT occurrence predicts best
            for i in range(len(seq) - n - 1, -1, -1):
                if seq[i:i + n] == tail:
                    return [int(t) for t in seq[i + n:i + n + max_len]]
        return []

    def _spec_len(self) -> int:
        """Longest draft: spec_lookahead, so that pending + draft fits
        the largest bucket."""
        return min(int(self.config.spec_lookahead),
                   self.config.prefill_buckets[-1] - 1)

    def _dispatch_spec(self) -> bool:
        """Prompt-lookup speculative decode: ONE prefill-shaped dispatch
        verifies each drafted continuation (inputs = pending token +
        draft; the argmax at every position comes back); the harvest
        accepts the longest prefix whose draft tokens match the model's
        own argmax. Greedy-only and only for slots with no work in flight
        (drafting needs the host-known tail). Returns False when no slot
        qualifies; the fused decode then covers everything."""
        cfg = self.config
        if cfg.spec_lookahead <= 0:
            return False
        L = self._spec_len()
        page = cfg.page_size
        rows: List[tuple] = []
        for req in self.running:
            if (req.slot < 0 or not req.decode_ready
                    or req.spec_inflight
                    or req.sampling.temperature > 0
                    or req.sampling.prefill_only
                    or req.planned_out != len(req.output_ids)
                    or req.planned_out >= req.sampling.max_tokens):
                continue
            cap = _cap_total(req, cfg.max_model_len)
            total = len(req.prompt_ids) + len(req.output_ids)
            if total >= cap:
                continue
            draft = self._prompt_lookup_draft(req, min(L, cap - total))
            if not draft:
                continue
            # page horizon for the draft writes (positions total-1 ..
            # total-1+len(draft), all < cap); a shortfall skips
            # speculation for this slot, the decode path owns preemption
            last_pos = total - 1 + len(draft)
            required = min(last_pos // page + 1, self.max_pages_per_seq)
            if len(req.pages) < required:
                try:
                    req.pages.extend(self.allocator.allocate(
                        required - len(req.pages)))
                except OutOfPages:
                    continue
            rows.append((req, draft))
            if len(rows) >= self._wave_rb:
                break
        if not rows:
            return False
        rb = self._wave_rb
        sb = _bucket(L + 1, cfg.prefill_buckets)
        ids = np.zeros((rb, sb), np.int32)
        positions = np.zeros((rb, sb), np.int32)
        bt = np.zeros((rb, self.max_pages_per_seq), np.int32)
        total_arr = np.zeros((rb,), np.int32)
        recs = []
        for i, (req, draft) in enumerate(rows):
            total = len(req.prompt_ids) + len(req.output_ids)
            pending = (req.output_ids[-1] if req.output_ids
                       else req.prompt_ids[-1])
            n = len(draft)
            ids[i, 0] = pending
            ids[i, 1:1 + n] = draft
            positions[i] = (total - 1) + np.arange(sb, dtype=np.int32)
            bt[i, :len(req.pages)] = req.pages
            # columns past pending + draft are padding: paged_write sends
            # them to page 0; the draft's own writes sit beyond the
            # request's total until accepted, and are rewritten by the
            # next dispatch before any attention reaches them
            total_arr[i] = total + n
            recs.append((req.request_id, req.slot, len(req.output_ids),
                         list(draft)))
            req.planned_out += n + 1  # optimistic; rolled back at harvest
            req.spec_inflight = True
            self._spec_drafted_total += n
        toks = self._compute_verify(bt, total_arr, ids, positions)
        self._inflight.append({"kind": "spec", "toks": toks, "rows": recs})
        return True

    def _decode_eligible(self) -> List[Request]:
        """Slots safe to decode: RUNNING, prefill harvested, no verify in
        flight, and not already dispatched through their whole token
        budget."""
        cfg = self.config
        elig = []
        for req in self.running:
            if (req.slot < 0 or not req.decode_ready
                    or req.spec_inflight):
                # spec_inflight: a verify dispatch owns the slot; the
                # device carry is stale until its harvest resolves
                continue
            cap = _cap_total(req, cfg.max_model_len)
            if (req.planned_out >= req.sampling.max_tokens
                    or len(req.prompt_ids) + req.planned_out >= cap):
                continue
            elig.append(req)
        return elig

    def _reserve_decode_pages(self, elig: List[Request],
                              k_steps: int) -> Optional[List[Request]]:
        """Page horizon for one decode chunk: every eligible slot needs
        pages covering its planned writes through this chunk (clamped by
        its cap). Oldest first; on exhaustion with an empty pipeline,
        preempt the victim with the MOST reclaimable pages, newest arrival
        breaking ties (recompute-style preemption); with work in flight,
        back off (returns None) and let the harvest free pages."""
        cfg = self.config
        page = cfg.page_size
        for req in sorted(elig, key=lambda r: r.arrival_t):
            cap = _cap_total(req, cfg.max_model_len)
            last_pos = min(len(req.prompt_ids) + req.planned_out - 1
                           + (k_steps - 1), cap - 1)
            required = min(last_pos // page + 1, self.max_pages_per_seq)
            while (req in self.running and req.state == RUNNING
                   and len(req.pages) < required):
                try:
                    req.pages.extend(
                        self.allocator.allocate(required - len(req.pages)))
                except OutOfPages:
                    if self._inflight:
                        return None
                    victims = [r for r in self.running
                               if r is not req and r.planned_out
                               == len(r.output_ids)]
                    if not victims:
                        if req.planned_out == len(req.output_ids):
                            self._preempt(req)
                        break
                    self._preempt(max(
                        victims,
                        key=lambda r: (
                            self.allocator.reclaimable_pages(r.pages),
                            r.arrival_t)))
        return [r for r in elig
                if r in self.running and r.state == RUNNING]

    def _dispatch_decode_chunk(self) -> bool:
        """Launch one fused K-step decode dispatch over the full slot set,
        reading last tokens from the device-resident carry. Returns False
        when there is nothing safe to decode."""
        cfg = self.config
        k_steps = max(1, int(cfg.decode_steps_per_dispatch))
        S = cfg.max_batch
        elig = self._decode_eligible()
        if not elig:
            return False
        elig = self._reserve_decode_pages(elig, k_steps)
        if not elig:
            return False
        mp = self.max_pages_per_seq
        bt = np.zeros((S, mp), np.int32)
        total = np.zeros((S,), np.int32)
        caps = np.ones((S,), np.int32)
        positions = np.zeros((S, 1), np.int32)
        override_mask = np.zeros((S,), bool)
        override_ids = np.zeros((S, 1), np.int32)
        chunk_slots = {}
        for req in elig:
            s = req.slot
            planned_total = len(req.prompt_ids) + req.planned_out
            bt[s, :len(req.pages)] = req.pages
            total[s] = planned_total
            caps[s] = _cap_total(req, cfg.max_model_len)
            positions[s, 0] = planned_total - 1
            if s in self._slot_override:
                override_mask[s] = True
                override_ids[s, 0] = self._slot_override.pop(s)
            chunk_slots[s] = (req.request_id, req.planned_out)
        keys_steps = np.zeros((k_steps, S, 2), np.uint32)
        temp = np.zeros((S,), np.float32)
        topk = np.zeros((S,), np.int32)
        for k in range(k_steps):
            t_k, tk_k, keys_k = self._sampling_arrays(
                elig, S, counter_offset=k, slot_layout=True,
                base="planned")
            keys_steps[k] = keys_k
            if k == 0:
                temp, topk = t_k, tk_k
        for req in elig:
            req.planned_out += k_steps
        toks = self._compute_decode(k_steps, bt, total, caps, positions,
                                    override_mask, override_ids, temp, topk,
                                    keys_steps)
        self._inflight.append({"kind": "decode", "toks": toks,
                               "slots": chunk_slots, "k": k_steps})
        return True

    # ---------------------------------------------------------- harvest

    def _harvest(self, rec: dict, deltas: List[OutputDelta]) -> None:
        toks_np = self._fetch_tokens(rec["toks"])
        if rec["kind"] == "prefill":
            for i, (rid, slot, end, final) in enumerate(rec["group"]):
                req = self.requests.get(rid)
                if req is None or req.state != RUNNING or req.slot != slot:
                    continue  # aborted while in flight
                self._register_full_pages(req, upto=end)
                if not final:
                    # intermediate chunk: pages are written; the sampled
                    # token (mid-prompt continuation) is meaningless
                    continue
                token = int(toks_np[i])
                # the decode chain reads this slot's first input from the
                # host-side override (the prefill wrote pages, not the
                # slot carry)
                self._slot_override[slot] = token
                req.decode_ready = True
                self._append_token(req, token, deltas)
            return
        if rec["kind"] == "spec":
            # toks_np is [rb, sb]: g[j] = the model's argmax AFTER input
            # column j. Accept g[0] (computed from the true pending
            # token), then each g[j] while draft[j-1] == g[j-1]: the
            # draft token fed at column j was the model's own choice, so
            # everything before the first mismatch is exactly what plain
            # greedy decode would have produced.
            for i, (rid, slot, start, draft) in enumerate(rec["rows"]):
                req = self.requests.get(rid)
                if req is None:
                    continue
                req.spec_inflight = False
                if (req.state != RUNNING or req.slot != slot
                        or len(req.output_ids) != start):
                    continue  # finished/aborted while in flight
                g = toks_np[i]
                emitted = [int(g[0])]
                for j in range(1, len(draft) + 1):
                    if int(draft[j - 1]) != emitted[-1]:
                        break
                    emitted.append(int(g[j]))
                self._spec_accepted_total += len(emitted) - 1
                for tok in emitted:
                    if req.state != RUNNING:
                        break  # EOS/stop/length inside the accepted run
                    self._append_token(req, tok, deltas)
                if req.state == RUNNING:
                    # roll the optimistic plan back to reality and feed
                    # the next dispatch the last ACCEPTED token (verify
                    # never touches the device carry)
                    req.planned_out = len(req.output_ids)
                    self._slot_override[req.slot] = req.output_ids[-1]
            return
        # decode chunk: toks_np is [K, S]
        for slot, (rid, start) in rec["slots"].items():
            req = self.requests.get(rid)
            if (req is None or req.state != RUNNING or req.slot != slot
                    or len(req.output_ids) != start):
                continue  # finished/aborted/preempted while in flight
            for k in range(rec["k"]):
                if req.state != RUNNING:
                    break
                self._append_token(req, int(toks_np[k, slot]), deltas)

    def _preempt(self, req: Request) -> None:
        """Return a running request to the waiting queue, dropping its
        pages (its KV is recomputed on re-admission; generated tokens are
        folded into the prompt). Only called with an empty pipeline."""
        if self._inflight:
            raise RuntimeError("preemption needs an empty pipeline")
        self._preempted_total += 1
        self.running.remove(req)
        self._release_slot(req)
        self.allocator.release(req.pages)
        req.prompt_ids = req.prompt_ids + req.output_ids
        req.sampling.max_tokens -= len(req.output_ids)
        req.output_ids = []
        req.pages = []
        req.n_cached = 0
        req.n_prefilled = 0
        req.n_hashed = 0
        req.planned_out = 0
        req.decode_ready = False
        req.spec_inflight = False
        req.dispatched_t = None  # re-prefill measures its own queue wait
        req.state = WAITING
        self.waiting.insert(0, req)

    def _release_slot(self, req: Request) -> None:
        if req.slot >= 0:
            self._slot_req.pop(req.slot, None)
            self._slot_override.pop(req.slot, None)
            self._free_slots.append(req.slot)
            self._free_slots.sort()
            req.slot = -1

    # ---------------------------------------------------------- sampling

    def _sampling_arrays(self, batch, rb: int = None,
                         counter_offset: int = 0, slot_layout: bool = False,
                         base: str = "actual"):
        """Per-row sampling params + generator keys. Keys derive from
        (request id, seed, tokens-sampled-so-far), the JAX engine's
        contract, so results are independent of batch composition. With
        slot_layout, rows are decode slots; `base` selects the token
        counter ('planned' for dispatch-ahead chunks)."""
        rb = rb or len(batch)
        temp = np.zeros((rb,), np.float32)
        topk = np.zeros((rb,), np.int32)
        keys = np.zeros((rb, 2), np.uint32)
        for i, req in enumerate(batch):
            row = req.slot if slot_layout else i
            s = req.sampling
            temp[row] = s.temperature
            topk[row] = min(s.top_k, _MAX_TOP_K) if s.top_k else 0
            seed = s.seed if s.seed is not None else self.config.seed
            count = (req.planned_out if base == "planned"
                     else len(req.output_ids))
            digest = hashlib.blake2b(
                f"{req.request_id}:{seed}:"
                f"{count + counter_offset}".encode(),
                digest_size=8).digest()
            keys[row, 0] = int.from_bytes(digest[:4], "little")
            keys[row, 1] = int.from_bytes(digest[4:], "little")
        return temp, topk, keys

    def _stop_reason(self, req: Request, token: int) -> Optional[str]:
        eos = self.config.eos_token_id
        if eos is not None and token == eos:
            return "stop"
        if token in req.sampling.stop_token_ids:
            return "stop"
        if len(req.output_ids) >= req.sampling.max_tokens:
            return "length"
        if req.total_len >= self.config.max_model_len:
            return "length"
        return None

    def _append_token(self, req: Request, token: int,
                      deltas: List[OutputDelta]) -> None:
        req.output_ids.append(token)
        stop = self._stop_reason(req, token)
        if req.sampling.prefill_only and stop is None:
            # gather-then-release inside the driver thread: the blob is
            # complete before the finished delta is observable. When the
            # first token already terminates, fall through to the normal
            # finish: there is nothing worth handing to a decode engine.
            blob = self._gather_kv(req)  # device gather OUTSIDE the lock
            with self._intake_lock:
                self.extracted[req.request_id] = blob
                self._extracted_order.append(
                    (req.request_id, time.monotonic()))
            self._evict_extracted()
            self._finish(req, "prefill_done")
            deltas.append(OutputDelta(req.request_id, [token], True,
                                      "prefill_done"))
            return
        if stop:
            self._finish(req, stop)
            deltas.append(OutputDelta(req.request_id, [token], True, stop))
        else:
            deltas.append(OutputDelta(req.request_id, [token], False))

    def _register_full_pages(self, req: Request,
                             upto: Optional[int] = None) -> None:
        """Enter any newly-FULL prompt pages into the prefix cache (only
        prompt tokens), bounded by the tokens whose KV has been written
        (a chunked prefill registers chunk by chunk)."""
        page = self.config.page_size
        n_prompt_full = len(req.prompt_ids) // page
        if upto is not None:
            n_prompt_full = min(n_prompt_full, upto // page)
        while req.n_hashed // page < n_prompt_full:
            i = req.n_hashed // page
            tokens = req.prompt_ids[i * page:(i + 1) * page]
            req.last_page_hash = self.allocator.register_full_page(
                req.pages[i], req.last_page_hash, tokens)
            req.n_hashed += page

    def _finish(self, req: Request, reason: str) -> None:
        if req.state == RUNNING and req in self.running:
            self.running.remove(req)
        elif req in self.waiting:
            self.waiting.remove(req)
        self._release_slot(req)
        req.state = FINISHED
        req.finish_reason = reason
        self.allocator.release(req.pages)
        req.pages = []
        self.requests.pop(req.request_id, None)

    # ------------------------------------------- prefill/decode handoff

    def _gather_kv(self, req: Request) -> Dict[str, Any]:
        """The request's pages and generation state as a host blob with
        the JAX engine's keys. ``kv`` is [L, n_pages, Hkv, page, 2*D], the
        page-major layout both packages share, in float32 (numpy has no
        bfloat16 of its own): a bf16 pool's values are widened exactly,
        with ``"kv_dtype": "bfloat16"``, and the JAX engine's cast to its
        pool's bfloat16 and ``_kv_from_blob``'s both round them back bit
        for bit. A tp engine gathers every rank's kv heads (the blob is
        the one a one-device engine writes)."""
        kv = self._dispatch("gather_kv", list(req.pages)).cpu()
        now = time.monotonic()
        disp = req.dispatched_t if req.dispatched_t is not None \
            else req.arrival_t
        blob = {
            "kv": kv.float().numpy(),
            "prompt_ids": list(req.prompt_ids),
            "output_ids": list(req.output_ids),
            # TTFT split: time queued before the prefill dispatch vs
            # prefill compute (the handoff's cost is the caller's)
            "queued_s": max(0.0, disp - req.arrival_t),
            "prefill_s": max(0.0, now - disp),
        }
        if kv.dtype == torch.bfloat16:
            blob["kv_dtype"] = "bfloat16"
        return blob

    def _run_gather_kv(self, pages: List[int]) -> torch.Tensor:
        """The pages ``[L, n, Hkv, page, 2*D]`` on the device, every rank's
        kv heads gathered over tp in rank order on a mesh."""
        with torch.inference_mode():
            idx = torch.tensor(pages, dtype=torch.long, device=self.device)
            kv = self.kv_pages.index_select(1, idx)
            if self.sharding is not None:
                kv = gather_from(kv, self.model.place.tp_group, dim=2)
            return kv

    def extract_kv(self, request_id: str) -> Dict[str, Any]:
        """Gather a running request's KV pages + generation state into a
        host blob for disaggregated prefill->decode handoff.
        Synchronous-driver use only; concurrent servers use
        SamplingParams(prefill_only=True) + pop_extracted, which gathers
        inside step()."""
        self._drain_pipeline(self._pending_deltas)
        req = self.requests.get(request_id)
        if req is None or req.state != RUNNING:
            # a decode chunk drained above may have crossed the request's
            # stop condition and finished it (its pages are released)
            raise KeyError(
                f"{request_id!r} is not running: it finished (possibly "
                "while in-flight decode chunks drained) or was never "
                "added; extract_kv must be called before generation "
                "completes")
        return self._gather_kv(req)

    def pop_extracted(self, request_id: str) -> Dict[str, Any]:
        """Fetch (and drop) the KV blob of a prefill_only request that
        finished with reason 'prefill_done'."""
        with self._intake_lock:
            blob = self.extracted.pop(request_id, None)
            self._extracted_order[:] = [
                e for e in self._extracted_order if e[0] != request_id]
        if blob is None:
            raise KeyError(
                f"prefill KV for {request_id!r} is unavailable: the "
                "handoff expired (TTL/cap eviction), was aborted, or the "
                "request never finished prefill")
        return blob

    def release_request(self, request_id: str) -> None:
        """Drop a request after handoff (its pages return to the pool)."""
        req = self.requests.pop(request_id, None)
        if req is not None and req.state != FINISHED:
            self._finish(req, "transferred")

    def inject_request(self, request_id: str, handoff: Dict[str, Any],
                       sampling: Optional[SamplingParams] = None) -> None:
        """Adopt a prefilled request (a blob of this engine or of the JAX
        engine): queue it for admission; the next step() scatters its KV
        pages and resumes decoding from its pending token. Queued (not
        applied inline) so injections respect the same max_batch/page
        admission control as fresh prompts."""
        shape = tuple(np.shape(handoff["kv"]))
        pool = list(self.kv_pages.shape)
        pool[2] = self.model_cfg.num_kv_heads  # a blob holds every kv head
        pool = tuple(pool)
        if len(shape) != 5 or shape[:1] + shape[2:] != pool[:1] + pool[2:]:
            raise ValueError(
                f"handoff kv {shape} does not fit this engine's pool "
                f"{pool}: every axis but the page axis (1) must match")
        with self._intake_lock:
            self._injections.append(
                (request_id, handoff, sampling or SamplingParams()))

    def _try_admit_injection(self, deltas: List[OutputDelta]) -> bool:
        """Admit the oldest queued injection if batch slots + pages allow
        (called from step(), before fresh-prompt admission: transferred
        requests already paid for their prefill)."""
        with self._intake_lock:
            if not self._injections:
                return False
            if len(self.running) >= self.config.max_batch:
                return False
            if not self._free_slots:
                return False
            request_id, handoff, sampling = self._injections[0]
            n = handoff["kv"].shape[1]
            if self.allocator.num_free() < n:
                return False
            self._injections.pop(0)
        kv = _kv_from_blob(handoff)
        self._drain_pipeline(deltas)
        pages = self.allocator.allocate(n)
        if self._frames is not None:
            # each rank's Hkv/tp heads of the blob, scattered over the
            # frames' group
            self._frames.send("inject", pages, None)
            kv = self._frames.scatter(list(kv.chunk(self.sharding.tp, 2)),
                                      self._pages_shape(n))
        self._run_inject(pages, kv)
        req = Request(request_id, [int(t) for t in handoff["prompt_ids"]],
                      sampling)
        req.output_ids = [int(t) for t in handoff["output_ids"]]
        req.pages = pages
        req.state = RUNNING
        # mark the whole transferred prompt as hashed so this engine never
        # registers pages it did not fill
        page = self.config.page_size
        req.n_hashed = (len(req.prompt_ids) // page) * page
        req.n_cached = 0
        req.n_prefilled = len(req.prompt_ids)
        req.slot = self._free_slots.pop(0)
        req.planned_out = len(req.output_ids)
        req.decode_ready = True
        self._slot_req[req.slot] = req
        # pending token (sampled by the prefill engine, not yet written)
        pending = (req.output_ids[-1] if req.output_ids
                   else req.prompt_ids[-1])
        self._slot_override[req.slot] = pending
        self.requests[request_id] = req
        self.running.append(req)
        return True

    def _pages_shape(self, n: int) -> tuple:
        """The shape of ``n`` pages of this rank's pool."""
        return (self.kv_pages.shape[0], n, *self.kv_pages.shape[2:])

    def _run_inject(self, pages: List[int], kv) -> None:
        """Write ``kv`` [L, n, Hkv/tp, page, 2*D] (a follower: None, its
        part comes from rank 0's scatter) into ``pages``: one in-place copy
        along the page axis; stream order puts it after every dispatch
        already enqueued."""
        if kv is None:
            kv = self._frames.scatter(None, self._pages_shape(len(pages)))
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        self.kv_pages.index_copy_(
            1, idx, kv.to(self.device, self.kv_pages.dtype))

    # ------------------------------------------------------ tp followers

    def follow(self) -> None:
        """A follower's loop (every rank of the mesh but rank 0): run each
        frame's dispatch on this rank's shard, in rank 0's order, until
        rank 0's ``close()``. Raises if rank 0 is gone, or after
        ``sharding.FOLLOW_TIMEOUT_S`` without a frame."""
        if self._frames is None or self._frames.is_source:
            raise RuntimeError("follow() is for the ranks of a tp mesh but "
                               "its first, which calls step()")
        while True:
            op, args = self._frames.recv()
            if op == "close":
                return
            getattr(self, "_run_" + op)(*args)

    def mark(self, tag: str) -> None:
        """Rank 0: a point in the dispatch order that every rank of the
        engine passes. Each rank calls its ``on_mark(tag)`` after it has
        run every dispatch sent before and before any sent after, so two
        marks bracket a window of the traffic on every rank."""
        self._dispatch("mark", tag)

    def _run_mark(self, tag: str) -> None:
        if self.on_mark is not None:
            self.on_mark(tag)

    def close(self) -> None:
        """On a mesh, rank 0 ends the followers' ``follow()``; a no-op
        elsewhere."""
        if self._frames is not None and self._frames.is_source:
            self._frames.send("close")

    # ----------------------------------------------------------- warmup

    def _dummy_prefill_args(self, sb: int) -> tuple:
        """Masked prefill inputs (total_lens = 0: every page write goes to
        page 0, no row reads a page): bt, total, ids, positions, gather,
        temp, top_k, keys."""
        rb = self._wave_rb
        return (np.zeros((rb, self.max_pages_per_seq), np.int32),
                np.zeros((rb,), np.int32), np.zeros((rb, sb), np.int32),
                np.zeros((rb, sb), np.int32), np.zeros((rb,), np.int32),
                np.zeros((rb,), np.float32), np.zeros((rb,), np.int32),
                np.zeros((rb, 2), np.uint32))

    def warmup(self, prompt_buckets=None, include_decode=True) -> int:
        """Run every dispatch shape traffic can hit once, by masked dummy
        dispatches: one prefill per (length bucket, cp in {0, full}),
        the speculative verify shape when spec_lookahead > 0, and the
        fused decode chunk. On a card this is where the kernel libraries
        build and load, cuBLAS initialises and the allocator grows.
        total_lens = 0 sends every page write to page 0 and leaves the
        decode carry as it is, so pages 1:, slot_ids and the allocator
        are untouched. prompt_buckets=() skips prefill shapes;
        include_decode=False skips decode-phase shapes. Returns the number
        of shapes run (the JAX engine's count). Needs an idle pipeline."""
        if self._inflight:
            raise RuntimeError("warmup requires an idle engine")
        S = self.config.max_batch
        rb = self._wave_rb
        mp = self.max_pages_per_seq
        k_steps = max(1, int(self.config.decode_steps_per_dispatch))
        n = 0
        if prompt_buckets is None:
            prompt_buckets = self.config.prefill_buckets
        for sb, cp in itertools.product(prompt_buckets, (0, mp)):
            self._fetch_tokens(self._compute_prefill(
                rb, cp, *self._dummy_prefill_args(sb)))
            n += 1
        if not include_decode:
            return n
        if self.config.spec_lookahead > 0:
            # the verify dispatch has ONE shape: the bucket covering
            # spec_lookahead + 1 (shorter drafts pad)
            sbv = _bucket(self._spec_len() + 1, self.config.prefill_buckets)
            self._fetch_tokens(self._compute_verify(
                np.zeros((rb, mp), np.int32), np.zeros((rb,), np.int32),
                np.zeros((rb, sbv), np.int32),
                np.zeros((rb, sbv), np.int32)))
            n += 1
        self._fetch_tokens(self._compute_decode(
            k_steps, np.zeros((S, mp), np.int32), np.zeros((S,), np.int32),
            np.ones((S,), np.int32), np.zeros((S, 1), np.int32),
            np.zeros((S,), bool), np.zeros((S, 1), np.int32),
            np.zeros((S,), np.float32), np.zeros((S,), np.int32),
            np.zeros((k_steps, S, 2), np.uint32)))
        return n + 1

    def measure_prefill(self, seq_len: Optional[int] = None,
                        iters: int = 3,
                        peak_flops: Optional[float] = None
                        ) -> Dict[str, Any]:
        """Synchronous prefill-only microbenchmark on the engine's own
        prefill shape (rows = prefill_wave_size, seq_len columns), by the
        same masked dummy dispatch as warmup(), so it leaves the engine
        untouched. Needs an idle pipeline. Returns the JAX engine's keys:
        ``link_rtt_ms`` is one dispatch and its synchronise (here a
        dispatch's whole round trip on the card, not a network link), and
        ``*_compute`` the per-dispatch estimate (chain - rtt)/(iters - 1).
        FLOPs follow the training convention: 2 N parameters + 4 L H hd S
        attention per token, N = ``param_count()``. ``peak_flops`` is the
        caller's (the engine knows no device peak)."""
        if self._inflight:
            raise RuntimeError("measure_prefill requires an idle engine")
        sb = seq_len or max(self.config.prefill_buckets)
        rb = self._wave_rb
        args = self._dummy_prefill_args(sb)

        def dispatch():
            return self._compute_prefill(rb, 0, *args)

        def finish(handle):
            self._fetch_tokens(handle)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        finish(dispatch())  # untimed: first use of the shape
        t0 = time.perf_counter()
        finish(dispatch())
        rtt = time.perf_counter() - t0
        # chained dispatches (stream order serialises them), ONE sync
        t0 = time.perf_counter()
        handle = None
        for _ in range(iters):
            handle = dispatch()
        finish(handle)
        dt = time.perf_counter() - t0

        cfg = self.model_cfg
        n_params = self.param_count()
        flops_per_tok = (2 * n_params
                         + 4 * cfg.num_layers * cfg.num_heads
                         * cfg.head_dim_ * sb)
        tokens = rb * sb * iters
        achieved = tokens / dt * flops_per_tok
        # compute-only estimate, clamped against noisy samples and
        # flagged unreliable when the chain barely exceeds one round trip
        reliable = dt > 1.5 * rtt
        c = max((dt - rtt) / max(iters - 1, 1), dt / iters * 0.05)
        achieved_compute = (rb * sb * flops_per_tok) / c
        if peak_flops:
            achieved_compute = min(achieved_compute, float(peak_flops))
        out = {"seq_len": sb, "rows": rb, "iters": iters,
               "link_rtt_ms": round(rtt * 1e3, 1),
               "prefill_tok_s": round(tokens / dt, 1),
               "achieved_tflops": round(achieved / 1e12, 2),
               "achieved_tflops_compute": round(
                   achieved_compute / 1e12, 2),
               "compute_estimate_reliable": reliable}
        if peak_flops:
            out["mfu"] = round(100.0 * achieved / peak_flops, 2)
            out["mfu_compute"] = round(
                100.0 * achieved_compute / peak_flops, 2)
        return out

    def param_count(self) -> int:
        """The model's parameters, every rank's parts on a mesh (the
        global count, as the JAX engine counts its global tree)."""
        tp = self.sharding.tp if self.sharding else 1
        return sum(p.numel() * (tp if "tp" in split_dims(name) else 1)
                   for name, p in self.model.named_parameters())

    # ------------------------------------------------------------ stats

    def stats(self) -> Dict[str, Any]:
        free = self.allocator.num_free()
        out = {
            "running": len(self.running),
            "waiting": len(self.waiting),
            "inflight": len(self._inflight),
            "expired_total": self._expired_total,
            "preempted_total": self._preempted_total,
            "spec_drafted_total": self._spec_drafted_total,
            "spec_accepted_total": self._spec_accepted_total,
            "free_pages": free,
            "pages_free": free,
            **self.allocator.stats,
        }
        if self.sharding is not None:
            out["sharding"] = self.sharding.page_accounting(
                self.config, self.model_cfg)
        return out
