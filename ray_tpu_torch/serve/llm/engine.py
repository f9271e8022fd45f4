"""Paged-KV continuous-batching LLM engine on PyTorch.

Counterpart of the JAX package's ``serve/llm/engine.py``: the host
scheduler (admission, prefix caching, page-pressure recompute preemption,
fused K-step decode dispatches, a ``pipeline_depth``-deep window of
in-flight dispatches harvested in order) is that engine's, line for line
where the two share a feature; the jitted compute is replaced by eager
PyTorch on one device.

Device rules:
- the page pool ``[L, P, Hkv, page, 2*D]`` and the decode carry
  ``slot_ids`` stay on the device and are updated in place;
- inputs go up from pinned host memory without blocking; sampled tokens
  come back by a non-blocking copy into pinned memory plus a recorded
  CUDA event, which ``_fetch_tokens`` waits on at harvest; nothing inside
  a dispatch reads a device value on the host;
- ``EngineConfig.device`` defaults to ``"cuda"``; with no card the engine
  raises instead of falling back to the CPU.

Scheduling is the legacy prefill-priority mode: admit and prefill whole
prompts first, then fill the pipeline with fused decode chunks, then
harvest the oldest dispatch. Chunked prefill, speculative decoding, P/D
KV handoff, deadlines, warmup/measure_prefill and tensor or pipeline
parallelism are not ported yet: ``EngineConfig`` refuses them.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ...models.config import get_config, torch_dtype
from ...models.convert import build_model, init_params
from ...models.llama import PagedCache
from .cache import OutOfPages, PageAllocator

WAITING, RUNNING, FINISHED = "WAITING", "RUNNING", "FINISHED"


@dataclasses.dataclass
class SamplingParams:
    max_tokens: int = 64
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0            # 0 => full vocab; bounded by 64
    stop_token_ids: tuple = ()
    seed: Optional[int] = None  # None => engine-level seed


@dataclasses.dataclass
class Request:
    request_id: str
    prompt_ids: List[int]
    sampling: SamplingParams
    state: str = WAITING
    pages: List[int] = dataclasses.field(default_factory=list)
    output_ids: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None
    last_page_hash: Optional[int] = None
    n_hashed: int = 0            # tokens already entered into prefix cache
    arrival_t: float = dataclasses.field(default_factory=time.monotonic)
    slot: int = -1               # decode slot while RUNNING
    planned_out: int = 0         # tokens dispatched (>= len(output_ids))
    decode_ready: bool = False   # prefill harvested; slot may decode
    n_prefilled: int = 0         # prompt tokens whose KV is dispatched

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
    # "cuda" (default) or "cpu"; a cuda engine with no card raises
    device: str = "cuda"
    # not ported yet; kept so configs written for the JAX engine parse,
    # and refused at any value but the default
    tp: int = 1
    pp: int = 1
    prefill_chunk_tokens: int = 0
    spec_lookahead: int = 0

    def __post_init__(self):
        for name, default in (("tp", 1), ("pp", 1),
                              ("prefill_chunk_tokens", 0),
                              ("spec_lookahead", 0)):
            if getattr(self, name) != default:
                raise ValueError(
                    f"EngineConfig.{name}={getattr(self, name)!r}: not "
                    f"supported by the PyTorch engine yet (only {default})")


_MAX_TOP_K = 64


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds the largest bucket {buckets[-1]}")


class LLMEngine:
    """Single-process engine. Not thread-safe except `add_request`/`abort`
    (which only touch the locked intake queue); one thread calls
    `step()`.

    params: a state dict (e.g. from ``models.convert.params_from_flax``)
    or None for a seeded random init made on the device."""

    def __init__(self, config: EngineConfig,
                 params: Optional[Dict[str, torch.Tensor]] = None):
        self.config = config
        self._build_compute(params)
        self.max_pages_per_seq = config.max_model_len // config.page_size
        self.allocator = PageAllocator(config.num_pages, config.page_size)
        self._init_host_state()

    def _build_compute(self, params) -> None:
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
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(config.seed)
            params = init_params(self.model_cfg, gen, self.device, dtype)
        self.model = build_model(self.model_cfg, params, self.device, dtype)
        cfg_m = self.model_cfg
        # page-major combined layout [L, P, Hkv, page, 2*D]
        self.kv_pages = torch.zeros(
            (cfg_m.num_layers, config.num_pages, cfg_m.num_kv_heads,
             config.page_size, 2 * cfg_m.head_dim_),
            dtype=dtype, device=self.device)
        # device-resident last-sampled token per slot: the decode carry
        self.slot_ids = torch.zeros((config.max_batch, 1), dtype=torch.long,
                                    device=self.device)
        self._rng = torch.Generator(device=self.device)

    def _init_host_state(self) -> None:
        config = self.config
        self._intake: List[Request] = []
        self._intake_lock = threading.Lock()
        self._aborted: set = set()
        self.waiting: List[Request] = []
        self.running: List[Request] = []
        self.requests: Dict[str, Request] = {}
        self._preempted_total = 0
        # rows per prefill dispatch (the single row count per bucket)
        self._wave_rb: int = (config.prefill_wave_size
                              or max(1, config.max_batch // 2))
        self._free_slots: List[int] = list(range(config.max_batch))
        # pending-first-decode override: slot -> host-known pending token
        self._slot_override: Dict[int, int] = {}
        # FIFO of in-flight dispatches awaiting harvest
        self._inflight: List[dict] = []

    # ----------------------------------------------------------- intake

    def add_request(self, request_id: str, prompt_ids: List[int],
                    sampling: Optional[SamplingParams] = None,
                    deadline: Optional[float] = None) -> None:
        if deadline is not None:
            raise ValueError("request deadlines are not supported by the "
                             "PyTorch engine yet")
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
        with self._intake_lock:
            self._intake.append(req)

    def abort(self, request_id: str) -> None:
        with self._intake_lock:
            self._aborted.add(request_id)

    def has_work(self) -> bool:
        with self._intake_lock:
            if self._intake:
                return True
        return bool(self.waiting or self.running or self._inflight)

    # ------------------------------------------------------------- step

    def step(self) -> List[OutputDelta]:
        """One scheduler iteration: admit + prefill whole prompts first
        (prefill-priority), fill the pipeline with fused decode chunks,
        harvest the oldest in-flight dispatch (blocking only when its
        tokens have not landed yet)."""
        deltas: List[OutputDelta] = []
        self._drain_intake(deltas)
        depth = max(1, int(self.config.pipeline_depth))
        self._dispatch_prefills()
        while len(self._inflight) < depth and self._dispatch_decode_chunk():
            pass
        if self._inflight:
            self._harvest(self._inflight.pop(0), deltas)
        return deltas

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

    def _admit_one(self, burst_prefixes: set) -> Optional[Request]:
        """Admit the head of the waiting queue (slot + page budget
        permitting) WITHOUT prefilling; returns the request or None.
        Admission is strict FIFO. A request whose leading page matches one
        admitted THIS step is deferred: next step its prefix pages are
        computed and cached, so it shares them instead of prefilling the
        same content in parallel."""
        if not self.waiting or not self._free_slots:
            return None
        page = self.config.page_size
        req = self.waiting[0]
        first_hash = None
        if len(req.prompt_ids) >= page:
            first_hash = self.allocator.chain_hash(
                None, req.prompt_ids[:page])
            if first_hash in burst_prefixes:
                return None  # wait one step; the prefix cache will hit
        cached_pages, n_cached = self.allocator.match_prefix(req.prompt_ids)
        need = -(-(len(req.prompt_ids) + 1) // page) - len(cached_pages)
        if self.allocator.num_free() < need:
            self.allocator.release(cached_pages)
            self.allocator.stats["cache_hits"] -= len(cached_pages)
            return None
        if first_hash is not None:
            burst_prefixes.add(first_hash)
        self.waiting.pop(0)
        self.allocator.note_prefix_lookup(len(req.prompt_ids), n_cached)
        req.pages = cached_pages + self.allocator.allocate(need)
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
        self.running.append(req)
        return req

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

    def _compute_prefill(self, rb, cp, bt, total, ids, positions, gather,
                         temp, topk, keys):
        """One prefill dispatch; returns the handle of its [rb] tokens."""
        with torch.inference_mode():
            cache = PagedCache(self.kv_pages, self._h2d(bt),
                               self._h2d(total), ctx_pages=cp)
            h = self.model.hidden(self._h2d(ids), self._h2d(positions),
                                  cache)
            # project only each row's last prompt position
            rows = h[torch.arange(rb, device=self.device),
                     self._h2d(gather).long()]
            logits = self.model.lm_head(rows).float()
            return self._to_host_async(self._sample(logits, temp, topk,
                                                    keys))

    def _compute_decode(self, k_steps, bt, total, caps, positions,
                        override_mask, override_ids, temp, topk,
                        keys_steps):
        """One fused K-step decode dispatch over the full slot set; returns
        the handle of its [K, S] tokens."""
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
                logits = self.model.lm_head(h[:, 0]).float()
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
            return self._to_host_async(torch.stack(toks))

    def _dispatch_prefills(self) -> None:
        """Admit as many waiting requests as slots/pages allow and launch
        one whole-prompt prefill dispatch per length bucket and wave."""
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

    def _dispatch_prefill_batch(self, sb: int, group: List[tuple]) -> None:
        """One prefill dispatch of rows (request, n_new). Rows whose start
        is > 0 (a prefix-cache hit) attend to their cached pages through
        the ctx-merge path."""
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
            rows.append((req.request_id, req.slot, start + n_new))
        # ctx_pages buckets to {0, full}: a fresh-prompt wave reads no pages
        cp = (self.max_pages_per_seq
              if any(req.n_prefilled for req, _ in group) else 0)
        temp, topk, keys = self._sampling_arrays(
            [req for req, _ in group], rb)
        tokens = self._compute_prefill(rb, cp, bt, total, ids, positions,
                                       gather, temp, topk, keys)
        for req, n_new in group:
            req.n_prefilled += n_new
            req.planned_out = 1
        self._inflight.append({"kind": "prefill", "toks": tokens,
                               "group": rows})

    def _decode_eligible(self) -> List[Request]:
        """Slots safe to decode: RUNNING, prefill harvested, and not
        already dispatched through their whole token budget."""
        cfg = self.config
        elig = []
        for req in self.running:
            if req.slot < 0 or not req.decode_ready:
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
            for i, (rid, slot, end) in enumerate(rec["group"]):
                req = self.requests.get(rid)
                if req is None or req.state != RUNNING or req.slot != slot:
                    continue  # aborted while in flight
                self._register_full_pages(req, upto=end)
                token = int(toks_np[i])
                # the decode chain reads this slot's first input from the
                # host-side override (the prefill wrote pages, not the
                # slot carry)
                self._slot_override[slot] = token
                req.decode_ready = True
                self._append_token(req, token, deltas)
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
        req.n_prefilled = 0
        req.n_hashed = 0
        req.planned_out = 0
        req.decode_ready = False
        req.state = WAITING
        self.waiting.insert(0, req)

    def _release_slot(self, req: Request) -> None:
        if req.slot >= 0:
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
        if stop:
            self._finish(req, stop)
            deltas.append(OutputDelta(req.request_id, [token], True, stop))
        else:
            deltas.append(OutputDelta(req.request_id, [token], False))

    def _register_full_pages(self, req: Request,
                             upto: Optional[int] = None) -> None:
        """Enter any newly-FULL prompt pages into the prefix cache (only
        prompt tokens), bounded by the tokens whose KV has been written."""
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

    # ------------------------------------------------------------ stats

    def stats(self) -> Dict[str, Any]:
        free = self.allocator.num_free()
        return {
            "running": len(self.running),
            "waiting": len(self.waiting),
            "inflight": len(self._inflight),
            "preempted_total": self._preempted_total,
            "free_pages": free,
            "pages_free": free,
            **self.allocator.stats,
        }
