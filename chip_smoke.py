#!/usr/bin/env python3
"""Smoke run of ray_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
1. device: needs a CUDA card; prints its name and power limit;
2. build: compiles every kernel of the serving path with nvcc for sm_90a
   and prints the ptxas register/shared-memory summary;
3. kernels: each kernel against its plain PyTorch version at Llama-3-8B
   shapes in bf16 (max error against a stated tolerance), with CUDA-event
   times of the kernel, the plain version and one PyTorch library call;
4. engine: the Serve-LLM engine at the full width and depth of llama3-8b
   (bf16, seeded random weights made on the card) serves 8 requests, one
   of them a prefix-cache hit that takes the cached-prefix (ctx) path; the
   kernels' launch counters must show the path went through them; then
   a steady decode window with all slots busy, timed and profiled, and
   one profiled prefill wave;
5. reference: at llama3-8b width with 2 layers in float32, first-prefill
   logits and greedy tokens of the kernel path on the card must match the
   plain path on the CPU.
Then one JSON line of per-kernel numbers, and as the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import warnings

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_FLOPS = 989e12          # H100 SXM dense bf16 tensor-core peak
# bf16 outputs: both sides keep float32 accumulators and round once to
# bf16, whose step is 2^-8 to 2^-7 of the value, so they may differ by a
# rounding step or two: |kernel - plain| <= 2e-2 + 1e-2 * |plain|
ATOL_O_BF16 = 2e-2
RTOL_O_BF16 = 1e-2
# lse is float32 on both sides; only the summation order differs
ATOL_LSE = 1e-3
# float32 end to end: accumulation order differs between cuBLAS/kernels
# and the CPU
ATOL_LOGITS_F32 = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2, flush=None) -> float:
    """Mean time of fn() by CUDA events; `flush` (a large buffer) is
    rewritten before each timed launch so inputs start cold in L2."""
    import torch

    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        if flush is not None:
            flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def close_bf16(got, want) -> bool:
    diff = (got.float() - want.float()).abs()
    return bool((diff <= ATOL_O_BF16 + RTOL_O_BF16 * want.float().abs())
                .all())


def check_kernels(torch, flush):
    """Phase 3: K1 and K2 against their plain versions at 8B shapes."""
    from ray_tpu_torch.ops.flash_attention import (flash_attention,
                                                   flash_attention_plain)
    from ray_tpu_torch.ops.paged_attention import (
        paged_attention_decode, paged_attention_decode_plain, paged_write)

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    hq, hkv, d, page, mp = 32, 8, 128, 16, 128
    results = {}

    # ---- K1: paged decode, B=8, ragged lengths, NaN outside live rows
    lengths = [0, 1, 15, 16, 17, 300, 1000, 2047]
    b = len(lengths)
    num_pages = 1 + b * mp
    pool = torch.full((num_pages, hkv, page, 2 * d), float("nan"),
                      dtype=bf16, device=dev)
    perm = torch.randperm(num_pages - 1, generator=gen, device=dev) + 1
    bt = perm[: b * mp].reshape(b, mp).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kd = torch.randn((b, mp * page, hkv, d), generator=gen, device=dev)
    vd = torch.randn((b, mp * page, hkv, d), generator=gen, device=dev)
    pos = torch.arange(mp * page, device=dev).expand(b, -1)
    paged_write(pool, kd.to(bf16), vd.to(bf16), bt, pos, lens)
    q = torch.randn((b, hq, d), generator=gen, device=dev).to(bf16)
    scale = d ** -0.5
    got = paged_attention_decode(q, pool, bt, lens)
    want = paged_attention_decode_plain(q, pool, bt, lens, scale=scale)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all(), "K1 output not finite"
    assert (got[0] == 0).all(), "K1: a length-0 row must give zeros"
    err = max_err(got, want)
    log(f"K1 paged_decode: max|kernel-plain| = {err:.3e} "
        f"(tolerance {ATOL_O_BF16} + {RTOL_O_BF16}*|plain|: bf16 output "
        f"rounding, f32 accumulators)")
    assert close_bf16(got, want), "K1 disagrees with its plain version"
    ms = time_ms(lambda: paged_attention_decode(q, pool, bt, lens),
                 flush=flush)
    plain_ms = time_ms(lambda: paged_attention_decode_plain(
        q, pool, bt, lens, scale=scale), flush=flush)
    used_rows = sum(math.ceil(n / page) * page for n in lengths)
    k1_bytes = used_rows * hkv * 2 * d * 2 + 2 * q.numel() * 2 \
        + bt.numel() * 4 + lens.numel() * 4
    k1_flops = 4 * sum(lengths) * hq * d
    results["paged_decode"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
        bytes=k1_bytes, flops=k1_flops)

    # ---- K2 self part: B=4, S=512, causal
    bs, s = 4, 512
    qs = torch.randn((bs, s, hq, d), generator=gen, device=dev).to(bf16)
    ks = torch.randn((bs, s, hkv, d), generator=gen, device=dev).to(bf16)
    vs = torch.randn((bs, s, hkv, d), generator=gen, device=dev).to(bf16)
    o, lse = flash_attention(qs, ks, vs, causal=True, return_lse=True)
    o_p, lse_p = flash_attention_plain(qs, ks, vs, causal=True, q_seg=None,
                                       kv_seg=None, scale=scale)
    torch.cuda.synchronize()
    err_o, err_l = max_err(o, o_p), max_err(lse, lse_p)
    log(f"K2 flash_fwd self (B=4 S=512 causal): max|o| err {err_o:.3e} "
        f"(tolerance {ATOL_O_BF16} + {RTOL_O_BF16}*|plain|), max|lse| err "
        f"{err_l:.3e} (atol {ATOL_LSE})")
    assert close_bf16(o, o_p) and err_l <= ATOL_LSE, "K2 self disagrees"
    q_t = qs.transpose(1, 2).contiguous()
    k_t = ks.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
    v_t = vs.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    results["flash_fwd_self"] = dict(
        max_abs_err=max(err_o, err_l),
        ms=time_ms(lambda: flash_attention(qs, ks, vs, causal=True,
                                           return_lse=True), flush=flush),
        plain_ms=time_ms(lambda: flash_attention_plain(
            qs, ks, vs, causal=True, q_seg=None, kv_seg=None, scale=scale),
            flush=flush),
        library_ms=time_ms(lambda: sdpa(q_t, k_t, v_t, is_causal=True),
                           flush=flush),
        bytes=(2 * qs.numel() + ks.numel() + vs.numel()) * 2  # q, o, k, v
        + lse.numel() * 4,
        flops=4 * bs * hq * s * s * d // 2)

    # ---- K2 ctx part: Sq=256, Sk=2048, non-causal, segment-masked
    ctx = [0, 16, 1024, 2048]
    sq, sk = 256, 2048
    bc = len(ctx)
    qc = torch.randn((bc, sq, hq, d), generator=gen, device=dev).to(bf16)
    kc = torch.randn((bc, sk, hkv, d), generator=gen, device=dev).to(bf16)
    vc = torch.randn((bc, sk, hkv, d), generator=gen, device=dev).to(bf16)
    q_seg = torch.ones((bc, sq), dtype=torch.int32, device=dev)
    kv_seg = (torch.arange(sk, device=dev)[None]
              < torch.tensor(ctx, device=dev)[:, None]).to(torch.int32)
    o, lse = flash_attention(qc, kc, vc, causal=False,
                             segment_ids=(q_seg, kv_seg), return_lse=True)
    o_p, lse_p = flash_attention_plain(qc, kc, vc, causal=False,
                                       q_seg=q_seg, kv_seg=kv_seg,
                                       scale=scale)
    torch.cuda.synchronize()
    err_o, err_l = max_err(o, o_p), max_err(lse, lse_p)
    assert (o[0] == 0).all() and (lse[0] == -1e30).all(), \
        "K2: a fully masked row must give o=0, lse=-1e30"
    log(f"K2 flash_fwd ctx (Sq=256 Sk=2048 ctx {ctx}): max|o| err "
        f"{err_o:.3e} (tolerance {ATOL_O_BF16} + {RTOL_O_BF16}*|plain|), "
        f"max|lse| err {err_l:.3e} (atol {ATOL_LSE})")
    assert close_bf16(o, o_p) and err_l <= ATOL_LSE, "K2 ctx disagrees"
    q_t = qc.transpose(1, 2).contiguous()
    k_t = kc.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
    v_t = vc.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
    mask = (q_seg[:, None, :, None] == kv_seg[:, None, None, :])
    live = sum(ctx)  # kv rows the segment mask lets through
    results["flash_fwd_ctx"] = dict(
        max_abs_err=max(err_o, err_l),
        ms=time_ms(lambda: flash_attention(
            qc, kc, vc, causal=False, segment_ids=(q_seg, kv_seg),
            return_lse=True), flush=flush),
        plain_ms=time_ms(lambda: flash_attention_plain(
            qc, kc, vc, causal=False, q_seg=q_seg, kv_seg=kv_seg,
            scale=scale), flush=flush),
        library_ms=time_ms(lambda: sdpa(q_t, k_t, v_t, attn_mask=mask),
                           flush=flush),
        bytes=qc.numel() * 2 * 2 + lse.numel() * 4 + live * hkv * d * 2 * 2
        + q_seg.numel() * 4 + kv_seg.numel() * 4,
        flops=4 * hq * sq * d * live)
    for r in results.values():
        r["bound_ms"] = 1e3 * max(r["bytes"] / HBM_BYTES_PER_S,
                                  r["flops"] / BF16_FLOPS)
        r["bound_by"] = ("bytes" if r["bytes"] / HBM_BYTES_PER_S
                         >= r["flops"] / BF16_FLOPS else "operations")
    for name, r in results.items():
        log(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}"
            f" ms, library {r['library_ms']} ms, bound {r['bound_ms']:.4f}"
            f" ms ({r['bound_by']})")
    return results


def serve(engine, requests, late):
    """Drive engine.step() until every request finishes. `late` requests
    are added once every earlier request has its first token (so a shared
    prefix is in the page cache). Returns ({rid: tokens}, {rid: ttft_s},
    decode tokens/s)."""
    t_add, ttft, out = {}, {}, {}
    for rid, prompt, sp in requests:
        engine.add_request(rid, prompt, sp)
        t_add[rid] = time.perf_counter()
        out[rid] = []
    pending_late = list(late)
    finished = set()
    total = len(requests) + len(late)
    t_first = None
    for _ in range(100000):
        if pending_late and all(out[r] for r, _, _ in requests):
            for rid, prompt, sp in pending_late:
                engine.add_request(rid, prompt, sp)
                t_add[rid] = time.perf_counter()
                out[rid] = []
            pending_late = []
        for dlt in engine.step():
            now = time.perf_counter()
            if dlt.new_token_ids and dlt.request_id not in ttft:
                ttft[dlt.request_id] = now - t_add[dlt.request_id]
                t_first = t_first or now
            out[dlt.request_id].extend(dlt.new_token_ids)
            if dlt.finished:
                finished.add(dlt.request_id)
        if len(finished) == total and not pending_late:
            break
    assert len(finished) == total, "engine did not finish every request"
    t_end = time.perf_counter()
    decode_tokens = sum(len(v) - 1 for v in out.values())
    return out, ttft, decode_tokens / (t_end - t_first)


def run_engine(torch, flush_counts):
    """Phase 4: llama3-8b, full width and depth, bf16, 8 requests."""
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.serve.llm import SamplingParams as SP

    t0 = time.perf_counter()
    engine = LLMEngine(EngineConfig(
        model="llama3-8b", dtype="bfloat16", page_size=16, num_pages=2048,
        max_model_len=2048, max_batch=8, decode_steps_per_dispatch=4,
        prefill_buckets=(64, 128, 256, 512, 1024, 2048)))
    torch.cuda.synchronize()
    log(f"engine built (llama3-8b, {engine.model_cfg.num_layers} layers, "
        f"bf16 weights made on the card) in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    rng = np.random.default_rng(1)
    vocab = engine.model_cfg.vocab_size

    def prompt(n):
        return [int(t) for t in rng.integers(0, vocab, n)]

    prefix = prompt(256)
    requests = [(f"r{n}", prompt(n), SP(max_tokens=32))
                for n in (20, 97, 180, 512, 700, 1000)]
    requests[2] = ("r180", requests[2][1],
                   SP(max_tokens=32, temperature=0.8, top_k=40, seed=7))
    requests.append(("prefix_a", prefix + prompt(64), SP(max_tokens=32)))
    late = [("prefix_b", prefix + prompt(150), SP(max_tokens=32))]
    # one short request first, so TTFT below excludes one-time CUDA and
    # cuBLAS initialisation
    serve(engine, [("warmup", prompt(40), SP(max_tokens=4))], [])
    flush_counts()  # the main path's run starts here
    t0 = time.perf_counter()
    out, ttft, tok_s = serve(engine, requests, late)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = engine.stats()
    for rid, toks in out.items():
        assert len(toks) == 32, (rid, len(toks))
        assert all(0 <= t < vocab for t in toks), rid
    assert stats["cache_hits"] >= 16, "prefix_b did not hit the prefix cache"
    return engine, dict(ttft_ms={k: v * 1e3 for k, v in ttft.items()},
                        decode_tok_s=tok_s, wall_s=wall, stats=stats)


def profile_decode(torch, engine):
    """Steady decode with all 8 slots busy (300-token prompts): tokens/s
    over 6 unprofiled steps, then 6 steps under torch.profiler for the
    device's busy share and the kernels that take its time."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.serve.llm import SamplingParams as SP

    rng = np.random.default_rng(4)
    vocab = engine.model_cfg.vocab_size
    rids = [f"w{i}" for i in range(engine.config.max_batch)]
    for rid in rids:
        engine.add_request(rid, [int(t) for t in
                                 rng.integers(0, vocab, 300)],
                           SP(max_tokens=200))
    seen = set()
    while len(seen) < len(rids):  # every slot prefilled and decoding
        seen.update(d.request_id for d in engine.step() if d.new_token_ids)
    for _ in range(2):
        engine.step()

    def window(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = sum(len(d.new_token_ids) for _ in range(n)
                   for d in engine.step())
        torch.cuda.synchronize()
        return toks, time.perf_counter() - t0

    toks, dt = window(6)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        p_toks, p_dt = window(6)
    # two more steps with CUDA's sync debug mode on: a synchronising call
    # inside them (dispatch or harvest) is reported and fails the run; the
    # harvest's wait on its copy's event is not one
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            engine.step()
            engine.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "prototype feature" not in str(w.message)]
    for rid in rids:
        engine.abort(rid)
    while engine.has_work():
        engine.step()
    out = {"decode_tok_s": toks / dt, "step_ms": dt / 6 * 1e3,
           "profiled_tokens": p_toks, **device_summary(prof, p_dt),
           "sync_warnings_in_2_steps": len(syncs)}
    log(f"steady decode (8 slots, K=4): {out['decode_tok_s']:.1f} tok/s, "
        f"{out['step_ms']:.2f} ms per step; device busy "
        f"{100 * out['device_busy_share']:.1f}% of a profiled window")
    log_kernels(out)
    log(f"synchronising calls in 2 engine steps: {len(syncs)} "
        f"{sorted(set(syncs))[:3]}")
    assert not syncs, "a dispatch or harvest synchronised the host"
    return out


def device_summary(prof, wall_s):
    """Device busy time, its share of `wall_s` and the top kernels of a
    torch.profiler window."""
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA"]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    return {"profiled_wall_ms": wall_s * 1e3,
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e6 / wall_s,
            "top_kernels": [{"name": e.key[:60],
                             "ms": e.self_device_time_total / 1e3,
                             "calls": e.count} for e in top]}


def log_kernels(summary):
    for k in summary["top_kernels"]:
        log(f"  {k['ms']:9.3f} ms {k['calls']:6d} calls  {k['name']}")


def profile_prefill(torch, engine):
    """One prefill wave, 4 prompts of 1000 tokens (bucket 1024) asking
    for one token each, under torch.profiler: where prefill time goes."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.serve.llm import SamplingParams as SP

    rng = np.random.default_rng(5)
    vocab = engine.model_cfg.vocab_size
    rids = [f"pf{i}" for i in range(4)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for rid in rids:
            engine.add_request(rid, [int(t) for t in
                                     rng.integers(0, vocab, 1000)],
                               SP(max_tokens=1))
        done = set()
        while len(done) < len(rids):
            done.update(d.request_id for d in engine.step() if d.finished)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    while engine.has_work():
        engine.step()
    out = device_summary(prof, wall)
    log(f"prefill wave (4 x 1000 tokens, bucket 1024): "
        f"{out['profiled_wall_ms']:.1f} ms wall under the profiler, device "
        f"busy {out['device_busy_ms']:.1f} ms")
    log_kernels(out)
    return out


def check_reference(torch):
    """Phase 5: float32, llama3-8b width, 2 layers; the kernel path on the
    card against the plain path on the CPU, same weights."""
    from ray_tpu_torch.models.config import get_config
    from ray_tpu_torch.models.convert import build_model, init_params
    from ray_tpu_torch.models.llama import PagedCache
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.serve.llm import SamplingParams as SP

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("llama3-8b", num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(3)
    sd_gpu = init_params(cfg, gen, "cuda", torch.float32)
    sd_cpu = {k: v.cpu() for k, v in sd_gpu.items()}

    # first-prefill logits through the paged path (K2 self part)
    rng = np.random.default_rng(2)
    n = 200
    ids = rng.integers(0, cfg.vocab_size, (1, n))
    logits = {}
    for dev, sd in (("cuda", sd_gpu), ("cpu", sd_cpu)):
        model = build_model(cfg, sd, dev, torch.float32)
        pool = torch.zeros((cfg.num_layers, 32, cfg.num_kv_heads, 16,
                            2 * cfg.head_dim_), device=dev)
        bt = torch.arange(1, 17, dtype=torch.int32, device=dev)[None]
        cache = PagedCache(pool, bt, torch.tensor([n], dtype=torch.int32,
                                                  device=dev))
        with torch.inference_mode():
            logits[dev] = model(torch.from_numpy(ids).to(dev),
                                torch.arange(n, device=dev)[None],
                                cache).float().cpu()
        del model
    err = max_err(logits["cuda"], logits["cpu"])
    log(f"f32 first-prefill logits (2 layers, 8B width): max|kernel path - "
        f"plain path| = {err:.3e} (atol {ATOL_LOGITS_F32})")
    assert torch.isfinite(logits["cuda"]).all()
    assert err <= ATOL_LOGITS_F32, "kernel-path logits disagree"

    # greedy tokens through the engine, incl. a prefix-cache (ctx) hit
    base = dict(model="llama3-8b", model_overrides={"num_layers": 2},
                dtype="float32", page_size=16, num_pages=256,
                max_model_len=1024, max_batch=4, decode_steps_per_dispatch=4,
                prefill_buckets=(64, 128, 256, 512, 1024))
    prefix = [int(t) for t in rng.integers(0, cfg.vocab_size, 160)]
    reqs = [("a", [int(t) for t in rng.integers(0, cfg.vocab_size, 40)]),
            ("b", prefix + [int(t) for t in rng.integers(0, cfg.vocab_size,
                                                         30)])]
    late = [("c", prefix + [int(t) for t in rng.integers(0, cfg.vocab_size,
                                                         70)])]
    outs = {}
    for dev, sd in (("cuda", sd_gpu), ("cpu", sd_cpu)):
        engine = LLMEngine(EngineConfig(**base, device=dev), params=sd)
        outs[dev], _, _ = serve(
            engine, [(r, p, SP(max_tokens=8)) for r, p in reqs],
            [(r, p, SP(max_tokens=8)) for r, p in late])
        assert engine.stats()["cache_hits"] > 0
        del engine
    log(f"f32 greedy tokens, kernel path: {outs['cuda']}")
    log(f"f32 greedy tokens, plain path:  {outs['cpu']}")
    assert outs["cuda"] == outs["cpu"], "greedy tokens differ"
    return err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.ops.paged_attention import paged_attention_decode

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(f"device: {name} (torch {torch.__version__}, cuda "
        f"{torch.version.cuda})")
    log(smi)

    # 2. build every kernel, in parallel, from the checkout's sources
    t0 = time.perf_counter()
    reports = _build.build_all(force=True)
    log(f"built {sorted(reports)} with nvcc {' '.join(_build.NVCC_FLAGS)} "
        f"in {time.perf_counter() - t0:.1f} s")
    for kname, rep in reports.items():
        for line in rep.splitlines():
            if "Compiling entry function" in line or "Used" in line \
                    or "spill" in line:
                log(f"  [{kname}] {line.strip()}")

    # 3. kernels against their plain versions
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    kernels = check_kernels(torch, flush)
    del flush

    # 4. the main path
    def flush_counts():
        paged_attention_decode.launches = 0
        flash_attention.launches = 0
        flash_attention.segment_launches = 0

    engine, eng = run_engine(torch, flush_counts)
    counts = {"paged_decode": paged_attention_decode.launches,
              "flash_fwd_self": flash_attention.launches
              - flash_attention.segment_launches,
              "flash_fwd_ctx": flash_attention.segment_launches}
    log(f"engine: TTFT ms {json.dumps(eng['ttft_ms'])}")
    log(f"engine: decode {eng['decode_tok_s']:.1f} tok/s over "
        f"{eng['wall_s']:.2f} s wall; stats {json.dumps(eng['stats'])}")
    log(f"engine: kernel launches {json.dumps(counts)}")
    for kname, c in counts.items():
        assert c > 0, f"{kname} was never launched on the main path"
    eng["steady"] = profile_decode(torch, engine)
    eng["prefill_wave"] = profile_prefill(torch, engine)
    del engine
    torch.cuda.empty_cache()

    # 5. reference check
    logits_err = check_reference(torch)

    sources = {"paged_decode": ("ray_tpu_torch/ops/csrc/paged_decode.cu",
                                "ray_tpu/ops/paged_attention.py:138"),
               "flash_fwd_self": ("ray_tpu_torch/ops/csrc/flash_fwd.cu",
                                  "ray_tpu/ops/flash_attention.py:66"),
               "flash_fwd_ctx": ("ray_tpu_torch/ops/csrc/flash_fwd.cu",
                                 "ray_tpu/ops/flash_attention.py:66")}
    line = {"kernels": [
        {"name": kname, "route": "cuda", "source": sources[kname][0],
         "replaces": sources[kname][1], "launches": counts[kname],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for kname, r in kernels.items()],
        "engine": {"ttft_ms": eng["ttft_ms"],
                   "decode_tok_s": eng["decode_tok_s"],
                   "wall_s": eng["wall_s"], "steady": eng["steady"],
                   "prefill_wave": eng["prefill_wave"],
                   "f32_logits_max_abs_err": logits_err}}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
