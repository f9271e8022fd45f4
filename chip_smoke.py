#!/usr/bin/env python3
"""Smoke run of ray_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py [--parent DIR]

Phases (any failure exits non-zero; nothing is caught). Each runs under a
watchdog (`run_phase`): a phase still running at its deadline in
DEADLINES_S, such as a kernel spinning on a barrier, ends the run with
every thread's traceback and exit code 1.
1. device: needs a CUDA card; prints its name and power limit;
2. build: compiles every kernel with nvcc for sm_90a, prints the ptxas
   register/shared-memory summary and, from `cuobjdump -sass`, each entry
   function's count of wgmma (HGMMA), TMA load (UTMALDG), bulk copy
   (UBLKCP) and mma.sync (HMMA) instructions; the bf16 K2, K3 and K4
   kernels must have HGMMA and UTMALDG, the bf16 K1 kernel a bulk copy and
   tensor-core instructions, and each has an instance at every head dim of
   KERNEL_HEAD_DIMS (DESIGN_ENTRIES', the designs of a head dim of its
   own: K2, K3 and K4 at D 256 and K4 and K1 at D 96, and K2 at D 96,
   which holds Q's fragments in registers, must spill nothing, as must
   the float32 K2 and K4 at every head dim but F32_SPILLS');
3. kernels: each kernel against its plain PyTorch version at Llama-3-8B
   shapes in bf16 (max error against a stated tolerance), with CUDA-event
   times of the kernel, the plain version and one PyTorch library call,
   and K1's decode and merge kernels' device time from torch.profiler;
   K2's ctx part at two shapes: 256 queries (a prefix-cache hit, a
   prefill chunk) and speculative verify's 64, whose prefixes end off a
   page edge;
4. engine: the Serve-LLM engine at the full width and depth of llama3-8b
   (bf16, seeded random weights made on the card) serves 8 requests, one
   of them a prefix-cache hit that takes the cached-prefix (ctx) path; the
   kernels' launch counters must show the path went through them; then
   a steady decode window with all slots busy, timed and profiled, one
   profiled prefill wave, and the greedy tokens of the parity prompts
   (`entry.parity_prompts()`, 8 tokens each);
4a. tp_engine: phase 4 again (its model, seed, settings and traffic)
   through the tensor-parallel engine, LLMEngine(config,
   mesh=create_mesh(MeshConfig(tp=1, fsdp=1))) on a world of one rank over
   NCCL: the frames to the followers, the tp-local layers at tp 1 and
   their collectives. K1 and K2 (self and ctx) must launch on its traffic
   (added to phase 4's counts), its greedy tokens on the parity prompts
   must equal phase 4's, and its steady decode (ms per step, tok/s, the
   frames' count, bytes and host ms per step) is printed beside phase 4's;
4e. pp_engine: phase 4's model, seed, settings and traffic (and the
   parity prompts) through the pipelined engine at pp 2 on the one card:
   two processes (spawn(share_device=True): a gloo world, both ranks on
   card 0), stage 0 and the scheduler on rank 0, stage 1 and the sampler
   on rank 1, host-staged frames between them. K1 and K2 (self and ctx)
   must launch on both stages in its main traffic (requests and late,
   bracketed on every rank by the engine's marks; the two stages' counts
   must agree, and are added to phase 4's), its greedy
   parity tokens must equal phase 4's, and its steady decode (ms per
   step, tok/s, rank 0's frames, bytes and host ms per step,
   pp_bubble_frac) is printed beside phase 4's;
4b. engine_v2: at phase 4's settings, engines built on one set of
   weights: warmup() (shapes and seconds); chunked prefill (256-token
   chunks) against the legacy scheduler while 7 requests decode and a
   2000-token prompt arrives (the longest gap between steps that emit a
   running request's token; K2's ctx part must launch during the chunks);
   speculative decoding on prompts repeating a 64-token pattern (drafted
   and accepted tokens); the P/D handoff (a prefill_only engine's blob
   injected into a decode engine: pages bit-identical, tokens identical to
   one engine serving the request alone); a 2 s deadline passing
   mid-decode (finish "expired", pages returned); measure_prefill at
   4 x 2048 tokens. K1 and K2 (self and ctx) launch counts must be
   non-zero and are added to phase 4's;
4c. moe: mixtral-8x7b at full width in bf16 (seeded weights made on the
   card), as deep as leaves 6 GiB of the card free, through phase 4's
   engine settings and traffic (K1 and K2 launches added to phase 4's),
   a profiled steady-decode window and prefill wave with the MoE layers'
   time apart (expert products, routing, dispatch and combine), the share
   of real (token, choice) assignments dropped by capacity in prefill and
   decode (a forward hook repeats the routing), and measure_prefill(2048)
   beside a rate counted from active FLOPs;
4d. moe_reference: at Mixtral width with 2 layers in float32, first-
   prefill logits and the routing behind them, and greedy tokens in the
   legacy, chunked and speculative engines: the card's tokens must equal
   the CPU's in each mode;
5. reference: at llama3-8b width with 2 layers in float32, first-prefill
   logits and greedy tokens of the kernel path on the card must match the
   plain path on the CPU, in the legacy scheduler, with chunked prefill
   and with speculative decoding (each equal to the legacy kernel path);
5b. dense_cache: at llama3-8b width with 2 layers in float32, the dense
   KV-cache path (LlamaModel(..., kv_caches=)) prefills 512 tokens into
   an empty cache and decodes 16 one at a time: every position's logits
   within 1e-3 of the full forward's, K2's split-KV design launched at
   Sq = 1 once a layer and step (flash_attention.decode_launches); then
   K2 at that call's shape, in float32 and in bf16, against its plain
   version, timed beside SDPA (row flash_fwd_decode, the bf16 variant
   under its "bf16" key); then the split-KV and 64-row designs at Sq 1 to
   64 in both types, each held to the plain version and timed in turns
   (the measurement behind DECODE_MAX_SQ);
6. training kernels: K2 (forward), K3 (backward dq) and K4 (backward
   dk/dv) against their plain versions at llama-1b's training shapes
   (bf16, B 4, S 2048, Hq 32, Hkv 8, D 64, causal), plus a packed-segment
   case and an sq < sk case, with CUDA-event times of each kernel, its
   plain version and SDPA (forward, and backward for K3/K4); and at
   moe_trainer's shapes (Mixtral: B 2, S 2048, Hq 32, Hkv 8, D 128),
   causal and with packed segments; then the float32 variants at both
   shapes likewise, timed beside their float32 bound and SDPA (under
   "f32" and "f32_d128" in the training rows);
7. trainer: ShardedTrainer on llama-1b at full width and depth (float32
   params, bf16 compute, remat "nothing", fused loss) takes 6 steps on one
   batch of 4 x 2048 seeded tokens; the loss must fall and K2/K3/K4 must
   have launched as many times as the layers need; then one profiled
   step;
7b. moe_trainer: ShardedTrainer at Mixtral width with 2 layers (float32
   params, bf16 compute, remat "nothing"), 4 steps on 2 x 2048 tokens:
   the loss must fall, the router terms must be at least 0.99 x coef per
   layer, and K2/K3/K4 must have launched as the layers need;
7c. mesh_trainer: phase 7 again (llama-1b, its seed, batch and
   optimizer) through the mesh trainer, ShardedTrainer(model,
   create_mesh(MeshConfig(fsdp=1))) on a world of one rank over NCCL:
   FSDP2's fully_shard, the tp-local layers at tp=1 and their
   collectives. Each step's loss and grad norm must be within rtol 1e-4
   and 1e-3 of phase 7's, the loss must fall and K2/K3/K4 must have
   launched as the layers need (added to the kernels' launches); ms per
   step, tokens/s and peak memory beside phase 7's;
7d. sp_attention: ring_attention and ulysses_attention over the one-rank
   sp group of create_mesh(MeshConfig(sp=1, fsdp=1)) (NCCL) at llama-1b's
   training shapes (bf16, B 4, S 2048, Hq 32, Hkv 8, D 64; causal, and
   packed segments), forward and backward, each against the dense kernel
   path (K2, K3, K4) and the plain version within the bf16 tolerance;
   Ulysses must launch K2, K3 and K4 (added to the kernels' launches);
   CUDA-event times of a forward and backward of ring, Ulysses and
   dense;
7e. pp_trainer: phase 7's run (llama-1b, its seed, batch and optimizer)
   through PipelinedTrainer on create_mesh(MeshConfig(pp=1, fsdp=1)), the
   one-stage bypass: the loss and grad norm of steps 1-2 within rtol 1e-4
   and 1e-3 of phase 7's, of every step within 1e-3 and 1e-2 (the dense
   loss rounds the head's product otherwise, and AdamW's updates grow
   the difference: RTOL_PP_LOSS), the loss must fall and K2/K3/K4 must launch as the
   layers need (added to the kernels' launches); ms per step, tokens/s
   and peak memory beside phase 7's; then the GPipe loop itself,
   gpipe(stage, 1, 4), on the same stack and batch (the one-rank shift,
   a copy, and the float32 broadcast, a one-rank NCCL all-reduce): its
   loss and gradients against the bypass's;
7f. checkpoint: phase 7's trainer takes 2 steps, saves its state
   (``train.checkpoint.save_train_state``: float32 parameters and AdamW's
   two moments, whole, in the JAX fallback's pickle) into a temporary
   directory and takes step 3; a fresh trainer loads it and takes step
   3, within loss rtol 1e-5, grad norm 1e-4 and parameters 1e-5 of the
   uninterrupted step; then the one-rank mesh trainer (FSDP2 over NCCL)
   at 2 layers likewise; the bytes and seconds to save and load;
8. train reference: at llama-1b width with 2 layers in float32, one step
   on the card and on the CPU's plain path from the same parameters must
   give the same loss, grad norm and updated parameters;
9. rllib: every learner of ray_tpu_torch.rllib (PPO discrete and
   Gaussian, DQN dueling with IS weights, IMPALA, APPO, BC, MARWIL, SAC,
   CQL, DreamerV3 on a vector and on a 64 x 64 x 3 image) at the JAX
   package's default sizes: three updates on the card and on the CPU from
   one init, batch and noise, after_update between them, TF32 off; before
   each update the CPU takes the card's state, and each update's metrics
   (rtol 1e-5, grad norm 1e-4) and parameters (phase 8's rule) must agree;
   DreamerV3's draws that a near tie decides otherwise on the CPU are
   replayed from the card's and counted. The median ms per update on each
   side; one act() over 64 envs for the MLP policy and DreamerV3's
   stateful step (same actions on both sides, ms each); a profiled card
   update of SAC and DreamerV3;
10. entry: ``entry.entry()``'s forward (llama-500m width, 8 layers, vocab
   8192, bf16) on the card: logits [2, 256, 8192], K2 once a layer (added
   to the training row's launches), within ATOL_ENTRY_BF16 of the same
   function on the CPU with the same parameters; ms a forward;
11. head_dims: K1-K4 at head dims 32, 96 and 256 (Hq/Hkv 8/4, 32/32,
   16/8), bf16 and float32, against their plain versions (K1: phase 3's
   ragged lengths, NaN outside the live rows; K2-K4: B 2, S 2048 causal,
   packed segments, 512 queries over 2048 keys), timed with L2 flushed
   beside their bounds and SDPA where it takes the shape; Phi-3-mini's
   widths (D 96) served at full depth in bf16 with phase 4's traffic
   (TTFT, tok/s), a Llama block at Gemma-2-9B's attention widths (D 256)
   and a small Llama at D 32 served at 4 layers likewise; phase 5's
   check (f32, 2 layers, card against CPU) at D 96 and D 256; 3
   ShardedTrainer steps at each width (4 layers) in bf16 and float32,
   each held to the same steps with attention through the plain versions
   on the card. Rows "<kernel>_d<D>" (bf16, float32 under "f32") count
   the launches of these served and trained runs, name the bf16 design
   they time ("design") and give K1's kernels' device time from the
   profiler ("decode_us", "merge_us"); K2's bf16 split-KV design at D 256 (Sq
   1, Sk 528, the dense cache's decode) is timed beside its bound, SDPA
   and this tree's 64-row kernel ("tiles_ms") under "decode_bf16" of
   its row.
The float32 phases (4d, 5, dense_cache, 8 and head_dims' float32 runs)
count their K2, K3 and K4 launches: one log line, "f32_launches" in the
JSON line, and "launches" in the float32 rows (K2's 64-row design).
With `--parent DIR` (a directory holding an earlier commit's tree, for
example unpacked by `git archive` into the ignored `_archive/`), phases
3, 5b, 6 and head_dims also build that tree's paged_decode.cu, flash_fwd.cu
and flash_bwd.cu and time its K1, K2, K3 and K4 on the same inputs, in
turns with the current ones; head_dims prints whether K1-K4's outputs
equal the earlier tree's bit for bit.
Then one JSON line of per-kernel numbers, and as the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import faulthandler
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_FLOPS = 989e12          # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12            # H100 SXM float32 outside the tensor cores
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
# bf16 gradients (K3, K4): float32 accumulators on both sides; the kernel
# rounds p and ds to bf16 before their products, as the TPU kernels do,
# and both sides round the output once: the o tolerance holds (checked
# against a CPU emulation of the rounding at S 1024, D 64)
# one float32 training step, card against CPU (phase 8): loss and grad
# norm differ by summation order only
RTOL_LOSS_F32 = 1e-5
RTOL_GNORM_F32 = 1e-4
# the mesh trainer at one rank against phase 7 (bf16 compute, 6 steps):
# the same parameters and batch; the loss's log-sum-exp over the
# vocabulary is taken in another order, and FSDP copies the gradients
RTOL_MESH_LOSS = 1e-4
RTOL_MESH_GNORM = 1e-3
# ring attention's gradients (phase sp_attention) against the kernels and
# the plain version: autograd of the ring's blocks takes dp = do . v^T
# as the bf16 product that JAX's design gives it (p is rounded to v's
# type before p . V, so its cotangent is bf16 too), before the softmax
# backward's subtraction dp - delta, where the kernels keep dp in float32
# and round ds: a rounding step of dp (up to 2^-8 x 10) survives the
# subtraction. At S 2048 a CPU emulation read errors up to 0.027 where the
# value is 0.08 (dk; 0.0208 allowed at 2e-2 + 1e-2 x |ref|)
ATOL_RING_GRAD_BF16 = 5e-2
# the pipelined trainer at one stage against phase 7: the same parameters,
# batch and layers; its loss is JAX's dense cross-entropy over [B, S, V]
# logits where phase 7's is the fused chunked one (the head's bf16
# product in one [8192, 2048] x [2048, 32000] call instead of 512-row
# chunks, so some logits round otherwise). Steps 1 and 2 (the parameters
# phase 7 starts from: the first step's learning rate is 0) are held to
# mesh_trainer's tolerances. From step 3 on AdamW's normalised update
# moves every weight by about lr whatever its gradient's size, so the
# rounding differences of the first update grow: on an H100 the losses
# read equal at steps 1-3, then 1.1e-5, 2.9e-5 and 1.4e-4 apart at steps
# 4-6, the grad norms up to 7.5e-4 apart. Every step is held to 1e-3 and
# 1e-2
RTOL_PP_LOSS = 1e-3
RTOL_PP_GNORM = 1e-2
# the GPipe loop at one stage (4 microbatches of one row) against the
# bypass (the whole batch at once), from the same parameters: each bf16
# product of a microbatch may round otherwise than the batch's, and a
# weight's gradient is summed over the 4 microbatches in float32 where
# the batch's is one bf16 product (2^-8 relative a rounding)
RTOL_GPIPE_LOSS = 1e-3
RTOL_GPIPE_GRADS = 1e-2
# Adam's first moment (0.1 x the clipped gradient), per tensor, relative
# to the tensor's largest entry: sums over 512 tokens in another order
RTOL_MU_F32 = 1e-4
# updated parameters: the first step moves each by lr * (g / (|g| + eps)
# + wd * p), g the clipped gradient. Where |g| >= NOISY_GRAD (100 eps)
# that is within ~1e-8 of its value on the other side, so the two agree
# within ATOL_PARAM_F32. Below it, a gradient entry's float32 noise (sums
# of hundreds of terms near 1e-3, ~1e-9 after the clip) is comparable to
# eps = 1e-8 and the step may land anywhere in [-lr, lr]: such entries
# may differ by up to 2 * lr
ATOL_PARAM_F32 = 1e-6
NOISY_GRAD = 1e-6
# entry()'s logits (bf16 compute on float32 parameters, 8 layers), card
# against CPU: both round every layer's activations to bf16 after
# products summed in other orders; at the logits' magnitude (up to 4-8,
# where bf16's step is 2^-5) eight steps. An H100 read 0.078 (2.5 steps)
# at max|logit| 5.28
ATOL_ENTRY_BF16 = 0.25


# Each phase's deadline in seconds: about five times its time on an H100
# (logged by run_phase: build 23.9 s with the earlier tree's kernels,
# kernels 9.2, engine 33.1, engine_v2 28.8, moe 69.5, moe_reference 39.6,
# reference 26.1 with its chunked and speculative engines, train_kernels
# 3.4, trainer 5.7, moe_trainer 1.3, mesh_trainer 5.1 to 14.3 with its
# NCCL start and a profiled step, train_reference 5.7; on a slower host
# build 42.2, kernels 17.4, engine 58.3; tp_engine as engine, with an NCCL
# start; pp_engine 28.3 with its two processes, dense_cache 0.3,
# checkpoint 72.4 with 13.5 GB written and read; rllib 15.3, entry 10.8;
# head_dims 55.6), and at least 30 s. Since the split-KV K2 and the
# float32 rows: build 42.1 to 48.6 s, then 21.5 to 24.6 for the earlier
# tree's kernels (86.6 to 97.8 in all); dense_cache 1.2, train_kernels
# 6.4, head_dims 36.3
DEADLINES_S = {"device": 30, "build": 300, "kernels": 60, "engine": 240,
               "tp_engine": 240, "engine_v2": 150, "moe": 350, "moe_reference": 200,
               "reference": 150, "train_kernels": 120, "trainer": 45,
               "moe_trainer": 30, "mesh_trainer": 60, "sp_attention": 60,
               "pp_trainer": 90, "train_reference": 45, "pp_engine": 150,
               "dense_cache": 30, "checkpoint": 360, "rllib": 90,
               "entry": 60, "head_dims": 280}


def log(msg: str) -> None:
    print(msg, flush=True)


def run_phase(name: str, deadline_s: float, fn, *args, **kwargs):
    """fn(*args, **kwargs) under a watchdog: if it has not returned after
    deadline_s seconds, faulthandler prints every thread's traceback and
    ends the process with exit code 1."""
    log(f"phase {name} (deadline {deadline_s} s)")
    t0 = time.perf_counter()
    faulthandler.dump_traceback_later(deadline_s, exit=True)
    try:
        out = fn(*args, **kwargs)
    finally:
        faulthandler.cancel_dump_traceback_later()
    log(f"phase {name} took {time.perf_counter() - t0:.1f} s")
    return out


# cycles the stream sleeps before each timed launch (about 0.6 ms): the
# host queues fn's launches meanwhile, so its launch latency stays out of
# the event window (without it, a 15 us kernel read 23 to 216 us)
HOLD_CYCLES = 1_000_000


def time_ms(fn, iters: int = 10, warmup: int = 2, flush=None) -> float:
    """Mean time of fn() by CUDA events; `flush` (a large buffer) is
    rewritten before each timed launch so inputs start cold in L2, and
    the stream is held busy before the window opens."""
    import torch

    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(HOLD_CYCLES)
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def time_windows(fn, iters: int = 20, windows: int = 3) -> list:
    """Mean time of fn() in each of `windows` runs of `iters` back-to-back
    calls between two CUDA events (no flush), after 2 warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    out = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return out


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def close_bf16(got, want, atol: float = ATOL_O_BF16) -> bool:
    diff = (got.float() - want.float()).abs()
    return bool((diff <= atol + RTOL_O_BF16 * want.float().abs()).all())


@contextlib.contextmanager
def one_rank_world(what: str):
    """A world of one rank over NCCL (a file store in a temporary
    directory), destroyed on exit."""
    import tempfile

    import torch.distributed as dist

    from ray_tpu_torch.parallel.distributed import init_process_group

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        init_process_group("cuda", rank=0, world_size=1,
                           store=dist.FileStore(os.path.join(tmp, "store"),
                                                1), timeout_s=120)
        log(f"{what}: world of 1 rank over {dist.get_backend()} in "
            f"{time.perf_counter() - t0:.1f} s")
        try:
            yield
        finally:
            dist.destroy_process_group()


# the earlier tree's kernel libraries (--parent), else None
PARENT = None


def build_parent(root: str) -> dict:
    """Build an earlier tree's kernel sources (under
    root/ray_tpu_torch/ops/csrc) into root/_build, in parallel; returns the
    loaded libraries, whose entry points take the current arguments (an
    entry point the earlier tree lacks is left unbound)."""
    from ray_tpu_torch.ops import _build

    csrc = os.path.join(root, "ray_tpu_torch", "ops", "csrc")
    out_dir = os.path.join(root, "_build")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in _build.SOURCES:
        path = os.path.join(out_dir, f"libparent_{name}.so")
        procs[name] = (path, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", path,
             os.path.join(csrc, _build.SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        report, _ = proc.communicate()
        assert proc.returncode == 0, f"parent {name} build failed:\n{report}"
        lib = ctypes.CDLL(path)
        for fn_name, argtypes in _build.SIGNATURES[name].items():
            if not hasattr(lib, fn_name):
                continue
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def parent_fwd(torch, q, k, v, causal, q_seg, kv_seg, scale):
    """The earlier tree's K2, called as the wrapper calls the current one."""
    from ray_tpu_torch.ops import flash_attention as fa

    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, sq, hq), dtype=torch.float32, device=q.device)
    code = PARENT["flash_fwd"].flash_fwd(
        fa._DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), fa._ptr(q_seg), fa._ptr(kv_seg), b, sq,
        sk, hq, hkv, d, fa._strides(q, k, v, o), int(causal), float(scale),
        torch.cuda.current_stream().cuda_stream)
    assert code == 0, f"parent flash_fwd: cudaError {code}"
    return o, lse


def parent_decode(torch, q, pool, bt, lens, scale):
    """The earlier tree's K1, called as the wrapper calls the current one
    (partial buffers sized by that tree's own split count)."""
    from ray_tpu_torch.ops import paged_attention as pa

    lib = PARENT["paged_decode"]
    b, hq, d = q.shape
    _, hkv, page, _ = pool.shape
    mp = bt.shape[1]
    n_split = lib.paged_decode_splits(page, mp)
    part_acc = torch.empty((b, hq, n_split, d), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b, hq, n_split, 2), dtype=torch.float32,
                          device=q.device)
    out = torch.empty_like(q)
    code = lib.paged_decode(
        pa._DTYPE_CODES[q.dtype], q.data_ptr(), pool.data_ptr(),
        bt.data_ptr(), lens.data_ptr(), part_acc.data_ptr(),
        part_ml.data_ptr(), out.data_ptr(), b, hq, hkv, d, page, mp,
        float(scale), torch.cuda.current_stream().cuda_stream)
    assert code == 0, f"parent paged_decode: cudaError {code}"
    return out


def parent_dq(torch, q, k, v, do, lse, delta, causal, q_seg, kv_seg,
              scale):
    """The earlier tree's K3, called as the wrapper calls the current one."""
    from ray_tpu_torch.ops import flash_attention as fa

    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dq = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    code = PARENT["flash_bwd"].flash_bwd_dq(
        fa._DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), fa._ptr(q_seg),
        fa._ptr(kv_seg), dq.data_ptr(), b, sq, sk, hq, hkv, d,
        fa._strides(q, k, v, do), int(causal), float(scale),
        torch.cuda.current_stream().cuda_stream)
    assert code == 0, f"parent flash_bwd_dq: cudaError {code}"
    return dq


def parent_dkv(torch, q, k, v, do, lse, delta, causal, q_seg, kv_seg,
               scale):
    """The earlier tree's K4, called as the wrapper calls the current one."""
    from ray_tpu_torch.ops import flash_attention as fa

    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dk = torch.empty((b, sk, hkv, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, sk, hkv, d), dtype=v.dtype, device=v.device)
    code = PARENT["flash_bwd"].flash_bwd_dkv(
        fa._DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), fa._ptr(q_seg),
        fa._ptr(kv_seg), dk.data_ptr(), dv.data_ptr(), b, sq, sk, hq, hkv, d,
        fa._strides(q, k, v, do), int(causal), float(scale),
        torch.cuda.current_stream().cuda_stream)
    assert code == 0, f"parent flash_bwd_dkv: cudaError {code}"
    return dk, dv


def timed(fn, flush, parent_fn=None):
    """(ms, parent_ms): fn's time by time_ms; with the earlier tree's
    version, both in turns (current, earlier, earlier, current), each the
    mean of its two."""
    if parent_fn is None:
        return time_ms(fn, flush=flush), None
    t = [time_ms(f, flush=flush) for f in (fn, parent_fn, parent_fn, fn)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


# K2's (either design; "flash_fwd_split" of them the split-KV one), K3's
# and K4's launch counters, read around the float32 phases
F32_COUNTERS = {"flash_fwd": "launches", "flash_fwd_split": "decode_launches",
                "flash_bwd_dq": "dq_launches", "flash_bwd_dkv": "dkv_launches"}


def kernel_counts(since=None) -> dict:
    """K2's, K3's and K4's launch counters now, or their growth since an
    earlier reading of this function."""
    from ray_tpu_torch.ops.flash_attention import flash_attention

    now = {k: getattr(flash_attention, a) for k, a in F32_COUNTERS.items()}
    return now if since is None else {k: now[k] - since[k] for k in now}


SASS_OPS = ("HGMMA", "UTMALDG", "UBLKCP", "HMMA")


def check_sass(_build) -> None:
    """Count wgmma (HGMMA), TMA load (UTMALDG), bulk copy (UBLKCP) and
    mma.sync (HMMA) instructions per entry function of the built libraries.
    The bf16 K2, K3 and K4 kernels must have HGMMA and UTMALDG, and no
    mma.sync design of them may remain; the bf16 K1 kernel must have a
    bulk copy and tensor-core instructions; each of the four has an
    instance at every head dim of KERNEL_HEAD_DIMS."""
    from ray_tpu_torch.ops.flash_attention import KERNEL_HEAD_DIMS

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = {}
    for name in _build.SOURCES:
        sass = subprocess.run([tool, "-sass", _build._lib_path(name)],
                              check=True, capture_output=True,
                              text=True).stdout
        fn = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                counts[fn] = dict.fromkeys(SASS_OPS, 0)
            elif fn is not None:
                for op in SASS_OPS:
                    counts[fn][op] += re.search(rf"\b{op}\b", line) is not None
    for fn, c in sorted(counts.items()):
        log(f"  sass {fn}: " + ", ".join(f"{op} {c[op]}" for op in SASS_OPS))
    for key in ("flash_fwd_wgmma", "bwd_dq_wgmma", "bwd_dkv_wgmma"):
        fns = [fn for fn in counts if key in fn]
        assert fns, f"no {key} entry function in the built libraries"
        for fn in fns:
            assert counts[fn]["HGMMA"] > 0 and counts[fn]["UTMALDG"] > 0, \
                f"{fn} has no wgmma or no TMA load"
    fns = [fn for fn in counts
           if "paged_decode_mma" in fn or "paged_decode_mha" in fn]
    assert fns, "no bf16 K1 entry function in the built libraries"
    for fn in fns:
        c = counts[fn]
        assert c["UBLKCP"] > 0 and c["HMMA"] + c["HGMMA"] > 0, \
            f"{fn} has no bulk copy or no tensor-core instruction"
    old = [fn for fn in counts if any(
        key in fn for key in ("flash_fwd_mma", "bwd_dq_mma", "bwd_dkv_mma"))]
    assert not old, f"an mma.sync design of K2, K3 or K4 remains: {old}"
    # a bf16 instance of each kernel at every head dim the wrappers take,
    # DESIGN_ENTRIES' where a head dim has a design of its own
    for key in ("flash_fwd_wgmma", "bwd_dq_wgmma", "bwd_dkv_wgmma",
                "paged_decode_mma"):
        for d in KERNEL_HEAD_DIMS:
            name = DESIGN_ENTRIES.get(d, {}).get(key, key)
            assert any(f"{name}ILi{d}E" in fn for fn in counts), \
                f"no {name}<{d}> in the built libraries"
    for d in DESIGN_ENTRIES:
        assert any(f"flash_fwd_wgmmaILi{d}E" in fn for fn in counts), \
            f"no one-warpgroup K2 at D {d} (Sq <= 64) in the built libraries"


# the bf16 designs of a head dim of their own, by head dim: at D 256 the
# two-warpgroup K2 past 64 q rows, K3 and K4 (K3's and K4's warpgroups
# exchange p and dS, or P^T and dS^T); at D 96 K4, each warpgroup owning
# 64 rows of a 128-row kv tile, and K1, four warps sharing each split
DESIGN_ENTRIES = {
    256: {"flash_fwd_wgmma": "flash_fwd_wgmma_pair",
          "bwd_dq_wgmma": "bwd_dq_wgmma_pair",
          "bwd_dkv_wgmma": "bwd_dkv_wgmma_pair"},
    96: {"bwd_dkv_wgmma": "bwd_dkv_wgmma_rows",
         "paged_decode_mma": "paged_decode_mha"}}


# the one-warpgroup K2 holding Q's fragments in registers (fwd_q_regs in
# flash_fwd.cu): held to no spill like the two-warpgroup designs
Q_REGS_ENTRIES = [("flash_fwd_wgmma", 96)]


# the float32 K2 and K4 (register tiles): an instance at every head dim,
# none spilling but these, each by at most F32_SPILL_BYTES: they were
# faster on the card than their variants that spill nothing
# (chip_variants.py: K2's S loop unrolled once, K4 at D 64 in two stages
# and one block an SM; PERF.md)
F32_ENTRIES = ("flash_fwd_f32", "bwd_dkv_f32")
F32_SPILLS = {("flash_fwd_f32", 32), ("flash_fwd_f32", 64),
              ("flash_fwd_f32", 96), ("bwd_dkv_f32", 64)}
F32_SPILL_BYTES = 128


def check_no_spill(reports) -> None:
    """The -Xptxas -v reports: each entry function's spill stores and
    loads; DESIGN_ENTRIES' entries (D 256 and 96), the one-warpgroup K2
    at D 96 (Q's fragments in registers) and the float32 K2 and K4 at
    every head dim must spill nothing, but F32_SPILLS' instances, which
    may spill up to F32_SPILL_BYTES."""
    from ray_tpu_torch.ops.flash_attention import KERNEL_HEAD_DIMS

    spills, fn = {}, None
    for rep in reports.values():
        for line in rep.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and fn is not None:
                spills[fn] = (int(m.group(1)), int(m.group(2)))
                fn = None
    held = [(name, d) for d, names in DESIGN_ENTRIES.items()
            for name in names.values()]
    held += Q_REGS_ENTRIES
    held += [(name, d) for name in F32_ENTRIES for d in KERNEL_HEAD_DIMS]
    for name, d in held:
        fns = [f for f in spills if f"{name}ILi{d}E" in f]
        assert fns, f"no ptxas report of {name}<{d}>"
        for f in fns:
            log(f"  {name}<{d}>: {spills[f][0]} bytes spill stores, "
                f"{spills[f][1]} bytes spill loads")
            if (name, d) in F32_SPILLS:
                assert max(spills[f]) <= F32_SPILL_BYTES, f"{f} spills"
            else:
                assert spills[f] == (0, 0), f"{f} spills"


def profile_decode_kernels(torch, fn, calls: int = 20) -> dict:
    """Device microseconds per call of K1's two kernels (the split pass,
    `paged_decode_mma` or at D 96 `paged_decode_mha`, and the merge), from
    torch.profiler over `calls` calls of fn."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type.name == "CUDA" and "paged_decode" in e.key:
            kind = "merge_us" if "merge" in e.key else "decode_us"
            out[kind] = e.self_device_time_total / e.count
    assert set(out) == {"decode_us", "merge_us"}, \
        f"K1's kernels not found in the profile: {out}"
    return out


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
    if PARENT is not None:  # the earlier tree computes the same function
        old = parent_decode(torch, q, pool, bt, lens, scale)
        log(f"  earlier tree's K1 against the current one: max diff "
            f"{max_err(old, got):.3e}")
    ms, parent_ms = timed(
        lambda: paged_attention_decode(q, pool, bt, lens), flush,
        PARENT and (lambda: parent_decode(torch, q, pool, bt, lens, scale)))
    prof_us = profile_decode_kernels(
        torch, lambda: paged_attention_decode(q, pool, bt, lens))
    log(f"  K1 device time per call (torch.profiler, 20 calls, L2 warm): "
        f"decode {prof_us['decode_us']:.2f} us, merge "
        f"{prof_us['merge_us']:.2f} us; event time {1e3 * ms:.2f} us "
        f"(L2 flushed)")
    plain_ms = time_ms(lambda: paged_attention_decode_plain(
        q, pool, bt, lens, scale=scale), flush=flush)
    # the live rows only: the kernel copies no row at or past a length
    k1_bytes = sum(lengths) * hkv * 2 * d * 2 + 2 * q.numel() * 2 \
        + bt.numel() * 4 + lens.numel() * 4
    k1_flops = 4 * sum(lengths) * hq * d
    results["paged_decode"] = dict(
        max_abs_err=err, ms=ms, parent_ms=parent_ms, plain_ms=plain_ms,
        library_ms=None, bytes=k1_bytes, flops=k1_flops, **prof_us)

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
    ms, parent_ms = timed(
        lambda: flash_attention(qs, ks, vs, causal=True, return_lse=True),
        flush, PARENT and (lambda: parent_fwd(torch, qs, ks, vs, True, None,
                                              None, scale)))
    results["flash_fwd_self"] = dict(
        max_abs_err=max(err_o, err_l), ms=ms, parent_ms=parent_ms,
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
    ms, parent_ms = timed(
        lambda: flash_attention(qc, kc, vc, causal=False,
                                segment_ids=(q_seg, kv_seg), return_lse=True),
        flush, PARENT and (lambda: parent_fwd(torch, qc, kc, vc, False, q_seg,
                                              kv_seg, scale)))
    results["flash_fwd_ctx"] = dict(
        max_abs_err=max(err_o, err_l), ms=ms, parent_ms=parent_ms,
        plain_ms=time_ms(lambda: flash_attention_plain(
            qc, kc, vc, causal=False, q_seg=q_seg, kv_seg=kv_seg,
            scale=scale), flush=flush),
        library_ms=time_ms(lambda: sdpa(q_t, k_t, v_t, attn_mask=mask),
                           flush=flush),
        bytes=qc.numel() * 2 * 2 + lse.numel() * 4 + live * hkv * d * 2 * 2
        + q_seg.numel() * 4 + kv_seg.numel() * 4,
        flops=4 * hq * sq * d * live)

    # ---- K2 ctx part at speculative verify's shape: 4 rows of 64 queries
    # (pending token + 4 drafts, padded to the 64 bucket) over the full
    # 2048-row block table, prefixes ending at total - 1, not at a page edge
    ctx = [37, 301, 1001, 2039]
    sq = 64
    qv = qc[:, :sq].contiguous()
    q_seg = torch.ones((bc, sq), dtype=torch.int32, device=dev)
    kv_seg = (torch.arange(sk, device=dev)[None]
              < torch.tensor(ctx, device=dev)[:, None]).to(torch.int32)
    o, lse = flash_attention(qv, kc, vc, causal=False,
                             segment_ids=(q_seg, kv_seg), return_lse=True)
    o_p, lse_p = flash_attention_plain(qv, kc, vc, causal=False,
                                       q_seg=q_seg, kv_seg=kv_seg,
                                       scale=scale)
    torch.cuda.synchronize()
    err_o, err_l = max_err(o, o_p), max_err(lse, lse_p)
    log(f"K2 flash_fwd verify (Sq=64 Sk=2048 ctx {ctx}): max|o| err "
        f"{err_o:.3e} (tolerance {ATOL_O_BF16} + {RTOL_O_BF16}*|plain|), "
        f"max|lse| err {err_l:.3e} (atol {ATOL_LSE})")
    assert close_bf16(o, o_p) and err_l <= ATOL_LSE, "K2 verify disagrees"
    q_t = qv.transpose(1, 2).contiguous()
    mask = (q_seg[:, None, :, None] == kv_seg[:, None, None, :])
    live = sum(ctx)
    ms, parent_ms = timed(
        lambda: flash_attention(qv, kc, vc, causal=False,
                                segment_ids=(q_seg, kv_seg), return_lse=True),
        flush, PARENT and (lambda: parent_fwd(torch, qv, kc, vc, False, q_seg,
                                              kv_seg, scale)))
    results["flash_fwd_verify"] = dict(
        max_abs_err=max(err_o, err_l), ms=ms, parent_ms=parent_ms,
        plain_ms=time_ms(lambda: flash_attention_plain(
            qv, kc, vc, causal=False, q_seg=q_seg, kv_seg=kv_seg,
            scale=scale), flush=flush),
        library_ms=time_ms(lambda: sdpa(q_t, k_t, v_t, attn_mask=mask),
                           flush=flush),
        bytes=qv.numel() * 2 * 2 + lse.numel() * 4 + live * hkv * d * 2 * 2
        + q_seg.numel() * 4 + kv_seg.numel() * 4,
        flops=4 * hq * sq * d * live)
    add_bounds(results)
    return results


def add_bounds(results):
    """Each kernel's bound: the larger of its bytes over the card's memory
    rate and its FLOPs over the peak of its inputs' type (the bf16
    tensor-core peak unless ``peak_flops`` says otherwise); its rate and
    its share of the bound."""
    for name, r in results.items():
        peak = r.get("peak_flops", BF16_FLOPS)  # by the inputs' type
        r["bound_ms"] = 1e3 * max(r["bytes"] / HBM_BYTES_PER_S,
                                  r["flops"] / peak)
        r["bound_by"] = ("bytes" if r["bytes"] / HBM_BYTES_PER_S
                         >= r["flops"] / peak else "operations")
        r["tflops"] = r["flops"] / r["ms"] / 1e9
        r["bound_share"] = r["bound_ms"] / r["ms"]
        parent = ("" if r.get("parent_ms") is None else
                  f", earlier tree {r['parent_ms']:.4f} ms "
                  f"({r['flops'] / r['parent_ms'] / 1e9:.1f} TFLOP/s)")
        log(f"  {name}: kernel {r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s, "
            f"{100 * r['bound_share']:.1f}% of the bound){parent}, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")


def check_flash_case(torch, gen, name, b, sq, sk, hq, hkv, d, segs,
                     dt=None):
    """K2, K3 and K4 on one causal case of seeded inputs in `dt` (bf16 by
    default; v a strided view of a fused k|v tensor, as in training)
    against their plain versions; K3/K4 get the kernels' own lse and
    delta, so each is checked alone. bf16 within ATOL_O_BF16 +
    RTOL_O_BF16 * |plain|, float32 within ATOL_HD_F32, lse within
    ATOL_LSE. Returns (q, k, v, do, o, lse, delta, kw) and the errors."""
    from ray_tpu_torch.ops.flash_attention import (
        attention_delta, flash_attention, flash_attention_plain,
        flash_bwd_dkv, flash_bwd_dkv_plain, flash_bwd_dq, flash_bwd_dq_plain)

    dt = dt or torch.bfloat16
    bf16 = dt == torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    def close(got, want):
        return close_bf16(got, want) if bf16 else \
            max_err(got, want) <= ATOL_HD_F32

    q, kv, do = randn(b, sq, hq, d), randn(b, sk, 2 * hkv, d), \
        randn(b, sq, hq, d)
    k, v = kv[:, :, :hkv].contiguous(), kv[:, :, hkv:]
    kw = dict(causal=True, q_seg=None if segs is None else segs[0],
              kv_seg=None if segs is None else segs[1], scale=d ** -0.5)
    o, lse = flash_attention(q, k, v, causal=True, segment_ids=segs,
                             return_lse=True)
    o_p, lse_p = flash_attention_plain(q, k, v, **kw)
    delta = attention_delta(o, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    dq_p = flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    dk_p, dv_p = flash_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    errs = {"o": max_err(o, o_p), "lse": max_err(lse, lse_p),
            "dq": max_err(dq, dq_p), "dk": max_err(dk, dk_p),
            "dv": max_err(dv, dv_p)}
    tol = (f"{ATOL_O_BF16} + {RTOL_O_BF16}*|plain|" if bf16 else
           f"{ATOL_HD_F32}, float32")
    log(f"{name} (B={b} Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} D={d}): "
        + ", ".join(f"max|{n}| err {e:.3e}" for n, e in errs.items())
        + f" (tolerance {tol}; lse atol {ATOL_LSE})")
    assert close(o, o_p) and errs["lse"] <= ATOL_LSE, f"{name}: K2 disagrees"
    assert close(dq, dq_p), f"{name}: K3 disagrees"
    assert close(dk, dk_p) and close(dv, dv_p), f"{name}: K4 disagrees"
    for t in (o, dq, dk, dv):
        assert torch.isfinite(t).all(), f"{name}: not finite"
    return (q, k, v, do, o, lse, delta, kw), errs


def check_training_kernels(torch, flush):
    """Phase 6: K2, K3 and K4 at llama-1b's training shapes and at
    moe_trainer's (Mixtral's head dim 128) against their plain versions
    (check_flash_case)."""
    from ray_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain, flash_bwd_dkv,
        flash_bwd_dkv_plain, flash_bwd_dq, flash_bwd_dq_plain)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    b, s, hq, hkv, d = 4, 2048, 32, 8, 64
    scale = d ** -0.5

    def run(name, sq, sk, segs, b=b, hq=hq, hkv=hkv, d=d):
        return check_flash_case(torch, gen, name, b, sq, sk, hq, hkv, d,
                                segs)

    # packed rows (documents of 512, 1024 and 512 tokens, and 2048) and
    # chunked-prefill-like rows (512 queries at the end of 2048 keys)
    seg = torch.tensor([0] * 512 + [1] * 1024 + [2] * 512,
                       dtype=torch.int32, device=dev)
    segs = torch.stack([seg, seg, torch.zeros_like(seg), seg.flip(0)])
    run("train kernels, packed segments", s, s, (segs, segs))
    run("train kernels, sq < sk", 512, s, None)
    # moe_trainer's shapes: Mixtral's D 128, the kernels' D-128 builds
    for name, mix_segs in (("causal", None),
                           ("packed segments", (segs[:2], segs[:2]))):
        run(f"train kernels at Mixtral's shapes, {name}", s, s, mix_segs,
            b=2, hq=32, hkv=8, d=128)
    (q, k, v, do, o, lse, delta, kw), errs = run("train kernels, causal",
                                                 s, s, None)

    # SDPA yardsticks on the same inputs: forward, and the backward alone
    # (dq, dk and dv in one call) over one prebuilt forward, 20 calls
    # back to back between the events so the host's launches overlap the
    # device's work, in three windows
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q_t, k_t, v_t = (x.transpose(1, 2).detach().requires_grad_()
                     for x in (q, k, v))
    out_t = sdpa(q_t, k_t, v_t, is_causal=True, enable_gqa=True)
    do_t = do.transpose(1, 2)
    bwd_windows = time_windows(lambda: torch.autograd.grad(
        out_t, (q_t, k_t, v_t), do_t, retain_graph=True))
    sdpa_bwd_ms = sorted(bwd_windows)[1]
    log(f"  SDPA backward alone, ms per call in 3 windows of 20: "
        f"{[round(t, 4) for t in bwd_windows]} (median {sdpa_bwd_ms:.4f})")
    with torch.no_grad():
        sdpa_fwd_ms = time_ms(lambda: sdpa(q_t, k_t, v_t, is_causal=True,
                                           enable_gqa=True), flush=flush)
    del out_t

    live = b * hq * s * (s + 1) // 2   # (q, k) pairs under the causal mask
    qb, kb = q.numel() * 2, k.numel() * 2  # bytes of q (= do, o) and k (= v)
    vec = lse.numel() * 4
    fwd_ms, fwd_parent_ms = timed(
        lambda: flash_attention(q, k, v, causal=True, return_lse=True),
        flush, PARENT and (lambda: parent_fwd(torch, q, k, v, True, None,
                                              None, scale)))
    dkv_ms, dkv_parent_ms = timed(
        lambda: flash_bwd_dkv(q, k, v, do, lse, delta, **kw), flush,
        PARENT and (lambda: parent_dkv(torch, q, k, v, do, lse, delta, True,
                                       None, None, scale)))
    dq_ms, dq_parent_ms = timed(
        lambda: flash_bwd_dq(q, k, v, do, lse, delta, **kw), flush,
        PARENT and (lambda: parent_dq(torch, q, k, v, do, lse, delta, True,
                                      None, None, scale)))
    if PARENT is not None:  # the earlier tree computes the same function
        dq_old = parent_dq(torch, q, k, v, do, lse, delta, True, None, None,
                           scale)
        dq_new = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        log(f"  earlier tree's K3 against the current one: max|dq| diff "
            f"{max_err(dq_old, dq_new):.3e}")
        dk_old, dv_old = parent_dkv(torch, q, k, v, do, lse, delta, True,
                                    None, None, scale)
        dk_new, dv_new = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        log(f"  earlier tree's K4 against the current one: max|dk| diff "
            f"{max_err(dk_old, dk_new):.3e}, max|dv| diff "
            f"{max_err(dv_old, dv_new):.3e}")
    results = {
        "flash_fwd_train": dict(
            max_abs_err=max(errs["o"], errs["lse"]), ms=fwd_ms,
            parent_ms=fwd_parent_ms,
            plain_ms=time_ms(lambda: flash_attention_plain(q, k, v, **kw),
                             flush=flush),
            library_ms=sdpa_fwd_ms,
            bytes=2 * qb + 2 * kb + vec, flops=2 * 2 * d * live),
        "flash_bwd_dq": dict(
            max_abs_err=errs["dq"], parent_ms=dq_parent_ms, ms=dq_ms,
            plain_ms=time_ms(lambda: flash_bwd_dq_plain(
                q, k, v, do, lse, delta, **kw), flush=flush),
            library_ms=sdpa_bwd_ms,
            bytes=3 * qb + 2 * kb + 2 * vec, flops=3 * 2 * d * live),
        "flash_bwd_dkv": dict(
            max_abs_err=max(errs["dk"], errs["dv"]), ms=dkv_ms,
            parent_ms=dkv_parent_ms,
            plain_ms=time_ms(lambda: flash_bwd_dkv_plain(
                q, k, v, do, lse, delta, **kw), flush=flush),
            library_ms=sdpa_bwd_ms,
            bytes=2 * qb + 4 * kb + 2 * vec, flops=4 * 2 * d * live)}
    log(f"  SDPA (is_causal, enable_gqa): forward {sdpa_fwd_ms:.4f} ms, "
        f"backward alone (dq, dk, dv in one call) {sdpa_bwd_ms:.4f} ms")
    add_bounds(results)
    # the float32 variants (the exact reference path) at the same shapes:
    # llama-1b's (D 64, B 4) under "f32", Mixtral's (D 128, B 2) under
    # "f32_d128", each with its bound at float32's peak, SDPA and, with
    # --parent, the earlier tree's kernels
    for key, d_, b_ in (("f32", d, b), ("f32_d128", 128, 2)):
        rows = hd_flash_rows(torch, flush, d_, hq, hkv, torch.float32, b=b_)
        log(f"training kernels in float32 (B {b_}, S {s}, {hq}/{hkv} heads, "
            f"D {d_}, causal):")
        add_bounds(rows)
        for kname, base in (("flash_fwd", "flash_fwd_train"),
                            ("flash_bwd_dq", "flash_bwd_dq"),
                            ("flash_bwd_dkv", "flash_bwd_dkv")):
            results[base][key] = {k: rows[kname][k] for k in (
                "max_abs_err", "ms", "parent_ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by", "tflops", "bound_share")}
        del rows
        torch.cuda.empty_cache()
    return results


def run_trainer(torch, reset_counts):
    """Phase 7: ShardedTrainer on llama-1b (22 layers, H 2048), 6 steps on
    one batch of 4 x 2048 tokens, then one profiled step."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models.config import get_config
    from ray_tpu_torch.models.llama import LlamaModel
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.parallel.train_lib import (ShardedTrainer,
                                                  default_optimizer)

    cfg = get_config("llama-1b")
    b, s = 4, 2048
    t0 = time.perf_counter()
    with torch.device("meta"):
        model = LlamaModel(cfg)
    trainer = ShardedTrainer(model, optimizer=default_optimizer(warmup=1))
    rng = np.random.default_rng(7)
    batch = {"input_ids": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (b, s), dtype=np.int32)).cuda()}
    state = trainer.init(torch.Generator(device="cuda").manual_seed(7),
                         batch)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state.params.values())
    log(f"trainer built (llama-1b: {cfg.num_layers} layers, H "
        f"{cfg.hidden_size}, {cfg.num_heads}/{cfg.num_kv_heads} heads, D "
        f"{cfg.head_dim_}, {n_params / 1e9:.3f} B params in "
        f"{model.param_dtype}, compute {model.dtype}, remat "
        f"{cfg.remat_policy if cfg.remat else 'off'}, loss chunk "
        f"{cfg.loss_chunk}) in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # the main path's run starts here
    metrics, step_ms = [], []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = trainer.step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    launches = {"flash_fwd_train": flash_attention.launches,
                "flash_bwd_dq": flash_attention.dq_launches,
                "flash_bwd_dkv": flash_attention.dkv_launches}
    peak = torch.cuda.max_memory_allocated()
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    log(f"train: losses {losses}")
    log(f"train: grad norms {gnorms}")
    log(f"train: step ms {[round(t, 2) for t in step_ms]}")
    log(f"train: kernel launches in 6 steps {json.dumps(launches)}")
    assert all(math.isfinite(x) for x in losses + gnorms), "non-finite loss"
    assert losses[-1] < losses[0], "the loss did not fall"
    layers, steps = cfg.num_layers, 6
    want = {"flash_fwd_train": 2 * layers * steps,  # forward + remat
            "flash_bwd_dq": layers * steps, "flash_bwd_dkv": layers * steps}
    assert launches == want, f"launches {launches}, expected {want}"

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = trainer.step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof_out = device_summary(prof, wall)

    step = sorted(step_ms[1:])[len(step_ms[1:]) // 2] / 1e3  # median, warm
    tokens = b * s
    h, v, l = cfg.hidden_size, cfg.vocab_size, cfg.num_layers
    matmul_params = cfg.num_params() - v * h - (2 * l + 1) * h
    live = b * cfg.num_heads * s * (s + 1) // 2
    attn = 2 * 2 * cfg.head_dim_ * live * l  # one forward's attention FLOPs
    # model FLOPs (no recompute): 6 N per token and forward + backward
    # attention (3 forwards' worth)
    model_flops = 6 * matmul_params * tokens + 3 * attn
    # the device's work with remat: every matmul's forward twice (the
    # layers' checkpoints and the fused loss's) but down_proj's, whose
    # recompute stops before it, plus its backward (2 products); K2 twice,
    # K3 (3 products) and K4 (4)
    f = cfg.intermediate_size
    device_flops = (8 * matmul_params - 2 * h * f * l) * tokens \
        + 2 * attn + attn * 7 / 2
    out = {"model": "llama-1b", "layers": l, "params": n_params,
           "batch": [b, s], "losses": losses, "grad_norms": gnorms,
           "step_ms": step_ms, "ms_per_step": step * 1e3,
           "tokens_per_s": tokens / step,
           "model_tflops_per_step": model_flops / 1e12,
           "mfu": model_flops / step / BF16_FLOPS,
           "bound_ms": device_flops / BF16_FLOPS * 1e3,
           "peak_memory_gib": peak / 2**30, "profiled_step": prof_out,
           "launches": launches}
    log(f"train: {out['ms_per_step']:.1f} ms per step (median of steps "
        f"2-6), {out['tokens_per_s']:.0f} tokens/s, model FLOPs "
        f"{out['model_tflops_per_step']:.1f} TFLOP per step = "
        f"{100 * out['mfu']:.1f}% of {BF16_FLOPS / 1e12:.0f} TFLOP/s; "
        f"bound {out['bound_ms']:.1f} ms (device FLOPs with remat); peak "
        f"memory {out['peak_memory_gib']:.2f} GiB")
    log(f"train: profiled step {prof_out['profiled_wall_ms']:.1f} ms wall, "
        f"device busy {prof_out['device_busy_ms']:.1f} ms "
        f"({100 * prof_out['device_busy_share']:.1f}%)")
    log_kernels(prof_out)
    del trainer, model, state, metrics, m
    return out


def run_mesh_trainer(torch, reset_counts, ref, smi):
    """Phase mesh_trainer: phase 7's run (llama-1b, seed 7, 6 steps on 4 x
    2048 tokens, default_optimizer(warmup=1)) through the mesh trainer on
    a world of one rank over NCCL, each step held to phase 7's ``ref``."""
    import torch.distributed as dist

    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models.config import get_config
    from ray_tpu_torch.models.llama import LlamaModel
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from ray_tpu_torch.parallel.train_lib import (ShardedTrainer,
                                                  default_optimizer)

    cfg = get_config("llama-1b")
    b, s, steps = 4, 2048, 6
    t0 = time.perf_counter()
    with one_rank_world("mesh trainer"):
        mesh = create_mesh(MeshConfig(fsdp=1))
        with torch.device("meta"):
            model = LlamaModel(cfg)
        trainer = ShardedTrainer(model, mesh, optimizer=default_optimizer(
            warmup=1))
        rng = np.random.default_rng(7)
        batch = {"input_ids": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (b, s), dtype=np.int32)).cuda()}
        state = trainer.init(torch.Generator(device="cuda").manual_seed(
            7), batch)
        torch.cuda.synchronize()
        log(f"mesh trainer built (world of 1 rank over "
            f"{dist.get_backend()}, mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}, FSDP2 over "
            f"(dp, fsdp)) in {time.perf_counter() - t0:.1f} s")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()  # this phase's main-path run starts here
        losses, gnorms, step_ms = [], [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = trainer.step(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        launches = {"flash_fwd_train": flash_attention.launches,
                    "flash_bwd_dq": flash_attention.dq_launches,
                    "flash_bwd_dkv": flash_attention.dkv_launches}
        peak = torch.cuda.max_memory_allocated()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = trainer.step(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        del trainer, model, state, m
    prof_out = device_summary(prof, wall)
    prof_out["host_ops"] = host_summary(prof)
    loss_err = [abs(a - r) / abs(r) for a, r in zip(losses, ref["losses"])]
    gn_err = [abs(a - r) / abs(r)
              for a, r in zip(gnorms, ref["grad_norms"])]
    step = sorted(step_ms[1:])[len(step_ms[1:]) // 2] / 1e3  # median, warm
    out = {"losses": losses, "grad_norms": gnorms, "step_ms": step_ms,
           "ms_per_step": step * 1e3, "tokens_per_s": b * s / step,
           "peak_memory_gib": peak / 2**30, "loss_rel_err": loss_err,
           "grad_norm_rel_err": gn_err, "profiled_step": prof_out,
           "launches": launches}
    log(f"mesh train: losses {losses}; grad norms {gnorms}")
    log(f"mesh train: rel err against phase 7, loss max {max(loss_err):.2e} "
        f"(rtol {RTOL_MESH_LOSS}), grad norm max {max(gn_err):.2e} (rtol "
        f"{RTOL_MESH_GNORM}); kernel launches in {steps} steps "
        f"{json.dumps(launches)}")
    log(f"mesh train on {smi}: {out['ms_per_step']:.1f} ms per step "
        f"(phase 7: {ref['ms_per_step']:.1f}), {out['tokens_per_s']:.0f} "
        f"tokens/s (phase 7: {ref['tokens_per_s']:.0f}), peak memory "
        f"{out['peak_memory_gib']:.2f} GiB (phase 7: "
        f"{ref['peak_memory_gib']:.2f})")
    log(f"mesh train: profiled step {prof_out['profiled_wall_ms']:.1f} ms "
        f"wall, device busy {prof_out['device_busy_ms']:.1f} ms "
        f"({100 * prof_out['device_busy_share']:.1f}%)")
    log_kernels(prof_out)
    for op in prof_out["host_ops"]:
        log(f"  host {op['ms']:9.3f} ms {op['calls']:6d} calls  {op['name']}")
    assert all(math.isfinite(x) for x in losses + gnorms), "non-finite loss"
    assert max(loss_err) <= RTOL_MESH_LOSS, "losses differ from phase 7's"
    assert max(gn_err) <= RTOL_MESH_GNORM, "grad norms differ from phase 7's"
    assert losses[-1] < losses[0], "the loss did not fall"
    want = {"flash_fwd_train": 2 * cfg.num_layers * steps,  # + remat
            "flash_bwd_dq": cfg.num_layers * steps,
            "flash_bwd_dkv": cfg.num_layers * steps}
    assert launches == want, f"launches {launches}, expected {want}"
    return out


def run_sp_attention(torch, reset_counts, smi):
    """Phase sp_attention: ring_attention and ulysses_attention over the
    one-rank sp group of create_mesh(MeshConfig(sp=1, fsdp=1)) at
    llama-1b's training shapes (bf16, causal, and packed segments),
    forward and backward, each against the dense kernel path (K2, K3, K4
    through flash_attention) and the plain version on the same inputs;
    Ulysses must launch K2, K3 and K4. CUDA-event times of a forward and
    backward of each."""
    from ray_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd_plain, flash_attention_plain)
    from ray_tpu_torch.ops.ring_attention import (ring_attention,
                                                  ulysses_attention)
    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(10)
    b, s, hq, hkv, d = 4, 2048, 32, 8, 64
    seg = torch.tensor([0] * 512 + [1] * 1024 + [2] * 512,
                       dtype=torch.int32, device=dev)
    packed = torch.stack([seg, seg, torch.zeros_like(seg), seg.flip(0)])

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    q, k, v, do = (randn(b, s, hq, d), randn(b, s, hkv, d),
                   randn(b, s, hkv, d), randn(b, s, hq, d))
    out = {"shapes": [b, s, hq, hkv, d], "cases": {}}
    launches = {"flash_fwd_train": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    with one_rank_world("sp attention"):
        group = create_mesh(MeshConfig(sp=1, fsdp=1)).get_group("sp")
        paths = {"ring": lambda *x, segs: ring_attention(
                     *x, group=group, causal=True, segment_ids=segs),
                 "ulysses": lambda *x, segs: ulysses_attention(
                     *x, group=group, causal=True, segment_ids=segs),
                 "dense": lambda *x, segs: flash_attention(
                     *x, causal=True, segment_ids=segs)}

        def fwd_bwd(path, segs):
            x = [t.detach().requires_grad_() for t in (q, k, v)]
            o = paths[path](*x, segs=segs)
            o.backward(do)
            return [o.detach()] + [t.grad for t in x]

        for case, segs in (("causal", None), ("packed segments", packed)):
            kw = dict(causal=True, q_seg=segs, kv_seg=segs, scale=d ** -0.5)
            o_p, lse_p = flash_attention_plain(q, k, v, **kw)
            plain = [o_p, *flash_attention_bwd_plain(q, k, v, o_p, lse_p, do,
                                                     **kw)]
            dense = fwd_bwd("dense", segs)
            reset_counts()  # Ulysses' own launches
            got = {"ulysses": fwd_bwd("ulysses", segs)}
            torch.cuda.synchronize()
            for name, n in (("flash_fwd_train", flash_attention.launches),
                            ("flash_bwd_dq", flash_attention.dq_launches),
                            ("flash_bwd_dkv", flash_attention.dkv_launches)):
                assert n >= 1, f"Ulysses ({case}) did not launch {name}"
                launches[name] += n
            got["ring"] = fwd_bwd("ring", segs)
            torch.cuda.synchronize()
            errs, bad = {}, []
            for path, res in got.items():
                for ref_name, ref in (("dense", dense), ("plain", plain)):
                    for t, name, want in zip(res, ("o", "dq", "dk", "dv"),
                                             ref):
                        errs[f"{path} vs {ref_name} {name}"] = max_err(t,
                                                                      want)
                        atol = (ATOL_RING_GRAD_BF16 if path == "ring"
                                and name != "o" else ATOL_O_BF16)
                        if not close_bf16(t, want, atol):
                            bad.append(f"{path} {name} vs {ref_name}")
            times = {path: time_ms(lambda path=path: fwd_bwd(path, segs))
                     for path in ("dense", "ulysses", "ring")}
            log(f"sp attention, {case} (B={b} S={s} Hq={hq} Hkv={hkv} "
                f"D={d}, one sp rank): max errors "
                + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
                + f" (tolerance {ATOL_O_BF16} + {RTOL_O_BF16}*|ref|; the "
                f"ring's gradients {ATOL_RING_GRAD_BF16} + {RTOL_O_BF16}"
                f"*|ref|)")
            log(f"sp attention, {case} on {smi}: forward + backward ms: "
                + ", ".join(f"{p} {t:.4f}" for p, t in times.items()))
            assert not bad, f"{case}: {bad} disagree"
            out["cases"][case] = {"max_abs_err": errs, "fwd_bwd_ms": times}
    log(f"sp attention: Ulysses' kernel launches {json.dumps(launches)}")
    out["launches"] = launches
    return out


def run_pp_trainer(torch, reset_counts, ref, smi):
    """Phase pp_trainer: PipelinedTrainer on llama-1b at full width and
    depth on create_mesh(MeshConfig(pp=1, fsdp=1)) over a world of one
    rank (JAX's one-stage bypass), phase 7's seed, batch and optimizer:
    each of 6 steps held to phase 7's ``ref``; then the GPipe loop itself,
    gpipe(stage, 1, 4) (4 microbatches, the one-rank shift and the
    float32 broadcast over NCCL), on the same stack and batch, its loss
    and gradients held to the bypass's."""
    from ray_tpu_torch.models.config import get_config
    from ray_tpu_torch.models.llama import LlamaModel
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.ops.pipeline import gpipe
    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from ray_tpu_torch.parallel.pp_train import PipelinedTrainer
    from ray_tpu_torch.parallel.train_lib import (default_optimizer,
                                                  global_norm)

    cfg = get_config("llama-1b")
    b, s, steps, m = 4, 2048, 6, 4
    with one_rank_world("pp trainer"):
        mesh = create_mesh(MeshConfig(pp=1, fsdp=1))
        with torch.device("meta"):
            model = LlamaModel(cfg)
        trainer = PipelinedTrainer(model, mesh, num_microbatches=m,
                                   optimizer=default_optimizer(warmup=1))
        rng = np.random.default_rng(7)
        batch = {"input_ids": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (b, s), dtype=np.int32)).cuda()}
        state = trainer.init(torch.Generator(device="cuda").manual_seed(7),
                             batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()  # this phase's main-path run starts here
        losses, gnorms, step_ms = [], [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, mt = trainer.step(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(mt["loss"]))
            gnorms.append(float(mt["grad_norm"]))
        launches = {"flash_fwd_train": flash_attention.launches,
                    "flash_bwd_dq": flash_attention.dq_launches,
                    "flash_bwd_dkv": flash_attention.dkv_launches}
        peak = torch.cuda.max_memory_allocated()

        # the schedule itself at one stage against the bypass, from the
        # same parameters: 4 microbatches of one row
        group = mesh.get_group("pp")
        run = gpipe(trainer.model.stage, 1, m, group)

        def schedule(fn, params, x):
            del fn  # the trainer's stage, as in run
            return run(params, x.reshape((m, b // m) + x.shape[1:])) \
                .reshape(x.shape)

        params = list(state.params.values())
        results = {}
        for name, pipeline in (("bypass", None), ("gpipe", schedule)):
            for p in params:
                p.grad = None
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = trainer.loss(batch, pipeline=pipeline)
            loss.backward()
            torch.cuda.synchronize()
            results[name] = {
                "loss": float(loss.detach()),
                "grads": [p.grad.clone() for p in params],
                "ms": (time.perf_counter() - t0) * 1e3,
                "launches": [flash_attention.launches,
                             flash_attention.dq_launches,
                             flash_attention.dkv_launches]}
        for p in params:
            p.grad = None
        del trainer, model, state, mt, loss, params
    bypass, sched = results["bypass"], results["gpipe"]
    grad_err = float(global_norm([a - w for a, w in zip(
        sched["grads"], bypass["grads"])]) / global_norm(bypass["grads"]))
    sched_loss_err = abs(sched["loss"] - bypass["loss"]) / abs(bypass["loss"])
    loss_err = [abs(a - r) / abs(r) for a, r in zip(losses, ref["losses"])]
    gn_err = [abs(a - r) / abs(r)
              for a, r in zip(gnorms, ref["grad_norms"])]
    step = sorted(step_ms[1:])[len(step_ms[1:]) // 2] / 1e3  # median, warm
    out = {"losses": losses, "grad_norms": gnorms, "step_ms": step_ms,
           "ms_per_step": step * 1e3, "tokens_per_s": b * s / step,
           "peak_memory_gib": peak / 2**30, "loss_rel_err": loss_err,
           "grad_norm_rel_err": gn_err, "launches": launches,
           "gpipe": {"microbatches": m, "loss_rel_err": sched_loss_err,
                     "grad_rel_err": grad_err,
                     "fwd_bwd_ms": sched["ms"], "bypass_fwd_bwd_ms":
                     bypass["ms"], "launches": sched["launches"],
                     "bypass_launches": bypass["launches"]}}
    log(f"pp train: losses {losses}; grad norms {gnorms}")
    log(f"pp train: rel err against phase 7 by step, loss "
        f"{[f'{e:.1e}' for e in loss_err]} (rtol {RTOL_MESH_LOSS} at steps "
        f"1-2, {RTOL_PP_LOSS} at each), grad norm "
        f"{[f'{e:.1e}' for e in gn_err]} (rtol {RTOL_MESH_GNORM}, "
        f"{RTOL_PP_GNORM}); kernel launches in {steps} steps "
        f"{json.dumps(launches)}")
    log(f"pp train on {smi}: {out['ms_per_step']:.1f} ms per step "
        f"(phase 7: {ref['ms_per_step']:.1f}), {out['tokens_per_s']:.0f} "
        f"tokens/s (phase 7: {ref['tokens_per_s']:.0f}), peak memory "
        f"{out['peak_memory_gib']:.2f} GiB (phase 7: "
        f"{ref['peak_memory_gib']:.2f})")
    log(f"pp train: gpipe(stage, 1, {m}) against the bypass: loss rel err "
        f"{sched_loss_err:.2e} (rtol {RTOL_GPIPE_LOSS}), gradients "
        f"|g - g_bypass| / |g_bypass| {grad_err:.2e} (at most "
        f"{RTOL_GPIPE_GRADS}); forward + backward {sched['ms']:.1f} ms "
        f"(bypass {bypass['ms']:.1f}); launches K2/K3/K4 "
        f"{sched['launches']} (bypass {bypass['launches']})")
    assert all(math.isfinite(x) for x in losses + gnorms), "non-finite loss"
    assert max(loss_err[:2]) <= RTOL_MESH_LOSS \
        and max(gn_err[:2]) <= RTOL_MESH_GNORM, \
        "steps 1-2 differ from phase 7's"
    assert max(loss_err) <= RTOL_PP_LOSS, "losses differ from phase 7's"
    assert max(gn_err) <= RTOL_PP_GNORM, "grad norms differ from phase 7's"
    assert losses[-1] < losses[0], "the loss did not fall"
    want = {"flash_fwd_train": 2 * cfg.num_layers * steps,  # + remat
            "flash_bwd_dq": cfg.num_layers * steps,
            "flash_bwd_dkv": cfg.num_layers * steps}
    assert launches == want, f"launches {launches}, expected {want}"
    assert sched_loss_err <= RTOL_GPIPE_LOSS, "gpipe's loss differs"
    assert grad_err <= RTOL_GPIPE_GRADS, "gpipe's gradients differ"
    assert sched["launches"] == [2 * cfg.num_layers * m, cfg.num_layers * m,
                                 cfg.num_layers * m], "gpipe's launches"
    return out


def check_train_reference(torch):
    """Phase 8: one float32 training step at llama-1b width with 2 layers,
    the kernel path on the card against the plain path on the CPU, from
    the same parameters and batch."""
    from ray_tpu_torch.models.config import get_config
    from ray_tpu_torch.models.convert import init_params
    from ray_tpu_torch.models.llama import LlamaModel
    from ray_tpu_torch.parallel.train_lib import (ShardedTrainer,
                                                  default_optimizer)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("llama-1b", num_layers=2, dtype="float32",
                     param_dtype="float32")
    lr = 1e-3
    gen = torch.Generator(device="cuda").manual_seed(8)
    sd = init_params(cfg, gen, "cuda", torch.float32)
    sd = {"cuda": sd, "cpu": {k: t.cpu() for k, t in sd.items()}}
    rng = np.random.default_rng(8)
    batch = {"input_ids": rng.integers(0, cfg.vocab_size, (2, 256),
                                       dtype=np.int32)}
    res = {}
    for dev in ("cuda", "cpu"):
        with torch.device("meta"):
            model = LlamaModel(cfg)
        trainer = ShardedTrainer(model, device=dev, optimizer=(
            default_optimizer(lr=lr, warmup=0, total_steps=10)))
        state = trainer.init(None, batch, params=sd.pop(dev))
        state, m = trainer.step(state, batch)
        res[dev] = (float(m["loss"]), float(m["grad_norm"]),
                    {n: p.detach().cpu() for n, p in state.params.items()},
                    [t.cpu() for t in state.opt_state["mu"]])
        del trainer, model, state, m
    (loss_g, gn_g, p_g, mu_g), (loss_c, gn_c, p_c, mu_c) = \
        res["cuda"], res["cpu"]
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    gn_err = abs(gn_g - gn_c) / abs(gn_c)
    mu_err = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                 for a, b in zip(mu_g, mu_c))
    total = noisy = off = 0
    worst = 0.0
    for (name, p), mu in zip(p_g.items(), mu_c):
        diff = (p - p_c[name]).abs()
        quiet = (mu / 0.1).abs() >= NOISY_GRAD  # mu = (1 - b1) g
        total += diff.numel()
        noisy += int((diff > ATOL_PARAM_F32).sum())
        off += int((diff[quiet] > ATOL_PARAM_F32).sum())
        worst = max(worst, float(diff.max()))
    log(f"f32 train step (2 layers, llama-1b width, B 2 x S 256): loss "
        f"{loss_g:.6f} card vs {loss_c:.6f} CPU (rel err {loss_err:.2e}, "
        f"rtol {RTOL_LOSS_F32}); grad norm {gn_g:.6f} vs {gn_c:.6f} (rel "
        f"err {gn_err:.2e}, rtol {RTOL_GNORM_F32}); Adam mu rel err "
        f"{mu_err:.2e} (rtol {RTOL_MU_F32}); params: {noisy} of {total} "
        f"differ by more than {ATOL_PARAM_F32}, {off} of them where "
        f"|clipped grad| >= {NOISY_GRAD} (allowed 0); max diff {worst:.3e} "
        f"(allowed 2*lr = {2 * lr})")
    assert math.isfinite(loss_g) and loss_err <= RTOL_LOSS_F32, "loss"
    assert gn_err <= RTOL_GNORM_F32, "grad norm disagrees"
    assert mu_err <= RTOL_MU_F32, "Adam's first moment disagrees"
    assert off == 0 and worst <= 2 * lr + ATOL_PARAM_F32, \
        "updated parameters disagree"
    return {"loss_rel_err": loss_err, "grad_norm_rel_err": gn_err,
            "mu_rel_err": mu_err, "param_entries_over_atol": noisy,
            "param_entries_over_atol_with_grad_over_noise": off,
            "param_entries": total, "param_max_abs_diff": worst}


# phase 4's engine, and engine_v2's: llama3-8b at full width and depth,
# bf16, 2048 pages of 16 tokens (4.0 GiB), 8 slots, K=4 fused decode steps
ENGINE_8B = dict(model="llama3-8b", dtype="bfloat16", page_size=16,
                 num_pages=2048, max_model_len=2048, max_batch=8,
                 decode_steps_per_dispatch=4,
                 prefill_buckets=(64, 128, 256, 512, 1024, 2048))


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


def phase4_traffic(vocab: int):
    """Phase 4's requests, as (request id, prompt, SamplingParams kwargs):
    one short warm-up request; 6 prompts of 20 to 1000 tokens (one
    sampled) and one on a 256-token prefix; and, late, a second on the
    same prefix (a prefix-cache hit), each asking 32 tokens."""
    rng = np.random.default_rng(1)

    def prompt(n):
        return [int(t) for t in rng.integers(0, vocab, n)]

    prefix = prompt(256)
    requests = [(f"r{n}", prompt(n), dict(max_tokens=32))
                for n in (20, 97, 180, 512, 700, 1000)]
    requests[2] = ("r180", requests[2][1],
                   dict(max_tokens=32, temperature=0.8, top_k=40, seed=7))
    requests.append(("prefix_a", prefix + prompt(64), dict(max_tokens=32)))
    late = [("prefix_b", prefix + prompt(150), dict(max_tokens=32))]
    return [("warmup", prompt(40), dict(max_tokens=4))], requests, late


def run_engine(torch, flush_counts, mesh=None, **config):
    """Phase 4: llama3-8b, full width and depth, bf16, 8 requests (and
    phase moe's traffic: ENGINE_8B with `config` in place; tp_engine's: on
    `mesh`)."""
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.serve.llm import SamplingParams as SP

    t0 = time.perf_counter()
    engine = LLMEngine(EngineConfig(**{**ENGINE_8B, **config}), mesh=mesh)
    torch.cuda.synchronize()
    log(f"engine built ({engine.config.model}, "
        f"{engine.model_cfg.num_layers} layers, "
        f"bf16 weights made on the card) in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated, "
        f"{torch.cuda.mem_get_info()[0] / 2**30:.2f} GiB free")
    warm, requests, late = (
        [(rid, p, SP(**sp)) for rid, p, sp in reqs]
        for reqs in phase4_traffic(engine.model_cfg.vocab_size))
    vocab = engine.model_cfg.vocab_size
    # one short request first, so TTFT below excludes one-time CUDA and
    # cuBLAS initialisation
    serve(engine, warm, [])
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


def greedy_parity(engine) -> dict:
    """{rid: tokens} of `entry.parity_prompts()`, 8 greedy tokens each."""
    from ray_tpu_torch.entry import drive, parity_prompts

    return drive(engine, [[(f"g{i}", [int(t) for t in p],
                            {"max_tokens": 8}, None)
                           for i, p in enumerate(parity_prompts())]])["tokens"]


def collective_host_us(torch, group, calls: int = 264) -> dict:
    """Host microseconds per call of the tp layers' collectives on a
    decode step's [8, 1, 4096] bf16 activations over `group`, `calls`
    calls back to back (one K=4 decode dispatch of llama3-8b makes 264),
    under inference mode as the engine runs them: `reduce_from`, `copy_to`
    and a bare `dist.all_reduce` in place."""
    import torch.distributed as dist

    from ray_tpu_torch.ops.collectives import copy_to, reduce_from

    x = torch.randn(8, 1, 4096, device="cuda", dtype=torch.bfloat16)
    fns = {"reduce_from": lambda: reduce_from(x, (group,)),
           "copy_to": lambda: copy_to(x, (group,)),
           "all_reduce": lambda: dist.all_reduce(x, group=group)}
    out = {}
    with torch.inference_mode():
        for name, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            out[name] = (time.perf_counter() - t0) / calls * 1e6
            torch.cuda.synchronize()
    return out


def run_tp_engine(torch, flush_counts, ref, smi):
    """Phase tp_engine: phase 4's run through LLMEngine on
    create_mesh(MeshConfig(tp=1, fsdp=1)) over a world of one rank over
    NCCL; its greedy parity tokens held to phase 4's ``ref``."""
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.ops.paged_attention import paged_attention_decode
    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh

    with one_rank_world("tp engine"):
        mesh = create_mesh(MeshConfig(tp=1, fsdp=1))
        log(f"tp engine: mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}")
        engine, eng = run_engine(torch, flush_counts, mesh=mesh)
        counts = {"paged_decode": paged_attention_decode.launches,
                  "flash_fwd_self": flash_attention.launches
                  - flash_attention.segment_launches,
                  "flash_fwd_ctx": flash_attention.segment_launches}
        eng["steady"] = profile_decode(torch, engine)
        eng["parity_tokens"] = greedy_parity(engine)
        eng["collective_host_us"] = collective_host_us(
            torch, engine.model.place.tp_group)
        frames = engine._frames
        eng["frames"] = {"frames": frames.frames, "bytes": frames.bytes,
                         "host_s": frames.seconds}
        eng["sharding"] = engine.stats()["sharding"]
        engine.close()
        del engine
    steady, ref_steady = eng["steady"], ref["steady"]
    log(f"tp engine: TTFT ms {json.dumps(eng['ttft_ms'])}")
    log(f"tp engine: kernel launches {json.dumps(counts)}; frames "
        f"{json.dumps(eng['frames'])}; sharding "
        f"{json.dumps(eng['sharding'])}")
    log(f"tp engine on {smi}: steady decode {steady['step_ms']:.2f} ms per "
        f"step (phase 4: {ref_steady['step_ms']:.2f}), "
        f"{steady['decode_tok_s']:.1f} tok/s (phase 4: "
        f"{ref_steady['decode_tok_s']:.1f}); frames per step "
        f"{steady['frames_per_step']:.2f}, "
        f"{steady['frame_bytes_per_step']:.0f} B, "
        f"{steady['frame_ms_per_step']:.3f} ms of host time; host us per "
        f"one-rank collective call {json.dumps(eng['collective_host_us'])}")
    log(f"tp engine: parity tokens {json.dumps(eng['parity_tokens'])}")
    for kname, c in counts.items():
        assert c > 0, f"{kname} was never launched on the tp engine's path"
    assert eng["parity_tokens"] == ref["parity_tokens"], \
        "the tp engine's greedy tokens differ from phase 4's"
    return counts, eng


def profile_decode(torch, engine):
    """Steady decode with all 8 slots busy (300-token prompts): tokens/s
    over 6 unprofiled steps, then 6 steps under torch.profiler for the
    device's busy share and the kernels that take its time (under
    annotate_moe, also the MoE layers' time, moe_summary)."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.entry import decode_window, drain, fill_slots

    rng = np.random.default_rng(4)
    vocab = engine.model_cfg.vocab_size
    frames = getattr(engine, "_frames", None)  # a tp engine's
    rids = fill_slots(engine, [rng.integers(0, vocab, 300)
                               for _ in range(engine.config.max_batch)],
                      max_tokens=200)
    for _ in range(2):
        engine.step()

    sent = frames and (frames.frames, frames.bytes, frames.seconds)
    win = decode_window(engine, 6)
    toks, dt = win["tokens"], win["seconds"]
    if frames:
        frame_stats = {"frames_per_step": (frames.frames - sent[0]) / 6,
                       "frame_bytes_per_step": (frames.bytes - sent[1]) / 6,
                       "frame_ms_per_step": (frames.seconds - sent[2])
                       / 6 * 1e3}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        win = decode_window(engine, 6)
    p_toks, p_dt = win["tokens"], win["seconds"]
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
    drain(engine, rids)
    out = {"decode_tok_s": toks / dt, "step_ms": dt / 6 * 1e3,
           "profiled_tokens": p_toks, **device_summary(prof, p_dt),
           "host_ops": host_summary(prof, 8),
           "sync_warnings_in_2_steps": len(syncs)}
    if frames:
        out.update(frame_stats)
    log(f"steady decode (8 slots, K=4): {out['decode_tok_s']:.1f} tok/s, "
        f"{out['step_ms']:.2f} ms per step; device busy "
        f"{100 * out['device_busy_share']:.1f}% of a profiled window")
    log_kernels(out, moe_summary(prof))
    for op in out["host_ops"]:
        log(f"  host {op['ms']:9.3f} ms {op['calls']:6d} calls  {op['name']}")
    log(f"synchronising calls in 2 engine steps: {len(syncs)} "
        f"{sorted(set(syncs))[:3]}")
    assert not syncs, "a dispatch or harvest synchronised the host"
    return out


# kernel families of a profile, by a substring of the kernel's name (the
# first that matches): the port's kernels, cuBLAS matmuls, PyTorch's
# elementwise and reduction kernels, the optimizer's foreach kernels
FAMILIES = (("port kernels", ("flash_fwd", "bwd_dq", "bwd_dkv",
                              "paged_decode")),
            ("matmuls", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
            ("foreach (optimizer)", ("multi_tensor_apply",)),
            ("reductions", ("reduce_kernel",)),
            ("elementwise", ("elementwise", "index", "scatter", "gather",
                             "cat", "copy")))


def device_summary(prof, wall_s):
    """Device busy time, its share of `wall_s`, the device time of each
    kernel family and the top kernels of a torch.profiler window."""
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" and e.key not in ANNOTATIONS]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    families = {name: 0.0 for name, _ in FAMILIES}
    families["other"] = 0.0
    for e in events:
        family = next((name for name, keys in FAMILIES
                       if any(k in e.key for k in keys)), "other")
        families[family] += e.self_device_time_total / 1e3
    return {"profiled_wall_ms": wall_s * 1e3,
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e6 / wall_s,
            "families_ms": families,
            "top_kernels": [{"name": e.key[:60],
                             "ms": e.self_device_time_total / 1e3,
                             "calls": e.count} for e in top]}


def host_summary(prof, n: int = 10):
    """The ops of a torch.profiler window that take the most host time of
    their own."""
    events = sorted(prof.key_averages(),
                    key=lambda e: -e.self_cpu_time_total)[:n]
    return [{"name": e.key[:60], "ms": e.self_cpu_time_total / 1e3,
             "calls": e.count} for e in events]


# record_function ranges of annotate_moe: on the device they are spans
# over other kernels, not kernels of their own
ANNOTATIONS = ("moe_mlp", "moe_route")


@contextlib.contextmanager
def annotate_moe():
    """While open, every MoEMLP forward and its routing (moe_route) run
    inside record_function ranges, which moe_summary reads."""
    from torch.autograd.profiler import record_function

    from ray_tpu_torch.models import llama

    forward, route = llama.MoEMLP.forward, llama.moe_route

    def annotated_forward(self, x, *args):
        with record_function("moe_mlp"):
            return forward(self, x, *args)

    def annotated_route(*args):
        with record_function("moe_route"):
            return route(*args)

    llama.MoEMLP.forward, llama.moe_route = annotated_forward, \
        annotated_route
    try:
        yield
    finally:
        llama.MoEMLP.forward, llama.moe_route = forward, route


def moe_summary(prof):
    """Device ms of a profile's kernels launched inside annotate_moe's
    ranges, each kernel counted once, at the aten op that launched it
    (the profiler also hangs a kernel on helper events under that op,
    such as "Activity Buffer Request", and an op's device total counts
    both): the expert products (aten::bmm), the routing (inside
    moe_route) and the rest of the MoE layers (dispatch and combine
    gathers, SiLU, the router term); `attributed_ms` is every kernel so
    counted, MoE or not, to hold against the device's busy time. None
    when the profile has no MoE range."""
    out = dict.fromkeys(("moe_ms", "expert_products_ms", "routing_ms",
                         "dispatch_combine_ms", "attributed_ms"), 0.0)
    seen = False
    for e in prof.events():
        if e.device_type.name != "CPU":
            continue
        seen = seen or e.name == "moe_mlp"
        if not e.name.startswith("aten::") or not e.kernels:
            continue
        ms = sum(k.duration for k in e.kernels) / 1e3
        out["attributed_ms"] += ms
        ranges, parent = set(), e.cpu_parent
        while parent is not None:
            ranges.add(parent.name)
            parent = parent.cpu_parent
        if "moe_mlp" not in ranges:
            continue
        key = ("expert_products_ms" if e.name == "aten::bmm" else
               "routing_ms" if "moe_route" in ranges else
               "dispatch_combine_ms")
        out[key] += ms
        out["moe_ms"] += ms
    return out if seen else None


def log_kernels(summary, moe=None):
    """Log a device_summary; with `moe` (a moe_summary) store it in the
    summary and log the MoE layers' time, which the families hold (the
    expert products among the matmuls)."""
    log("  by family: " + ", ".join(
        f"{name} {ms:.1f} ms" for name, ms in summary["families_ms"].items()))
    if moe is not None:
        summary["moe"] = moe
        log("  of which in the MoE layers: " + ", ".join(
            f"{name} {ms:.1f}" for name, ms in moe.items()))
    for k in summary["top_kernels"]:
        log(f"  {k['ms']:9.3f} ms {k['calls']:6d} calls  {k['name']}")


def profile_prefill(torch, engine):
    """One prefill wave, 4 prompts of 1000 tokens (bucket 1024) asking
    for one token each, under torch.profiler: where prefill time goes
    (under annotate_moe, as profile_decode's)."""
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
    log_kernels(out, moe_summary(prof))
    return out


def drain(engine, out, fin):
    """Step the engine until it has no work, adding each delta's tokens to
    out[rid] and its finish reason to fin[rid]."""
    while engine.has_work():
        for d in engine.step():
            out.setdefault(d.request_id, []).extend(d.new_token_ids)
            if d.finished:
                fin[d.request_id] = d.finish_reason


def arrival_gaps(engine, running, arrival):
    """`running` requests decode; once each has its first token and 6
    more steps have run, `arrival` is added. Gaps are host-clock times
    between two engine steps that emit a token to a running request.
    Every request must finish with its tokens. Returns (the median gap of
    the 6 steady steps, the longest gap from the arrival until 3 steps
    after its first token (a stall behind its prefill shows in the step
    after), and the K2 ctx launches until its first token)."""
    from ray_tpu_torch.ops.flash_attention import flash_attention

    out, fin = {}, {}

    def step_gaps(until):
        """Step until until(steps taken) holds; the gaps between steps
        that emit a token to a running request."""
        gaps, last, n = [], time.perf_counter(), 0
        while not until(n):
            deltas = engine.step()
            now = time.perf_counter()
            n += 1
            for d in deltas:
                out.setdefault(d.request_id, []).extend(d.new_token_ids)
                if d.finished:
                    fin[d.request_id] = d.finish_reason
            if any(d.request_id != arrival[0] and d.new_token_ids
                   for d in deltas):
                gaps.append(now - last)
                last = now
        return gaps

    for rid, p, sp in running:
        engine.add_request(rid, p, sp)
    step_gaps(lambda n: all(out.get(rid) for rid, _, _ in running))
    steady = step_gaps(lambda n: n == 6)
    rid_a, prompt_a, sp_a = arrival
    engine.add_request(rid_a, prompt_a, sp_a)
    ctx0 = flash_attention.segment_launches
    during = step_gaps(lambda n: bool(out.get(rid_a)))
    ctx = flash_attention.segment_launches - ctx0
    during += step_gaps(lambda n: n == 3)
    drain(engine, out, fin)
    want = [rid for rid, _, _ in running] + [rid_a]
    assert sorted(fin) == sorted(want), f"unfinished: {fin}"
    for rid, _, sp in running + [arrival]:
        assert len(out[rid]) == sp.max_tokens, (rid, len(out[rid]))
    return sorted(steady)[len(steady) // 2], max(during), ctx


def page_rows(kv, n):
    """The first n token rows of pages [L, n_pages, Hkv, page, 2D], as
    [L, n, Hkv, 2D]."""
    layers, n_pages, hkv, page, d2 = kv.shape
    return kv.permute(0, 1, 3, 2, 4).reshape(layers, n_pages * page, hkv,
                                              d2)[:, :n]


def run_engine_v2(torch, reset_counts, smi):
    """Phase engine_v2: the engine's scheduler-v2 paths at llama3-8b full
    width and depth (bf16, phase 4's settings), every engine built on one
    set of weights made on the card: warmup; chunked prefill against the
    legacy scheduler under a long arrival; speculative decoding; the P/D
    KV handoff; a deadline passing mid-decode; measure_prefill."""
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.ops.paged_attention import paged_attention_decode
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.serve.llm import SamplingParams as SP

    res = {}
    t0 = time.perf_counter()
    base = LLMEngine(EngineConfig(**ENGINE_8B))
    torch.cuda.synchronize()
    sd = base.model.state_dict()  # every later engine shares these tensors
    log(f"engine_v2: engine built in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")

    def engine(**kw):
        return LLMEngine(EngineConfig(**ENGINE_8B, **kw), params=sd)

    # 1. warmup on the fresh engine
    t0 = time.perf_counter()
    n_shapes = base.warmup()
    torch.cuda.synchronize()
    res["warmup"] = {"shapes": n_shapes, "s": time.perf_counter() - t0}
    log(f"engine_v2 warmup: {n_shapes} shapes in {res['warmup']['s']:.2f} s "
        f"(buckets {ENGINE_8B['prefill_buckets']} x cp {{0, full}} + the "
        f"K=4 decode chunk)")
    assert n_shapes == 2 * len(ENGINE_8B["prefill_buckets"]) + 1

    rng = np.random.default_rng(11)
    vocab = base.model_cfg.vocab_size

    def prompt(n):
        return [int(t) for t in rng.integers(0, vocab, n)]

    reset_counts()  # this phase's main-path run starts here
    # 2. chunked prefill: 7 requests decoding, then a 2000-token arrival;
    # the same traffic under the legacy scheduler
    running = [(f"run{i}", prompt(n), SP(max_tokens=128))
               for i, n in enumerate((40, 90, 150, 200, 260, 330, 400))]
    arrival = ("long", prompt(2000), SP(max_tokens=8))
    res["gaps_ms"] = {}
    for name, kw in (("chunked", dict(prefill_chunk_tokens=256)),
                     ("legacy", {})):
        eng = engine(**kw)
        steady, worst, ctx = arrival_gaps(eng, running, arrival)
        res["gaps_ms"][name] = {"steady_median": steady * 1e3,
                                "max_during_arrival": worst * 1e3}
        if name == "chunked":
            assert ctx > 0, "no K2 ctx launch during the chunked prefill"
            res["chunked_ctx_launches"] = ctx
        del eng
    log(f"engine_v2 chunked prefill (256-token chunks; 7 requests decoding, "
        f"one 2000-token arrival): gaps between steps that emit a token to "
        f"a running request, ms: {json.dumps(res['gaps_ms'])}; K2 ctx "
        f"launches during the chunks {res['chunked_ctx_launches']}")

    # 3. speculative decoding on prompts that repeat a 64-token pattern;
    # one dispatch deep, so every greedy slot may draft at every step
    eng = engine(spec_lookahead=4, pipeline_depth=1)
    verify_ctx = [0]  # K2 ctx launches inside verify dispatches
    compute_verify = eng._compute_verify

    def counted_verify(*args):
        before = flash_attention.segment_launches
        handle = compute_verify(*args)
        verify_ctx[0] += flash_attention.segment_launches - before
        return handle

    eng._compute_verify = counted_verify
    pattern = prompt(64)
    out, fin = {}, {}
    for i in range(4):
        eng.add_request(f"spec{i}", pattern * (2 + i) + prompt(8),
                        SP(max_tokens=32))
    drain(eng, out, fin)
    assert set(fin) == {f"spec{i}" for i in range(4)}, fin
    assert all(len(v) == 32 for v in out.values())
    st = eng.stats()
    res["spec"] = {k: st[k] for k in ("spec_drafted_total",
                                      "spec_accepted_total")}
    res["spec"]["verify_ctx_launches"] = verify_ctx[0]
    log(f"engine_v2 speculative decoding (spec_lookahead 4, 4 requests of "
        f"a repeated 64-token pattern, 32 tokens each): "
        f"{json.dumps(res['spec'])}")
    assert res["spec"]["spec_drafted_total"] > 0, "nothing was drafted"
    del eng

    # 4. P/D handoff: a prefill_only engine, a decode engine, one request;
    # the reference is `base` (no prefix cached) serving it alone
    pd_prompt = prompt(700)
    pre, dec = engine(), engine()
    pre.add_request("pd", pd_prompt, SP(max_tokens=32, prefill_only=True))
    out, fin = {}, {}
    drain(pre, out, fin)
    assert fin == {"pd": "prefill_done"}, fin
    blob = pre.pop_extracted("pd")
    # bf16 pages leave widened exactly to float32
    assert blob["kv_dtype"] == "bfloat16" and blob["kv"].dtype == np.float32
    dec.inject_request("pd", blob, SP(max_tokens=32))
    for d in dec.step():  # admits the injection, dispatches decode
        out["pd"].extend(d.new_token_ids)
    idx = torch.tensor(dec.requests["pd"].pages, device=dec.device)
    injected = dec.kv_pages.index_select(1, idx).view(torch.int16).cpu()
    sent = torch.from_numpy(blob["kv"]).to(torch.bfloat16).view(torch.int16)
    assert torch.equal(sent.view(torch.bfloat16).float(),
                       torch.from_numpy(blob["kv"])), "a blob value is no bf16"
    # the prompt's rows; the first decode step writes row len(prompt) on
    pages_equal = torch.equal(page_rows(injected, len(pd_prompt)),
                              page_rows(sent, len(pd_prompt)))
    drain(dec, out, fin)
    ref, ref_fin = {}, {}
    base.add_request("pd", pd_prompt, SP(max_tokens=32))
    drain(base, ref, ref_fin)
    res["handoff"] = {"pages_identical": pages_equal,
                      "tokens_identical": out["pd"] == ref["pd"],
                      "blob_mb": blob["kv"].nbytes / 1e6,
                      "prefill_s": blob["prefill_s"]}
    log(f"engine_v2 P/D handoff (700-token prompt, {len(blob['kv'][0])} "
        f"pages, {res['handoff']['blob_mb']:.1f} MB blob): injected pages "
        f"bit-identical {pages_equal}; tokens identical to one engine "
        f"{res['handoff']['tokens_identical']}")
    assert pages_equal, "the injected pages differ from the prefill's"
    assert out["pd"] == ref["pd"], (out["pd"], ref["pd"])
    del pre

    # 5. a deadline that passes mid-decode
    free0 = dec.allocator.num_free()
    dec.add_request("dl", prompt(100), SP(max_tokens=1000),
                    deadline=time.time() + 2.0)
    out, fin = {}, {}
    drain(dec, out, fin)
    res["deadline"] = {"finish": fin["dl"], "tokens": len(out["dl"]),
                       "expired_total": dec.stats()["expired_total"]}
    log(f"engine_v2 deadline (2 s, max_tokens 1000): finished "
        f"{fin['dl']!r} after {len(out['dl'])} tokens; free pages "
        f"{dec.allocator.num_free()} (before {free0})")
    assert fin["dl"] == "expired" and 0 < len(out["dl"]) < 1000
    assert dec.allocator.num_free() == free0, "pages not returned"
    del dec

    counts = {"paged_decode": paged_attention_decode.launches,
              "flash_fwd_self": flash_attention.launches
              - flash_attention.segment_launches,
              "flash_fwd_ctx": flash_attention.segment_launches
              - verify_ctx[0],
              "flash_fwd_verify": verify_ctx[0]}
    log(f"engine_v2: kernel launches {json.dumps(counts)}")
    for kname, c in counts.items():
        assert c > 0, f"{kname} was never launched in engine_v2"

    # 6. measure_prefill (outside the counted run: dummy dispatches)
    res["measure_prefill"] = base.measure_prefill(seq_len=2048,
                                                  peak_flops=BF16_FLOPS)
    log(f"engine_v2 measure_prefill (4 x 2048 tokens, peak {BF16_FLOPS:.3g} "
        f"FLOP/s) on {smi}: {json.dumps(res['measure_prefill'])}")
    del base
    return counts, res


# phase moe: Mixtral 8x7B at full width, as deep as the card holds with
# MOE_FREE_GIB free for the prefill workspace
MOE_FREE_GIB = 6.0


def moe_depth(torch, cfg, engine_cfg) -> int:
    """The deepest depth, at most cfg.num_layers, whose bf16 weights (the
    router float32) and page pool leave MOE_FREE_GIB of the card free."""
    free, total = torch.cuda.mem_get_info()
    h, v, n_exp = cfg.hidden_size, cfg.vocab_size, cfg.num_experts
    fixed = (2 * v * h + h) * 2                 # embed, lm_head, final norm
    layer = ((cfg.num_params() - 2 * v * h - h) // cfg.num_layers * 2
             + h * n_exp * 2 + 2 * h * 2)       # router and scales in f32
    pool = (engine_cfg["num_pages"] * cfg.num_kv_heads
            * engine_cfg["page_size"] * 2 * cfg.head_dim_ * 2)
    depth = min(cfg.num_layers,
                int((free - MOE_FREE_GIB * 2**30 - fixed) // (layer + pool)))
    log(f"moe: mem_get_info free {free / 2**30:.2f} GiB of "
        f"{total / 2**30:.2f}; a layer holds {layer / 2**30:.3f} GiB of "
        f"weights and {pool / 2**30:.3f} GiB of pages, embedding and head "
        f"{fixed / 2**30:.3f} GiB: depth {depth} of {cfg.num_layers} leaves "
        f"at least {MOE_FREE_GIB} GiB free")
    assert depth >= 1, "no MoE layer fits the card"
    return depth


def moe_drop_share(torch, engine, requests):
    """Serve `requests` with a forward hook on every MoE layer that repeats
    its routing with the plain moe_route and counts the real (token,
    choice) assignments past their expert's capacity, apart for
    prefill-shaped forwards (prefill, verify) and decode. A token is real
    where the dispatch's position is below its row's total (idle slots,
    padding rows and columns are routed too, and take capacity, but are
    not counted, apart from the capacity they keep). Returns {kind:
    [real assignments dropped, real assignments, other assignments kept]}
    and {kind: each expert's share of the real choices, before the
    drop}."""
    from ray_tpu_torch.models.llama import moe_capacity, moe_route

    cfg = engine.model_cfg
    real = {}
    seams = {name: getattr(engine, name) for name in
             ("_compute_prefill", "_compute_verify", "_compute_decode")}

    def prefill(rb, cp, bt, total, ids, positions, *rest):
        real["mask"] = positions < total[:, None]
        return seams["_compute_prefill"](rb, cp, bt, total, ids, positions,
                                         *rest)

    def verify(bt, total, ids, positions):
        real["mask"] = positions < total[:, None]
        return seams["_compute_verify"](bt, total, ids, positions)

    def decode(k_steps, bt, total, *rest):
        real["mask"] = (total > 0)[:, None]
        return seams["_compute_decode"](k_steps, bt, total, *rest)

    # [real assignments dropped, real assignments, padding and idle-slot
    # assignments kept (the capacity they take from real tokens)]
    counts = {"prefill": [0, 0, 0], "decode": [0, 0, 0]}
    # choices each expert received among real tokens, before the drop
    load = {kind: torch.zeros(cfg.num_experts, dtype=torch.long)
            for kind in counts}

    def hook(mod, args, out):
        x = args[0]
        b, s, h = x.shape
        n = b * s
        g = min(cfg.moe_group_size, n)
        rows = torch.cat([x.reshape(n, h), x.new_zeros(((-n) % g, h))])
        _, _, idx, slot = moe_route(rows.view(-1, g, h), mod.router,
                                    cfg.num_experts_per_tok)
        mask = torch.from_numpy(real["mask"]).to(x.device).reshape(n)
        over = (slot.reshape(-1, cfg.num_experts_per_tok)[:n]
                >= moe_capacity(cfg, g))
        past = over[mask]
        kind = "decode" if s == 1 else "prefill"
        counts[kind][0] += int(past.sum())
        counts[kind][1] += past.numel()
        counts[kind][2] += int((~over[~mask]).sum())
        chosen = idx.reshape(-1, cfg.num_experts_per_tok)[:n][mask]
        load[kind] += torch.bincount(chosen.flatten().cpu(),
                                     minlength=cfg.num_experts)

    engine._compute_prefill, engine._compute_verify, \
        engine._compute_decode = prefill, verify, decode
    hooks = [layer.moe.register_forward_hook(hook)
             for layer in engine.model.layers]
    try:
        serve(engine, requests, [])
    finally:
        for handle in hooks:
            handle.remove()
        for name, fn in seams.items():
            setattr(engine, name, fn)
    return counts, {kind: (c / c.sum().clamp(min=1)).tolist()
                    for kind, c in load.items()}


def run_moe(torch, reset_counts, smi):
    """Phase moe: mixtral-8x7b at full width (bf16, seeded weights made on
    the card) as deep as the card holds, through phase 4's engine
    settings and traffic, a profiled steady-decode window and prefill
    wave (MoE time apart), the capacity drop share, and
    measure_prefill(2048) beside a rate counted from active FLOPs."""
    from ray_tpu_torch.models.config import get_config
    from ray_tpu_torch.models.llama import moe_capacity
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.ops.paged_attention import paged_attention_decode
    from ray_tpu_torch.serve.llm import SamplingParams as SP

    cfg = get_config("mixtral-8x7b")
    depth = moe_depth(torch, cfg, ENGINE_8B)
    engine, eng = run_engine(torch, reset_counts, model="mixtral-8x7b",
                             model_overrides={"num_layers": depth})
    counts = {"paged_decode": paged_attention_decode.launches,
              "flash_fwd_self": flash_attention.launches
              - flash_attention.segment_launches,
              "flash_fwd_ctx": flash_attention.segment_launches}
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    cfg = engine.model_cfg
    eng.update(depth=depth, free_gib_after_build=free / 2**30,
               params=cfg.num_params(), active_params=cfg.active_params())
    log(f"moe: {depth} layers, {cfg.num_params() / 1e9:.3f} B params "
        f"({cfg.active_params() / 1e9:.3f} B active a token); free after "
        f"the build and the traffic {free / 2**30:.2f} GiB")
    log(f"moe: TTFT ms {json.dumps(eng['ttft_ms'])}")
    log(f"moe: decode {eng['decode_tok_s']:.1f} tok/s over "
        f"{eng['wall_s']:.2f} s wall; stats {json.dumps(eng['stats'])}")
    log(f"moe: kernel launches {json.dumps(counts)}")
    for kname, c in counts.items():
        assert c > 0, f"{kname} was never launched in phase moe"

    with annotate_moe():
        eng["steady"] = profile_decode(torch, engine)
        eng["prefill_wave"] = profile_prefill(torch, engine)
    # decode's group of 8 tokens reaches every expert: each forward reads
    # every weight once at least
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in engine.model.parameters())
    k_steps = ENGINE_8B["decode_steps_per_dispatch"]
    eng["steady"]["bound_ms"] = k_steps * weight_bytes / HBM_BYTES_PER_S * 1e3
    log(f"moe steady decode: {eng['steady']['step_ms']:.1f} ms per "
        f"K={k_steps} step against a bound of "
        f"{eng['steady']['bound_ms']:.1f} ms "
        f"({k_steps} forwards reading {weight_bytes / 1e9:.1f} GB of weights "
        f"at {HBM_BYTES_PER_S / 1e12:.2f} TB/s)")

    rng = np.random.default_rng(12)
    requests = [(f"d{n}", [int(t) for t in rng.integers(0, cfg.vocab_size,
                                                        n)],
                 SP(max_tokens=32))
                for n in (20, 97, 180, 320, 410, 512, 700, 1000)]
    drops, load = moe_drop_share(torch, engine, requests)
    eng["dropped"] = {kind: {"dropped": d, "assignments": a,
                             "share": d / max(a, 1),
                             "padding_kept": pad,
                             "expert_load": load[kind]}
                      for kind, (d, a, pad) in drops.items()}
    log(f"moe: real (token, choice) assignments past capacity (8 requests "
        f"of 20 to 1000 prompt tokens, 32 new; decode capacity "
        f"{moe_capacity(cfg, ENGINE_8B['max_batch'])} per expert at "
        f"{ENGINE_8B['max_batch']} slots, prefill "
        f"{moe_capacity(cfg, cfg.moe_group_size)} per group of "
        f"{cfg.moe_group_size}): {json.dumps(eng['dropped'])}")

    mp = engine.measure_prefill(seq_len=2048, peak_flops=BF16_FLOPS)
    rows = mp["rows"] * mp["seq_len"]
    g = min(cfg.moe_group_size, rows)
    n_exp, k = cfg.num_experts, cfg.num_experts_per_tok
    slack = n_exp * moe_capacity(cfg, g) / (k * g)
    expert = cfg.num_layers * k * 3 * cfg.hidden_size * cfg.intermediate_size
    per_tok = (2 * (cfg.active_params() - expert) + 2 * expert * slack
               + 4 * cfg.num_layers * cfg.num_heads * cfg.head_dim_
               * mp["seq_len"])
    active = mp["prefill_tok_s"] * per_tok
    eng["measure_prefill"] = mp
    eng["prefill_active"] = {"gflop_per_token": per_tok / 1e9,
                             "capacity_slack": slack,
                             "tflops": active / 1e12,
                             "mfu": active / BF16_FLOPS}
    log(f"moe measure_prefill (4 x 2048 tokens) on {smi}: "
        f"{json.dumps(mp)} -- its FLOPs count 2 N over every expert "
        f"({2 * cfg.num_params() / 1e9:.1f} GFLOP a token)")
    log(f"moe prefill from active FLOPs: {per_tok / 1e9:.2f} GFLOP a token "
        f"(2 x {cfg.active_params() / 1e9:.3f} B active params, the expert "
        f"products x {slack:.3f} capacity slack, attention at S 2048): "
        f"{active / 1e12:.1f} TFLOP/s, {100 * active / BF16_FLOPS:.1f}% of "
        f"{BF16_FLOPS / 1e12:.0f} TFLOP/s")
    del engine
    return counts, eng


def check_moe_reference(torch):
    """Phase moe_reference: float32, Mixtral width, 2 layers; the kernel
    path on the card against the plain path on the CPU, same weights:
    first-prefill logits, the routing decisions behind them, and greedy
    tokens in the legacy, chunked and speculative engines, each mode's
    card tokens against the CPU's in the same mode (MoE routes each
    dispatch shape's token set apart, so the modes may differ from each
    other)."""
    from ray_tpu_torch.models.config import get_config
    from ray_tpu_torch.models.convert import build_model, init_params
    from ray_tpu_torch.models.llama import PagedCache, moe_route
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.serve.llm import SamplingParams as SP

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("mixtral-8x7b", num_layers=2)
    k = cfg.num_experts_per_tok
    gen = torch.Generator(device="cuda").manual_seed(13)
    sd_gpu = init_params(cfg, gen, "cuda", torch.float32)
    sd_cpu = {name: t.cpu() for name, t in sd_gpu.items()}

    rng = np.random.default_rng(13)
    n = 200
    ids = rng.integers(0, cfg.vocab_size, (1, n))
    logits, routes = {}, {}
    for dev, sd in (("cuda", sd_gpu), ("cpu", sd_cpu)):
        model = build_model(cfg, sd, dev, torch.float32)
        routes[dev] = []

        def hook(mod, args, out, dev=dev):
            x = args[0]
            probs, _, idx, _ = moe_route(x.reshape(1, n, -1), mod.router, k)
            routes[dev].append((idx.cpu(), probs.cpu()))

        hooks = [layer.moe.register_forward_hook(hook)
                 for layer in model.layers]
        pool = torch.zeros((cfg.num_layers, 32, cfg.num_kv_heads, 16,
                            2 * cfg.head_dim_), device=dev)
        bt = torch.arange(1, 17, dtype=torch.int32, device=dev)[None]
        cache = PagedCache(pool, bt, torch.tensor([n], dtype=torch.int32,
                                                  device=dev))
        with torch.inference_mode():
            logits[dev] = model(torch.from_numpy(ids).to(dev),
                                torch.arange(n, device=dev)[None],
                                cache).float().cpu()
        for handle in hooks:
            handle.remove()
        del model
    err = max_err(logits["cuda"], logits["cpu"])
    flips, margins = 0, []
    for (idx_g, _), (idx_c, probs_c) in zip(routes["cuda"], routes["cpu"]):
        differ = idx_g != idx_c
        flips += int(differ.sum())
        top = probs_c.sort(dim=-1, descending=True).values
        gap = (top[..., k - 1] - top[..., k])[differ.any(-1)]
        margins += [float(m) for m in gap.flatten()]
    log(f"moe f32 first-prefill logits (2 layers, Mixtral width, {n} "
        f"tokens): max|kernel path - plain path| = {err:.3e} (atol "
        f"{ATOL_LOGITS_F32}); routing decisions that differ between the "
        f"card and the CPU: {flips} of {2 * n * k}"
        + (f" (CPU probability margins at the k-th choice {margins})"
           if flips else ""))
    assert torch.isfinite(logits["cuda"]).all()
    assert err <= ATOL_LOGITS_F32, "MoE kernel-path logits disagree"

    base = dict(model="mixtral-8x7b", model_overrides={"num_layers": 2},
                dtype="float32", page_size=16, num_pages=256,
                max_model_len=1024, max_batch=4, decode_steps_per_dispatch=4,
                prefill_buckets=(64, 128, 256, 512, 1024))
    prefix = [int(t) for t in rng.integers(0, cfg.vocab_size, 160)]
    reqs = [("a", [int(t) for t in rng.integers(0, cfg.vocab_size, 40)]),
            ("b", prefix + [int(t) for t in rng.integers(0, cfg.vocab_size,
                                                         30)])]
    late = [("c", prefix + [int(t) for t in rng.integers(0, cfg.vocab_size,
                                                         70)])]
    modes = {"legacy": {}, "chunked": dict(prefill_chunk_tokens=64),
             "spec": dict(spec_lookahead=4, pipeline_depth=1)}
    outs, spec = {}, {}
    for mode, kw in modes.items():
        for dev, sd in (("cuda", sd_gpu), ("cpu", sd_cpu)):
            engine = LLMEngine(EngineConfig(**base, **kw, device=dev),
                               params=sd)
            if mode == "spec":
                # both devices draft the card's legacy tokens (a random
                # 2-layer model repeats no n-gram in 8 tokens)
                truth = outs["legacy", "cuda"]
                engine._prompt_lookup_draft = lambda req, m, t=truth: \
                    t[req.request_id][len(req.output_ids):
                                      len(req.output_ids) + m]
            outs[mode, dev], _, _ = serve(
                engine, [(r, p, SP(max_tokens=8)) for r, p in reqs],
                [(r, p, SP(max_tokens=8)) for r, p in late])
            st = engine.stats()
            assert st["cache_hits"] > 0
            if mode == "spec":
                spec[dev] = (st["spec_drafted_total"],
                             st["spec_accepted_total"])
                assert st["spec_drafted_total"] > 0, "nothing was drafted"
            del engine
    log(f"moe f32 speculative decoding, (drafted, accepted): "
        f"{json.dumps(spec)}")
    same = {}
    for mode in modes:
        same[mode] = outs[mode, "cuda"] == outs[mode, "cpu"]
        log(f"moe f32 greedy tokens, {mode}: card {outs[mode, 'cuda']}, "
            f"CPU {outs[mode, 'cpu']}; identical {same[mode]}")
    for mode in modes:
        assert same[mode], f"MoE greedy tokens differ: {mode}"
    return {"logits_max_abs_err": err, "routing_flips": flips,
            "flip_margins": margins, "spec_drafted_accepted": spec,
            "modes_equal_legacy": {m: outs[m, "cuda"] == outs["legacy",
                                                              "cuda"]
                                   for m in modes}}


def run_moe_trainer(torch, reset_counts):
    """Phase moe_trainer: ShardedTrainer at Mixtral width with 2 layers
    (float32 params, bf16 compute, remat "nothing", fused loss, AdamW with
    clip 1.0), 4 steps on one batch of 2 x 2048 tokens (two routing
    groups)."""
    from ray_tpu_torch.models.config import get_config
    from ray_tpu_torch.models.llama import LlamaModel
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.parallel.train_lib import (ShardedTrainer,
                                                  default_optimizer)

    cfg = get_config("mixtral-8x7b", num_layers=2)
    b, s, steps = 2, 2048, 4
    t0 = time.perf_counter()
    with torch.device("meta"):
        model = LlamaModel(cfg)
    trainer = ShardedTrainer(model, optimizer=default_optimizer(warmup=1))
    rng = np.random.default_rng(14)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s),
                                        dtype=np.int32)).cuda()
    batch = {"input_ids": ids}
    state = trainer.init(torch.Generator(device="cuda").manual_seed(14),
                         batch)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state.params.values())
    log(f"moe trainer built (Mixtral width, {cfg.num_layers} layers, "
        f"{cfg.num_experts} experts, top {cfg.num_experts_per_tok}, "
        f"{n_params / 1e9:.3f} B params in {model.param_dtype}, compute "
        f"{model.dtype}, remat {cfg.remat_policy}) in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # the main path's run starts here
    losses, gnorms, step_ms = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = trainer.step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    launches = {"flash_fwd_train": flash_attention.launches,
                "flash_bwd_dq": flash_attention.dq_launches,
                "flash_bwd_dkv": flash_attention.dkv_launches}
    peak = torch.cuda.max_memory_allocated()
    targets = torch.cat([ids[:, 1:], ids[:, :1]], dim=1)
    with torch.no_grad():
        _, aux = model(ids, targets=targets, return_aux=True)
    aux = float(aux)
    bound = 0.99 * cfg.router_aux_loss_coef * cfg.num_layers
    log(f"moe train: losses {losses}; grad norms {gnorms}")
    log(f"moe train: step ms {[round(t, 2) for t in step_ms]}; kernel "
        f"launches in {steps} steps {json.dumps(launches)}")
    log(f"moe train: router terms after the steps {aux:.6f} (at least "
        f"0.99 x coef {cfg.router_aux_loss_coef} x {cfg.num_layers} layers "
        f"= {bound:.6f})")
    assert all(math.isfinite(x) for x in losses + gnorms), "non-finite loss"
    assert losses[-1] < losses[0], "the MoE loss did not fall"
    assert aux >= bound, "router terms below their bound"
    want = {"flash_fwd_train": 2 * cfg.num_layers * steps,  # + remat
            "flash_bwd_dq": cfg.num_layers * steps,
            "flash_bwd_dkv": cfg.num_layers * steps}
    assert launches == want, f"launches {launches}, expected {want}"

    step = sorted(step_ms[1:])[len(step_ms[1:]) // 2] / 1e3  # median, warm
    tokens = b * s
    live = b * cfg.num_heads * s * (s + 1) // 2
    attn = 2 * 2 * cfg.head_dim_ * live * cfg.num_layers
    active_flops = 6 * cfg.active_params() * tokens + 3 * attn
    out = {"layers": cfg.num_layers, "params": n_params,
           "batch": [b, s], "losses": losses, "grad_norms": gnorms,
           "router_terms": aux, "step_ms": step_ms,
           "ms_per_step": step * 1e3, "tokens_per_s": tokens / step,
           "active_tflops_per_step": active_flops / 1e12,
           "mfu_active": active_flops / step / BF16_FLOPS,
           "peak_memory_gib": peak / 2**30, "launches": launches}
    log(f"moe train: {out['ms_per_step']:.1f} ms per step (median of steps "
        f"2-{steps}), {out['tokens_per_s']:.0f} tokens/s, active FLOPs "
        f"(6 x {cfg.active_params() / 1e9:.3f} B active params a token, "
        f"plus attention) {out['active_tflops_per_step']:.1f} TFLOP a step "
        f"= {100 * out['mfu_active']:.1f}% of {BF16_FLOPS / 1e12:.0f} "
        f"TFLOP/s; peak memory {out['peak_memory_gib']:.2f} GiB")
    del trainer, model, state, m
    return out


def first_prefill_logits(torch, cfg, sd, dev, ids):
    """Float32 logits (on the CPU) of the first prefill of ids [1, n],
    n <= 256, through the paged path (K2's self part) of a float32 model
    of `cfg` with state dict `sd` on `dev`."""
    from ray_tpu_torch.models.convert import build_model
    from ray_tpu_torch.models.llama import PagedCache

    n = ids.shape[1]
    model = build_model(cfg, sd, dev, torch.float32)
    pool = torch.zeros((cfg.num_layers, 32, cfg.num_kv_heads, 16,
                        2 * cfg.head_dim_), device=dev)
    bt = torch.arange(1, 17, dtype=torch.int32, device=dev)[None]
    cache = PagedCache(pool, bt, torch.tensor([n], dtype=torch.int32,
                                              device=dev))
    with torch.inference_mode():
        return model(torch.from_numpy(ids).to(dev),
                     torch.arange(n, device=dev)[None], cache).float().cpu()


def check_reference(torch):
    """Phase 5: float32, llama3-8b width, 2 layers; the kernel path on the
    card against the plain path on the CPU, same weights."""
    from ray_tpu_torch.models.config import get_config
    from ray_tpu_torch.models.convert import init_params
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
    ids = rng.integers(0, cfg.vocab_size, (1, 200))
    logits = {dev: first_prefill_logits(torch, cfg, sd, dev, ids)
              for dev, sd in (("cuda", sd_gpu), ("cpu", sd_cpu))}
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
    # 64-token chunks split b and c's suffix; speculative decoding one
    # dispatch deep, every slot drafting at every step
    modes = {"legacy": {}, "chunked": dict(prefill_chunk_tokens=64),
             "spec": dict(spec_lookahead=4, pipeline_depth=1)}
    outs = {}
    for mode, kw in modes.items():
        for dev, sd in (("cuda", sd_gpu), ("cpu", sd_cpu)):
            engine = LLMEngine(EngineConfig(**base, **kw, device=dev),
                               params=sd)
            if mode == "spec":
                # a random 2-layer model repeats no n-gram in 8 tokens, so
                # the drafts are the legacy kernel path's own tokens (the
                # JAX engine's oracle test): verify's argmax at every
                # position is held against the decode path's tokens
                truth = outs["legacy", "cuda"]
                engine._prompt_lookup_draft = lambda req, n, t=truth: \
                    t[req.request_id][len(req.output_ids):
                                      len(req.output_ids) + n]
            outs[mode, dev], _, _ = serve(
                engine, [(r, p, SP(max_tokens=8)) for r, p in reqs],
                [(r, p, SP(max_tokens=8)) for r, p in late])
            st = engine.stats()
            assert st["cache_hits"] > 0
            if mode == "spec":
                log(f"f32 speculative decoding on {dev}: drafted "
                    f"{st['spec_drafted_total']}, accepted "
                    f"{st['spec_accepted_total']}")
                assert st["spec_accepted_total"] > 0, "nothing was accepted"
            del engine
    log(f"f32 greedy tokens, kernel path: {outs['legacy', 'cuda']}")
    log(f"f32 greedy tokens, plain path:  {outs['legacy', 'cpu']}")
    for key, toks in outs.items():
        log(f"f32 greedy tokens, {key[0]} on {key[1]} identical to the "
            f"legacy kernel path: {toks == outs['legacy', 'cuda']}")
        assert toks == outs["legacy", "cuda"], f"greedy tokens differ: {key}"
    return err


def run_pp_engine(torch, ref, smi):
    """Phase pp_engine: phase 4's model, seed, settings and traffic
    through the pipelined engine at pp 2 on the one card: two processes
    (``entry.serve_on_mesh`` under ``spawn(share_device=True)``: a gloo
    world, both ranks on card 0), rank 0 scheduling and running layers
    0-15, rank 1 layers 16-31 and sampling; the activations cross as host
    frames. Its greedy parity tokens are held to phase 4's ``ref``, K1
    and K2 must launch on both stages in the main traffic (the requests
    and the late one, as phase 4 counts them: the counters go to 0 on
    every rank after the warm-up wave and are read before the parity and
    steady runs), and its steady decode (8 busy slots) is printed beside
    phase 4's."""
    from ray_tpu_torch.entry import parity_prompts, serve_on_mesh
    from ray_tpu_torch.models.config import get_config
    from ray_tpu_torch.parallel.distributed import spawn

    vocab = get_config("llama3-8b").vocab_size
    warm, requests, late = phase4_traffic(vocab)
    parity = [(f"g{i}", [int(t) for t in p], dict(max_tokens=8))
              for i, p in enumerate(parity_prompts())]
    rng = np.random.default_rng(4)  # profile_decode's prompts
    steady = dict(prompts=[[int(t) for t in rng.integers(0, vocab, 300)]
                           for _ in range(ENGINE_8B["max_batch"])],
                  max_tokens=200, steps=24)
    run = {"engine": dict(ENGINE_8B, pp=2),
           "waves": [[(rid, p, sp, None) for rid, p, sp in wave]
                     for wave in (warm, requests, late, parity)],
           "count_waves": (1, 3), "steady": steady}
    t0 = time.perf_counter()
    ranks = spawn(serve_on_mesh, 2, "cuda",
                  DEADLINES_S["pp_engine"] - 30, args=([run],),
                  share_device=True)
    wall = time.perf_counter() - t0
    stages = [r[0] for r in ranks]
    out = stages[0]
    tokens = out["tokens"]
    parity_tokens = {rid: tokens[rid] for rid, _, _ in parity}
    st = out["steady"]
    ref_steady = ref["steady"]
    eng = {"wall_s": wall, "parity_tokens": parity_tokens,
           "stats": out["stats"], "pp_stats": out["pp_stats"],
           "links": out["links"],
           "launches_per_stage": [r["launches"] for r in stages],
           "steady": {"step_ms": st["step_ms"], "decode_tok_s": st["tok_s"],
                      "tokens": st["tokens"], "steps": steady["steps"],
                      "frames_per_step": st["frames"] / steady["steps"],
                      "frame_bytes_per_step": st["bytes"] / steady["steps"],
                      "activation_bytes_per_step":
                          st["activation_bytes"] / steady["steps"],
                      "frame_host_ms_per_step": st["host_ms_per_step"],
                      "kinds": st["kinds"],
                      "pp_bubble_frac": st["pp_stats"]["pp_bubble_frac"],
                      "per_stage": st["pp_stats"]["per_stage"]}}
    log(f"pp engine: two processes on one card, {wall:.1f} s from spawn "
        f"to close; stats {json.dumps(out['stats'])}")
    log(f"pp engine: kernel launches per stage in the main traffic "
        f"(requests and late, after the warm-up wave) "
        f"{json.dumps(eng['launches_per_stage'])}")
    log(f"pp engine on {smi}: steady decode {st['step_ms']:.2f} ms per "
        f"step ({st['tokens']} tokens in {steady['steps']} steps of one "
        f"tick each; phase 4: {ref_steady['step_ms']:.2f} ms per K=4 "
        f"step), {st['tok_s']:.1f} tok/s (phase 4: "
        f"{ref_steady['decode_tok_s']:.1f}); frames per step "
        f"{eng['steady']['frames_per_step']:.2f}, "
        f"{eng['steady']['frame_bytes_per_step']:.0f} B "
        f"({eng['steady']['activation_bytes_per_step']:.0f} B of "
        f"activations), {st['host_ms_per_step']:.3f} ms of rank 0's host "
        f"time; pp_bubble_frac {eng['steady']['pp_bubble_frac']:.3f} "
        f"(per stage {json.dumps(eng['steady']['per_stage'])})")
    log(f"pp engine: parity tokens {json.dumps(parity_tokens)}")
    for rid, _, sp in requests + late:
        assert len(tokens[rid]) == sp["max_tokens"], (rid, len(tokens[rid]))
        assert all(0 <= t < vocab for t in tokens[rid]), rid
    assert out["stats"]["cache_hits"] >= 16, \
        "prefix_b did not hit the prefix cache"
    assert st["kinds"] == {"decode": st["frames"]}, \
        "steady decode sent other frames than decode ticks"
    for s, counts in enumerate(eng["launches_per_stage"]):
        for kname, c in counts.items():
            assert c > 0, f"{kname} was never launched on stage {s}"
    # the stages hold as many layers and run the same dispatches in the
    # window, so their counts agree when the window is the same on both
    assert eng["launches_per_stage"][0] == eng["launches_per_stage"][1], \
        "the stages' count windows differ"
    assert parity_tokens == ref["parity_tokens"], \
        "the pp engine's greedy tokens differ from phase 4's"
    counts = {k: sum(c[k] for c in eng["launches_per_stage"])
              for k in eng["launches_per_stage"][0]}
    return counts, eng


def run_dense_cache(torch, flush, smi):
    """Phase dense_cache: llama3-8b width with 2 layers in float32 through
    the dense KV-cache path (``LlamaModel(..., kv_caches=)``): prefill 512
    tokens into an empty cache, then decode 16 one at a time; every
    position's logits within ATOL_LOGITS_F32 of the full forward's, and
    K2's split-KV design launched at Sq = 1 once a layer and step. Then K2
    at that call's shape (Sq 1, Sk 528), in float32 and in bf16, against
    its plain version, timed beside SDPA and, with --parent, the earlier
    tree's kernel; and the split-KV design against the 64-row one from Sq
    1 to 64 (decode_sweep)."""
    from ray_tpu_torch.models.config import get_config
    from ray_tpu_torch.models.convert import build_model, init_params
    from ray_tpu_torch.ops.flash_attention import (flash_attention,
                                                   flash_attention_plain)

    cfg = get_config("llama3-8b", num_layers=2)
    n_prefill, n_decode = 512, 16
    n = n_prefill + n_decode
    gen = torch.Generator(device="cuda").manual_seed(5)
    model = build_model(cfg, init_params(cfg, gen, "cuda", torch.float32),
                        "cuda", torch.float32)
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n))).cuda()
    hd, hkv = cfg.head_dim_, cfg.num_kv_heads
    counts0 = kernel_counts()
    with torch.inference_mode():
        full = model(ids).float()
        empty = (torch.zeros((cfg.num_layers, 1, 0, hkv, hd),
                             device="cuda"),) * 2
        got, cache = model(ids[:, :n_prefill],
                           torch.arange(n_prefill, device="cuda")[None],
                           kv_caches=empty)
        errs = [max_err(got, full[:, :n_prefill])]
        before = flash_attention.launches
        before_split = flash_attention.decode_launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(n_prefill, n):
            got, cache = model(ids[:, t:t + 1],
                               torch.tensor([[t]], device="cuda"),
                               kv_caches=cache)
            errs.append(max_err(got, full[:, t:t + 1]))
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / n_decode * 1e3
        launches = flash_attention.launches - before
        split = flash_attention.decode_launches - before_split
    f32_counts = kernel_counts(counts0)  # full forward, prefill, decode
    assert tuple(cache[0].shape) == (cfg.num_layers, 1, n, hkv, hd)
    log(f"dense cache (llama3-8b width, 2 layers, f32): prefill "
        f"{n_prefill} then {n_decode} one-token steps; max|logits - full "
        f"forward| prefill {errs[0]:.3e}, decode max {max(errs[1:]):.3e} "
        f"(atol {ATOL_LOGITS_F32}); K2 launches in the decode steps "
        f"{launches}, {split} of them split-KV (Sq = 1, {cfg.num_layers} a "
        f"step); {step_ms:.2f} ms a decode step on {smi}")
    assert all(math.isfinite(e) for e in errs)
    assert max(errs) <= ATOL_LOGITS_F32, "dense-cache logits disagree"
    assert launches == split == cfg.num_layers * n_decode, \
        f"K2 launched {launches} times at Sq = 1, {split} split-KV"

    # K2 at the last decode step's shape, held to its plain version
    hq, scale = cfg.num_heads, hd ** -0.5
    q = torch.randn((1, 1, hq, hd), generator=gen, device="cuda")
    k = torch.randn((1, n, hkv, hd), generator=gen, device="cuda")
    v = torch.randn((1, n, hkv, hd), generator=gen, device="cuda")
    o, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    o_p, lse_p = flash_attention_plain(q, k, v, causal=True, q_seg=None,
                                       kv_seg=None, scale=scale)
    torch.cuda.synchronize()
    err = max(max_err(o, o_p), max_err(lse, lse_p))
    log(f"K2 flash_fwd decode (f32, Sq=1 Sk={n}): max|kernel-plain| "
        f"{err:.3e} (atol {ATOL_LOGITS_F32 / 100})")
    assert err <= ATOL_LOGITS_F32 / 100, "K2 at Sq = 1 disagrees"
    q_t = q.transpose(1, 2).contiguous()
    k_t = k.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
    v_t = v.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms, parent_ms = timed(
        lambda: flash_attention(q, k, v, causal=True, return_lse=True),
        flush, PARENT and (lambda: parent_fwd(torch, q, k, v, True, None,
                                              None, scale)))
    row = dict(
        max_abs_err=err, parent_ms=parent_ms, ms=ms,
        plain_ms=time_ms(lambda: flash_attention_plain(
            q, k, v, causal=True, q_seg=None, kv_seg=None, scale=scale),
            flush=flush),
        library_ms=time_ms(lambda: sdpa(q_t, k_t, v_t), flush=flush),
        bytes=(2 * q.numel() + k.numel() + v.numel()) * 4 + lse.numel() * 4,
        flops=4 * hq * n * hd, peak_flops=F32_FLOPS, launches=split)
    add_bounds({"flash_fwd_decode": row})

    # the bf16 variant at the same shape (a bf16 model's dense cache runs
    # it), held and timed likewise and kept in the row under "bf16"
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    ob, lseb = flash_attention(qb, kb, vb, causal=True, return_lse=True)
    ob_p, lseb_p = flash_attention_plain(qb, kb, vb, causal=True,
                                         q_seg=None, kv_seg=None, scale=scale)
    torch.cuda.synchronize()
    err_b = max(max_err(ob, ob_p), max_err(lseb, lseb_p))
    log(f"K2 flash_fwd decode (bf16, Sq=1 Sk={n}): max|kernel-plain| "
        f"{err_b:.3e} (o: {ATOL_O_BF16} + {RTOL_O_BF16}*|plain|, lse: "
        f"{ATOL_LSE})")
    assert close_bf16(ob, ob_p) and max_err(lseb, lseb_p) <= ATOL_LSE, \
        "K2 at Sq = 1 in bf16 disagrees"
    qb_t, kb_t, vb_t = (t.to(torch.bfloat16) for t in (q_t, k_t, v_t))
    ms_b, parent_ms_b = timed(
        lambda: flash_attention(qb, kb, vb, causal=True, return_lse=True),
        flush, PARENT and (lambda: parent_fwd(torch, qb, kb, vb, True, None,
                                              None, scale)))
    row_b = dict(
        max_abs_err=err_b, parent_ms=parent_ms_b, ms=ms_b,
        plain_ms=time_ms(lambda: flash_attention_plain(
            qb, kb, vb, causal=True, q_seg=None, kv_seg=None, scale=scale),
            flush=flush),
        library_ms=time_ms(lambda: sdpa(qb_t, kb_t, vb_t), flush=flush),
        bytes=(2 * qb.numel() + kb.numel() + vb.numel()) * 2
        + lseb.numel() * 4, flops=4 * hq * n * hd, peak_flops=BF16_FLOPS)
    add_bounds({"flash_fwd_decode bf16": row_b})
    row["bf16"] = {k: row_b[k] for k in (
        "max_abs_err", "ms", "parent_ms", "plain_ms", "library_ms",
        "bound_ms", "bound_by")}
    del model, full, cache
    sweep = decode_sweep(torch, flush, gen, n, hq, hkv, hd)
    return {"flash_fwd_decode": row}, {
        "logits_max_abs_err_prefill": errs[0],
        "logits_max_abs_err_decode": max(errs[1:]),
        "decode_step_ms": step_ms, "k2_launches_at_sq1": launches,
        "k2_split_kv_launches": split, "split_vs_tiles": sweep,
        "f32_launches": f32_counts}


def decode_sweep(torch, flush, gen, sk, hq, hkv, d):
    """K2's two designs at Sq 1 to 64 over sk keys (B 1, causal), in
    float32 and bf16: the split-KV kernel and the 64-row one, each held to
    the plain version and timed in turns (64-row, split, split, 64-row),
    L2 flushed. The wrapper's DECODE_MAX_SQ is the largest Sq at which
    the split design was the faster here."""
    from ray_tpu_torch.ops import flash_attention as fa

    out = {}
    for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for sq in (1, 2, 4, 8, 16, 32, 64):
            q = torch.randn((1, sq, hq, d), generator=gen, device="cuda")
            k = torch.randn((1, sk, hkv, d), generator=gen, device="cuda")
            v = torch.randn((1, sk, hkv, d), generator=gen, device="cuda")
            q, k, v = (t.to(dt) for t in (q, k, v))
            kw = dict(causal=True, q_seg=None, kv_seg=None, scale=d ** -0.5)
            o_p, lse_p = fa.flash_attention_plain(q, k, v, **kw)
            designs = {"split": sq, "tiles": 0}  # the wrapper's max_sq
            errs = {}
            for design, max_sq in designs.items():
                o, lse = fa._launch(q, k, v, max_sq=max_sq, **kw)
                torch.cuda.synchronize()
                errs[design] = max(max_err(o, o_p), max_err(lse, lse_p))
                ok = (close_bf16(o, o_p) if dt == torch.bfloat16 else
                      max_err(o, o_p) <= ATOL_HD_F32)
                assert ok and max_err(lse, lse_p) <= ATOL_LSE, \
                    f"K2 {design} at Sq {sq} ({name}) disagrees"
            t = [time_ms(lambda m=designs[s]: fa._launch(q, k, v, max_sq=m,
                                                         **kw), flush=flush)
                 for s in ("tiles", "split", "split", "tiles")]
            split_ms, tiles_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
            log(f"  K2 at Sq {sq}, Sk {sk} ({name}): split-KV {split_ms:.4f} "
                f"ms, 64-row tiles {tiles_ms:.4f} ms (max|kernel-plain| "
                f"{errs['split']:.2e}, {errs['tiles']:.2e}); the wrapper "
                f"takes the "
                + ("split" if sq <= fa.DECODE_MAX_SQ[dt] else "64-row")
                + " design")
            out[f"{name}_sq{sq}"] = {"split_ms": split_ms,
                                     "tiles_ms": tiles_ms}
    return out


def _train_and_resume(torch, make, batch, path, steps: int = 2):
    """``steps`` steps of a fresh trainer (``make()`` -> (trainer,
    generator)), its state saved into ``path``, then step ``steps + 1``;
    a fresh trainer loads the checkpoint and takes the same step. Returns
    the two steps' metrics, the largest parameter difference after them,
    the bytes on disk and in the state, and the seconds to save and
    load."""
    from ray_tpu_torch.train.checkpoint import (load_train_state,
                                                save_train_state,
                                                state_bytes)

    trainer, gen = make()
    state = trainer.init(gen, batch)
    for _ in range(steps):
        state, _ = trainer.step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    meta = save_train_state(trainer, state, path)
    save_s = time.perf_counter() - t0
    disk = sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)
    held = sum(state_bytes(state))
    state, m = trainer.step(state, batch)
    want = {k: float(v) for k, v in m.items()}
    kept = {k: p.detach().clone() for k, p in state.params.items()}
    del trainer, state, m
    gc.collect()
    torch.cuda.empty_cache()
    trainer, _ = make()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = load_train_state(trainer, path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    assert state.step == steps and state.opt_state["count"] == steps
    state, m = trainer.step(state, batch)
    got = {k: float(v) for k, v in m.items()}

    def local(t):  # a one-rank mesh trainer's parameters are DTensors
        return t.to_local() if hasattr(t, "to_local") else t

    diff = max(float((local(p.detach()) - local(kept[k])).abs().max())
               for k, p in state.params.items())
    del trainer, state, m, kept
    return {"uninterrupted": want, "resumed": got, "param_max_abs_diff": diff,
            "disk_bytes": disk, "state_bytes": held, "save_s": save_s,
            "load_s": load_s, "metadata": meta}


def run_checkpoint(torch, reset_counts, smi):
    """Phase checkpoint: phase 7's trainer (llama-1b, seed 7, its batch
    and optimizer) takes 2 steps and saves its state
    (``save_train_state``: float32 parameters and AdamW's two moments,
    whole, in the JAX fallback's pickle) into a temporary directory, then
    step 3; a fresh trainer loads the checkpoint and takes step 3, held
    to the uninterrupted one (loss rtol 1e-5, grad norm 1e-4, parameters
    1e-5). Then the one-rank mesh trainer (FSDP2, NCCL) saves and loads
    likewise, at 2 layers. The directory is deleted."""
    import tempfile

    from ray_tpu_torch.models.config import get_config
    from ray_tpu_torch.models.llama import LlamaModel
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from ray_tpu_torch.parallel.train_lib import (ShardedTrainer,
                                                  default_optimizer)

    b, s = 4, 2048
    rng = np.random.default_rng(7)
    cfg = get_config("llama-1b")
    batch = {"input_ids": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (b, s), dtype=np.int32)).cuda()}
    root = tempfile.mkdtemp(prefix="rtpu_ckpt_")
    try:
        # params and two moments in float32, pickled once
        need = 3 * 4 * cfg.num_params()
        free = shutil.disk_usage(root).free
        layers = cfg.num_layers
        while need * 1.2 > free and layers > 2:
            layers //= 2
            cfg = get_config("llama-1b", num_layers=layers)
            need = 3 * 4 * cfg.num_params()
        log(f"checkpoint: {free / 2**30:.1f} GiB free at {root}; "
            f"llama-1b at {layers} layers ({need / 1e9:.2f} GB to write)")

        def one_device(c=cfg):
            def make():
                with torch.device("meta"):
                    model = LlamaModel(c)
                return (ShardedTrainer(model, optimizer=default_optimizer(
                    warmup=1)), torch.Generator(device="cuda").manual_seed(7))
            return make

        reset_counts()  # the resumed steps' launches start here
        out = {"layers": layers, "one_device": _train_and_resume(
            torch, one_device(), batch, os.path.join(root, "one_device"))}
        shutil.rmtree(os.path.join(root, "one_device"))
        mesh_cfg = get_config("llama-1b", num_layers=2)
        with one_rank_world("checkpoint mesh trainer"):
            def make_mesh():
                mesh = create_mesh(MeshConfig(fsdp=1))
                with torch.device("meta"):
                    model = LlamaModel(mesh_cfg, mesh=mesh)
                return (ShardedTrainer(model, mesh,
                                       optimizer=default_optimizer(warmup=1)),
                        torch.Generator(device="cuda").manual_seed(7))

            out["mesh"] = _train_and_resume(torch, make_mesh, batch,
                                            os.path.join(root, "mesh"))
        out["launches"] = {"flash_fwd_train": flash_attention.launches,
                           "flash_bwd_dq": flash_attention.dq_launches,
                           "flash_bwd_dkv": flash_attention.dkv_launches}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for kind in ("one_device", "mesh"):
        r = out[kind]
        want, got = r["uninterrupted"], r["resumed"]
        loss_err = abs(got["loss"] - want["loss"]) / abs(want["loss"])
        gn_err = (abs(got["grad_norm"] - want["grad_norm"])
                  / abs(want["grad_norm"]))
        r.update(loss_rel_err=loss_err, grad_norm_rel_err=gn_err)
        log(f"checkpoint {kind} ({r['metadata']['trainer']}, mesh "
            f"{r['metadata']['mesh']}, {r['metadata']['config']['num_layers']}"
            f" layers) on {smi}: state {r['state_bytes'] / 1e9:.3f} GB on "
            f"the card, {r['disk_bytes'] / 1e9:.3f} GB on disk; save "
            f"{r['save_s']:.1f} s, load {r['load_s']:.1f} s; step 3 "
            f"resumed {got} against uninterrupted {want}: loss rel err "
            f"{loss_err:.2e} (1e-5), grad norm {gn_err:.2e} (1e-4), params "
            f"max abs diff {r['param_max_abs_diff']:.2e} (1e-5)")
        assert math.isfinite(got["loss"]), "non-finite loss after a load"
        assert loss_err <= 1e-5, f"{kind}: resumed loss differs"
        assert gn_err <= 1e-4, f"{kind}: resumed grad norm differs"
        assert r["param_max_abs_diff"] <= 1e-5, \
            f"{kind}: resumed parameters differ"
    log(f"checkpoint: kernel launches {json.dumps(out['launches'])}")
    return out


# ------------------------------------------------------------------ rllib

# the JAX package's defaults (its config classes): the learner config,
# the module spec and the batch of each learner; widths are CartPole-v1's
# (4 observations, 2 actions) and HalfCheetah's (17, 6). Base config: lr
# 3e-4, grad_clip 10, gamma 0.99
RL_CASES = {
    # name: (algorithm module, learner, module class, spec kwargs,
    #        observation shape, actions (n, or a box's width), config,
    #        batch kind)
    "ppo-discrete": ("ppo", "PPOLearner", "DiscreteMLPModule",
                     dict(hidden=(64, 64)), (4,), 2, dict(
                         clip_param=0.3, vf_clip_param=10.0,
                         vf_loss_coeff=1.0, entropy_coeff=0.0), "ppo"),
    "ppo-gaussian": ("ppo", "PPOLearner", "GaussianMLPModule",
                     dict(hidden=(64, 64)), (17,), (6,), dict(
                         clip_param=0.3, vf_clip_param=10.0,
                         vf_loss_coeff=1.0, entropy_coeff=0.0), "ppo"),
    "dqn": ("dqn", "DQNLearner", "QMLPModule",
            dict(hidden=(64, 64), dueling=True), (4,), 2,
            dict(target_update_freq=50), "dqn"),
    "impala": ("impala", "IMPALALearner", "DiscreteMLPModule",
               dict(hidden=(64, 64)), (4,), 2, dict(
                   lr=6e-4, vf_loss_coeff=0.5, entropy_coeff=0.005,
                   vtrace_clip_rho=1.0, vtrace_clip_c=1.0), "impala"),
    "appo": ("impala", "APPOLearner", "DiscreteMLPModule",
             dict(hidden=(64, 64)), (4,), 2, dict(
                 lr=6e-4, vf_loss_coeff=0.5, entropy_coeff=0.005,
                 vtrace_clip_rho=1.0, vtrace_clip_c=1.0, clip_param=0.2),
             "impala"),
    "bc": ("bc", "MARWILLearner", "DiscreteMLPModule", dict(hidden=(64, 64)),
           (4,), 2, dict(beta=0.0, vf_coeff=1.0), "offline"),
    "marwil": ("bc", "MARWILLearner", "DiscreteMLPModule",
               dict(hidden=(64, 64)), (4,), 2,
               dict(beta=1.0, vf_coeff=1.0), "offline"),
    "sac": ("sac", "SACLearner", "SACModule", dict(hidden=(256, 256)),
            (17,), (6,), dict(tau=0.005, initial_alpha=1.0), "sac"),
    "cql": ("cql", "CQLLearner", "SACModule", dict(hidden=(256, 256)),
            (17,), (6,), dict(tau=0.005, initial_alpha=1.0, cql_alpha=1.0,
                              cql_n_actions=4), "sac"),
    "dreamerv3-vector": ("dreamerv3", "DreamerV3Learner", "DreamerV3Module",
                         dict(config=dict(hidden=128, deter=128, stoch=8,
                                          classes=8, bins=41)),
                         (4,), 2, dict(lr=4e-4, imagine_horizon=8,
                                       lambda_=0.95, entropy_coef=3e-3,
                                       free_bits=1.0), "dreamer"),
    "dreamerv3-image": ("dreamerv3", "DreamerV3Learner", "DreamerV3Module",
                        dict(config=dict(hidden=128, deter=128, stoch=8,
                                         classes=8, bins=41)),
                        (64, 64, 3), 6, dict(lr=4e-4, imagine_horizon=8,
                                             lambda_=0.95,
                                             entropy_coef=3e-3,
                                             free_bits=1.0), "dreamer"),
}
RL_SEED = 12
RL_UPDATES = 3
ACT_ENVS = 64


def rl_spaces(obs_shape, acts):
    """Spaces as the modules read them: ``.shape``, and ``.n`` or a box's
    ``.shape``, ``.low`` and ``.high``."""
    from types import SimpleNamespace

    obs = SimpleNamespace(shape=tuple(obs_shape))
    if isinstance(acts, int):
        return obs, SimpleNamespace(n=acts)
    return obs, SimpleNamespace(shape=acts, low=-np.ones(acts, np.float32),
                                high=np.ones(acts, np.float32))


def rl_batch(kind, rng, obs_shape, acts):
    """A numpy batch in the JAX learners' format at the default sizes."""
    f32 = np.float32
    d = int(np.prod(obs_shape))
    if kind == "ppo":  # minibatch 128
        n = 128
        actions = (rng.integers(0, acts, n).astype(np.int32)
                   if isinstance(acts, int)
                   else rng.uniform(-0.95, 0.95, (n, *acts)).astype(f32))
        return {"obs": rng.normal(size=(n, d)).astype(f32),
                "actions": actions,
                "logp": (rng.normal(scale=0.3, size=n) - 1.0).astype(f32),
                "advantages": rng.normal(size=n).astype(f32),
                "value_targets": rng.normal(scale=3, size=n).astype(f32)}
    if kind in ("dqn", "sac"):  # update batch 64; 256
        n = 64 if kind == "dqn" else 256
        actions = (rng.integers(0, acts, n).astype(np.int32)
                   if isinstance(acts, int)
                   else rng.uniform(-0.95, 0.95, (n, *acts)).astype(f32))
        out = {"obs": rng.normal(size=(n, d)).astype(f32),
               "actions": actions,
               "rewards": rng.normal(size=n).astype(f32),
               "next_obs": rng.normal(size=(n, d)).astype(f32),
               "dones": (rng.random(n) < 0.05).astype(f32)}
        if kind == "dqn":  # prioritized replay's IS weights
            out["weights"] = rng.uniform(0.2, 1.0, n).astype(f32)
        return out
    if kind == "impala":  # 500 steps as B 10 x T 50, some rows padded
        B, T = 10, 50
        lengths = np.where(np.arange(B) % 3 == 2, rng.integers(5, T, B), T)
        mask = (np.arange(T)[None] < lengths[:, None]).astype(f32)
        return {"obs": rng.normal(size=(B, T, d)).astype(f32)
                * mask[..., None],
                "actions": (rng.integers(0, acts, (B, T)) * mask).astype(
                    np.int32),
                "rewards": rng.normal(size=(B, T)).astype(f32) * mask,
                "behavior_logp": (rng.normal(scale=0.3, size=(B, T))
                                  - 0.7).astype(f32) * mask,
                "mask": mask,
                "bootstrap_obs": rng.normal(size=(B, d)).astype(f32),
                "terminated": (rng.random(B) < 0.3).astype(f32),
                "length": lengths.astype(np.int32)}
    if kind == "offline":  # minibatch 256
        n = 256
        return {"obs": rng.normal(size=(n, d)).astype(f32),
                "actions": rng.integers(0, acts, n).astype(np.int32),
                "returns": rng.normal(scale=10, size=n).astype(f32)}
    B, T = 8, 32  # DreamerV3: batch_size_B, batch_length_T
    is_first = np.zeros((B, T), f32)
    is_first[:, 0] = 1.0
    is_first[np.arange(B) % 4 == 1, T // 2] = 1.0
    obs = (rng.uniform(0, 255, (B, T, *obs_shape)) if len(obs_shape) == 3
           else rng.normal(size=(B, T, *obs_shape)))
    return {"obs": obs.astype(f32),
            "actions": rng.integers(0, acts, (B, T)).astype(np.int32),
            "rewards": rng.normal(scale=2, size=(B, T)).astype(f32),
            "dones": (rng.random((B, T)) < 0.02).astype(f32),
            "is_first": is_first}


class ReplayDraws:
    """Wraps ``categorical_sample`` in DreamerV3's module (its latents'
    and actions' draws): the card's run records each draw's indices, and
    the CPU's run takes the card's index where its own differs, counting
    those. A draw is argmax(logits + gumbel) of the same noise on both
    sides, so they differ only where two classes tie within float
    rounding; the comparison then holds every continuous quantity on the
    same discrete path."""

    def __init__(self, module):
        self.module = module
        self.draw = module.categorical_sample
        self.mode = None
        self.recorded = []
        self.flips = self.draws = 0
        self.at = 0

    def __call__(self, logits, gumbel):
        idx = self.draw(logits, gumbel)
        if self.mode == "record":
            self.recorded.append(idx)
        elif self.mode == "replay":
            want = self.recorded[self.at].to(idx.device)
            self.at += 1
            self.draws += want.numel()
            self.flips += int((want != idx).sum())
            idx = want
        return idx

    def start(self, mode):
        self.mode, self.at = mode, 0
        if mode == "record":
            self.recorded = []

    def __enter__(self):
        self.module.categorical_sample = self
        return self

    def __exit__(self, *exc):
        self.module.categorical_sample = self.draw


def rl_learners(torch, name, extra=None):
    """The case's learner on the card and on the CPU, from one init (the
    learners draw it on the CPU from the seed); ``extra`` joins the
    config."""
    import importlib

    from ray_tpu_torch.rllib.core import rl_module

    algo, cls_name, mod_name, spec_kw, obs_shape, acts, cfg, kind = \
        RL_CASES[name]
    alg = importlib.import_module(f"ray_tpu_torch.rllib.algorithms.{algo}")
    mod_cls = (getattr(alg, mod_name) if hasattr(alg, mod_name)
               else getattr(rl_module, mod_name))
    obs_space, act_space = rl_spaces(obs_shape, acts)
    cfg = {"lr": 3e-4, "grad_clip": 10.0, "gamma": 0.99, **cfg,
           **(extra or {})}
    learners = {}
    for dev in ("cuda", "cpu"):
        spec = rl_module.RLModuleSpec(module_class=mod_cls, **spec_kw)
        learners[dev] = getattr(alg, cls_name)(
            spec.build(obs_space, act_space), dict(cfg), seed=RL_SEED,
            device=dev)
    return alg, learners, cfg


def rl_metric_err(got, want, key):
    """Relative error of a metric: the grad norm's against its value, the
    others' against max(|value|, 1) (a mean of O(1) terms may cancel
    toward 0, where its rounding stays that of the terms)."""
    if key == "grad_norm":
        return abs(got - want) / abs(want)
    return abs(got - want) / max(abs(want), 1.0)


@contextlib.contextmanager
def rl_synced(cuda, cpu):
    """The CPU learner takes the card's parameters, Adam moments and
    return scale before an update (each update is then one step from the
    same state, as phase 8's); yields the CPU's first moments before the
    update (for rl_param_check). Targets are not copied: after_update's
    work shows through the next update's loss."""
    import torch

    with torch.no_grad():
        for k, p in cpu.params.items():
            p.copy_(cuda.params[k].cpu())
        for key in ("mu", "nu"):
            for a, b in zip(cpu.opt_state[key], cuda.opt_state[key]):
                a.copy_(b.cpu())
    assert cpu.opt_state["count"] == cuda.opt_state["count"]
    if hasattr(cuda, "_ret_scale"):
        cpu._ret_scale = cuda._ret_scale
    yield [m.clone() for m in cpu.opt_state["mu"]]


def rl_param_check(cuda, cpu, mu_before, lr):
    """One update's parameters, phase 8's rule: within ATOL_PARAM_F32
    wherever the step's clipped gradient (from the CPU's Adam first
    moment before and after) is at least NOISY_GRAD; elsewhere within
    2 * lr."""
    b1 = 0.9
    total = off = over = 0
    worst = 0.0
    for (name, p), mu, mu0 in zip(cpu.params.items(), cpu.opt_state["mu"],
                                  mu_before):
        diff = (cuda.params[name].cpu() - p).abs()
        grad = (mu - b1 * mu0) / (1 - b1)
        total += diff.numel()
        over += int((diff > ATOL_PARAM_F32).sum())
        off += int((diff[grad.abs() >= NOISY_GRAD] > ATOL_PARAM_F32).sum())
        worst = max(worst, float(diff.max()))
    return {"param_entries": total, "param_entries_over_atol": over,
            "param_entries_over_atol_with_grad_over_noise": off,
            "param_max_abs_diff": worst,
            "ok": off == 0 and worst <= 2 * lr + ATOL_PARAM_F32}


def run_rl_case(torch, name, smi):
    """Three updates of one learner on the card and on the CPU from the
    same init, batch and noise, after_update between them."""
    _, _, _, _, obs_shape, acts, cfg, kind = RL_CASES[name]
    batch = rl_batch(kind, np.random.default_rng(RL_SEED), obs_shape, acts)
    # MARWIL's dataset-level advantage scale, as MARWILConfig sets it
    extra = ({"adv_scale": float(np.std(batch["returns"]) + 1e-6)}
             if kind == "offline" and cfg["beta"] else None)
    alg, learners, cfg = rl_learners(torch, name, extra)
    cuda, cpu = learners["cuda"], learners["cpu"]
    for k, p in cpu.params.items():
        assert torch.equal(cuda.params[k].cpu(), p), f"{name}: init {k}"
    ms = {"cuda": [], "cpu": []}
    errs = {}
    params = {"param_entries": 0, "param_entries_over_atol": 0,
              "param_entries_over_atol_with_grad_over_noise": 0,
              "param_max_abs_diff": 0.0, "ok": True}
    flips = draws = 0
    with contextlib.ExitStack() as stack:
        replay = (stack.enter_context(ReplayDraws(alg))
                  if name.startswith("dreamerv3") else None)
        for _ in range(RL_UPDATES):
            metrics = {}
            mu_before = stack.enter_context(rl_synced(cuda, cpu))
            for dev, learner in learners.items():
                if replay is not None:
                    replay.start("record" if dev == "cuda" else "replay")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                metrics[dev] = learner.update(batch)  # syncs: metrics out
                ms[dev].append((time.perf_counter() - t0) * 1e3)
            for learner in learners.values():
                learner.after_update()
            for key, want in metrics["cpu"].items():
                errs[key] = max(errs.get(key, 0.0), rl_metric_err(
                    metrics["cuda"][key], want, key))
            step = rl_param_check(cuda, cpu, mu_before, cfg["lr"])
            for key, val in step.items():
                params[key] = (params[key] and val if key == "ok"
                               else max(params[key], val)
                               if key == "param_max_abs_diff"
                               else params[key] + val)
        if replay is not None:
            flips, draws = replay.flips, replay.draws
    med = {dev: sorted(v)[len(v) // 2] for dev, v in ms.items()}
    out = {"update_ms_cuda": med["cuda"], "update_ms_cpu": med["cpu"],
           "update_ms_cuda_all": ms["cuda"], "update_ms_cpu_all": ms["cpu"],
           "metric_rel_err": errs, "last_metrics": metrics["cuda"],
           **{k: v for k, v in params.items() if k != "ok"}}
    if draws:
        out.update(draws=draws, draws_differing=flips)
    log(f"rllib {name} on {smi}: {med['cuda']:.2f} ms per update on the "
        f"card, {med['cpu']:.2f} ms on the CPU (median of {RL_UPDATES}); "
        f"metric rel errs {json.dumps({k: float(f'{v:.2e}') for k, v in errs.items()})}; "
        f"params over the {RL_UPDATES} updates: "
        f"{params['param_entries_over_atol']} of {params['param_entries']} "
        f"over {ATOL_PARAM_F32}, "
        f"{params['param_entries_over_atol_with_grad_over_noise']} where "
        f"|clipped grad| >= {NOISY_GRAD} (allowed 0), max diff "
        f"{params['param_max_abs_diff']:.3e}"
        + (f"; {flips} of {draws} draws decided otherwise on the CPU "
           f"(replayed)" if draws else ""))
    for key, err in errs.items():
        tol = RTOL_GNORM_F32 if key == "grad_norm" else RTOL_LOSS_F32
        assert err <= tol, f"rllib {name}: {key} rel err {err:.3e} > {tol}"
    assert params["ok"], f"rllib {name}: parameters disagree"
    assert all(math.isfinite(v) for v in metrics["cuda"].values())
    return out, learners


def time_act(torch, fn, calls: int = 20) -> float:
    """Median wall ms of fn() (act copies its result to the host, which
    waits for the card), after 2 warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[calls // 2]


def run_act(torch, name, learners, smi):
    """One act() over ACT_ENVS envs with the case's trained module on the
    card and on the CPU: the same actions given the same noise (DreamerV3's
    draws replayed as in its updates), then the median ms of each."""
    from ray_tpu_torch.rllib.algorithms import dreamerv3
    from ray_tpu_torch.rllib.core.rl_module import gumbel_noise
    from ray_tpu_torch.rllib.env.policy import act

    module = learners["cpu"].module
    obs_shape = RL_CASES[name][4]
    obs = np.random.default_rng(RL_SEED).normal(
        size=(ACT_ENVS, *obs_shape)).astype(np.float32)
    stateful = name.startswith("dreamerv3")
    gen = torch.Generator().manual_seed(RL_SEED)
    if stateful:
        noise = {"z": gumbel_noise((ACT_ENVS, module.stoch, module.classes),
                                   gen),
                 "a": gumbel_noise((ACT_ENVS, module.act_dim), gen)}
    else:
        noise = {"gumbel": gumbel_noise((ACT_ENVS, module.n_actions), gen)}
    outs = {}
    with ReplayDraws(dreamerv3) as replay:
        for dev, learner in learners.items():
            replay.start("record" if dev == "cuda" else "replay")
            state = learner.module.initial_state(ACT_ENVS) if stateful \
                else None
            outs[dev] = act(learner.module, learner.params, obs,
                            state=state, noise=noise)
    np.testing.assert_array_equal(outs["cuda"]["actions"],
                                  outs["cpu"]["actions"])
    logp_err = float(np.abs(outs["cuda"]["logp"] - outs["cpu"]["logp"]).max())
    assert logp_err <= 1e-4, f"act {name}: logp differs by {logp_err}"
    ms = {}
    for dev, learner in learners.items():
        gen = torch.Generator().manual_seed(RL_SEED)
        state = [learner.module.initial_state(ACT_ENVS) if stateful
                 else None]

        def step():
            out = act(learner.module, learner.params, obs, generator=gen,
                      state=state[0])
            state[0] = out.get("state")

        ms[dev] = time_act(torch, step)
    log(f"act {name} ({ACT_ENVS} envs) on {smi}: {ms['cuda']:.3f} ms on the "
        f"card, {ms['cpu']:.3f} ms on the CPU (median of 20); logp err "
        f"{logp_err:.2e}, {replay.flips} draws replayed")
    return {"envs": ACT_ENVS, "ms_cuda": ms["cuda"], "ms_cpu": ms["cpu"],
            "logp_max_abs_err": logp_err}


def profile_update(torch, name, learner, smi):
    """One more update of the card's learner under torch.profiler: wall
    ms, device busy ms and share, kernels launched, the top host ops."""
    from torch.profiler import ProfilerActivity, profile

    _, _, _, _, obs_shape, acts, _, kind = RL_CASES[name]
    batch = rl_batch(kind, np.random.default_rng(RL_SEED), obs_shape, acts)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        learner.update(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = device_summary(prof, wall)
    out["kernels"] = sum(e.count for e in prof.key_averages()
                         if e.device_type.name == "CUDA")
    out["host_top"] = host_summary(prof, 5)
    log(f"rllib {name} on {smi}, a profiled update: "
        f"{out['profiled_wall_ms']:.1f} ms wall, device busy "
        f"{out['device_busy_ms']:.2f} ms "
        f"({100 * out['device_busy_share']:.1f}%), {out['kernels']} kernels")
    return out


def run_rllib(torch, smi):
    """Phase rllib: every learner of ray_tpu_torch.rllib at the JAX
    package's default sizes, three updates on the card and on the CPU in
    this process (TF32 off, cuDNN's too), held to phase 8's tolerances;
    the median ms per update on each, and the ms of one act() over 64
    envs for the MLP policy and DreamerV3's stateful step; a profiled
    card update of SAC and of both DreamerV3 cases."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name in RL_CASES:
        out[name], learners = run_rl_case(torch, name, smi)
        if name in ("ppo-discrete", "dreamerv3-vector", "dreamerv3-image"):
            out[name]["act"] = run_act(torch, name, learners, smi)
        if name in ("sac", "dreamerv3-vector", "dreamerv3-image"):
            out[name]["profiled_update"] = profile_update(
                torch, name, learners["cuda"], smi)
        del learners
    out["card"] = smi
    return out


# ------------------------------------------------------------------ entry

def run_entry(torch, smi):
    """Phase entry: ``entry.entry()``'s forward on the card (llama-500m
    width, 8 layers, vocab 8192, bf16 compute) on its [2, 256] ids: logits
    [2, 256, 8192], K2 once a layer, held to the same function on the CPU
    with the same parameters within ATOL_ENTRY_BF16."""
    from ray_tpu_torch.entry import entry
    from ray_tpu_torch.ops.flash_attention import flash_attention

    fn, (params, ids) = entry()
    fn(params, ids)  # builds and warms the kernels
    torch.cuda.synchronize()
    flash_attention.launches = 0  # the main path's run starts here
    logits = fn(params, ids)
    torch.cuda.synchronize()
    launches = flash_attention.launches
    ms = sorted(time_windows(lambda: fn(params, ids), iters=5,
                             windows=5))[2]
    cpu = fn({k: v.cpu() for k, v in params.items()}, ids.cpu())
    err = max_err(logits.cpu(), cpu)
    scale = float(cpu.float().abs().max())
    log(f"entry on {smi}: logits {list(logits.shape)} {logits.dtype}, K2 "
        f"launches {launches}, {ms:.3f} ms a forward (CUDA events, median "
        f"of 5 windows of 5); max|card - CPU| {err:.3e} (atol "
        f"{ATOL_ENTRY_BF16}; max|logit| {scale:.3f})")
    assert tuple(logits.shape) == (2, 256, 8192), logits.shape
    assert bool(torch.isfinite(logits).all()), "non-finite logits"
    assert launches == 8, f"K2 launched {launches} times, expected 8"
    assert err <= ATOL_ENTRY_BF16, "entry logits disagree with the CPU"
    return {"shape": list(logits.shape), "dtype": str(logits.dtype),
            "k2_launches": launches, "ms": ms, "max_abs_err": err,
            "max_abs_logit": scale, "card": smi}


# ---------------------------------------------------------------------
# Phase head_dims: the head dims K1-K4 take beside CONFIGS' 16, 64 and
# 128, at the widths of models that have them, as get_config overrides of
# llama3-8b (no entry of CONFIGS). Phi-3-mini (D 96, 3.82 B parameters,
# microsoft/Phi-3-mini-4k-instruct's config.json; its sliding window of
# 2047 tokens is not LlamaConfig's, so no sequence here is longer); a
# Llama block at Gemma-2-9B's attention widths (D 256, q width 4096 beside
# a hidden size of 3584; Gemma-2's GeGLU, soft-capping, sandwich norms
# and local layers are not LlamaConfig's); and a small Llama at D 32.
PHI3_MINI = dict(vocab_size=32064, hidden_size=3072, intermediate_size=8192,
                 num_layers=32, num_heads=32, num_kv_heads=32, head_dim=96,
                 rope_theta=10000.0, rms_norm_eps=1e-5)
GEMMA2_9B_ATTN = dict(vocab_size=256000, hidden_size=3584,
                      intermediate_size=14336, num_heads=16, num_kv_heads=8,
                      head_dim=256)
SMALL_D32 = dict(vocab_size=32000, hidden_size=256, intermediate_size=688,
                 num_heads=8, num_kv_heads=4, head_dim=32)
HEAD_DIM_WIDTHS = {32: SMALL_D32, 96: PHI3_MINI, 256: GEMMA2_9B_ATTN}
# float32 kernels against their plain versions at these shapes (sums over
# up to 2048 kv rows or 2 x 2048 q rows in another order, values up to
# ~10): absolute
ATOL_HD_F32 = 1e-3
# layers of the engines and trainers at the D 256 and D 32 widths, and of
# the trainers at D 96 (Phi-3-mini serves at all 32)
HD_LAYERS = 4
HD_TRAIN_STEPS = 3


def hd_decode_row(torch, flush, d, hq, hkv, dt):
    """K1 at head dim d (phase 3's ragged lengths, NaN outside the live
    rows, pages of 16) against its plain version, timed in turns with
    --parent's K1 (whether its output is the earlier tree's bit for bit is
    logged), its two kernels' device time from the profiler ("decode_us",
    "merge_us"): its row."""
    from ray_tpu_torch.ops.paged_attention import (
        paged_attention_decode, paged_attention_decode_plain, paged_write)

    gen = torch.Generator(device="cuda").manual_seed(d)
    page, mp = 16, 128
    lengths = [0, 1, 15, 16, 17, 300, 1000, 2047]
    b = len(lengths)
    num_pages = 1 + b * mp
    pool = torch.full((num_pages, hkv, page, 2 * d), float("nan"),
                      dtype=dt, device="cuda")
    perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
    bt = perm[: b * mp].reshape(b, mp).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    kd, vd = (torch.randn((b, mp * page, hkv, d), generator=gen,
                          device="cuda").to(dt) for _ in range(2))
    pos = torch.arange(mp * page, device="cuda").expand(b, -1)
    paged_write(pool, kd, vd, bt, pos, lens)
    del kd, vd
    q = torch.randn((b, hq, d), generator=gen, device="cuda").to(dt)
    scale = d ** -0.5
    got = paged_attention_decode(q, pool, bt, lens)
    want = paged_attention_decode_plain(q, pool, bt, lens, scale=scale)
    torch.cuda.synchronize()
    err = max_err(got, want)
    assert torch.isfinite(got).all() and (got[0] == 0).all(), \
        f"K1 at D {d} ({dt}): non-finite, or a length-0 row not zero"
    ok = close_bf16(got, want) if dt == torch.bfloat16 else \
        err <= ATOL_HD_F32
    assert ok, f"K1 at D {d} ({dt}) disagrees: {err:.3e}"
    if PARENT is not None:  # the earlier tree computes the same function
        old = parent_decode(torch, q, pool, bt, lens, scale)
        log(f"  earlier tree's K1 at D {d} {dt} against the current one, bit "
            f"for bit: {bool(torch.equal(old, got))}; max|diff| "
            f"{max_err(old, got):.3e}")
    ms, parent_ms = timed(
        lambda: paged_attention_decode(q, pool, bt, lens), flush,
        PARENT and (lambda: parent_decode(torch, q, pool, bt, lens, scale)))
    prof_us = profile_decode_kernels(
        torch, lambda: paged_attention_decode(q, pool, bt, lens))
    size = 2 if dt == torch.bfloat16 else 4
    return dict(
        max_abs_err=err, parent_ms=parent_ms, ms=ms, **prof_us,
        plain_ms=time_ms(lambda: paged_attention_decode_plain(
            q, pool, bt, lens, scale=scale), iters=3, flush=flush),
        library_ms=None,
        bytes=sum(lengths) * hkv * 2 * d * size + 2 * q.numel() * size
        + bt.numel() * 4 + lens.numel() * 4,
        flops=4 * sum(lengths) * hq * d,
        peak_flops=BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS)


def hd_flash_rows(torch, flush, d, hq, hkv, dt, b=2):
    """K2, K3 and K4 at head dim d against their plain versions (B b, S
    2048: causal, packed segments, and 512 queries over 2048 keys;
    check_flash_case), timed on the causal case beside SDPA where it takes
    the shape and, with --parent, the earlier tree's kernels: their
    rows."""
    from ray_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain, flash_bwd_dkv,
        flash_bwd_dkv_plain, flash_bwd_dq, flash_bwd_dq_plain)

    gen = torch.Generator(device="cuda").manual_seed(100 + d)
    s = 2048
    bf16 = dt == torch.bfloat16
    seg = torch.tensor([0] * 512 + [1] * 1024 + [2] * 512,
                       dtype=torch.int32, device="cuda")
    segs = torch.stack([seg, seg.flip(0)] * (b // 2))
    errs = {}
    for name, sq, sg in (("packed segments", s, (segs, segs)),
                         ("sq < sk", 512, None), ("causal", s, None)):
        case, e = check_flash_case(torch, gen, f"  D {d} {dt} {name}", b,
                                   sq, s, hq, hkv, d, sg, dt)
        errs["fwd"] = max(errs.get("fwd", 0.0), e["o"], e["lse"])
        errs["dq"] = max(errs.get("dq", 0.0), e["dq"])
        errs["dkv"] = max(errs.get("dkv", 0.0), e["dk"], e["dv"])
    q, k, v, do, _, lse, delta, kw = case  # the causal case, timed

    # SDPA on the same inputs where it takes them: forward, and the
    # backward alone (dq, dk, dv in one call), as phase 6 times them
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q_t, k_t, v_t = (x.transpose(1, 2).detach().requires_grad_()
                     for x in (q, k, v))
    try:
        out_t = sdpa(q_t, k_t, v_t, is_causal=True, enable_gqa=True)
        sdpa_bwd = sorted(time_windows(lambda: torch.autograd.grad(
            out_t, (q_t, k_t, v_t), do.transpose(1, 2), retain_graph=True),
            iters=5))[1]
        with torch.no_grad():
            sdpa_fwd = time_ms(lambda: sdpa(q_t, k_t, v_t, is_causal=True,
                                            enable_gqa=True), flush=flush)
        del out_t
    except RuntimeError as exc:  # no SDPA backend takes this shape
        log(f"  SDPA at D {d} {dt}: {str(exc).splitlines()[0]}")
        sdpa_fwd = sdpa_bwd = None
    live = b * hq * s * (s + 1) // 2
    size = 2 if bf16 else 4
    qb, kb, vec = q.numel() * size, k.numel() * size, lse.numel() * 4
    peak = BF16_FLOPS if bf16 else F32_FLOPS
    plain = dict(iters=3, warmup=1, flush=flush)
    # the kernels and, with --parent, the earlier tree's in turns
    scale = kw["scale"]
    fwd_ms, fwd_parent_ms = timed(
        lambda: flash_attention(q, k, v, causal=True, return_lse=True),
        flush, PARENT and (lambda: parent_fwd(torch, q, k, v, True, None,
                                              None, scale)))
    dq_ms, dq_parent_ms = timed(
        lambda: flash_bwd_dq(q, k, v, do, lse, delta, **kw), flush,
        PARENT and (lambda: parent_dq(torch, q, k, v, do, lse, delta, True,
                                      None, None, scale)))
    dkv_ms, dkv_parent_ms = timed(
        lambda: flash_bwd_dkv(q, k, v, do, lse, delta, **kw), flush,
        PARENT and (lambda: parent_dkv(torch, q, k, v, do, lse, delta, True,
                                       None, None, scale)))
    if PARENT is not None:  # the earlier tree computes the same function
        new = (*flash_attention(q, k, v, causal=True, return_lse=True),
               flash_bwd_dq(q, k, v, do, lse, delta, **kw),
               *flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
        old = (*parent_fwd(torch, q, k, v, True, None, None, scale),
               parent_dq(torch, q, k, v, do, lse, delta, True, None, None,
                         scale),
               *parent_dkv(torch, q, k, v, do, lse, delta, True, None, None,
                           scale))
        same = {n: bool(torch.equal(a, o_))
                for n, a, o_ in zip(("o", "lse", "dq", "dk", "dv"), new, old)}
        log(f"  earlier tree's K2/K3/K4 at D {d} {dt} against the current "
            f"ones, bit for bit: {json.dumps(same)}; max|diff| "
            + ", ".join(f"{n} {max_err(a, o_):.3e}" for n, a, o_ in
                        zip(("o", "lse", "dq", "dk", "dv"), new, old)))
    return {
        "flash_fwd": dict(
            max_abs_err=errs["fwd"], parent_ms=fwd_parent_ms,
            peak_flops=peak, ms=fwd_ms,
            plain_ms=time_ms(lambda: flash_attention_plain(q, k, v, **kw),
                             **plain),
            library_ms=sdpa_fwd, bytes=2 * qb + 2 * kb + vec,
            flops=2 * 2 * d * live),
        "flash_bwd_dq": dict(
            max_abs_err=errs["dq"], parent_ms=dq_parent_ms, peak_flops=peak,
            ms=dq_ms,
            plain_ms=time_ms(lambda: flash_bwd_dq_plain(
                q, k, v, do, lse, delta, **kw), **plain),
            library_ms=sdpa_bwd, bytes=3 * qb + 2 * kb + 2 * vec,
            flops=3 * 2 * d * live),
        "flash_bwd_dkv": dict(
            max_abs_err=errs["dkv"], parent_ms=dkv_parent_ms,
            peak_flops=peak, ms=dkv_ms,
            plain_ms=time_ms(lambda: flash_bwd_dkv_plain(
                q, k, v, do, lse, delta, **kw), **plain),
            library_ms=sdpa_bwd, bytes=2 * qb + 4 * kb + 2 * vec,
            flops=4 * 2 * d * live)}


def hd_split_decode(torch, flush, d, hq, hkv, sk=528):
    """K2's bf16 split-KV design at Sq 1 over sk keys (the dense cache's
    decode shape, B 1, causal) at head dim d against its plain version,
    timed beside SDPA and in turns with this tree's 64-row kernel at the
    same shape (tiles_ms; 64-row, split, split, 64-row)."""
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops.flash_attention import (flash_attention,
                                                   flash_attention_plain)

    gen = torch.Generator(device="cuda").manual_seed(200 + d)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for shape in ((1, 1, hq, d), (1, sk, hkv, d),
                                      (1, sk, hkv, d)))
    scale = d ** -0.5
    kw = dict(causal=True, q_seg=None, kv_seg=None, scale=scale)
    o, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    o_p, lse_p = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = max(max_err(o, o_p), max_err(lse, lse_p))
    assert close_bf16(o, o_p) and max_err(lse, lse_p) <= ATOL_LSE, \
        f"K2 split-KV at D {d} (bf16, Sq 1, Sk {sk}) disagrees"
    q_t = q.transpose(1, 2)
    k_t, v_t = (x.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
                .contiguous() for x in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    o_t, lse_t = fa._launch(q, k, v, max_sq=0, **kw)  # the 64-row kernel
    torch.cuda.synchronize()
    assert close_bf16(o_t, o_p) and max_err(lse_t, lse_p) <= ATOL_LSE, \
        f"K2's 64-row kernel at D {d} (bf16, Sq 1, Sk {sk}) disagrees"
    t = [time_ms(lambda m=m: fa._launch(q, k, v, max_sq=m, **kw),
                 flush=flush) for m in (0, 1, 1, 0)]
    row = dict(
        max_abs_err=err, ms=(t[1] + t[2]) / 2, tiles_ms=(t[0] + t[3]) / 2,
        plain_ms=time_ms(lambda: flash_attention_plain(q, k, v, **kw),
                         flush=flush),
        library_ms=time_ms(lambda: sdpa(q_t, k_t, v_t), flush=flush),
        bytes=(2 * q.numel() + k.numel() + v.numel()) * 2 + lse.numel() * 4,
        flops=4 * hq * sk * d)
    log(f"K2 split-KV at D {d} (bf16, Sq 1, Sk {sk}, {hq}/{hkv} heads), "
        f"beside the 64-row kernel's {row['tiles_ms']:.4f} ms:")
    add_bounds({f"flash_fwd_decode_d{d} bf16": row})
    return {key: row[key] for key in (
        "max_abs_err", "ms", "tiles_ms", "plain_ms", "library_ms",
        "bound_ms", "bound_by")}


def check_head_dim_kernels(torch, flush):
    """K1-K4 at head dims 32, 96 and 256, in bf16 and float32, against
    their plain versions at the widths' shapes (Hq/Hkv 8/4, 32/32, 16/8):
    rows keyed "<kernel>_d<D>", the bf16 numbers first and the float32
    ones under "f32", each naming the bf16 design it times; at D 256 also
    the bf16 split-KV K2 at the dense cache's decode shape."""
    rows = {}
    for d, width in HEAD_DIM_WIDTHS.items():
        hq, hkv = width["num_heads"], width["num_kv_heads"]
        per_type = {}
        for dt in (torch.bfloat16, torch.float32):
            r = {"paged_decode": hd_decode_row(torch, flush, d, hq, hkv, dt),
                 **hd_flash_rows(torch, flush, d, hq, hkv, dt)}
            log(f"head dim {d}, {dt}:")
            add_bounds(r)
            per_type[dt] = r
            torch.cuda.empty_cache()
        for kname, row in per_type[torch.bfloat16].items():
            f32 = per_type[torch.float32][kname]
            row["f32"] = {k: f32[k] for k in (
                "max_abs_err", "ms", "parent_ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by", "tflops", "bound_share")}
            rows[f"{kname}_d{d}"] = row
        two = DESIGN_ENTRIES.get(d, {})
        for kname, entry in (("paged_decode", "paged_decode_mma"),
                             ("flash_fwd", "flash_fwd_wgmma"),
                             ("flash_bwd_dq", "bwd_dq_wgmma"),
                             ("flash_bwd_dkv", "bwd_dkv_wgmma")):
            rows[f"{kname}_d{d}"]["design"] = f"{two.get(entry, entry)}<{d}>"
        if d == 256:
            rows["flash_fwd_d256"]["decode_bf16"] = hd_split_decode(
                torch, flush, d, hq, hkv)
    return rows


@contextlib.contextmanager
def plain_attention():
    """Attention through the plain versions of K2, K3 and K4 on the card:
    the wrappers' launch and the backward's two kernels swapped for them
    (nothing launched, nothing counted), restored on exit."""
    from ray_tpu_torch.ops import flash_attention as fa

    saved = fa._launch, fa.flash_bwd_dq, fa.flash_bwd_dkv
    fa._launch = fa.flash_attention_plain
    fa.flash_bwd_dq, fa.flash_bwd_dkv = fa.flash_bwd_dq_plain, \
        fa.flash_bwd_dkv_plain
    try:
        yield
    finally:
        fa._launch, fa.flash_bwd_dq, fa.flash_bwd_dkv = saved


def hd_train(torch, reset_counts, d, dtype, plain):
    """HD_TRAIN_STEPS ShardedTrainer steps at the width of head dim d,
    HD_LAYERS layers, params float32, compute `dtype`, on one batch of 2 x
    1024 seeded tokens from seeded weights; with `plain`, attention
    through the plain versions. Returns (losses, grad norms, step ms,
    launches)."""
    from ray_tpu_torch.models.config import get_config
    from ray_tpu_torch.models.llama import LlamaModel
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.parallel.train_lib import (ShardedTrainer,
                                                  default_optimizer)

    cfg = get_config("llama3-8b", **{**HEAD_DIM_WIDTHS[d],
                                     "num_layers": HD_LAYERS}, dtype=dtype)
    with torch.device("meta"):
        model = LlamaModel(cfg)
    trainer = ShardedTrainer(model, optimizer=default_optimizer(warmup=1))
    rng = np.random.default_rng(20 + d)
    batch = {"input_ids": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 1024), dtype=np.int32)).cuda()}
    state = trainer.init(torch.Generator(device="cuda").manual_seed(d),
                         batch)
    losses, gnorms, step_ms = [], [], []
    with plain_attention() if plain else contextlib.nullcontext():
        reset_counts()  # the main path's run starts here
        for _ in range(HD_TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = trainer.step(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        launches = (flash_attention.launches, flash_attention.dq_launches,
                    flash_attention.dkv_launches)
    n_params = sum(p.numel() for p in state.params.values())
    del trainer, model, state, m
    gc.collect()
    torch.cuda.empty_cache()
    return losses, gnorms, step_ms, launches, n_params


def hd_reference(torch, d):
    """Phase 5 at the width of head dim d with 2 layers in float32: first-
    prefill logits and the greedy tokens of the parity prompts, the kernel
    path on the card against the plain path on the CPU, same weights."""
    from ray_tpu_torch.models.config import get_config
    from ray_tpu_torch.models.convert import init_params
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    overrides = {**HEAD_DIM_WIDTHS[d], "num_layers": 2}
    cfg = get_config("llama3-8b", **overrides)
    gen = torch.Generator(device="cuda").manual_seed(30 + d)
    sd = {"cuda": init_params(cfg, gen, "cuda", torch.float32)}
    sd["cpu"] = {k: t.cpu() for k, t in sd["cuda"].items()}
    ids = np.random.default_rng(31).integers(0, cfg.vocab_size, (1, 200))
    logits, tokens = {}, {}
    for dev in ("cuda", "cpu"):
        logits[dev] = first_prefill_logits(torch, cfg, sd[dev], dev, ids)
        engine = LLMEngine(EngineConfig(
            model="llama3-8b", model_overrides=overrides, dtype="float32",
            page_size=16, num_pages=64, max_model_len=256, max_batch=4,
            decode_steps_per_dispatch=4, prefill_buckets=(32, 64, 128, 256),
            device=dev), params=sd.pop(dev))
        tokens[dev] = greedy_parity(engine)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    err = max_err(logits["cuda"], logits["cpu"])
    log(f"f32 reference at D {d} (2 layers): first-prefill max|kernel path "
        f"- plain path| {err:.3e} (atol {ATOL_LOGITS_F32}); greedy parity "
        f"tokens card {tokens['cuda']}, CPU {tokens['cpu']}")
    assert torch.isfinite(logits["cuda"]).all()
    assert err <= ATOL_LOGITS_F32, f"D {d}: kernel-path logits disagree"
    assert tokens["cuda"] == tokens["cpu"], f"D {d}: greedy tokens differ"
    return {"logits_max_abs_err": err, "parity_tokens": tokens["cuda"]}


def run_head_dims(torch, smi):
    """Phase head_dims: K1-K4 at head dims 32, 96 and 256 against their
    plain versions; Phi-3-mini's widths served at full depth in bf16 with
    phase 4's traffic, the D 256 and D 32 widths at HD_LAYERS layers; phase
    5's check at D 96 and D 256; ShardedTrainer steps at the three widths
    in bf16 and float32 on the kernel path, held to the plain path on the
    card. Returns the kernel rows (launches from the served and trained
    runs) and the phase's numbers."""
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.ops.paged_attention import paged_attention_decode

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    rows = check_head_dim_kernels(torch, flush)
    del flush
    launches = {d: dict.fromkeys(("paged_decode", "flash_fwd",
                                  "flash_bwd_dq", "flash_bwd_dkv"), 0)
                for d in HEAD_DIM_WIDTHS}

    def reset_counts():
        paged_attention_decode.launches = 0
        flash_attention.launches = 0
        flash_attention.segment_launches = 0
        flash_attention.dq_launches = 0
        flash_attention.dkv_launches = 0

    out = {"engine": {}, "reference": {}, "train": {}, "card": smi}
    for d in (96, 256, 32):
        overrides = dict(HEAD_DIM_WIDTHS[d])
        if d != 96:
            overrides["num_layers"] = HD_LAYERS
        engine, eng = run_engine(torch, reset_counts,
                                 model_overrides=overrides)
        counts = {"paged_decode": paged_attention_decode.launches,
                  "flash_fwd": flash_attention.launches}
        layers = engine.model_cfg.num_layers
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        log(f"engine at D {d} ({layers} layers, bf16): TTFT ms "
            f"{json.dumps(eng['ttft_ms'])}; decode {eng['decode_tok_s']:.1f} "
            f"tok/s; kernel launches {json.dumps(counts)}")
        for kname, c in counts.items():
            assert c > 0, f"{kname} at D {d} was never launched"
            launches[d][kname] += c
        out["engine"][d] = {"layers": layers, **{k: eng[k] for k in (
            "ttft_ms", "decode_tok_s", "wall_s")}, "launches": counts}
    # the float32 path's launches at each D: phase 5's check and the
    # float32 trainers
    f32_launches = {d: dict.fromkeys(F32_COUNTERS, 0) for d in HEAD_DIM_WIDTHS}
    for d in (96, 256):
        counts0 = kernel_counts()
        out["reference"][d] = hd_reference(torch, d)
        f32_launches[d] = kernel_counts(counts0)
    for d in (96, 256, 32):
        for dtype, (rtol_loss, rtol_gnorm) in (
                ("bfloat16", (RTOL_PP_LOSS, RTOL_PP_GNORM)),
                ("float32", (RTOL_MESH_LOSS, RTOL_MESH_GNORM))):
            loss, gnorm, step_ms, counts, n_params = hd_train(
                torch, reset_counts, d, dtype, plain=False)
            loss_p, gnorm_p, step_ms_p, counts_p, _ = hd_train(
                torch, reset_counts, d, dtype, plain=True)
            loss_err = max(abs(a - b) / abs(b) for a, b in zip(loss, loss_p))
            gn_err = max(abs(a - b) / abs(b) for a, b in zip(gnorm, gnorm_p))
            log(f"train at D {d}, {dtype} ({HD_LAYERS} layers, "
                f"{n_params / 1e9:.3f} B params, 2 x 1024 tokens): losses "
                f"{loss} (plain path {loss_p}, max rel err {loss_err:.2e}, "
                f"rtol {rtol_loss}); grad norms {gnorm} (plain {gnorm_p}, "
                f"max rel err {gn_err:.2e}, rtol {rtol_gnorm}); step ms "
                f"{[round(t, 1) for t in step_ms]} (plain "
                f"{[round(t, 1) for t in step_ms_p]}); K2/K3/K4 launches "
                f"{counts}")
            want = (2 * HD_LAYERS * HD_TRAIN_STEPS,  # forward + remat
                    HD_LAYERS * HD_TRAIN_STEPS, HD_LAYERS * HD_TRAIN_STEPS)
            assert counts == want, f"D {d} {dtype}: launches {counts}"
            assert counts_p == (0, 0, 0), "the plain path launched a kernel"
            assert all(math.isfinite(x) for x in loss + gnorm)
            assert loss_err <= rtol_loss and gn_err <= rtol_gnorm, \
                f"D {d} {dtype}: the kernel path's steps disagree"
            for kname, c in zip(("flash_fwd", "flash_bwd_dq",
                                 "flash_bwd_dkv"), counts):
                launches[d][kname] += c
                if dtype == "float32":
                    f32_launches[d][kname] += c
            out["train"][f"{d}_{dtype}"] = {
                "params": n_params, "losses": loss, "plain_losses": loss_p,
                "grad_norms": gnorm, "plain_grad_norms": gnorm_p,
                "step_ms": step_ms, "plain_step_ms": step_ms_p}
    for d, counts in launches.items():
        for kname, c in counts.items():
            rows[f"{kname}_d{d}"]["launches"] = c
    for d, counts in f32_launches.items():  # K2's 64-row design alone
        rows[f"flash_fwd_d{d}"]["f32"]["launches"] = \
            counts["flash_fwd"] - counts["flash_fwd_split"]
        for kname in ("flash_bwd_dq", "flash_bwd_dkv"):
            rows[f"{kname}_d{d}"]["f32"]["launches"] = counts[kname]
    out["f32_launches"] = f32_launches
    return rows, out


def child_processes() -> list:
    """The pids of the processes whose parent is this one (from /proc)."""
    kids = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:  # ended meanwhile
            continue
        # "pid (command) state ppid ...": the command may hold spaces
        if int(stat.rsplit(")", 1)[1].split()[1]) == os.getpid():
            kids.append(int(entry))
    return kids


def device_info(torch):
    """Phase 1: the card's name and power limit."""
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(f"device: {name} (torch {torch.__version__}, cuda "
        f"{torch.version.cuda})")
    log(smi)
    return name, smi


def build(parent):
    """Phase 2: every kernel from the checkout's sources, in parallel; the
    SASS check; the earlier tree's kernels with --parent."""
    global PARENT
    from ray_tpu_torch.ops import _build

    t0 = time.perf_counter()
    reports = _build.build_all(force=True)
    log(f"built {sorted(reports)} with nvcc {' '.join(_build.NVCC_FLAGS)} "
        f"in {time.perf_counter() - t0:.1f} s")
    for kname, rep in reports.items():
        for line in rep.splitlines():
            if "Compiling entry function" in line or "Used" in line \
                    or "spill" in line or "Performance" in line:
                log(f"  [{kname}] {line.strip()}")
    check_sass(_build)
    check_no_spill(reports)
    if parent:
        t0 = time.perf_counter()
        PARENT = build_parent(parent)
        log(f"built the earlier tree's kernels from {parent} in "
            f"{time.perf_counter() - t0:.1f} s")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", default=None,
                        help="an earlier tree whose K1, K2, K3 and K4 are "
                        "timed beside the current ones")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.ops.paged_attention import paged_attention_decode

    # 1. device; 2. build
    name, smi = run_phase("device", DEADLINES_S["device"], device_info,
                          torch)
    run_phase("build", DEADLINES_S["build"], build, args.parent)

    # 3. kernels against their plain versions
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    kernels = run_phase("kernels", DEADLINES_S["kernels"], check_kernels,
                        torch, flush)
    del flush

    # 4. the main path
    def flush_counts():
        paged_attention_decode.launches = 0
        flash_attention.launches = 0
        flash_attention.segment_launches = 0

    def engine_phase():
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
        eng["parity_tokens"] = greedy_parity(engine)
        log(f"engine: parity tokens {json.dumps(eng['parity_tokens'])}")
        return counts, eng

    counts, eng = run_phase("engine", DEADLINES_S["engine"], engine_phase)
    gc.collect()  # phase 4's engine goes before the next is built
    torch.cuda.empty_cache()

    # 4a. phase 4 through the tp engine, its launches added to phase 4's
    tp_counts, tp_eng = run_phase("tp_engine", DEADLINES_S["tp_engine"],
                                  run_tp_engine, torch, flush_counts, eng,
                                  smi)
    for kname, c in tp_counts.items():
        counts[kname] += c
    gc.collect()
    torch.cuda.empty_cache()

    # 4e. phase 4 through the pipelined engine at pp 2 (two processes on
    # the card), the stages' launches added to phase 4's
    pp_counts, pp_eng = run_phase("pp_engine", DEADLINES_S["pp_engine"],
                                  run_pp_engine, torch, eng, smi)
    for kname, c in pp_counts.items():
        counts[kname] += c
    gc.collect()
    torch.cuda.empty_cache()

    # 4b. the rest of the engine, its launches added to the main path's
    v2_counts, engine_v2 = run_phase("engine_v2", DEADLINES_S["engine_v2"],
                                     run_engine_v2, torch, flush_counts, smi)
    for kname, c in v2_counts.items():
        counts[kname] = counts.get(kname, 0) + c
    gc.collect()
    torch.cuda.empty_cache()

    # 4c. mixtral-8x7b through the engine, its launches added likewise
    moe_counts, moe = run_phase("moe", DEADLINES_S["moe"], run_moe, torch,
                                flush_counts, smi)
    for kname, c in moe_counts.items():
        counts[kname] += c
    gc.collect()
    torch.cuda.empty_cache()
    # the float32 phases' K2/K3/K4 launches (4d, 5, dense_cache, 8, and
    # head_dims' float32 runs)
    f32 = {}
    counts0 = kernel_counts()
    moe["reference"] = run_phase("moe_reference",
                                 DEADLINES_S["moe_reference"],
                                 check_moe_reference, torch)
    f32["moe_reference"] = kernel_counts(counts0)
    gc.collect()
    torch.cuda.empty_cache()

    # 5. reference check
    counts0 = kernel_counts()
    logits_err = run_phase("reference", DEADLINES_S["reference"],
                           check_reference, torch)
    f32["reference"] = kernel_counts(counts0)

    # 5b. the dense KV-cache path: K2 at Sq = 1
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    decode_row, dense = run_phase("dense_cache", DEADLINES_S["dense_cache"],
                                  run_dense_cache, torch, flush, smi)
    kernels.update(decode_row)
    counts["flash_fwd_decode"] = decode_row["flash_fwd_decode"]["launches"]
    f32["dense_cache"] = dense["f32_launches"]
    del flush
    gc.collect()
    torch.cuda.empty_cache()

    # 6. training kernels against their plain versions
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    kernels.update(run_phase("train_kernels", DEADLINES_S["train_kernels"],
                             check_training_kernels, torch, flush))
    del flush
    torch.cuda.empty_cache()

    # 7. the training path: llama-1b, full width and depth
    def reset_train_counts():
        flash_attention.launches = 0
        flash_attention.dq_launches = 0
        flash_attention.dkv_launches = 0

    train = run_phase("trainer", DEADLINES_S["trainer"], run_trainer, torch,
                      reset_train_counts)
    counts.update(train.pop("launches"))
    gc.collect()
    torch.cuda.empty_cache()

    # 7b. the training path with experts, its launches added to phase 7's
    moe["train"] = run_phase("moe_trainer", DEADLINES_S["moe_trainer"],
                             run_moe_trainer, torch, reset_train_counts)
    for kname, c in moe["train"].pop("launches").items():
        counts[kname] += c
    gc.collect()
    torch.cuda.empty_cache()

    # 7c. phase 7 through the mesh trainer, its launches added likewise
    train["mesh"] = run_phase("mesh_trainer", DEADLINES_S["mesh_trainer"],
                              run_mesh_trainer, torch, reset_train_counts,
                              train, smi)
    for kname, c in train["mesh"].pop("launches").items():
        counts[kname] += c
    gc.collect()
    torch.cuda.empty_cache()

    # 7d. ring and Ulysses attention at one sp rank, Ulysses' launches
    # added likewise
    train["sp_attention"] = run_phase(
        "sp_attention", DEADLINES_S["sp_attention"], run_sp_attention, torch,
        reset_train_counts, smi)
    for kname, c in train["sp_attention"].pop("launches").items():
        counts[kname] += c
    gc.collect()
    torch.cuda.empty_cache()

    # 7e. phase 7 through the pipelined trainer at one stage, and the GPipe
    # loop itself; the steps' launches added likewise
    train["pp"] = run_phase("pp_trainer", DEADLINES_S["pp_trainer"],
                            run_pp_trainer, torch, reset_train_counts, train,
                            smi)
    for kname, c in train["pp"].pop("launches").items():
        counts[kname] += c
    gc.collect()
    torch.cuda.empty_cache()

    # 7f. phase 7's state saved and loaded (and the mesh trainer's), the
    # resumed steps' launches added likewise
    train["checkpoint"] = run_phase("checkpoint", DEADLINES_S["checkpoint"],
                                    run_checkpoint, torch,
                                    reset_train_counts, smi)
    for kname, c in train["checkpoint"].pop("launches").items():
        counts[kname] += c
    gc.collect()
    torch.cuda.empty_cache()

    # 8. one float32 step, card against CPU
    counts0 = kernel_counts()
    train["reference"] = run_phase("train_reference",
                                   DEADLINES_S["train_reference"],
                                   check_train_reference, torch)
    f32["train_reference"] = kernel_counts(counts0)

    # 9. the RL learners, card against CPU
    rllib = run_phase("rllib", DEADLINES_S["rllib"], run_rllib, torch, smi)
    gc.collect()
    torch.cuda.empty_cache()

    # 10. entry(): the Llama forward through K2, its launches added to the
    # cache-free row's
    entry_out = run_phase("entry", DEADLINES_S["entry"], run_entry, torch,
                          smi)
    counts["flash_fwd_train"] += entry_out["k2_launches"]
    gc.collect()
    torch.cuda.empty_cache()

    # 11. K1-K4 at head dims 32, 96 and 256, and the widths that have them
    # served and trained; each row's launches from its own main paths
    hd_rows, head_dims = run_phase("head_dims", DEADLINES_S["head_dims"],
                                   run_head_dims, torch, smi)
    kernels.update(hd_rows)
    counts.update({kname: r["launches"] for kname, r in hd_rows.items()})
    for d, c in head_dims["f32_launches"].items():
        f32[f"head_dims_d{d}"] = c

    # the float32 training rows' launches from their main paths: D 64
    # (llama-1b width) phase 8's step, D 128 (Mixtral's and llama3-8b's
    # widths) phases 4d, 5 and dense_cache; K2's 64-row design alone (its
    # split-KV launches are the decode row's)
    log(f"float32 path launches (K2 either design, flash_fwd_split of "
        f"them split-KV; K3; K4) by phase: {json.dumps(f32)}")
    for key, phases in (("f32", ("train_reference",)),
                        ("f32_d128", ("moe_reference", "reference",
                                      "dense_cache"))):
        c = {k: sum(f32[ph][k] for ph in phases) for k in F32_COUNTERS}
        kernels["flash_fwd_train"][key]["launches"] = \
            c["flash_fwd"] - c["flash_fwd_split"]
        for kname in ("flash_bwd_dq", "flash_bwd_dkv"):
            kernels[kname][key]["launches"] = c[kname]
    gc.collect()
    torch.cuda.empty_cache()

    # every process the run started has ended: pp_engine's spawn server
    # and its resource tracker would outlive the exit by a moment
    # otherwise (the ranks ended inside spawn)
    from ray_tpu_torch.parallel.distributed import shutdown
    shutdown()
    left = child_processes()
    assert not left, f"processes still running: {left}"

    sources = {"paged_decode": ("ray_tpu_torch/ops/csrc/paged_decode.cu",
                                "ray_tpu/ops/paged_attention.py:138"),
               "flash_fwd_self": ("ray_tpu_torch/ops/csrc/flash_fwd.cu",
                                  "ray_tpu/ops/flash_attention.py:66"),
               "flash_fwd_ctx": ("ray_tpu_torch/ops/csrc/flash_fwd.cu",
                                 "ray_tpu/ops/flash_attention.py:66"),
               "flash_fwd_verify": ("ray_tpu_torch/ops/csrc/flash_fwd.cu",
                                    "ray_tpu/ops/flash_attention.py:66"),
               "flash_fwd_train": ("ray_tpu_torch/ops/csrc/flash_fwd.cu",
                                   "ray_tpu/ops/flash_attention.py:66"),
               "flash_fwd_decode": ("ray_tpu_torch/ops/csrc/flash_fwd.cu",
                                    "ray_tpu/ops/flash_attention.py:66"),
               "flash_bwd_dq": ("ray_tpu_torch/ops/csrc/flash_bwd.cu",
                                "ray_tpu/ops/flash_attention.py:178"),
               "flash_bwd_dkv": ("ray_tpu_torch/ops/csrc/flash_bwd.cu",
                                 "ray_tpu/ops/flash_attention.py:228")}
    sources.update({f"{kname}_d{d}": sources[base]
                    for kname, base in (("paged_decode", "paged_decode"),
                                        ("flash_fwd", "flash_fwd_train"),
                                        ("flash_bwd_dq", "flash_bwd_dq"),
                                        ("flash_bwd_dkv", "flash_bwd_dkv"))
                    for d in HEAD_DIM_WIDTHS})
    line = {"kernels": [
        {"name": kname, "route": "cuda", "source": sources[kname][0],
         "replaces": sources[kname][1], "launches": counts[kname],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         "tflops": r["tflops"], "bound_share": r["bound_share"],
         "parent_ms": r["parent_ms"],
         **{k: r[k] for k in ("decode_us", "merge_us", "bf16", "f32",
                              "f32_d128", "design", "decode_bf16")
            if k in r}}
        for kname, r in kernels.items()],
        "engine": {"ttft_ms": eng["ttft_ms"],
                   "decode_tok_s": eng["decode_tok_s"],
                   "wall_s": eng["wall_s"], "steady": eng["steady"],
                   "prefill_wave": eng["prefill_wave"],
                   "f32_logits_max_abs_err": logits_err,
                   "parity_tokens": eng["parity_tokens"]},
        "tp_engine": {k: tp_eng[k] for k in (
            "ttft_ms", "decode_tok_s", "wall_s", "steady", "frames",
            "sharding", "collective_host_us")},
        "pp_engine": pp_eng, "dense_cache": dense,
        "engine_v2": engine_v2, "moe": moe, "train": train,
        "rllib": rllib, "entry": entry_out, "head_dims": head_dims,
        "f32_launches": f32, "card": smi}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
