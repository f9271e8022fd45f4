"""Time variants of the K1, K2, K3 and K4 kernels beside the built ones.

Each variant is this tree's kernel source with one design constant
changed: for the float32 K2 and K4, stages, blocks an SM and loop
unrolling; for the bf16 K4 at D 96 (bwd_dkv_wgmma_rows), the ring's
stages, its grid order and K or V read from shared memory, and its
design at D 64 and 128, where the built tree keeps the one-warpgroup
kernel (a probe); for the bf16 K2 at D 96 (flash_fwd_wgmma), Q read from
shared memory instead of registers; for the bf16 K3 at D 256, the
one-warpgroup kernel instead of the pair; for the bf16 K1 at D 96
(paged_decode_mha), two warps sharing each split instead of four, and
paged_decode_mma (one warp a split). It is built by nvcc into
``ray_tpu_torch/_build/variants/`` (its -Xptxas -v registers and spills
printed), held to the built kernel on the same inputs (float32 within
ATOL_HD_F32, bf16 within the kernel tolerance, and whether it is bit for
bit the built kernel's is printed), and timed in turns with it (built,
variants, variants reversed, built: one round, repeated --rounds times;
CUDA events, L2 flushed) at the shapes chip_smoke.py times the kernels:
B 2 (B 4 at D 64), S 2048, causal, the head counts of the widths that
have each head dim (K1: its head_dims phase's lengths and pages). Each
kernel's mean over its windows is printed with the least and the most
of them. The last line is one JSON object of the times. Needs a card;
names select variants (default: all):

    python3 chip_variants.py [--rounds N] [NAME ...]
"""

import ctypes
import json
import os
import re
import subprocess
import sys

import torch

import chip_smoke as cs
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import flash_attention as fa

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "ray_tpu_torch", "ops", "csrc")
OUT = os.path.join(_build.BUILD_DIR, "variants")
# head dim: (batch, q heads, kv heads), as chip_smoke.py times them
SHAPES = {32: (2, 8, 4), 64: (4, 32, 8), 96: (2, 32, 32), 128: (2, 32, 8),
          256: (2, 16, 8)}
K2_S_LOOP = ("#pragma unroll 2\n    for (int e = 0; e < D; e += 4) {\n"
             "      float4 kf[4];")


def unroll1(text):
    return text, text.replace("unroll 2", "unroll 1")


# name: (kernel, source, [(text, replacement)], head dims timed)
VARIANTS = {
    "k2_two_stages_d96": ("K2", "flash_fwd.cu", [(
        "STAGES = D == 96 || D > 128 ? 1 : 2;",
        "STAGES = D > 128 ? 1 : 2;")], (96,)),
    "k2_s_loop_unroll1": ("K2", "flash_fwd.cu", [unroll1(K2_S_LOOP)],
                          (32, 64, 96)),
    "k4_two_blocks_d32": ("K4", "flash_bwd.cu", [(
        "min_blocks = D == 64 ? 2 : 1;", "min_blocks = D <= 64 ? 2 : 1;")],
        (32,)),
    "k4_two_stages_d64": ("K4", "flash_bwd.cu", [
        ("STAGES = D == 64 || D > 128 ? 1 : 2;", "STAGES = D > 128 ? 1 : 2;"),
        ("min_blocks = D == 64 ? 2 : 1;", "min_blocks = 1;"),
        ("static_assert(2 * DkvF32<64>::bytes + 2048 <= 233472",
         "static_assert(true")], (64,)),
    "k4_one_half_d256": ("K4", "flash_bwd.cu", [
        ("PAIR = D > 128;", "PAIR = false;"),
        ("NT = kThreads;", "NT = D > 128 ? 128 : kThreads;")], (256,)),
    # the bf16 K4 at D 96, two warpgroups over 128 kv rows
    "k4_rows_two_stages": ("K4 bf16", "flash_bwd.cu", [
        ("kRowsStages = 3;", "kRowsStages = 2;")], (96,)),
    "k4_rows_light_first": ("K4 bf16", "flash_bwd.cu", [
        ("kRowsHeavyFirst = true;", "kRowsHeavyFirst = false;")], (96,)),
    # S^T with K, dP^T with V read from shared memory (the built K4 holds
    # their fragments in registers: each product reads one operand there)
    "k4_rows_k_smem": ("K4 bf16", "flash_bwd.cu", [
        ("kRowsKRegs = true;", "kRowsKRegs = false;")], (96,)),
    "k4_rows_v_smem": ("K4 bf16", "flash_bwd.cu", [
        ("kRowsVRegs = true;", "kRowsVRegs = false;")], (96,)),
    # the design at D 64 and 128 with K and V read from shared memory:
    # load_afrag takes the 64-byte swizzle only
    "k4_rows_d64_d128": ("K4 bf16", "flash_bwd.cu", [
        ("return d == 96;", "return d == 64 || d == 96 || d == 128;"),
        ("kRowsKRegs = true;", "kRowsKRegs = false;"),
        ("kRowsVRegs = true;", "kRowsVRegs = false;")], (64, 128)),
    # the bf16 K2 at D 96 with S = Q K^T reading Q from shared memory (the
    # built kernel holds Q's fragments in registers)
    "k2_q_smem_d96": ("K2 bf16", "flash_fwd.cu", [
        ("fwd_q_regs(int d) { return d == 96; }",
         "fwd_q_regs(int d) { return false; }")], (96,)),
    # the bf16 K3 at D 256 in one warpgroup (bwd_dq_wgmma, the design
    # bwd_dq_wgmma_pair replaced)
    "k3_one_warpgroup_d256": ("K3 bf16", "flash_bwd.cu", [
        ("dq_pair(int d) { return d == 256; }",
         "dq_pair(int d) { return false; }")], (256,)),
    # the bf16 K1 at D 96 (paged_decode_mha) with two warps sharing each
    # split instead of four, and paged_decode_mma (one warp a split)
    "k1_mha_two_warps": ("K1 bf16", "paged_decode.cu", [
        ("kMhaWarps = 4;", "kMhaWarps = 2;")], (96,)),
    "k1_mma_d96": ("K1 bf16", "paged_decode.cu", [
        ("mha_design(int d) { return d == 96; }",
         "mha_design(int d) { return false; }")], (96,)),
}
# the varied kernels' entry functions (regular expressions), for their
# ptxas reports
ENTRIES = {"K2": "flash_fwd_f32", "K4": "bwd_dkv_f32",
           "K2 bf16": "flash_fwd_wgmma", "K4 bf16": "bwd_dkv_wgmma_rows",
           "K3 bf16": "bwd_dq_wgmma(?:_pair)?",
           "K1 bf16": "paged_decode_m[hm]a"}
# K1's inputs as chip_smoke.py's head_dims phase times it: Phi-3-mini's
# 32/32 heads, phase 3's lengths, pages of 16, NaN outside the live rows
K1_LENGTHS = [0, 1, 15, 16, 17, 300, 1000, 2047]


def build_variants(names):
    """The named variants' libraries, built in parallel; their ptxas
    reports of the varied kernels' entries are printed."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name in names:
        kernel, src, subs, _ = VARIANTS[name]
        with open(os.path.join(CSRC, src)) as f:
            text = f.read()
        for old, new in subs:
            assert old in text, f"{name}: {old!r} not in {src}"
            text = text.replace(old, new)
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(OUT, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", CSRC, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        report, _ = proc.communicate()
        assert proc.returncode == 0, f"{name} build failed:\n{report}"
        entry = ENTRIES[VARIANTS[name][0]]
        fn = None
        for line in report.splitlines():
            if "Compiling entry function" in line:
                m = re.search(rf"({entry})ILi(\d+)E", line)
                fn = m and f"{m.group(1)}<{m.group(2)}>"
            elif fn and ("spill" in line or "Used" in line):
                cs.log(f"  {name} {fn}: {line.strip()}")
        libs[name] = ctypes.CDLL(lib)
        for fn_name, argtypes in {
                **_build.SIGNATURES["flash_fwd"],
                **_build.SIGNATURES["flash_bwd"],
                **_build.SIGNATURES["paged_decode"]}.items():
            if hasattr(libs[name], fn_name):
                getattr(libs[name], fn_name).argtypes = argtypes
                getattr(libs[name], fn_name).restype = ctypes.c_int
    return libs


def call_k2(lib, q, k, v):
    b, sq, hq, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, sq, hq), dtype=torch.float32, device=q.device)
    code = lib.flash_fwd(
        fa._DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), None, None, b, sq, k.shape[1], hq,
        k.shape[2], d,
        fa._strides(q, k, v, o), 1, d ** -0.5,
        torch.cuda.current_stream().cuda_stream)
    assert code == 0, f"flash_fwd: cudaError {code}"
    return o, lse


def call_k3(lib, q, k, v, do, lse, delta):
    b, sq, hq, d = q.shape
    dq = torch.empty_like(q)
    code = lib.flash_bwd_dq(
        fa._DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), None, None,
        dq.data_ptr(), b, sq, k.shape[1], hq, k.shape[2], d,
        fa._strides(q, k, v, do), 1, d ** -0.5,
        torch.cuda.current_stream().cuda_stream)
    assert code == 0, f"flash_bwd_dq: cudaError {code}"
    return (dq,)


def call_k1(lib, q, pool, bt, lens):
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
        1, q.data_ptr(), pool.data_ptr(), bt.data_ptr(), lens.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(), b, hq, hkv,
        d, page, mp, d ** -0.5, torch.cuda.current_stream().cuda_stream)
    assert code == 0, f"paged_decode: cudaError {code}"
    return (out,)


def k1_inputs(d, hq, hkv, page=16, mp=128):
    """K1's inputs at head dim d (K1_LENGTHS, bf16)."""
    from ray_tpu_torch.ops.paged_attention import paged_write

    gen = torch.Generator(device="cuda").manual_seed(d)
    b = len(K1_LENGTHS)
    pool = torch.full((1 + b * mp, hkv, page, 2 * d), float("nan"),
                      dtype=torch.bfloat16, device="cuda")
    perm = torch.randperm(b * mp, generator=gen, device="cuda") + 1
    bt = perm.reshape(b, mp).to(torch.int32)
    lens = torch.tensor(K1_LENGTHS, dtype=torch.int32, device="cuda")
    kd, vd = (torch.randn((b, mp * page, hkv, d), generator=gen,
                          device="cuda").to(torch.bfloat16)
              for _ in range(2))
    paged_write(pool, kd, vd, bt,
                torch.arange(mp * page, device="cuda").expand(b, -1), lens)
    q = torch.randn((b, hq, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    return q, pool, bt, lens


def compare_and_time(label, call, built, libs, group, rounds, flush, f32):
    """Hold each variant of `group` to the built kernel, then time them in
    turns; returns each one's mean ms."""
    want = call(built)
    for n in group:
        got = call(libs[n])
        err = max(cs.max_err(a, w) for a, w in zip(got, want))
        same = all(torch.equal(a, w) for a, w in zip(got, want))
        ok = (err <= cs.ATOL_HD_F32 if f32 else
              all(cs.close_bf16(a, w) for a, w in zip(got, want)))
        cs.log(f"  {n} {label}: max|variant - built| {err:.3e}, bit for "
               f"bit {same}")
        assert ok, f"{n} {label}: {err:.3e}"
    order = [("built", built)] + [(n, libs[n]) for n in group]
    t = {n: [] for n, _ in order}
    for n, lib in (order + order[::-1]) * rounds:
        t[n].append(cs.time_ms(lambda lib=lib: call(lib), flush=flush))
    cs.log(f"{label} ({2 * rounds} windows): " + ", ".join(
        f"{n} {sum(x) / len(x):.4f} ({min(x):.4f}-{max(x):.4f})"
        for n, x in t.items()) + " ms")
    return {n: sum(x) / len(x) for n, x in t.items()}


def call_k4(lib, q, k, v, do, lse, delta):
    b, sq, hq, d = q.shape
    dk = torch.empty((b, k.shape[1], k.shape[2], d), dtype=k.dtype,
                     device=q.device)
    dv = torch.empty_like(dk)
    code = lib.flash_bwd_dkv(
        fa._DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), None, None,
        dk.data_ptr(), dv.data_ptr(), b, sq, k.shape[1], hq, k.shape[2], d,
        fa._strides(q, k, v, do), 1, d ** -0.5,
        torch.cuda.current_stream().cuda_stream)
    assert code == 0, f"flash_bwd_dkv: cudaError {code}"
    return dk, dv


def main() -> int:
    args = sys.argv[1:]
    rounds = 1
    if args[:1] == ["--rounds"]:
        rounds, args = int(args[1]), args[2:]
    names = args or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"chip_variants: no variant {unknown}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    cs.log(smi)
    _build.build_all(["flash_fwd", "flash_bwd", "paged_decode"], force=True)
    built = {"K2": _build.library("flash_fwd"),
             "K3": _build.library("flash_bwd"),
             "K4": _build.library("flash_bwd"),
             "K1": _build.library("paged_decode")}
    libs = build_variants(names)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    times = {}
    for d in sorted({d for n in names for d in VARIANTS[n][3]
                     if VARIANTS[n][0] == "K1 bf16"}):
        _, hq, hkv = SHAPES[d]
        group = [n for n in names if VARIANTS[n][0] == "K1 bf16"
                 and d in VARIANTS[n][3]]
        q, pool, bt, lens = k1_inputs(d, hq, hkv)
        times[f"K1_bf16_d{d}"] = compare_and_time(
            f"K1 bfloat16 at D {d} (B {len(K1_LENGTHS)}, {hq}/{hkv} heads, "
            f"pages of 16)", lambda lib: call_k1(lib, q, pool, bt, lens),
            built["K1"], libs, group, rounds, flush, False)
        del q, pool, bt, lens
        torch.cuda.empty_cache()
    for d in sorted({d for n in names for d in VARIANTS[n][3]
                     if VARIANTS[n][0] != "K1 bf16"}):
        b, hq, hkv = SHAPES[d]
        for dt, suffix in ((torch.float32, ""), (torch.bfloat16, " bf16")):
            gen = torch.Generator(device="cuda").manual_seed(d)
            q, do = (torch.randn((b, 2048, hq, d), generator=gen,
                                 device="cuda").to(dt) for _ in range(2))
            kv = torch.randn((b, 2048, 2 * hkv, d), generator=gen,
                             device="cuda").to(dt)
            k, v = kv[:, :, :hkv], kv[:, :, hkv:]
            o, lse = call_k2(built["K2"], q, k, v)
            delta = fa.attention_delta(o, do)
            calls = {"K2": lambda lib: call_k2(lib, q, k, v),
                     "K3": lambda lib: call_k3(lib, q, k, v, do, lse, delta),
                     "K4": lambda lib: call_k4(lib, q, k, v, do, lse, delta)}
            for kernel, call in calls.items():
                group = [n for n in names if VARIANTS[n][0] == kernel + suffix
                         and d in VARIANTS[n][3]]
                if not group:
                    continue
                times[f"{kernel}{suffix.replace(' ', '_')}_d{d}"] = \
                    compare_and_time(
                        f"{kernel} {str(dt)[6:]} at D {d} (B {b}, {hq}/{hkv} "
                        f"heads, S 2048, causal)", call, built[kernel], libs,
                        group, rounds, flush, dt == torch.float32)
            del q, do, kv, k, v, o, lse, delta
            torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
