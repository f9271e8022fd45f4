"""Time variants of the K2 and K4 kernels beside the built ones.

Each variant is this tree's kernel source with one design constant
changed: for the float32 K2 and K4, stages, blocks an SM and loop
unrolling; for the bf16 K4 at D 96 (bwd_dkv_wgmma_rows), the ring's
stages, its grid order and K or V read from shared memory, and its
design at D 64 and 128, where the built tree keeps the one-warpgroup
kernel (a probe); for the bf16 K2 at D 96 (flash_fwd_wgmma), Q read from
shared memory instead of registers. It is built by nvcc into
``ray_tpu_torch/_build/variants/`` (its -Xptxas -v registers and spills
printed), held to the built kernel on the same inputs (float32 within
ATOL_HD_F32, bf16 within the kernel tolerance, and whether it is bit for
bit the built kernel's is printed), and timed in turns with it (built,
variants, variants reversed, built: one round, repeated --rounds times;
CUDA events, L2 flushed) at the shapes chip_smoke.py times the kernels:
B 2 (B 4 at D 64), S 2048, causal, the head counts of the widths that
have each head dim. Each kernel's mean over its windows is printed with
the least and the most of them. The last line is one JSON object of the
times. Needs a card; names select variants (default: all):

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
}
ENTRIES = {"K2": "flash_fwd_f32", "K4": "bwd_dkv_f32",
           "K2 bf16": "flash_fwd_wgmma", "K4 bf16": "bwd_dkv_wgmma_rows"}


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
                m = re.search(rf"{entry}ILi(\d+)E", line)
                fn = m and f"{entry}<{m.group(1)}>"
            elif fn and ("spill" in line or "Used" in line):
                cs.log(f"  {name} {fn}: {line.strip()}")
        libs[name] = ctypes.CDLL(lib)
        for fn_name, argtypes in {**_build.SIGNATURES["flash_fwd"],
                                  **_build.SIGNATURES["flash_bwd"]}.items():
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
    _build.build_all(["flash_fwd", "flash_bwd"], force=True)
    built = {"K2": _build.library("flash_fwd"),
             "K4": _build.library("flash_bwd")}
    libs = build_variants(names)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    times = {}
    for d in sorted({d for n in names for d in VARIANTS[n][3]}):
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
                     "K4": lambda lib: call_k4(lib, q, k, v, do, lse, delta)}
            for kernel, call in calls.items():
                group = [n for n in names if VARIANTS[n][0] == kernel + suffix
                         and d in VARIANTS[n][3]]
                if not group:
                    continue
                want = call(built[kernel])
                for n in group:
                    got = call(libs[n])
                    err = max(cs.max_err(a, w) for a, w in zip(got, want))
                    same = all(torch.equal(a, w) for a, w in zip(got, want))
                    ok = (err <= cs.ATOL_HD_F32 if dt == torch.float32 else
                          all(cs.close_bf16(a, w) for a, w in zip(got, want)))
                    cs.log(f"  {n} at D {d}: max|variant - built| {err:.3e}, "
                           f"bit for bit {same}")
                    assert ok, f"{n} at D {d}: {err:.3e}"
                order = [("built", built[kernel])] + [(n, libs[n])
                                                      for n in group]
                t = {n: [] for n, _ in order}
                for n, lib in (order + order[::-1]) * rounds:
                    t[n].append(cs.time_ms(lambda lib=lib: call(lib),
                                           flush=flush))
                row = {n: sum(x) / len(x) for n, x in t.items()}
                times[f"{kernel}{suffix.replace(' ', '_')}_d{d}"] = row
                cs.log(f"{kernel} {str(dt)[6:]} at D {d} (B {b}, {hq}/{hkv} "
                       f"heads, S 2048, causal; {2 * rounds} windows): " +
                       ", ".join(f"{n} {row[n]:.4f} ({min(x):.4f}-"
                                 f"{max(x):.4f})" for n, x in t.items()) +
                       " ms")
            del q, do, kv, k, v, o, lse, delta
            torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
