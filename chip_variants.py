"""Time variants of the float32 K2 and K4 kernels beside the built ones.

Each variant is this tree's kernel source with one design constant
changed (stages, blocks an SM, loop unrolling). It is built by nvcc into
``ray_tpu_torch/_build/variants/`` (its -Xptxas -v registers and spills
printed), held to the built kernel on the same inputs, and timed in turns
with it (built, variants, variants reversed, built; CUDA events, L2
flushed) at the shapes chip_smoke.py times the float32 kernels: B 2 (B 4
at D 64), S 2048, causal, the head counts of the widths that have each
head dim. The last line is one JSON object of the times. Needs a card:

    python3 chip_variants.py
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
}
ENTRIES = {"K2": "flash_fwd_f32", "K4": "bwd_dkv_f32"}


def build_variants():
    """Every variant's library, built in parallel; their ptxas reports of
    the float32 K2 and K4 entries are printed."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, (kernel, src, subs, _) in VARIANTS.items():
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
        0, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), None, None, b, sq, k.shape[1], hq, k.shape[2], d,
        fa._strides(q, k, v, o), 1, d ** -0.5,
        torch.cuda.current_stream().cuda_stream)
    assert code == 0, f"flash_fwd: cudaError {code}"
    return o, lse


def call_k4(lib, q, k, v, do, lse, delta):
    b, sq, hq, d = q.shape
    dk = torch.empty((b, k.shape[1], k.shape[2], d), device=q.device)
    dv = torch.empty_like(dk)
    code = lib.flash_bwd_dkv(
        0, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), None, None, dk.data_ptr(),
        dv.data_ptr(), b, sq, k.shape[1], hq, k.shape[2], d,
        fa._strides(q, k, v, do), 1, d ** -0.5,
        torch.cuda.current_stream().cuda_stream)
    assert code == 0, f"flash_bwd_dkv: cudaError {code}"
    return dk, dv


def main() -> int:
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
    libs = build_variants()
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    times = {}
    for d in sorted({d for *_, dims in VARIANTS.values() for d in dims}):
        b, hq, hkv = SHAPES[d]
        gen = torch.Generator(device="cuda").manual_seed(d)
        q, do = (torch.randn((b, 2048, hq, d), generator=gen, device="cuda")
                 for _ in range(2))
        kv = torch.randn((b, 2048, 2 * hkv, d), generator=gen, device="cuda")
        k, v = kv[:, :, :hkv], kv[:, :, hkv:]
        o, lse = call_k2(built["K2"], q, k, v)
        delta = fa.attention_delta(o, do)
        calls = {"K2": lambda lib: call_k2(lib, q, k, v),
                 "K4": lambda lib: call_k4(lib, q, k, v, do, lse, delta)}
        for kernel, call in calls.items():
            names = [n for n, (kn, _, _, dims) in VARIANTS.items()
                     if kn == kernel and d in dims]
            if not names:
                continue
            want = call(built[kernel])
            for n in names:
                err = max(cs.max_err(a, w) for a, w in
                          zip(call(libs[n]), want))
                assert err <= cs.ATOL_HD_F32, f"{n} at D {d}: {err:.3e}"
            order = [("built", built[kernel])] + [(n, libs[n])
                                                  for n in names]
            t = {n: [] for n, _ in order}
            for n, lib in order + order[::-1]:
                t[n].append(cs.time_ms(lambda lib=lib: call(lib),
                                       flush=flush))
            row = {n: sum(x) / 2 for n, x in t.items()}
            times[f"{kernel}_d{d}"] = row
            cs.log(f"{kernel} float32 at D {d} (B {b}, {hq}/{hkv} heads, "
                   f"S 2048, causal): " + ", ".join(
                       f"{n} {ms:.4f}" for n, ms in row.items()) + " ms")
        del q, do, kv, k, v, o, lse, delta
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
