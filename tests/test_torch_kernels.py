"""ray_tpu_torch's CUDA kernels against their plain PyTorch versions.

This file imports neither JAX nor ray_tpu, so it also runs on a machine
with a card and no JAX (there without the repo's conftest):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Tests marked ``gpu`` decide in their body whether a card is present and
skip without one; the one test of ``chip_smoke.py``'s watchdog needs no
card. Tolerances: float32 1e-5 (summation order only; 1e-4
for the backward, whose sums run over up to 200 terms of magnitude up to
10); bfloat16 2e-2 + 1e-2*|plain| (float32 accumulators; the outputs, and
in the backward p and ds before their products, are rounded to bf16 as
the TPU kernels round them); lse 1e-3 absolute (float32 on both sides).
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import flash_attention as t_flash
from ray_tpu_torch.ops import paged_attention as t_paged

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = dict(rtol=1e-5, atol=1e-5)
F32_BWD = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=1e-2, atol=2e-2)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)


def _decode_inputs(rng, *, b, hq, hkv, d, page, num_pages, mp, lengths):
    """A pool holding `lengths` tokens per row, NaN everywhere else, and
    one query per row."""
    pool = torch.full((num_pages, hkv, page, 2 * d), float("nan"))
    bt = torch.from_numpy((rng.permutation(num_pages - 1)[: b * mp] + 1)
                          .reshape(b, mp).astype(np.int32))
    lens = torch.tensor(lengths, dtype=torch.int32)
    k = torch.from_numpy(rng.standard_normal((b, mp * page, hkv, d))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, mp * page, hkv, d))
                         .astype(np.float32))
    pos = torch.arange(mp * page).expand(b, -1)
    t_paged.paged_write(pool, k, v, bt, pos, lens)
    q = torch.from_numpy(rng.standard_normal((b, hq, d)).astype(np.float32))
    return q, pool, bt, lens


def _qkv(rng, sq, sk, hq, hkv, d, b=2):
    return tuple(torch.from_numpy(rng.standard_normal(shape)
                                  .astype(np.float32))
                 for shape in ((b, sq, hq, d), (b, sk, hkv, d),
                               (b, sk, hkv, d)))


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors the wrappers run the plain versions and launch
    nothing; the kernel build never starts."""
    rng = np.random.default_rng(0)
    q, pool, bt, lens = _decode_inputs(rng, b=2, hq=4, hkv=2, d=16, page=4,
                                       num_pages=16, mp=4,
                                       lengths=[3, 16])
    n_dec = t_paged.paged_attention_decode.launches
    n_fl = t_flash.flash_attention.launches
    out = t_paged.paged_attention_decode(q, pool, bt, lens)
    want = t_paged.paged_attention_decode_plain(q, pool, bt, lens,
                                                scale=16 ** -0.5)
    assert torch.equal(out, want) and torch.isfinite(out).all()
    qf, kf, vf = _qkv(rng, 9, 9, 4, 2, 16)
    o = t_flash.flash_attention(qf, kf, vf, causal=True)
    o_p, _ = t_flash.flash_attention_plain(qf, kf, vf, causal=True,
                                           q_seg=None, kv_seg=None,
                                           scale=16 ** -0.5)
    assert torch.equal(o, o_p)
    assert t_paged.paged_attention_decode.launches == n_dec
    assert t_flash.flash_attention.launches == n_fl


def test_cpu_backward_takes_the_plain_version():
    """On CPU tensors the autograd backward of flash_attention is the
    plain backward; K3 and K4 are never launched."""
    rng = np.random.default_rng(1)
    q, k, v = (x.requires_grad_() for x in _qkv(rng, 9, 12, 4, 2, 16))
    do = torch.from_numpy(rng.standard_normal((2, 9, 4, 16))
                          .astype(np.float32))
    counts = (t_flash.flash_attention.dq_launches,
              t_flash.flash_attention.dkv_launches)
    t_flash.flash_attention(q, k, v, causal=True).backward(do)
    with torch.no_grad():
        o, lse = t_flash.flash_attention_plain(q, k, v, causal=True,
                                               q_seg=None, kv_seg=None,
                                               scale=16 ** -0.5)
        want = t_flash.flash_attention_bwd_plain(
            q, k, v, o, lse, do, causal=True, q_seg=None, kv_seg=None,
            scale=16 ** -0.5)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        assert torch.equal(got, w)
    assert (t_flash.flash_attention.dq_launches,
            t_flash.flash_attention.dkv_launches) == counts


def test_build_check_raises_on_nonzero_codes():
    with pytest.raises(RuntimeError, match="cudaError 9"):
        _build.check("paged_decode", 9)
    _build.check("paged_decode", 0)
    assert set(_build.SOURCES) == set(_build.SIGNATURES)
    # every library's entry points are named after it
    assert all(fns and all(fn.startswith(name) for fn in fns)
               for name, fns in _build.SIGNATURES.items())


def test_chip_smoke_watchdog_ends_a_hung_phase():
    """A phase still running at its deadline (here one that sleeps past 1 s,
    as a kernel spinning on a barrier would) ends chip_smoke.py's process
    with the threads' tracebacks and a non-zero exit; no card needed."""
    code = ("import time, chip_smoke; "
            "chip_smoke.run_phase('hang', 1, time.sleep, 30)")
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0
    assert time.monotonic() - t0 < 20
    assert "Timeout" in proc.stderr and "run_phase" in proc.stderr
    assert "phase hang (deadline 1 s)" in proc.stdout


@pytest.mark.parametrize("spilled,spills,ok", [
    (None, None, True),
    (("flash_fwd_wgmma_pair", 256), (440, 808), False),
    (("flash_fwd_f32", 128), (16, 16), False),
    (("bwd_dkv_f32", 96), (8, 8), False),
    (("flash_fwd_f32", 64), (24, 64), True),   # F32_SPILLS, within bounds
    (("bwd_dkv_f32", 64), (128, 256), False),   # F32_SPILLS, past them
    (("bwd_dkv_f32", 32), None, False),         # no report of it
    (("flash_fwd_wgmma_pair", 256), None, False),
    (("bwd_dkv_wgmma_rows", 96), (16, 16), False),
    (("bwd_dkv_wgmma_rows", 96), None, False),
    (("flash_fwd_wgmma", 96), (8, 8), False),
    (("bwd_dq_wgmma_pair", 256), (8, 8), False),
    (("bwd_dq_wgmma_pair", 256), None, False),
    (("paged_decode_mha", 96), (8, 8), False),
    (("paged_decode_mha", 96), None, False),
])
def test_chip_smoke_spill_check_reads_ptxas_reports(spilled, spills, ok):
    """chip_smoke.py's build phase holds the entries of a head dim's own
    design (K2, K3 and K4 at D 256, K4 and K1 at D 96), K2 at D 96 (Q's
    fragments in registers) and
    the float32 K2 and K4 at every head dim to no spill, but
    for F32_SPILLS' instances (a few bytes), from the -Xptxas -v report; a
    report that lacks one of them fails too. No card needed."""
    import chip_smoke

    def entry(name, d, stores, loads):
        return (f"ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_1"
                f"{len(name)}{name}ILi{d}EEEv14CUtensorMap_st' for "
                f"'sm_90a'\nptxas info    : Function properties for x\n"
                f"    0 bytes stack frame, {stores} bytes spill stores, "
                f"{loads} bytes spill loads\nptxas info    : Used 231 "
                f"registers, used 3 barriers\n")

    dims = t_flash.KERNEL_HEAD_DIMS
    held = [(n, 256) for n in ("bwd_dkv_wgmma_pair", "flash_fwd_wgmma_pair",
                               "bwd_dq_wgmma_pair")]
    held += [("bwd_dkv_wgmma_rows", 96), ("flash_fwd_wgmma", 96),
             ("paged_decode_mha", 96)]
    held += [(n, d) for n in ("flash_fwd_f32", "bwd_dkv_f32") for d in dims]
    reports = {"flash_bwd": entry("bwd_dkv_wgmma", 256, 8, 16)}  # may spill
    for name, d in held:
        if (name, d) == spilled:
            if spills is not None:
                reports["flash_bwd"] += entry(name, d, *spills)
        else:
            reports["flash_bwd"] += entry(name, d, 0, 0)
    if ok:
        chip_smoke.check_no_spill(reports)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.check_no_spill(reports)


def _variant_names():
    import chip_variants

    return sorted(chip_variants.VARIANTS)


@pytest.mark.parametrize("name", _variant_names())
def test_chip_variants_apply_to_the_sources(name):
    """Each variant of chip_variants.py (the float32 K2/K4 ones, the bf16
    K4's stages, grid order, K/V in shared memory and D 64/128 probe, and
    the bf16 K2 with Q in shared memory) changes text that the kernel
    sources hold, once, and times head dims the kernels take (no card
    needed)."""
    import chip_variants

    kernel, src, subs, dims = chip_variants.VARIANTS[name]
    with open(os.path.join(chip_variants.CSRC, src)) as f:
        text = f.read()
    assert kernel in chip_variants.ENTRIES and dims
    assert set(dims) <= set(chip_variants.SHAPES)
    for old, new in subs:
        assert text.count(old) == 1 and old != new, (name, old)


@pytest.mark.parametrize("shape,want", [
    ((1, 1, 528, 32, 8), (32, 17)),    # the dense cache's decode: 136 blocks
    ((2, 1, 4096, 32, 8), (256, 16)),  # past the SMs: 8 chunks a split
    ((2, 1, 1, 8, 2), (32, 1)),        # one chunk: one split, no merge
    ((1, 1, 33, 8, 8), (32, 2)),
    ((1, 1, 10000, 32, 1), (96, 105)),  # rep 32: two row groups a kv head
    ((1, 2, 528, 32, 8), None),        # past max_sq: the 64-row kernels
    ((1, 1, 0, 32, 8), None),          # no kv row
])
def test_decode_plan_sizes_the_splits(shape, want):
    """K2's split-KV plan (no card needed): whole 32-row chunks a split,
    the splits covering the kv axis with no empty one, and about two
    blocks an SM (132 SMs) unless each split is one chunk already."""
    b, sq, sk, hq, hkv = shape
    plan = t_flash.decode_plan(b, sq, sk, hq, hkv, sms=132, max_sq=1)
    assert plan == want
    if plan is None:
        return
    split_rows, n_split = plan
    chunk = t_flash.DECODE_CHUNK
    assert split_rows % chunk == 0
    assert (n_split - 1) * split_rows < sk <= n_split * split_rows
    groups = -(-(hq // hkv) * sq // t_flash.DECODE_ROWS)  # row groups
    blocks = n_split * b * hkv * groups
    assert blocks <= 2 * 132 + b * hkv * groups or split_rows == chunk


def _split_rows(page):
    """Rows of one K1 split: the smallest block table with two splits
    is one page wider than a split."""
    lib = _build.library("paged_decode")
    pages = next(m for m in range(1, 4096)
                 if lib.paged_decode_splits(page, m + 1) == 2)
    return pages * page


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv", [(8, 8), (16, 4), (16, 2),
                                    (32, 2), (24, 2)])  # rep 1, 4, 8, 16, 12
@pytest.mark.parametrize("page", [8, 16, 32])
@pytest.mark.parametrize("d", [16, 32, 64, 96, 128, 256])
def test_decode_kernel_matches_plain_on_card(dtype, hq, hkv, page, d):
    """K1 over a NaN-filled pool (the last live page of every row holds
    stale NaN rows) at lengths 0, a page edge +-1, a split edge +-1 and
    the block table's full width."""
    _need_card()
    rng = np.random.default_rng(8)
    dt = getattr(torch, dtype)
    mp = 512 // page
    split = _split_rows(page)
    lengths = [0, page - 1, page, page + 1, split - 1, split, split + 1,
               300, mp * page]
    q, pool, bt, lens = _decode_inputs(
        rng, b=len(lengths), hq=hq, hkv=hkv, d=d, page=page,
        num_pages=1 + len(lengths) * mp, mp=mp, lengths=lengths)
    args = (q.to("cuda", dt), pool.to("cuda", dt), bt.cuda(), lens.cuda())
    before = t_paged.paged_attention_decode.launches
    got = t_paged.paged_attention_decode(*args)
    want = t_paged.paged_attention_decode_plain(*args, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert t_paged.paged_attention_decode.launches == before + 1
    assert torch.isfinite(got).all() and (got[0] == 0).all()
    _close(got, want, **(F32 if dtype == "float32" else BF16))


def test_decode_counts_are_one_zeroed_buffer_per_device_and_stream():
    """The count buffer of K2's split-KV kernel (the last split of a group
    merges it): one int32 buffer per (device, stream), all zeros when
    made, kept while it is large enough and replaced by a larger zeroed
    one otherwise (no card needed)."""
    saved = dict(t_flash._decode_counts)
    t_flash._decode_counts.clear()
    try:
        cpu = torch.device("cpu")
        a = t_flash._counts(cpu, 11, 8)
        assert a.dtype == torch.int32 and a.numel() >= 8
        assert not a.any()
        assert t_flash._counts(cpu, 11, 8) is a
        assert t_flash._counts(cpu, 12, 8) is not a  # another stream
        big = t_flash._counts(cpu, 11, a.numel() + 1)
        assert big is not a and big.numel() > a.numel() and not big.any()
        assert t_flash._counts(cpu, 11, 8) is big
    finally:
        t_flash._decode_counts.clear()
        t_flash._decode_counts.update(saved)


def _decode_inputs_on_card(seed, *, hq, hkv, d, page, lengths):
    """_decode_inputs' pool and queries drawn on the card (bf16): every
    row's block table as wide as its longest length."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b = len(lengths)
    mp = -(-max(lengths) // page)
    num_pages = 1 + b * mp
    pool = torch.full((num_pages, hkv, page, 2 * d), float("nan"),
                      dtype=torch.bfloat16, device="cuda")
    perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
    bt = perm[: b * mp].reshape(b, mp).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    k, v = (torch.randn((b, mp * page, hkv, d), generator=gen,
                        device="cuda").to(torch.bfloat16) for _ in range(2))
    pos = torch.arange(mp * page, device="cuda").expand(b, -1)
    t_paged.paged_write(pool, k, v, bt, pos, lens)
    q = torch.randn((b, hq, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    return q, pool, bt, lens


MHA_LENGTHS = [0, 1, 15, 16, 17, 63, 64, 65, 255, 256, 257, 2047]


@pytest.mark.gpu
@pytest.mark.parametrize("page", [8, 16, 32])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
def test_decode_kernel_at_d96_matches_plain_on_card(page, rep):
    """K1 in bf16 at D 96 (paged_decode_mha: four warps sharing each
    split) over a pool holding NaN outside the live rows, at lengths 0, 1,
    a page's and a split's edges +-1 and 2047, against its plain
    version."""
    _need_card()
    hkv = 4
    q, pool, bt, lens = _decode_inputs_on_card(
        96 + page + rep, hq=hkv * rep, hkv=hkv, d=96, page=page,
        lengths=MHA_LENGTHS)
    before = t_paged.paged_attention_decode.launches
    got = t_paged.paged_attention_decode(q, pool, bt, lens)
    want = t_paged.paged_attention_decode_plain(q, pool, bt, lens,
                                                scale=96 ** -0.5)
    torch.cuda.synchronize()
    assert t_paged.paged_attention_decode.launches == before + 1
    assert torch.isfinite(got).all() and (got[0] == 0).all()
    _close(got, want, **BF16)


@pytest.mark.gpu
@pytest.mark.parametrize("streams", [1, 2])
def test_decode_kernel_at_d96_repeats_its_bits_on_card(streams):
    """Launches of K1 at D 96 back to back on one stream, or side by side
    on two, each give their plain version's output, the same bits each
    time."""
    _need_card()
    runs = [_decode_inputs_on_card(7 + i, hq=32, hkv=32, d=96, page=16,
                                   lengths=MHA_LENGTHS) for i in range(2)]
    wants = [t_paged.paged_attention_decode_plain(*r, scale=96 ** -0.5)
             for r in runs]
    ss = [torch.cuda.current_stream()] + [torch.cuda.Stream()
                                          for _ in range(streams - 1)]
    torch.cuda.synchronize()
    gots = []
    for i in range(4):
        with torch.cuda.stream(ss[i % streams]):
            gots.append(t_paged.paged_attention_decode(*runs[i % 2]))
    torch.cuda.synchronize()
    for i, got in enumerate(gots):
        _close(got, wants[i % 2], **BF16)
        assert torch.equal(got, gots[i % 2])


def _fwd_inputs(rng, case, d, dt):
    """q, k, v on the card, segment ids and causality of a forward case."""
    if case.startswith("causal"):  # ragged: Sq 1, 37, 100, 130; Sk = Sq + 30
        sq = int(case.split("_")[1])
        q, k, v = _qkv(rng, sq, sq + 30, 8, 2, d)
        segs, causal = None, True
    elif case == "strided_v":  # k and v are views of one fused tensor
        q = torch.from_numpy(rng.standard_normal((2, 100, 8, d))
                             .astype(np.float32))
        kv = torch.from_numpy(rng.standard_normal((2, 130, 4, d))
                              .astype(np.float32)).to("cuda", dt)
        return q.to("cuda", dt), kv[:, :, :2], kv[:, :, 2:], None, True
    else:  # Sq < Sk; row 0 sees no kv row at all: o = 0, lse = -1e30
        q, k, v = _qkv(rng, 70, 256, 8, 2, d)
        kv_seg = (torch.arange(256)[None] < torch.tensor([[0], [48]])).to(
            torch.int32)
        segs = (torch.ones(2, 70, dtype=torch.int32).cuda(), kv_seg.cuda())
        causal = False
    q, k, v = (x.to("cuda", dt) for x in (q, k, v))
    return q, k, v, segs, causal


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 32, 64, 96, 128, 256])
@pytest.mark.parametrize("case", ["causal_1", "causal_37", "causal_100",
                                  "causal_130", "ctx_segments",
                                  "strided_v"])
def test_flash_kernel_matches_plain_on_card(dtype, d, case):
    _need_card()
    rng = np.random.default_rng(9)
    q, k, v, segs, causal = _fwd_inputs(rng, case, d, getattr(torch, dtype))
    before = t_flash.flash_attention.launches
    o, lse = t_flash.flash_attention(q, k, v, causal=causal,
                                     segment_ids=segs, return_lse=True)
    o_p, lse_p = t_flash.flash_attention_plain(
        q, k, v, causal=causal, q_seg=None if segs is None else segs[0],
        kv_seg=None if segs is None else segs[1], scale=d ** -0.5)
    torch.cuda.synchronize()
    assert t_flash.flash_attention.launches == before + 1
    _close(o, o_p, **(F32 if dtype == "float32" else BF16))
    _close(lse, lse_p, rtol=0, atol=1e-3)
    if segs is not None:
        assert (o[0] == 0).all() and (lse[0] == -1e30).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 64, 96, 128, 256])
def test_flash_kernel_at_sq1_over_a_growing_cache_matches_plain_on_card(
        dtype, d):
    """The dense KV-cache decode (``LlamaModel(..., kv_caches=)``): K2 at
    Sq = 1 against a cache that grows by concatenation (a new contiguous
    tensor each step, as ``KVCache`` makes it), GQA 32/8, at kv lengths
    around the 64-row tiles and well past them; causal relative to the end
    of the kv axis."""
    _need_card()
    rng = np.random.default_rng(11)
    dt = getattr(torch, dtype)
    k = torch.empty((2, 0, 8, d), dtype=dt, device="cuda")
    v = torch.empty_like(k)
    for sk in (1, 2, 63, 64, 65, 129, 513, 1000):
        _, k_new, v_new = _qkv(rng, 1, sk - k.shape[1], 32, 8, d)
        k = torch.cat([k, k_new.to("cuda", dt)], dim=1)
        v = torch.cat([v, v_new.to("cuda", dt)], dim=1)
        q = torch.from_numpy(rng.standard_normal((2, 1, 32, d)).astype(
            np.float32)).to("cuda", dt)
        before = t_flash.flash_attention.launches
        o, lse = t_flash.flash_attention(q, k, v, causal=True,
                                         return_lse=True)
        o_p, lse_p = t_flash.flash_attention_plain(
            q, k, v, causal=True, q_seg=None, kv_seg=None, scale=d ** -0.5)
        torch.cuda.synchronize()
        assert t_flash.flash_attention.launches == before + 1
        _close(o, o_p, **(F32 if dtype == "float32" else BF16),
               err_msg=f"sk {sk}")
        _close(lse, lse_p, rtol=0, atol=1e-3, err_msg=f"sk {sk}")


def _fused_kv(rng, b, sk, hkv, d, dt, aligned=True):
    """k and v on the card as strided views of one fused [B, Sk, 2 Hkv,
    D] tensor, as in training; not ``aligned``: views one float past a
    16-byte boundary (float32 only: K2's and K3's 4-byte copies)."""
    pad = 0 if aligned else 1
    kv = torch.from_numpy(rng.standard_normal((b, sk, 2 * hkv, d + pad))
                          .astype(np.float32)).to("cuda", dt)[..., pad:]
    return kv[:, :, :hkv], kv[:, :, hkv:]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 32, 64, 96, 128, 256])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
def test_flash_decode_kernel_matches_plain_on_card(dtype, d, rep):
    """K2's split-KV design at Sq = 1 (B 2, 2 kv heads, GQA rep 1 to 8)
    at kv lengths around its 32-row chunks and its splits and far past
    them, k and v strided views of one fused tensor; launched once a
    call, counted by decode_launches."""
    _need_card()
    rng = np.random.default_rng(15)
    dt = getattr(torch, dtype)
    hkv = 2
    for sk in (1, 2, 31, 32, 33, 63, 64, 65, 1000, 4096):
        q = torch.from_numpy(rng.standard_normal((2, 1, hkv * rep, d))
                             .astype(np.float32)).to("cuda", dt)
        k, v = _fused_kv(rng, 2, sk, hkv, d, dt)
        before = (t_flash.flash_attention.launches,
                  t_flash.flash_attention.decode_launches)
        o, lse = t_flash.flash_attention(q, k, v, causal=True,
                                         return_lse=True)
        o_p, lse_p = t_flash.flash_attention_plain(
            q, k, v, causal=True, q_seg=None, kv_seg=None, scale=d ** -0.5)
        torch.cuda.synchronize()
        assert (t_flash.flash_attention.launches,
                t_flash.flash_attention.decode_launches) == (
                    before[0] + 1, before[1] + 1), f"sk {sk}"
        _close(o, o_p, **(F32 if dtype == "float32" else BF16),
               err_msg=f"sk {sk}")
        _close(lse, lse_p, rtol=0, atol=1e-3, err_msg=f"sk {sk}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 32, 64, 96, 128, 256])
def test_flash_decode_kernel_with_segments_matches_plain_on_card(dtype, d):
    """K2's split-KV design with segment ids, causal and not, at Sq 1 and
    at the largest Sq it takes (DECODE_MAX_SQ), over 300 kv rows (several
    splits; float32 also with k and v off 16-byte alignment): batch row
    1's first q row matches no kv row, so o = 0 and lse = -1e30 there."""
    _need_card()
    rng = np.random.default_rng(16)
    dt = getattr(torch, dtype)
    sk, hq, hkv = 300, 8, 2
    kv_seg = np.ones((2, sk), np.int32)
    kv_seg[0, :100] = 0
    for sq in sorted({1, t_flash.DECODE_MAX_SQ[dt]}):
        q_seg = np.ones((2, sq), np.int32)
        q_seg[1, 0] = 7
        segs = (torch.from_numpy(q_seg).cuda(),
                torch.from_numpy(kv_seg).cuda())
        for causal in (True, False):
            for aligned in ((True, False) if dtype == "float32" else (True,)):
                q = torch.from_numpy(rng.standard_normal((2, sq, hq, d))
                                     .astype(np.float32)).to("cuda", dt)
                k, v = _fused_kv(rng, 2, sk, hkv, d, dt, aligned)
                before = t_flash.flash_attention.decode_launches
                o, lse = t_flash.flash_attention(
                    q, k, v, causal=causal, segment_ids=segs,
                    return_lse=True)
                o_p, lse_p = t_flash.flash_attention_plain(
                    q, k, v, causal=causal, q_seg=segs[0], kv_seg=segs[1],
                    scale=d ** -0.5)
                torch.cuda.synchronize()
                what = f"sq {sq} causal {causal} aligned {aligned}"
                assert t_flash.flash_attention.decode_launches == \
                    before + 1, what
                _close(o, o_p, **(F32 if dtype == "float32" else BF16),
                       err_msg=what)
                _close(lse, lse_p, rtol=0, atol=1e-3, err_msg=what)
                assert (o[1, 0] == 0).all() and (lse[1, 0] == -1e30).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 32, 64, 96, 128, 256])
def test_flash_decode_threshold_on_card(dtype, d):
    """The last Sq that takes K2's split-KV design (DECODE_MAX_SQ) and
    the first that takes the 64-row kernels, causal over 700 kv rows with
    GQA 8/2: each against the plain version, the split counted only
    below the threshold."""
    _need_card()
    rng = np.random.default_rng(17)
    dt = getattr(torch, dtype)
    last = t_flash.DECODE_MAX_SQ[dt]
    for sq, split in ((last, 1), (last + 1, 0)):
        q = torch.from_numpy(rng.standard_normal((2, sq, 8, d))
                             .astype(np.float32)).to("cuda", dt)
        k, v = _fused_kv(rng, 2, 700, 2, d, dt)
        before = (t_flash.flash_attention.launches,
                  t_flash.flash_attention.decode_launches)
        o, lse = t_flash.flash_attention(q, k, v, causal=True,
                                         return_lse=True)
        o_p, lse_p = t_flash.flash_attention_plain(
            q, k, v, causal=True, q_seg=None, kv_seg=None, scale=d ** -0.5)
        torch.cuda.synchronize()
        assert (t_flash.flash_attention.launches,
                t_flash.flash_attention.decode_launches) == (
                    before[0] + 1, before[1] + split), f"sq {sq}"
        _close(o, o_p, **(F32 if dtype == "float32" else BF16),
               err_msg=f"sq {sq}")
        _close(lse, lse_p, rtol=0, atol=1e-3, err_msg=f"sq {sq}")


def _f32_edge_inputs(rng, d, case):
    """float32 q, k, v, do on the card and the keyword arguments of a
    tile-edge case: 97 queries over 161 keys (off the 64-row tiles and D
    256's 32-row ones), k and v strided views of one fused tensor, GQA 8/2
    unless the case says otherwise. "causal"; "segments": causal, packed
    segments crossing the tiles' edges, q row 5 of row 1 matching no kv
    row; "unaligned": causal, every operand one float off 16-byte
    alignment (the 4-byte copies); "rep1": causal at 2/2 heads; "rep8":
    not causal, at 16/2 heads."""
    sq, sk = 97, 161
    hq, hkv = {"rep1": (2, 2), "rep8": (16, 2)}.get(case, (8, 2))
    segs = (None, None)
    if case == "segments":
        kv_seg = np.stack([np.repeat([0, 1, 2, 3], [20, 50, 60, 31]),
                           np.repeat([0, 1, 2], [50, 50, 61])]).astype(
                               np.int32)
        q_seg = kv_seg[:, -sq:].copy()
        q_seg[1, 5] = 9
        segs = (torch.from_numpy(q_seg).cuda(),
                torch.from_numpy(kv_seg).cuda())
    pad = 1 if case == "unaligned" else 0
    q, do = (torch.from_numpy(rng.standard_normal((2, sq, hq, d + pad))
                              .astype(np.float32)).cuda()[..., pad:]
             for _ in range(2))
    k, v = _fused_kv(rng, 2, sk, hkv, d, torch.float32, not pad)
    kw = dict(causal=case != "rep8", q_seg=segs[0], kv_seg=segs[1],
              scale=d ** -0.5)
    return q, k, v, do, kw


def _segment_ids(kw):
    return None if kw["q_seg"] is None else (kw["q_seg"], kw["kv_seg"])


F32_EDGE_CASES = ["causal", "segments", "unaligned", "rep1", "rep8"]


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32, 64, 96, 128, 256])
@pytest.mark.parametrize("case", F32_EDGE_CASES)
def test_flash_fwd_f32_at_tile_edges_matches_plain_on_card(d, case):
    """K2's float32 64-row design (forced below the split-KV threshold by
    max_sq=0) at a q length and a kv length off its tiles
    (_f32_edge_inputs' cases); a q row that matches no kv row gives o = 0
    and lse = -1e30."""
    _need_card()
    rng = np.random.default_rng(19)
    q, k, v, _, kw = _f32_edge_inputs(rng, d, case)
    before = (t_flash.flash_attention.launches,
              t_flash.flash_attention.decode_launches)
    o, lse = t_flash._launch(q, k, v, max_sq=0, **kw)
    o_p, lse_p = t_flash.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (t_flash.flash_attention.launches,
            t_flash.flash_attention.decode_launches) == (before[0] + 1,
                                                         before[1])
    _close(o, o_p, **F32)
    _close(lse, lse_p, rtol=0, atol=1e-3)
    if case == "segments":
        assert (o[1, 5] == 0).all() and (lse[1, 5] == -1e30).all()


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32, 64, 96, 128, 256])
@pytest.mark.parametrize("case", ["causal", "segments", "unaligned"])
def test_flash_bwd_dq_f32_at_tile_edges_matches_plain_on_card(d, case):
    """K3's float32 design at a q length off its q tile (64 rows, 32 at
    D 256) and a kv length off its 64-row kv tile (_f32_edge_inputs:
    causal; packed segments with a q row that matches no kv row, dq = 0
    there; every operand one float off 16-byte alignment)."""
    _need_card()
    rng = np.random.default_rng(18)
    q, k, v, do, kw = _f32_edge_inputs(rng, d, case)
    o, lse = t_flash.flash_attention(q, k, v, causal=True,
                                     segment_ids=_segment_ids(kw),
                                     return_lse=True)
    delta = t_flash.attention_delta(o, do)
    before = t_flash.flash_attention.dq_launches
    dq = t_flash.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    want = t_flash.flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert t_flash.flash_attention.dq_launches == before + 1
    assert torch.isfinite(dq).all()
    _close(dq, want, **F32_BWD)
    if case == "segments":
        assert (lse[1, 5] == -1e30).all() and (dq[1, 5] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32, 64, 96, 128, 256])
@pytest.mark.parametrize("case", F32_EDGE_CASES)
def test_flash_bwd_dkv_f32_at_tile_edges_matches_plain_on_card(d, case):
    """K4's float32 design at a kv length off its kv tile (64 rows, 32 at
    D 256) and a q length off its 64-row q items (_f32_edge_inputs' cases;
    lse from K2), dk and dv summed over the GQA group."""
    _need_card()
    rng = np.random.default_rng(20)
    q, k, v, do, kw = _f32_edge_inputs(rng, d, case)
    o, lse = t_flash.flash_attention(q, k, v, causal=kw["causal"],
                                     segment_ids=_segment_ids(kw),
                                     return_lse=True)
    delta = t_flash.attention_delta(o, do)
    before = t_flash.flash_attention.dkv_launches
    dk, dv = t_flash.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    want_dk, want_dv = t_flash.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                   **kw)
    torch.cuda.synchronize()
    assert t_flash.flash_attention.dkv_launches == before + 1
    for got, want in ((dk, want_dk), (dv, want_dv)):
        assert torch.isfinite(got).all()
        _close(got, want, **F32_BWD)


def _bwd_inputs(rng, case, d, dt):
    """q, k, v, do on the card and the segment ids of a backward case; k
    and v are strided views of one fused tensor, as in training."""
    segs, causal = None, True
    if case == "causal":
        sq = sk = 100
    elif case == "sq_lt_sk":
        sq, sk = 70, 200
    elif case == "sq1_sk200":
        sq, sk = 1, 200
    else:  # packed rows, q rows of segment 3 see no kv row at all
        sq = sk = 130
        kv_seg = torch.from_numpy(np.stack([
            np.repeat([0, 1, 2], [50, 50, 30]),
            np.repeat([0, 1], [64, 66])]).astype(np.int32))
        q_seg = kv_seg.clone()
        q_seg[0, 120:] = 3
        segs = (q_seg.cuda(), kv_seg.cuda())
    q = rng.standard_normal((2, sq, 8, d)).astype(np.float32)
    kv = rng.standard_normal((2, sk, 4, d)).astype(np.float32)
    do = rng.standard_normal((2, sq, 8, d)).astype(np.float32)
    q, kv, do = (torch.from_numpy(x).to("cuda", dt) for x in (q, kv, do))
    return q, kv[:, :, :2], kv[:, :, 2:], do, segs, causal


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 32, 64, 96, 128, 256])
@pytest.mark.parametrize("case", ["causal", "segments", "sq_lt_sk",
                                  "sq1_sk200"])
def test_flash_bwd_kernels_match_plain_on_card(dtype, d, case):
    """K3 and K4 against their plain versions on the same q, k, v, do,
    lse and delta (lse from K2)."""
    _need_card()
    rng = np.random.default_rng(11)
    q, k, v, do, segs, causal = _bwd_inputs(rng, case, d,
                                            getattr(torch, dtype))
    kw = dict(causal=causal, q_seg=None if segs is None else segs[0],
              kv_seg=None if segs is None else segs[1], scale=d ** -0.5)
    o, lse = t_flash.flash_attention(q, k, v, causal=causal,
                                     segment_ids=segs, return_lse=True)
    delta = t_flash.attention_delta(o, do)
    before = (t_flash.flash_attention.dq_launches,
              t_flash.flash_attention.dkv_launches)
    dq = t_flash.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = t_flash.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    want_dq = t_flash.flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    want_dk, want_dv = t_flash.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                   **kw)
    torch.cuda.synchronize()
    assert (t_flash.flash_attention.dq_launches,
            t_flash.flash_attention.dkv_launches) == (before[0] + 1,
                                                      before[1] + 1)
    tol = F32_BWD if dtype == "float32" else BF16
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert torch.isfinite(got).all()
        _close(got, want, **tol)
    if case == "segments":  # fully masked rows: lse = -1e30, dq = 0
        assert (lse[0, 120:] == -1e30).all() and (dq[0, 120:] == 0).all()


def _tile_edge_inputs(rng, s, rep, case, d):
    """bf16 q, k, v, do on the card at head dim d (2 kv heads, 2 * rep q
    heads, B 2; k and v strided views of one fused tensor, as in training)
    and the segment ids of a tile-edge case. "segments": packed rows where
    the last q row of row 0 sees no kv row and, in row 1, kv rows
    ``unseen`` (a whole 64-row kv tile where s > 64) are seen by no q
    row."""
    hkv = 2
    sq, sk = (s, s + 67) if case == "sq_lt_sk" else (s, s)
    segs, unseen = None, None
    if case == "segments":
        kv_seg = np.zeros((2, sk), np.int32)
        kv_seg[0, sk // 2:] = 1
        unseen = slice(64, min(128, sk)) if sk > 64 else slice(sk - 8, sk)
        kv_seg[1, unseen] = 9
        q_seg = kv_seg.copy()
        q_seg[0, -1] = 5
        q_seg[1, unseen] = 0
        segs = (torch.from_numpy(q_seg).cuda(), torch.from_numpy(kv_seg).cuda())
    q = rng.standard_normal((2, sq, hkv * rep, d)).astype(np.float32)
    kv = rng.standard_normal((2, sk, 2 * hkv, d)).astype(np.float32)
    do = rng.standard_normal((2, sq, hkv * rep, d)).astype(np.float32)
    q, kv, do = (torch.from_numpy(x).to("cuda", torch.bfloat16)
                 for x in (q, kv, do))
    return q, kv[:, :, :hkv], kv[:, :, hkv:], do, segs, unseen


@pytest.mark.gpu
@pytest.mark.parametrize("d", [96, 256])
@pytest.mark.parametrize("case", ["causal", "sq_lt_sk", "segments"])
@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("s", [63, 64, 65, 127, 128, 129, 255, 257])
def test_flash_kernels_at_d96_and_d256_tile_edges_match_plain_on_card(
        case, rep, s, d):
    """The bf16 two-warpgroup designs and K2 and K3 at lengths around the
    64-row and 128-row tiles, GQA rep 1, 2 and 4, v a strided view:
    causal, causal with Sq < Sk, and packed segments with a fully masked q
    row and kv rows no q row sees; each output against its plain version
    on the same inputs (lse from K2). At D 256: K2 over 128-row q tiles in
    two warpgroups, K4 with S^T and dP^T exchanged between two
    warpgroups. At D 96: K4 over 128-row kv tiles in two warpgroups whose
    causal starts differ by one q tile, fed through a ring that the later
    warpgroup refills at its turn."""
    _need_card()
    rng = np.random.default_rng(14)
    q, k, v, do, segs, unseen = _tile_edge_inputs(rng, s, rep, case, d)
    kw = dict(causal=True, q_seg=None if segs is None else segs[0],
              kv_seg=None if segs is None else segs[1], scale=d ** -0.5)
    before = (t_flash.flash_attention.launches,
              t_flash.flash_attention.dq_launches,
              t_flash.flash_attention.dkv_launches)
    o, lse = t_flash.flash_attention(q, k, v, causal=True, segment_ids=segs,
                                     return_lse=True)
    o_p, lse_p = t_flash.flash_attention_plain(q, k, v, **kw)
    delta = t_flash.attention_delta(o, do)
    dq = t_flash.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = t_flash.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    want_dq = t_flash.flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    want_dk, want_dv = t_flash.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                   **kw)
    torch.cuda.synchronize()
    assert (t_flash.flash_attention.launches,
            t_flash.flash_attention.dq_launches,
            t_flash.flash_attention.dkv_launches) == tuple(
                n + 1 for n in before)
    _close(o, o_p, **BF16)
    _close(lse, lse_p, rtol=0, atol=1e-3)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert torch.isfinite(got).all()
        _close(got, want, **BF16)
    if case == "segments":
        assert (o[0, -1] == 0).all() and (lse[0, -1] == -1e30).all()
        assert (dq[0, -1] == 0).all()
        assert (dk[1, unseen] == 0).all() and (dv[1, unseen] == 0).all()


@pytest.mark.gpu
def test_flash_attention_autograd_runs_k2_k3_k4_on_card():
    _need_card()
    rng = np.random.default_rng(12)
    q, k, v, do, _, _ = _bwd_inputs(rng, "causal", 64, torch.bfloat16)
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    before = (t_flash.flash_attention.launches,
              t_flash.flash_attention.dq_launches,
              t_flash.flash_attention.dkv_launches)
    t_flash.flash_attention(q, k, v, causal=True).backward(do)
    with torch.no_grad():
        o, lse = t_flash.flash_attention_plain(q, k, v, causal=True,
                                               q_seg=None, kv_seg=None,
                                               scale=0.125)
        want = t_flash.flash_attention_bwd_plain(
            q, k, v, o, lse, do, causal=True, q_seg=None, kv_seg=None,
            scale=0.125)
    torch.cuda.synchronize()
    assert (t_flash.flash_attention.launches,
            t_flash.flash_attention.dq_launches,
            t_flash.flash_attention.dkv_launches) == tuple(
                n + 1 for n in before)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        _close(got, w, **BF16)


@pytest.mark.gpu
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    _need_card()
    q = torch.zeros(2, 4, 24, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        t_flash.flash_attention(q[None], q[None], q[None], causal=False)
    q = torch.zeros(1, 8, 2, 48, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        t_flash.flash_attention(q, q, q, causal=False)
    # TMA: a base off 16-byte alignment, and zero-length Sk
    buf = torch.zeros(2 * 8 * 2 * 64 + 8, device="cuda",
                      dtype=torch.bfloat16)
    odd = buf[1:1 + 2 * 8 * 2 * 64].view(2, 8, 2, 64)
    with pytest.raises(ValueError, match="16-byte"):
        t_flash.flash_attention(odd, odd, odd, causal=False)
    empty = torch.zeros(2, 0, 2, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="zero-length"):
        t_flash.flash_attention(buf[:2048].view(2, 8, 2, 64), empty, empty,
                                causal=False)
    # K1 in bf16 takes head dims 16, 32, 64, 96, 128 and 256
    pool = torch.zeros(4, 2, 16, 16, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 8"):
        t_paged.paged_attention_decode(
            torch.zeros(1, 4, 8, device="cuda", dtype=torch.bfloat16), pool,
            torch.ones(1, 2, device="cuda", dtype=torch.int32),
            torch.ones(1, device="cuda", dtype=torch.int32))
    # the backward wrappers: type, head dim, alignment, lse/delta layout
    x = torch.zeros(1, 8, 2, 64, device="cuda", dtype=torch.bfloat16)
    vec = torch.zeros(1, 8, 2, device="cuda")
    kw = dict(causal=True, scale=0.125)
    for fn in (t_flash.flash_bwd_dq, t_flash.flash_bwd_dkv):
        with pytest.raises(TypeError):
            fn(x.half(), x.half(), x.half(), x.half(), vec, vec, **kw)
        y = torch.zeros(1, 8, 2, 48, device="cuda", dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head dim"):
            fn(y, y, y, y, vec, vec, **kw)
        wide = torch.zeros(1, 8, 2, 72, device="cuda", dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="16-byte"):
            fn(wide[..., 1:65], x, x, x, vec, vec, **kw)
        with pytest.raises(ValueError, match="lse"):
            fn(x, x, x, x, vec.double(), vec, **kw)


@pytest.mark.gpu
def test_decode_head_dims_match_the_library():
    """The engine's construction-time check (DECODE_HEAD_DIMS_BF16, and a
    16-byte float32 pool row) answers as the library's
    paged_decode_supports does, for every head dim up to 256."""
    _need_card()
    lib = _build.library("paged_decode")
    for d in range(1, 257):
        assert bool(lib.paged_decode_supports(1, d)) == \
            (d in t_paged.DECODE_HEAD_DIMS_BF16), d
        assert lib.paged_decode_supports(0, d)
