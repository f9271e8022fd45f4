"""Paged KV-cache attention ops: the serving engine's compute core.

Counterpart of the JAX package's ``ops/paged_attention.py``. KV lives in
fixed-size pages laid out ``[P, Hkv, page, 2*D]`` per layer, K in lanes
``[:D]`` and V in lanes ``[D:]`` (the same layout, so pools and tests
compare directly).

- ``paged_write`` scatters new tokens into their pages, in place. Rows of
  padding (``positions >= total_lens``) are sent to page 0, the
  allocator's reserved dummy page, instead of being dropped.
- ``paged_attention_decode`` is the single-token step, kernel K1
  (``csrc/paged_decode.cu``): on a CUDA tensor it launches the kernel or
  raises, on a CPU tensor it runs ``paged_attention_decode_plain``.
  ``paged_attention_decode.launches`` counts kernel launches (the split
  pass and its merge pass count as one). In bf16 the kernel takes head
  dims 16, 32, 64, 96, 128 and 256 (``DECODE_HEAD_DIMS_BF16``, K2-K4's
  set), in float32 any head dim whose pool row is a multiple of 16 bytes.
- ``paged_prefill_attention`` splits prefill into causal attention among
  the new tokens and segment-masked attention over the cached prefix
  pages, both through ``flash_attention`` (kernel K2), merged by
  log-sum-exp.
- ``paged_attention_reference`` is the gather-based oracle of the tests.
- ``check_kernel_head_dim`` refuses, when a CUDA model is built, a head
  dim that K1 or K2-K4 lack (the plain versions take any).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ._build import check, library
from .attention import NEG_INF
from .flash_attention import KERNEL_HEAD_DIMS, flash_attention

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# head dims of the bf16 K1 kernel, K2-K4's (csrc/common.cuh's
# HEAD_DIM_CASES): the library's paged_decode_supports answers the same,
# as a gpu test checks
DECODE_HEAD_DIMS_BF16 = KERNEL_HEAD_DIMS


def check_kernel_head_dim(head_dim: int, dtype: torch.dtype, device, *,
                          decode: bool, owner: str) -> None:
    """Raise ValueError, naming the kernel, when a model on a CUDA device
    has a head dim its kernels lack: K2/K3/K4 take KERNEL_HEAD_DIMS (16,
    32, 64, 96, 128 and 256); with ``decode`` (the paged serving path) K1
    too, which takes DECODE_HEAD_DIMS_BF16 (the same) in bf16 and, in
    float32, a pool row (2 * head_dim floats) of a multiple of 16 bytes.
    On any other device the plain versions run and every head dim is
    taken."""
    if torch.device(device).type != "cuda":
        return
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"{owner}: head dim {head_dim} is not taken by the flash "
            f"attention kernels K2/K3/K4 (flash_fwd, flash_bwd), which take "
            f"{KERNEL_HEAD_DIMS}")
    if not decode:
        return
    if dtype == torch.bfloat16:
        ok = head_dim in DECODE_HEAD_DIMS_BF16
    else:
        ok = (2 * head_dim * torch.finfo(dtype).bits // 8) % 16 == 0
    if not ok:
        raise ValueError(
            f"{owner}: head dim {head_dim} in {dtype} is not taken by the "
            f"paged decode kernel K1 (paged_decode), which takes "
            f"{DECODE_HEAD_DIMS_BF16} in bf16")


def make_kv_pages(num_kv_heads: int, num_pages: int, page_size: int,
                  head_dim: int, dtype, device=None) -> torch.Tensor:
    """A zeroed page pool [P, Hkv, page, 2*D] (K | V in lanes)."""
    return torch.zeros((num_pages, num_kv_heads, page_size, 2 * head_dim),
                       dtype=dtype, device=device)


# ------------------------------------------------------------------ write
def paged_write(kv_pages: torch.Tensor, k_new: torch.Tensor,
                v_new: torch.Tensor, block_tables: torch.Tensor,
                positions: torch.Tensor,
                total_lens: torch.Tensor) -> torch.Tensor:
    """Scatter new tokens' K/V into their sequences' pages, in place.

    kv_pages: [P, Hkv, page, 2*D]; k_new/v_new: [B, S, Hkv, D];
    block_tables: [B, MP]; positions: [B, S] absolute positions;
    total_lens: [B] length INCLUDING the new tokens. Padding rows
    (positions >= total_lens) may point past the block table; their column
    is clamped and their write goes to page 0, which no sequence reads.
    Returns kv_pages.
    """
    page_size = kv_pages.shape[2]
    mp = block_tables.shape[1]
    positions = positions.long()
    valid = positions < total_lens.long()[:, None]
    col = torch.clamp(positions // page_size, 0, mp - 1)
    page_ix = torch.gather(block_tables.long(), 1, col)
    page_ix = torch.where(valid, page_ix, torch.zeros_like(page_ix))
    offset = positions % page_size
    kv = torch.cat([k_new, v_new], dim=-1).to(kv_pages.dtype)
    # indices on axes 0 and 2 (split by a slice) put [B, S] in front: the
    # indexed view is [B, S, Hkv, 2*D], which is kv's layout
    kv_pages[page_ix, :, offset] = kv
    return kv_pages


# -------------------------------------------------------- gather reference
def gather_kv(kv_pages: torch.Tensor, block_tables: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[P, Hkv, page, 2D] + [B, MP] -> (k, v) each [B, MP*page, Hkv, D]."""
    _, hkv, page, d2 = kv_pages.shape
    b, mp = block_tables.shape
    out = kv_pages[block_tables.long()]           # [B, MP, Hkv, page, 2D]
    out = out.permute(0, 1, 3, 2, 4).reshape(b, mp * page, hkv, d2)
    d = d2 // 2
    return out[..., :d], out[..., d:]


def paged_attention_reference(q: torch.Tensor, kv_pages: torch.Tensor,
                              block_tables: torch.Tensor,
                              positions: torch.Tensor, *,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Attention over paged KV, gather-based, causal by absolute position.

    q: [B, S, Hq, D]; positions: [B, S]. Returns [B, S, Hq, D].
    """
    b, s, hq, d = q.shape
    _, hkv, page, _ = kv_pages.shape
    mp = block_tables.shape[1]
    k, v = gather_kv(kv_pages, block_tables)
    rep = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, s, hkv, rep, d)
    logits = torch.einsum("bshrd,bkhd->bhrsk", qg.float(), k.float()) * scale
    kv_pos = torch.arange(mp * page, device=q.device)
    mask = kv_pos[None, None, None, None, :] \
        <= positions.long()[:, None, None, :, None]
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhrsk,bkhd->bshrd", probs, v)
    return out.reshape(b, s, hq, d)


# ----------------------------------------------------------- decode (K1)
def paged_attention_decode_plain(q: torch.Tensor, kv_pages: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 lengths: torch.Tensor, *,
                                 scale: float) -> torch.Tensor:
    """K1's function in plain PyTorch. Rows at or past a sequence's length
    are zeroed before any product, as in the kernel, so a pool holding
    non-finite garbage outside the live rows gives the same answer."""
    b, hq, d = q.shape
    _, hkv, page, _ = kv_pages.shape
    mp = block_tables.shape[1]
    k, v = gather_kv(kv_pages, block_tables)      # [B, MP*page, Hkv, D]
    live = torch.arange(mp * page, device=q.device)[None, :] \
        < lengths.long()[:, None]                 # [B, K]
    zero = torch.zeros((), dtype=k.dtype, device=k.device)
    k = torch.where(live[:, :, None, None], k, zero)
    v = torch.where(live[:, :, None, None], v, zero)
    qg = q.reshape(b, hkv, hq // hkv, d)
    logits = torch.einsum("bhrd,bkhd->bhrk", qg.float(), k.float()) * scale
    logits = logits.masked_fill(~live[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    # a length-0 row has no live key: its output is zero
    probs = probs.masked_fill(~live[:, None, None, :], 0.0).to(v.dtype)
    out = torch.einsum("bhrk,bkhd->bhrd", probs, v)
    return out.reshape(b, hq, d).to(q.dtype)


def _decode_launch(q, kv_pages, block_tables, lengths, *, scale: float):
    b, hq, d = q.shape
    _, hkv, page, d2 = kv_pages.shape
    mp = block_tables.shape[1]
    if q.dtype not in _DTYPE_CODES or kv_pages.dtype != q.dtype:
        raise TypeError(f"paged_decode takes float32 or bfloat16 q and pool "
                        f"of one type, got {q.dtype}, {kv_pages.dtype}")
    if d2 != 2 * d or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit pool "
                         f"{tuple(kv_pages.shape)}")
    if block_tables.shape[0] != b or lengths.shape != (b,):
        raise ValueError("block_tables/lengths do not match the batch")
    if not (q.is_contiguous() and kv_pages.is_contiguous()):
        raise ValueError("paged_decode needs contiguous q and pool")
    if (d2 * kv_pages.element_size()) % 16 or kv_pages.data_ptr() % 16:
        raise ValueError("paged_decode copies 16-byte units: a pool row "
                         "must be a multiple of 16 bytes, 16-byte aligned")
    lib = library("paged_decode")
    if not lib.paged_decode_supports(_DTYPE_CODES[q.dtype], d):
        raise ValueError(f"paged_decode has no {q.dtype} kernel for head "
                         f"dim {d}")
    bt = block_tables.to(device=q.device, dtype=torch.int32).contiguous()
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    if b == 0:
        return out
    # per-split partial results, merged by the kernel's second pass
    n_split = lib.paged_decode_splits(page, mp)
    part_acc = torch.empty((b, hq, n_split, d), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b, hq, n_split, 2), dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):
        code = lib.paged_decode(
            _DTYPE_CODES[q.dtype], q.data_ptr(), kv_pages.data_ptr(),
            bt.data_ptr(), lens.data_ptr(), part_acc.data_ptr(),
            part_ml.data_ptr(), out.data_ptr(), b, hq, hkv, d, page, mp,
            float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    check("paged_decode", code)
    paged_attention_decode.launches += 1
    return out


def paged_attention_decode(q: torch.Tensor, kv_pages: torch.Tensor,
                           block_tables: torch.Tensor, lengths: torch.Tensor,
                           *, scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode attention over paged KV.

    q: [B, Hq, D] (the newest token per sequence, already written to its
    page); kv_pages: [P, Hkv, page, 2D]; block_tables: [B, MP];
    lengths: [B] total tokens per sequence (0 = inactive row -> zero
    output). Returns [B, Hq, D].
    """
    scale_f = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if q.device.type == "cpu":
        return paged_attention_decode_plain(q, kv_pages, block_tables,
                                            lengths, scale=scale_f)
    return _decode_launch(q, kv_pages, block_tables, lengths, scale=scale_f)


paged_attention_decode.launches = 0


# --------------------------------------------------------- prefill (+ctx)
def _attn_lse(q, k, v, *, causal, segment_ids, scale):
    """Attention returning (o [B,S,Hq,D], lse [B,S,Hq]) through K2."""
    return flash_attention(q, k, v, causal=causal, segment_ids=segment_ids,
                           scale=scale, return_lse=True)


def merge_attention(o1: torch.Tensor, lse1: torch.Tensor,
                    o2: torch.Tensor, lse2: torch.Tensor) -> torch.Tensor:
    """Combine two attention partials over disjoint kv sets by their
    log-sum-exp. o*: [B,S,H,D]; lse*: [B,S,H]."""
    m = torch.maximum(lse1, lse2)
    a1 = torch.exp(lse1 - m)
    a2 = torch.exp(lse2 - m)
    denom = a1 + a2
    w1 = (a1 / denom)[..., None]
    w2 = (a2 / denom)[..., None]
    return (o1.float() * w1 + o2.float() * w2).to(o1.dtype)


def paged_prefill_attention(q: torch.Tensor, k_new: torch.Tensor,
                            v_new: torch.Tensor, kv_pages: torch.Tensor,
                            block_tables: torch.Tensor,
                            positions: torch.Tensor,
                            total_lens: torch.Tensor, *, ctx_pages: int = 0,
                            scale: Optional[float] = None) -> torch.Tensor:
    """Prefill attention: new tokens attend to themselves (causal) and to
    an optional cached prefix held in pages, merged by log-sum-exp.

    q/k_new/v_new: [B, S, H*, D], contiguous from each row's first
    position positions[:, 0], the cached-prefix length. That length need
    not be a page multiple: the prefix part masks kv positions
    ``>= positions[:, 0]`` one by one, which speculative verify relies on
    (its rows start at total - 1); a prefix-cache hit or chunk k > 0 of a
    chunked prefill starts at a page multiple. ctx_pages is the number of
    block-table columns the prefix may span; 0 skips the prefix part (no
    page reads). Rows with a shorter prefix mask the tail; rows with none
    mask it all.
    """
    d = q.shape[-1]
    scale_f = float(scale if scale is not None else d ** -0.5)
    o1, lse1 = _attn_lse(q, k_new, v_new, causal=True, segment_ids=None,
                         scale=scale_f)
    if ctx_pages <= 0:
        return o1
    page = kv_pages.shape[2]
    k_ctx, v_ctx = gather_kv(kv_pages, block_tables[:, :ctx_pages])
    b, sq = q.shape[:2]
    ctx_len = positions[:, 0].long()
    kv_pos = torch.arange(ctx_pages * page, device=q.device)
    kv_seg = (kv_pos[None, :] < ctx_len[:, None]).to(torch.int32)
    q_seg = torch.ones((b, sq), dtype=torch.int32, device=q.device)
    o2, lse2 = _attn_lse(q, k_ctx, v_ctx, causal=False,
                         segment_ids=(q_seg, kv_seg), scale=scale_f)
    return merge_attention(o1, lse1, o2, lse2)
