"""Plain softmax attention in PyTorch, the numerics oracle the kernels and
the tests are held against, and the attention dispatcher. Mirrors the JAX
package's ``ops/attention.py`` (``split_segment_ids``,
``reference_attention``, ``attention``); layouts are the same, q
``[B,Sq,Hq,D]`` and k/v ``[B,Sk,Hkv,D]``.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def split_segment_ids(segment_ids, sq: int, sk: int):
    """Normalize segment_ids to a (q_seg [B,Sq], kv_seg [B,Sk]) pair.

    Accepts None, a single [B,S] tensor (requires Sq == Sk), or an explicit
    pair (cached decode / chunked prefill, where kv is longer than q).
    """
    if segment_ids is None:
        return None, None
    if isinstance(segment_ids, tuple):
        q_seg, kv_seg = segment_ids
    else:
        if sq != sk:
            raise ValueError(
                "single segment_ids array requires Sq == Sk; pass a "
                "(q_segment_ids, kv_segment_ids) tuple when using a kv cache")
        q_seg = kv_seg = segment_ids
    return q_seg, kv_seg


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, segment_ids=None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain softmax attention. q [B,Sq,Hq,D], k/v [B,Sk,Hkv,D]."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if hq != hkv:
        if hq % hkv:
            raise ValueError(f"num q heads {hq} not a multiple of {hkv}")
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~mask, NEG_INF)
    q_seg, kv_seg = split_segment_ids(segment_ids, sq, sk)
    if q_seg is not None:
        seg = q_seg[:, None, :, None] == kv_seg[:, None, None, :]
        logits = logits.masked_fill(~seg, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, segment_ids=None,
              scale: Optional[float] = None,
              impl: Optional[str] = None) -> torch.Tensor:
    """Dispatch to an attention implementation.

    impl: None or "flash" (``flash_attention``: kernels K2-K4 on CUDA
    tensors, their plain versions on CPU tensors) | "reference"
    (``reference_attention``) | "ring" | "ulysses" (sequence-parallel
    attention, not ported: ROADMAP queue 1 item 9).
    """
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attention impl={impl!r} (sequence-parallel attention) is not "
            f"ported yet: ROADMAP queue 1 item 9")
    if impl in (None, "flash"):
        from .flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal,
                               segment_ids=segment_ids, scale=scale)
    if impl == "reference":
        return reference_attention(q, k, v, causal=causal,
                                   segment_ids=segment_ids, scale=scale)
    raise ValueError(f"unknown attention impl {impl!r}")
