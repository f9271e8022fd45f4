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
    attention over the ``sp`` group of the ambient mesh,
    ``parallel.mesh.current_mesh()``, on the rank's sequence shards;
    with no mesh, or sp == 1, a warning and dense attention, as in JAX).
    """
    if impl in ("ring", "ulysses"):
        from ..parallel.mesh import current_mesh, mesh_sizes

        mesh = current_mesh()
        if mesh is not None and mesh_sizes(mesh).get("sp", 1) > 1:
            if isinstance(segment_ids, tuple):
                raise NotImplementedError(
                    "sequence-parallel attention does not take a "
                    "(q_seg, kv_seg) pair (kv-cache decode is dense)")
            from .ring_attention import (ring_attention_sharded,
                                         ulysses_attention_sharded)
            fn = (ring_attention_sharded if impl == "ring"
                  else ulysses_attention_sharded)
            return fn(q, k, v, mesh, causal=causal, segment_ids=segment_ids,
                      scale=scale)
        _warn_dense_fallback(
            f"impl={impl!r} requested but no active mesh with sp>1 "
            "(wrap the call in ray_tpu_torch.parallel.mesh.active_mesh); "
            "running dense attention")
        impl = None
    if impl in (None, "flash"):
        from .flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal,
                               segment_ids=segment_ids, scale=scale)
    if impl == "reference":
        return reference_attention(q, k, v, causal=causal,
                                   segment_ids=segment_ids, scale=scale)
    raise ValueError(f"unknown attention impl {impl!r}")


_warned = set()


def _warn_dense_fallback(reason: str) -> None:
    """Warn once per reason, as the JAX package's ``_warn_flash_fallback``."""
    if reason not in _warned:
        _warned.add(reason)
        import warnings

        warnings.warn(f"falling back to dense attention: {reason}")
