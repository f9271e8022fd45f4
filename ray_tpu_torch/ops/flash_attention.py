"""Flash-attention forward (kernel K2) and its plain PyTorch version.

Counterpart of the JAX package's ``ops/flash_attention.py`` public
``flash_attention``, forward only: q ``[B,Sq,Hq,D]``, k/v ``[B,Sk,Hkv,D]``
-> o ``[B,Sq,Hq,D]`` (and lse ``[B,Sq,Hq]`` float32 with
``return_lse=True``). The masks are the TPU kernel's: kv padding, causal
relative to the end of the kv axis (``k_pos <= q_pos + sk - sq``) and an
optional segment-id equality mask. A fully masked row gives ``o = 0`` and
``lse = -1e30``.

On a CUDA tensor the wrapper launches the hand-written kernel
``csrc/flash_fwd.cu`` (which replaces ``_fwd_kernel`` of the JAX package;
see the source for its design and bound) or raises; on a CPU tensor it
runs ``flash_attention_plain``. ``flash_attention.launches`` counts kernel
launches and ``flash_attention.segment_launches`` the launches with segment
ids (the cached-prefix part of paged prefill). The backward kernels are
not ported yet, so nothing here is differentiable.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ._build import check, library
from .attention import NEG_INF, split_segment_ids

KERNEL_HEAD_DIMS = (16, 64, 128)  # every head dim in CONFIGS
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, *, causal: bool, q_seg, kv_seg,
                          scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: returns (o, lse)."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    rep = hq // hkv
    qg = q.reshape(b, sq, hkv, rep, d)
    logits = torch.einsum("bshrd,bkhd->bhrsk", qg.float(), k.float()) * scale
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask.tril(sk - sq)
    mask = mask[None, None, None].expand(b, 1, 1, sq, sk)
    if q_seg is not None:
        mask = mask & (q_seg[:, None, None, :, None]
                       == kv_seg[:, None, None, None, :])
    logits = logits.masked_fill(~mask, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bhrsk,bkhd->bshrd", (p / l_safe).to(v.dtype), v)
    lse = (m + torch.log(l_safe))[..., 0]          # [B,Hkv,rep,Sq]
    return (o.reshape(b, sq, hq, d).to(q.dtype),
            lse.reshape(b, hq, sq).transpose(1, 2).contiguous())


def _launch(q, k, v, *, causal: bool, q_seg, kv_seg,
            scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_fwd takes float32 or bfloat16 q/k/v of one "
                        f"type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_fwd head dim {d} not in {KERNEL_HEAD_DIMS}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_fwd needs a contiguous head dim")
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, sq, hq), dtype=torch.float32, device=q.device)
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])
            for t in (q, k, v)):
        raise ValueError("the bf16 flash_fwd kernel loads 16-byte rows: "
                         "q/k/v need 16-byte aligned rows")
    if o.numel() == 0:
        return o, lse
    if q_seg is not None:
        q_seg = q_seg.to(device=q.device, dtype=torch.int32).contiguous()
        kv_seg = kv_seg.to(device=q.device, dtype=torch.int32).contiguous()
        if q_seg.shape != (b, sq) or kv_seg.shape != (b, sk):
            raise ValueError(f"segment ids {tuple(q_seg.shape)}, "
                             f"{tuple(kv_seg.shape)} do not match "
                             f"({b}, {sq}), ({b}, {sk})")
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3])
    fn = library("flash_fwd").flash_fwd
    with torch.cuda.device(q.device):
        code = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                  q_seg.data_ptr() if q_seg is not None else None,
                  kv_seg.data_ptr() if kv_seg is not None else None,
                  b, sq, sk, hq, hkv, d, strides, int(causal), float(scale),
                  torch.cuda.current_stream(q.device).cuda_stream)
    check("flash_fwd", code)
    flash_attention.launches += 1
    if q_seg is not None:
        flash_attention.segment_launches += 1
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, segment_ids=None,
                    scale: Optional[float] = None, return_lse: bool = False):
    """Flash attention forward. q [B,Sq,Hq,D]; k/v [B,Sk,Hkv,D].

    segment_ids: None, one [B,S] tensor (Sq == Sk), or a
    (q_segment_ids [B,Sq], kv_segment_ids [B,Sk]) pair.
    return_lse: also return the log-sum-exp [B,Sq,Hq] (float32), the hook
    for merging partials over disjoint kv sets (paged prefill).
    """
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if hq % hkv != 0:
        raise ValueError(f"num q heads {hq} not a multiple of kv heads {hkv}")
    if causal and sk < sq:
        raise ValueError(f"causal attention needs sk >= sq, got {sq=} {sk=}")
    scale = float(scale if scale is not None else d ** -0.5)
    q_seg, kv_seg = split_segment_ids(segment_ids, sq, sk)
    if q.device.type == "cpu":
        o, lse = flash_attention_plain(q, k, v, causal=causal, q_seg=q_seg,
                                       kv_seg=kv_seg, scale=scale)
    else:
        o, lse = _launch(q, k, v, causal=causal, q_seg=q_seg, kv_seg=kv_seg,
                         scale=scale)
    return (o, lse) if return_lse else o


flash_attention.launches = 0
flash_attention.segment_launches = 0
