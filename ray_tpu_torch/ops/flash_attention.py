"""Flash attention: forward (kernel K2), backward (kernels K3 and K4), and
their plain PyTorch versions.

Counterpart of the JAX package's ``ops/flash_attention.py`` public
``flash_attention``: q ``[B,Sq,Hq,D]``, k/v ``[B,Sk,Hkv,D]`` -> o
``[B,Sq,Hq,D]`` (and lse ``[B,Sq,Hq]`` float32 with ``return_lse=True``).
The masks are the TPU kernels': kv padding, causal relative to the end of
the kv axis (``k_pos <= q_pos + sk - sq``) and an optional segment-id
equality mask. A fully masked row gives ``o = 0`` and ``lse = -1e30``.

``flash_attention`` is differentiable in q, k and v (a
``torch.autograd.Function``, the counterpart of ``_flash``'s custom VJP):
the forward saves q, k, v, the segment ids, o and lse, and the backward
recomputes p from lse, with ``delta = rowsum(do * o)``. The
``return_lse=True`` path is forward-only, as in JAX.

On CUDA tensors the wrappers launch the hand-written kernels
(``csrc/flash_fwd.cu`` for ``_fwd_kernel``, ``csrc/flash_bwd.cu`` for
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``; see the sources for their
design and bound) or raise; on CPU tensors they run the plain versions.
K2 has two designs: at decode shapes (Sq up to ``DECODE_MAX_SQ``) a
split-KV kernel whose splits ``decode_plan`` sizes, else 64-row q tiles.
Launch counters: ``flash_attention.launches`` (K2, either design),
``flash_attention.decode_launches`` (K2's split-KV design: the dense KV
cache's decode steps), ``flash_attention.segment_launches`` (K2 with
segment ids, the cached-prefix part of paged prefill),
``flash_attention.dq_launches`` (K3) and ``flash_attention.dkv_launches``
(K4).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ._build import check, library
from .attention import NEG_INF, split_segment_ids

# the head dims K2, K3 and K4 are built for (csrc/common.cuh's
# HEAD_DIM_CASES): those of CONFIGS and 32, Phi-3-mini's 96 and
# Gemma-2's 256
KERNEL_HEAD_DIMS = (16, 32, 64, 96, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# K2's split-KV design (csrc/flash_fwd.cu, flash_fwd_decode): a block takes
# DECODE_ROWS rows (the q heads of one kv head's group times the q rows)
# and stages its split of the kv axis DECODE_CHUNK rows at a time (the
# source's kDecRows and kDecChunk)
DECODE_ROWS = 16
DECODE_CHUNK = 32
# the largest Sq that takes it, by type; a larger Sq takes the 64-row
# kernels. chip_smoke.py's dense_cache phase times both designs at Sq 1 to
# 64 over 528 keys (32/8 heads, D 128; PERF.md): in float32 the split-KV
# design was the faster at every Sq up to 64, one whole q tile of the
# 64-row kernel, which computes all 64 rows whatever Sq is (0.0745 against
# 0.0876 ms at Sq 64 on an H100, register tiles); in bf16 only at Sq 1:
# from Sq 2 the wgmma kernel, whose 64-row tile costs about as much at Sq
# 2 as at 1, was the faster.
DECODE_MAX_SQ = {torch.float32: 64, torch.bfloat16: 1}


def decode_plan(b: int, sq: int, sk: int, hq: int, hkv: int, sms: int,
                max_sq: int) -> Optional[Tuple[int, int]]:
    """(split_rows, n_split) of K2's split-KV kernel at this shape, or
    None where the 64-row kernels take it (Sq past ``max_sq``, or no kv).

    The kv axis is cut into n_split splits of split_rows rows (whole
    DECODE_CHUNK-row chunks, at least one), as many as give about two
    blocks an SM over the grid of (split, kv head and row group, batch
    row). At the dense KV cache's decode (B 1, Sq 1, Sk 528, 32/8 heads,
    132 SMs): 17 splits of 32 rows, 136 blocks."""
    if sq > max_sq or sk == 0:
        return None
    blocks = b * hkv * _row_groups(sq, hq, hkv)  # blocks of one split
    chunks = -(-sk // DECODE_CHUNK)
    want = max(1, -(-2 * sms // blocks))
    per = -(-chunks // min(chunks, want))
    return per * DECODE_CHUNK, -(-chunks // per)


def _row_groups(sq: int, hq: int, hkv: int) -> int:
    """Blocks of the split-KV kernel a kv head and split: its rep * Sq
    rows in groups of DECODE_ROWS."""
    return -(-(hq // hkv) * sq // DECODE_ROWS)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# the split-KV kernel's int32 counts, one buffer per (device, stream): the
# last split of a group to finish merges the group and sets its count
# back to zero, so a buffer is zero before every launch on its stream
_decode_counts = {}


def _counts(device, stream: int, n: int) -> torch.Tensor:
    buf = _decode_counts.get((device.index, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _decode_counts[(device.index, stream)] = buf
    return buf


def _mask(q, k, causal: bool, q_seg, kv_seg) -> torch.Tensor:
    """The kernels' mask, [B, 1, 1, Sq, Sk] (kv axis grouped as in
    ``flash_attention_plain``)."""
    b, sq = q.shape[:2]
    sk = k.shape[1]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask.tril(sk - sq)
    mask = mask[None, None, None].expand(b, 1, 1, sq, sk)
    if q_seg is not None:
        mask = mask & (q_seg[:, None, None, :, None]
                       == kv_seg[:, None, None, None, :])
    return mask


def flash_attention_plain(q, k, v, *, causal: bool, q_seg, kv_seg,
                          scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: returns (o, lse)."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    rep = hq // hkv
    qg = q.reshape(b, sq, hkv, rep, d)
    logits = torch.einsum("bshrd,bkhd->bhrsk", qg.float(), k.float()) * scale
    mask = _mask(q, k, causal, q_seg, kv_seg)
    logits = logits.masked_fill(~mask, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bhrsk,bkhd->bshrd", (p / l_safe).to(v.dtype), v)
    lse = (m + torch.log(l_safe))[..., 0]          # [B,Hkv,rep,Sq]
    return (o.reshape(b, sq, hq, d).to(q.dtype),
            lse.reshape(b, hq, sq).transpose(1, 2).contiguous())


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(do * o)`` in float32, [B, Sq, Hq]."""
    return torch.einsum("bshd,bshd->bsh", do.float(), o.float())


def _bwd_terms(q, k, v, do, lse, delta, *, causal, q_seg, kv_seg, scale):
    """p and ds of every (q, k) pair, [B, Hkv, rep, Sq, Sk] float32, by the
    kernels' formulas, with q and do grouped [B, Sq, Hkv, rep, D]."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    rep = hq // hkv
    qg = q.reshape(b, sq, hkv, rep, d).float()
    dog = do.reshape(b, sq, hkv, rep, d).float()
    s = torch.einsum("bshrd,bkhd->bhrsk", qg, k.float()) * scale
    mask = _mask(q, k, causal, q_seg, kv_seg)

    def grouped(x):  # [B, Sq, Hq] -> [B, Hkv, rep, Sq, 1]
        return x.reshape(b, sq, hkv, rep).permute(0, 2, 3, 1)[..., None]

    # zeroed after the exp: a fully masked row has lse = -1e30
    p = torch.exp(s.masked_fill(~mask, NEG_INF) - grouped(lse))
    p = p.masked_fill(~mask, 0.0)
    dp = torch.einsum("bshrd,bkhd->bhrsk", dog, v.float())
    ds = p * (dp - grouped(delta)) * scale
    return p, ds, qg, dog


def flash_bwd_dq_plain(q, k, v, do, lse, delta, *, causal: bool, q_seg,
                       kv_seg, scale: float) -> torch.Tensor:
    """K3's function in plain PyTorch: dq in q's type."""
    _, ds, _, _ = _bwd_terms(q, k, v, do, lse, delta, causal=causal,
                             q_seg=q_seg, kv_seg=kv_seg, scale=scale)
    return torch.einsum("bhrsk,bkhd->bshrd", ds, k.float()).reshape(
        q.shape).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, *, causal: bool, q_seg,
                        kv_seg, scale: float):
    """K4's function in plain PyTorch: (dk, dv) in k's and v's types."""
    p, ds, qg, dog = _bwd_terms(q, k, v, do, lse, delta, causal=causal,
                                q_seg=q_seg, kv_seg=kv_seg, scale=scale)
    return (torch.einsum("bhrsk,bshrd->bkhd", ds, qg).to(k.dtype),
            torch.einsum("bhrsk,bshrd->bkhd", p, dog).to(v.dtype))


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool, q_seg,
                              kv_seg, scale: float):
    """The backward of ``flash_attention`` in plain PyTorch, recomputing p
    from lse by the kernels' formulas: returns (dq, dk, dv)."""
    kw = dict(causal=causal, q_seg=q_seg, kv_seg=kv_seg, scale=scale)
    delta = attention_delta(o, do)
    return (flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw),
            *flash_bwd_dkv_plain(q, k, v, do, lse, delta, **kw))


def _check_inputs(name: str, *tensors) -> None:
    """Refuse what the kernels do not take: one float32 or bf16 type, a
    head dim in KERNEL_HEAD_DIMS, one device, a contiguous head dim and,
    for bf16 (TMA tile loads), a 16-byte aligned base, strides that are
    multiples of 16 bytes and no empty tensor (zero-length Sq or Sk)."""
    dtype, d = tensors[0].dtype, tensors[0].shape[-1]
    if dtype not in _DTYPE_CODES or any(t.dtype != dtype for t in tensors):
        raise TypeError(f"{name} takes float32 or bfloat16 tensors of one "
                        f"type, got {[t.dtype for t in tensors]}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name} head dim {d} not in {KERNEL_HEAD_DIMS}")
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError(f"{name}: every tensor must lie on one device")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError(f"{name} needs a contiguous head dim")
    if dtype != torch.bfloat16:
        return
    if any(t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])
           for t in tensors):
        raise ValueError(f"the bf16 {name} kernel loads tiles by TMA: its "
                         f"inputs need a 16-byte aligned base and strides "
                         f"of a multiple of 16 bytes")
    if any(t.numel() == 0 for t in tensors):
        raise ValueError(f"the bf16 {name} kernel loads tiles by TMA: "
                         f"zero-length Sq or Sk is refused, got shapes "
                         f"{[tuple(t.shape) for t in tensors]}")


def _segments(q_seg, kv_seg, b: int, sq: int, sk: int, device):
    if q_seg is None:
        return None, None
    q_seg = q_seg.to(device=device, dtype=torch.int32).contiguous()
    kv_seg = kv_seg.to(device=device, dtype=torch.int32).contiguous()
    if q_seg.shape != (b, sq) or kv_seg.shape != (b, sk):
        raise ValueError(f"segment ids {tuple(q_seg.shape)}, "
                         f"{tuple(kv_seg.shape)} do not match "
                         f"({b}, {sq}), ({b}, {sk})")
    return q_seg, kv_seg


def _ptr(t) -> Optional[int]:
    return t.data_ptr() if t is not None else None


def _strides(*tensors):
    return (ctypes.c_longlong * (3 * len(tensors)))(
        *(st for t in tensors for st in t.stride()[:3]))


def _launch(q, k, v, *, causal: bool, q_seg, kv_seg, scale: float,
            max_sq: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 on CUDA tensors: the split-KV design up to ``max_sq`` q rows
    (default ``DECODE_MAX_SQ`` of the type; ``chip_smoke.py`` sets it to
    time the two designs at one shape), else the 64-row one."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    _check_inputs("flash_fwd", q, k, v)
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, sq, hq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    q_seg, kv_seg = _segments(q_seg, kv_seg, b, sq, sk, q.device)
    lib = library("flash_fwd")
    if max_sq is None:
        max_sq = DECODE_MAX_SQ[q.dtype]
    plan = decode_plan(b, sq, sk, hq, hkv, _sm_count(q.device.index),
                       max_sq)
    args = (_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), _ptr(q_seg), _ptr(kv_seg))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if plan is None:
            code = lib.flash_fwd(*args, b, sq, sk, hq, hkv, d,
                                 _strides(q, k, v, o), int(causal),
                                 float(scale), stream)
        else:  # the splits' partial (acc, m and l) for the merge
            split_rows, n_split = plan
            part_acc = part_ml = counts = None
            if n_split > 1:
                part_acc = torch.empty((n_split, b, sq, hq, d),
                                       dtype=torch.float32, device=q.device)
                part_ml = torch.empty((n_split, b, sq, hq, 2),
                                      dtype=torch.float32, device=q.device)
                counts = _counts(q.device, stream,
                                 b * hkv * _row_groups(sq, hq, hkv))
            code = lib.flash_fwd_decode(
                *args, _ptr(part_acc), _ptr(part_ml), _ptr(counts), b, sq,
                sk, hq, hkv, d, _strides(q, k, v, o), int(causal),
                float(scale), split_rows, n_split, stream)
    check("flash_fwd", code)
    flash_attention.launches += 1
    if plan is not None:
        flash_attention.decode_launches += 1
    if q_seg is not None:
        flash_attention.segment_launches += 1
    return o, lse


def _bwd_prepare(name, q, k, v, do, lse, delta, q_seg, kv_seg):
    _check_inputs(name, q, k, v, do)
    b, sq, hq, _ = q.shape
    sk = k.shape[1]
    for t, what in ((lse, "lse"), (delta, "delta")):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, sq, hq) \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name}: {what} must be a contiguous float32 "
                             f"[{b}, {sq}, {hq}] tensor on {q.device}")
    return _segments(q_seg, kv_seg, b, sq, sk, q.device)


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool, q_seg=None,
                 kv_seg=None, scale: float) -> torch.Tensor:
    """K3 on CUDA tensors (raises on what it does not take): dq."""
    q_seg, kv_seg = _bwd_prepare("flash_bwd_dq", q, k, v, do, lse, delta,
                                 q_seg, kv_seg)
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    dq = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq
    fn = library("flash_bwd").flash_bwd_dq
    with torch.cuda.device(q.device):
        code = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                  delta.data_ptr(), _ptr(q_seg), _ptr(kv_seg), dq.data_ptr(),
                  b, sq, sk, hq, hkv, d, _strides(q, k, v, do), int(causal),
                  float(scale),
                  torch.cuda.current_stream(q.device).cuda_stream)
    check("flash_bwd_dq", code)
    flash_attention.dq_launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool, q_seg=None,
                  kv_seg=None, scale: float):
    """K4 on CUDA tensors (raises on what it does not take): (dk, dv)."""
    q_seg, kv_seg = _bwd_prepare("flash_bwd_dkv", q, k, v, do, lse, delta,
                                 q_seg, kv_seg)
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    dk = torch.empty((b, sk, hkv, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, sk, hkv, d), dtype=v.dtype, device=v.device)
    if dk.numel() == 0:
        return dk, dv
    fn = library("flash_bwd").flash_bwd_dkv
    with torch.cuda.device(q.device):
        code = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                  delta.data_ptr(), _ptr(q_seg), _ptr(kv_seg), dk.data_ptr(),
                  dv.data_ptr(), b, sq, sk, hq, hkv, d,
                  _strides(q, k, v, do), int(causal), float(scale),
                  torch.cuda.current_stream(q.device).cuda_stream)
    check("flash_bwd_dkv", code)
    flash_attention.dkv_launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool, q_seg,
                        kv_seg, scale: float):
    """The backward of ``flash_attention``: (dq, dk, dv). K3 and K4 on CUDA
    tensors, the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         q_seg=q_seg, kv_seg=kv_seg,
                                         scale=scale)
    do = do.contiguous()
    delta = attention_delta(o, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal=causal, q_seg=q_seg,
                      kv_seg=kv_seg, scale=scale)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal,
                           q_seg=q_seg, kv_seg=kv_seg, scale=scale)
    return dq, dk, dv


def _forward(q, k, v, *, causal, q_seg, kv_seg, scale):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, q_seg=q_seg,
                                     kv_seg=kv_seg, scale=scale)
    return _launch(q, k, v, causal=causal, q_seg=q_seg, kv_seg=kv_seg,
                   scale=scale)


class _FlashAttention(torch.autograd.Function):
    """``_flash`` / ``_flash_fwd`` / ``_flash_bwd`` of the JAX package."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal, scale):
        o, lse = _forward(q, k, v, causal=causal, q_seg=q_seg,
                          kv_seg=kv_seg, scale=scale)
        ctx.save_for_backward(q, k, v, q_seg, kv_seg, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_seg, kv_seg, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         causal=ctx.causal, q_seg=q_seg,
                                         kv_seg=kv_seg, scale=ctx.scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, segment_ids=None,
                    scale: Optional[float] = None, return_lse: bool = False):
    """Flash attention. q [B,Sq,Hq,D]; k/v [B,Sk,Hkv,D].

    segment_ids: None, one [B,S] tensor (Sq == Sk), or a
    (q_segment_ids [B,Sq], kv_segment_ids [B,Sk]) pair.
    return_lse: also return the log-sum-exp [B,Sq,Hq] (float32), the hook
    for merging partials over disjoint kv sets (paged prefill); that path
    is forward-only. Otherwise the result is differentiable in q, k, v.
    """
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if hq % hkv != 0:
        raise ValueError(f"num q heads {hq} not a multiple of kv heads {hkv}")
    if causal and sk < sq:
        raise ValueError(f"causal attention needs sk >= sq, got {sq=} {sk=}")
    scale = float(scale if scale is not None else d ** -0.5)
    q_seg, kv_seg = split_segment_ids(segment_ids, sq, sk)
    if return_lse:
        return _forward(q, k, v, causal=causal, q_seg=q_seg, kv_seg=kv_seg,
                        scale=scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, q_seg, kv_seg, causal, scale)
    return _forward(q, k, v, causal=causal, q_seg=q_seg, kv_seg=kv_seg,
                    scale=scale)[0]


flash_attention.launches = 0
flash_attention.decode_launches = 0
flash_attention.segment_launches = 0
flash_attention.dq_launches = 0
flash_attention.dkv_launches = 0
