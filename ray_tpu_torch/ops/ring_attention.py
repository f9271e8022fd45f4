"""Ring attention and Ulysses sequence parallelism over the ``sp`` group:
the counterpart of the JAX package's ``ops/ring_attention.py``.

Each rank holds its sequence shard of q, k and v, ``[B, S/n, H, D]``
(rank ``i`` the positions ``[i * S/n, (i + 1) * S/n)``), and gets back its
shard of the output.

- ``ring_attention``: blockwise-softmax attention; the raw k/v heads (and
  the segment ids) rotate round the group with ``ring_shift``, one block
  a step, and each step's partial output is merged into the running one
  by log-sum-exp. The full sequence never exists on a rank. As in JAX,
  the per-block products are plain tensor products (``torch.einsum``),
  not a kernel.
- ``ulysses_attention``: ``all_to_all`` reshards ``[B, S/n, H, D]`` to
  ``[B, S, H/n, D]``, dense attention runs on whole sequences for a head
  subset (``ops.attention.attention``: ``flash_attention``, so kernels
  K2, K3 and K4 on CUDA tensors and their plain versions on CPU ones),
  and a second exchange scatters the output back to sequence shards.

Both are collectives: every rank of the group calls them with shards of
one shape. There is no global array, so the JAX ``*_sharded`` wrappers
(``shard_map`` over a mesh) become ``ring_attention_sharded`` and
``ulysses_attention_sharded``, which take a ``DeviceMesh`` and use its
``sp`` group on the rank's shards. q, k and v of Ulysses leave the first
exchange as views of one contiguous buffer, so the bf16 kernels' TMA
rule (strides of a multiple of 16 bytes) holds.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .attention import NEG_INF, attention
from .collectives import all_gather, all_to_all, ring_shift


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> [B, S, Hkv * n_rep, D], q head h reading kv head
    h // n_rep (the JAX ``_repeat_kv``)."""
    return k if n_rep == 1 else k.repeat_interleave(n_rep, dim=2)


def _block_attention(q, k, v, mask, scale: float):
    """Softmax attention of q against one k/v block, kv heads already
    repeated. q [B,Sq,H,D], k/v [B,Sk,H,D], mask [B,1,Sq,Sk] boolean or
    None. Returns (out [B,Sq,H,D] normalized within the block, in q's
    type; lse [B,H,Sq] float32). Logits are float32, the unnormalised p
    is rounded to v's type before its product with v; a fully masked
    row gets lse ~ NEG_INF, so that the merge gives it no weight."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)                   # [B,H,Sq,1]
    m_safe = torch.clamp(m, min=NEG_INF)                    # no -inf - -inf
    unnorm = torch.exp(logits - m_safe)
    l_safe = torch.clamp(unnorm.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", unnorm.to(v.dtype), v)
    out = (out / l_safe.transpose(1, 2)).to(q.dtype)        # [B,Sq,H,D]
    return out, (m_safe + torch.log(l_safe))[..., 0]


def _merge(o, lse, o_new, lse_new):
    """Numerically stable merge of two normalized partial attentions,
    guarding rows masked on both sides (max lse == NEG_INF)."""
    max_lse = torch.maximum(lse, lse_new)
    dead = max_lse <= NEG_INF / 2
    max_safe = torch.where(dead, 0.0, max_lse)
    w_old = torch.exp(lse - max_safe)
    w_new = torch.exp(lse_new - max_safe)
    denom = torch.clamp(w_old + w_new, min=1e-30)
    scale_old = (w_old / denom).transpose(1, 2)[..., None]  # [B,Sq,H,1]
    scale_new = (w_new / denom).transpose(1, 2)[..., None]
    o = o * scale_old.to(o.dtype) + o_new * scale_new.to(o.dtype)
    lse = torch.where(dead, NEG_INF, max_safe + torch.log(denom))
    return o, lse


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   group, causal: bool = True,
                   segment_ids: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention over ``group``, on the rank's shards q [B,S/n,Hq,D]
    and k/v [B,S/n,Hkv,D] (GQA: Hq a multiple of Hkv) and, if given, its
    segment ids [B,S/n]. q's positions are the global ones; at step
    ``s`` the rank holds the k/v block of rank ``(rank - s) % n``. The
    raw kv heads rotate (k and v in one tensor, one exchange a step) and
    are repeated only at compute time; the segment ids rotate with them.
    Differentiable in q, k and v: the gradients of the blocks travel back
    round the ring."""
    n = dist.get_world_size(group)
    rank = dist.get_group_rank(group, dist.get_rank())
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    n_rep = hq // hkv
    scale = float(scale if scale is not None else d ** -0.5)
    q_pos = rank * sq + torch.arange(sq, device=q.device)
    kv = torch.cat([k, v], dim=2)
    seg = segment_ids
    o = torch.zeros_like(q)
    lse = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32,
                     device=q.device)
    for step in range(n):
        kv_idx = (rank - step) % n
        mask = None
        if causal:
            k_pos = kv_idx * sk + torch.arange(sk, device=q.device)
            mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
        if seg is not None:
            seg_mask = segment_ids[:, None, :, None] == seg[:, None, None, :]
            mask = seg_mask if mask is None else mask & seg_mask
        k_cur, v_cur = kv.split(hkv, dim=2)
        o_new, lse_new = _block_attention(
            q, _repeat_kv(k_cur, n_rep), _repeat_kv(v_cur, n_rep), mask,
            scale)
        o, lse = _merge(o, lse, o_new, lse_new)
        if step + 1 < n:  # the last block's shift would go unused
            kv = ring_shift(kv, group)
            if seg is not None:
                seg = ring_shift(seg, group)
    return o


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      group, causal: bool = True,
                      segment_ids: Optional[torch.Tensor] = None,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Ulysses sequence parallelism over ``group``: one all-to-all takes
    the rank's shards of q, k and v [B,S/n,H,D] to whole sequences of its
    H/n heads, ``ops.attention.attention`` runs on them (flash attention)
    with the all-gathered segment ids, and a second all-to-all returns
    the output's sequence shard. With GQA the raw kv heads are exchanged
    when Hkv splits evenly over the group, and read as a group by the
    dense call (JAX repeats them after the exchange: the same numbers);
    otherwise they are repeated to Hq first."""
    n = dist.get_world_size(group)
    b, s_loc, hq, d = q.shape
    hkv = k.shape[2]
    if hq % n:
        raise ValueError(f"{hq} q heads do not split over sp={n} ranks")
    if hkv % n:
        k = _repeat_kv(k, hq // hkv)
        v = _repeat_kv(v, hq // hkv)
        hkv = hq
    # q, k, v in one exchange: [B, S/n, n, (Hq + 2 Hkv)/n, D] split over
    # the ranks along dim 2, received sequence blocks along dim 1
    parts = torch.cat([x.unflatten(2, (n, -1)) for x in (q, k, v)], dim=3)
    full = all_to_all(parts, group, split_dim=2, concat_dim=1).squeeze(2)
    qg, kg, vg = full.split([hq // n, hkv // n, hkv // n], dim=2)
    seg_full = (all_gather(segment_ids, group, dim=1)
                if segment_ids is not None else None)
    out = attention(qg, kg, vg, causal=causal, segment_ids=seg_full,
                    scale=scale)
    # [B, S, H/n, D] -> [B, S/n, H, D]
    return all_to_all(out, group, split_dim=1, concat_dim=2)


def _sp_group(mesh):
    names = tuple(mesh.mesh_dim_names or ())
    if "sp" not in names:
        raise ValueError(f"mesh {names} has no 'sp' axis")
    return mesh.get_group("sp")


def ring_attention_sharded(q, k, v, mesh, *, causal: bool = True,
                           segment_ids=None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """``ring_attention`` over the ``sp`` group of ``mesh`` (a
    ``DeviceMesh``), on the rank's shards: its rows over (dp, fsdp), its
    heads over tp, its sequence block over sp."""
    return ring_attention(q, k, v, group=_sp_group(mesh), causal=causal,
                          segment_ids=segment_ids, scale=scale)


def ulysses_attention_sharded(q, k, v, mesh, *, causal: bool = True,
                              segment_ids=None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """``ulysses_attention`` over the ``sp`` group of ``mesh`` (see
    ``ring_attention_sharded``)."""
    return ulysses_attention(q, k, v, group=_sp_group(mesh), causal=causal,
                             segment_ids=segment_ids, scale=scale)
