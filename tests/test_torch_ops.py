"""Parity of ray_tpu_torch's attention ops with the JAX package's.

Inputs are made from a seed with numpy and fed to both sides in float32.
Pallas kernels run as the JAX tests run them on the CPU (interpret mode),
at their tiny shapes; on the CPU the port runs each kernel's plain
PyTorch version. Tolerance: 1e-5 absolute and relative (float32, only
the summation order differs); 5e-5 for the backward, as the JAX
package's own grad-parity tests state it (sums over up to 96 kv rows).
The CUDA kernels are held against these plain versions in
tests/test_torch_kernels.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jax_llama
from ray_tpu.ops import attention as jax_attn
from ray_tpu.ops import flash_attention as jax_flash
from ray_tpu.ops import paged_attention as jax_paged
from ray_tpu.parallel import mesh as jax_mesh
from ray_tpu_torch.models import config as t_config
from ray_tpu_torch.ops import attention as t_attn
from ray_tpu_torch.ops import flash_attention as t_flash
from ray_tpu_torch.ops import paged_attention as t_paged
from ray_tpu_torch.parallel import mesh as port_mesh

TOL = dict(rtol=1e-5, atol=1e-5)
BWD_TOL = dict(rtol=5e-5, atol=5e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs files in
    parallel workers, and tiny shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, err_msg="", **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               err_msg=err_msg, **(tol or TOL))


# ----------------------------------------------------------------- config
def test_config_mirror_equals_jax_configs():
    assert set(t_config.CONFIGS) == set(jax_llama.CONFIGS)
    for name, jc in jax_llama.CONFIGS.items():
        tc = t_config.CONFIGS[name]
        jf = dataclasses.asdict(jc)
        tf = dataclasses.asdict(tc)
        assert set(jf) == set(tf), name
        for field, jv in jf.items():
            tv = tf[field]
            if field in ("dtype", "param_dtype"):
                assert str(t_config.torch_dtype(tv)) \
                    == "torch." + jnp.dtype(jv).name, (name, field)
            else:
                assert jv == tv, (name, field, jv, tv)
        assert tc.head_dim_ == jc.head_dim_
        assert tc.num_params() == jc.num_params()
        assert tc.active_params() == jc.active_params()
    assert t_config.get_config("tiny", num_layers=3).num_layers == 3


# ------------------------------------------------------------ write/gather
def _pool_inputs(rng, *, b, hkv, d, page, num_pages, mp, s, starts, lens):
    perm = rng.permutation(num_pages - 1)[: b * mp] + 1
    bt = perm.reshape(b, mp).astype(np.int32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    pos = (np.asarray(starts)[:, None] + np.arange(s)).astype(np.int32)
    return bt, k, v, pos, np.asarray(lens, np.int32)


def test_paged_write_and_gather_match_jax_with_oob_padding():
    """Padding columns run past the block table (positions up to
    start + s - 1 > mp * page): JAX drops those writes, the port sends
    them to page 0. Pools agree on every page but page 0."""
    rng = np.random.default_rng(0)
    b, hkv, d, page, num_pages, mp = 3, 2, 8, 4, 32, 5
    s = 16
    bt, k, v, pos, lens = _pool_inputs(
        rng, b=b, hkv=hkv, d=d, page=page, num_pages=num_pages, mp=mp, s=s,
        starts=[0, 8, 12], lens=[13, 0, 20])
    jpool = jax_paged.paged_write(
        jax_paged.make_kv_pages(hkv, num_pages, page, d, jnp.float32),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt), jnp.asarray(pos),
        jnp.asarray(lens))
    tpool = t_paged.paged_write(
        t_paged.make_kv_pages(hkv, num_pages, page, d, torch.float32),
        _t(k), _t(v), _t(bt), _t(pos), _t(lens))
    np.testing.assert_array_equal(tpool[1:].numpy(), np.asarray(jpool)[1:])
    jk, jv = jax_paged.gather_kv(jpool, jnp.asarray(bt))
    tk, tv = t_paged.gather_kv(tpool, _t(bt))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _filled_pool(rng, *, b, hq, hkv, d, page, num_pages, mp, lengths):
    """A pool holding `lengths` tokens per row (written by the port's
    paged_write, itself held to JAX's above) and one query per row."""
    bt, k, v, pos, lens = _pool_inputs(
        rng, b=b, hkv=hkv, d=d, page=page, num_pages=num_pages, mp=mp,
        s=mp * page, starts=[0] * b, lens=lengths)
    pool = t_paged.paged_write(
        t_paged.make_kv_pages(hkv, num_pages, page, d, torch.float32),
        _t(k), _t(v), _t(bt), _t(pos), _t(lens))
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    return pool.numpy(), bt, lens, q


# ------------------------------------------------------------------ decode
@pytest.mark.parametrize("hq,hkv,interpret,d", [
    pytest.param(8, 2, True, 32, id="8-2-True"),
    pytest.param(4, 4, None, 32, id="4-4-None"),
    pytest.param(4, 4, True, 96, id="4-4-True-d96"),
    pytest.param(4, 2, True, 256, id="4-2-True-d256")])
def test_decode_plain_matches_jax(hq, hkv, interpret, d):
    """GQA and MHA, incl. an inactive (length 0) and a full row; the JAX
    side is the Pallas decode kernel in interpret mode (GQA, and the head
    dims 96 and 256 that K1 takes beside 32) or its jnp reference path
    (MHA)."""
    rng = np.random.default_rng(2)
    b, page, mp = 4, 4, 8
    lengths = [1, 13, 0, mp * page]
    pool, bt, lens, q = _filled_pool(rng, b=b, hq=hq, hkv=hkv, d=d,
                                     page=page, num_pages=64, mp=mp,
                                     lengths=lengths)
    want = np.asarray(jax.jit(functools.partial(
        jax_paged.paged_attention_decode, interpret=interpret))(
        jnp.asarray(q), jnp.asarray(pool), jnp.asarray(bt),
        jnp.asarray(lens)))
    got = t_paged.paged_attention_decode(_t(q), _t(pool), _t(bt), _t(lens))
    _close(got, want)
    np.testing.assert_array_equal(got[2].numpy(), 0.0)


def test_decode_plain_ignores_nan_outside_live_rows():
    """A recycled pool may hold NaN past a sequence's length: the plain
    version (like the kernel) zeroes dead rows before any product."""
    rng = np.random.default_rng(3)
    b, hq, hkv, d, page, mp = 3, 4, 2, 16, 4, 4
    lengths = [5, 0, 9]
    pool, bt, lens, q = _filled_pool(rng, b=b, hq=hq, hkv=hkv, d=d,
                                     page=page, num_pages=32, mp=mp,
                                     lengths=lengths)
    want = np.array(jax_paged.paged_attention_reference(
        jnp.asarray(q)[:, None], jnp.asarray(pool), jnp.asarray(bt),
        jnp.maximum(jnp.asarray(lens) - 1, 0)[:, None]))[:, 0]
    want[1] = 0.0
    dirty = pool.copy()
    for i, n in enumerate(lengths):  # poison every dead row of each table
        for pos in range(n, mp * page):
            dirty[bt[i, pos // page], :, pos % page] = np.nan
    got = t_paged.paged_attention_decode(_t(q), _t(dirty), _t(bt),
                                         _t(lens))
    assert torch.isfinite(got).all()
    _close(got, want)


# ------------------------------------------------------------------- flash
def _qkv(rng, sq, sk, hq=4, hkv=2, d=32, b=2):
    return (rng.standard_normal((b, sq, hq, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("case", ["causal_sq_lt_sk", "unaligned",
                                  "segment_tuple", "fully_masked_rows",
                                  "d96_segment_tuple",
                                  "d256_causal_sq_lt_sk",
                                  "sq1_gqa_long_sk",
                                  "sq1_segments_fully_masked"])
def test_flash_forward_with_lse_matches_jax_kernel(case):
    """The forward's contract against the Pallas kernel; the "sq1" cases
    are the one-token decode that K2's split-KV design takes on a card
    (GQA 8/2 over a kv axis of several splits; segment ids, one batch
    row's query matching no kv row: o = 0, lse = -1e30)."""
    rng = np.random.default_rng(4)
    segs, causal = None, True
    if case == "causal_sq_lt_sk":
        q, k, v = _qkv(rng, 20, 45)
    elif case == "sq1_gqa_long_sk":
        q, k, v = _qkv(rng, 1, 300, hq=8, hkv=2)
    elif case == "sq1_segments_fully_masked":
        q, k, v = _qkv(rng, 1, 100, hq=8, hkv=2)
        kv_seg = (np.arange(100)[None] >= np.array([[40], [0]])).astype(
            np.int32)
        segs = (np.array([[0], [0]], np.int32), kv_seg)
    elif case.startswith("d"):  # head dims 96 and 256 (the rest are D 32)
        q, k, v = _qkv(rng, 12, 30, d=int(case[1:].split("_")[0]))
        if case == "d96_segment_tuple":
            kv_seg = (np.arange(30)[None] >= np.array([[10], [20]])).astype(
                np.int32)
            segs = (kv_seg[:, -12:], kv_seg)
    elif case == "unaligned":
        q, k, v = _qkv(rng, 37, 37)
        causal = False
    elif case == "segment_tuple":
        q, k, v = _qkv(rng, 24, 70)
        kv_seg = (np.arange(70)[None] >= np.array([[30], [50]])).astype(
            np.int32)
        segs = (kv_seg[:, -24:], kv_seg)
    else:  # q rows of segment 2 match no kv row: o = 0, lse = -1e30
        q, k, v = _qkv(rng, 16, 40)
        causal = False
        q_seg = np.where(np.arange(16)[None] < 10, 1, 2).repeat(2, 0)
        segs = (q_seg.astype(np.int32), np.ones((2, 40), np.int32))
    jo, jl = jax_flash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        segment_ids=None if segs is None else tuple(map(jnp.asarray, segs)),
        interpret=True, return_lse=True)
    to, tl = t_flash.flash_attention(
        _t(q), _t(k), _t(v), causal=causal,
        segment_ids=None if segs is None else tuple(map(_t, segs)),
        return_lse=True)
    _close(to, jo)
    _close(tl, jl)
    if case == "fully_masked_rows":
        assert (to[:, 10:] == 0).all()
        assert (tl[:, 10:] == -1e30).all()
    if case == "sq1_segments_fully_masked":  # row 1: every kv id is 1
        assert (to[1] == 0).all() and (tl[1] == -1e30).all()
        assert (to[0] != 0).any()


def _bwd_case(case):
    """q, k, v, do, segment ids and causality of a backward case."""
    rng = np.random.default_rng(8)
    segs, causal = None, True
    if case == "gqa_causal":
        q, k, v = _qkv(rng, 40, 40, d=16)
    elif case.startswith("d"):  # head dims 96 and 256 (packed is D 32)
        q, k, v = _qkv(rng, 12, 12, d=int(case[1:].split("_")[0]))
        if case == "d96_packed_segments":
            seg = np.repeat(np.arange(2, dtype=np.int32), [5, 7])
            segs = np.stack([seg, np.sort(seg[::-1])])
    elif case == "sq_lt_sk":
        q, k, v = _qkv(rng, 24, 70, d=16)
    elif case == "packed_segments":
        q, k, v = _qkv(rng, 48, 48, d=32)
        seg = np.repeat(np.arange(3, dtype=np.int32), [20, 20, 8])
        segs = np.stack([seg, np.sort(seg[::-1])])
    else:  # q rows of segment 2 match no kv row: lse = -1e30, dq = 0
        q, k, v = _qkv(rng, 16, 40, d=16)
        causal = False
        q_seg = np.where(np.arange(16)[None] < 10, 1, 2).repeat(2, 0)
        segs = (q_seg.astype(np.int32), np.ones((2, 40), np.int32))
    do = rng.standard_normal(q.shape).astype(np.float32)
    return q, k, v, do, segs, causal


def _split(segs, sq, sk):
    return t_attn.split_segment_ids(
        None if segs is None else (tuple(map(_t, segs)) if isinstance(
            segs, tuple) else _t(segs)), sq, sk)


@pytest.mark.parametrize("case", ["gqa_causal", "sq_lt_sk",
                                  "packed_segments", "fully_masked_row",
                                  "d96_packed_segments", "d256_gqa_causal"])
def test_flash_backward_plain_matches_jax_pallas_backward(case):
    """``flash_attention_bwd_plain`` against ``jax.vjp`` of the JAX
    ``flash_attention``, whose backward is the Pallas K3/K4 in interpret
    mode, on the same cotangent."""
    q, k, v, do, segs, causal = _bwd_case(case)
    jsegs = (None if segs is None else tuple(map(jnp.asarray, segs))
             if isinstance(segs, tuple) else jnp.asarray(segs))
    _, vjp = jax.vjp(functools.partial(
        jax_flash.flash_attention, causal=causal, segment_ids=jsegs,
        interpret=True), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    q_seg, kv_seg = _split(segs, q.shape[1], k.shape[1])
    o, lse = t_flash.flash_attention_plain(
        _t(q), _t(k), _t(v), causal=causal, q_seg=q_seg, kv_seg=kv_seg,
        scale=q.shape[-1] ** -0.5)
    got = t_flash.flash_attention_bwd_plain(
        _t(q), _t(k), _t(v), o, lse, _t(do), causal=causal, q_seg=q_seg,
        kv_seg=kv_seg, scale=q.shape[-1] ** -0.5)
    for g, w, name in zip(got, want, "qkv"):
        _close(g, w, err_msg=f"d{name}", **BWD_TOL)
    if case == "fully_masked_row":
        assert (got[0][:, 10:] == 0).all()


@pytest.mark.parametrize("case", ["gqa_causal", "packed_segments"])
def test_flash_autograd_matches_reference_autograd(case):
    """The autograd Function (plain forward and backward on the CPU)
    against torch autograd through ``reference_attention``."""
    q, k, v, do, segs, causal = _bwd_case(case)
    seg_t = None if segs is None else _t(segs)
    grads = []
    for fn in (t_flash.flash_attention, t_attn.reference_attention):
        x = [_t(a).requires_grad_() for a in (q, k, v)]
        fn(*x, causal=causal, segment_ids=seg_t).backward(_t(do))
        grads.append([a.grad for a in x])
    for g, w in zip(*grads):
        _close(g, w)


def test_attention_dispatcher():
    rng = np.random.default_rng(9)
    q, k, v = (_t(a) for a in _qkv(rng, 12, 12))
    want = t_attn.reference_attention(q, k, v, causal=True)
    for impl in (None, "flash", "reference"):
        _close(t_attn.attention(q, k, v, causal=True, impl=impl), want)
    # sequence-parallel attention with no sp mesh: a warning (once), then
    # dense attention, as in JAX; on an sp mesh a (q_seg, kv_seg) pair is
    # refused with JAX's error (raised before any collective: a stand-in
    # mesh of the right sizes will do)
    sp_mesh = type("SpMesh", (), {"mesh_dim_names": port_mesh.AXES,
                                  "shape": (1, 1, 1, 2, 1, 1)})()
    jax_sp_mesh = jax_mesh.create_mesh(jax_mesh.MeshConfig(sp=2, fsdp=1),
                                       devices=jax.devices()[:2])
    pair = (np.zeros((2, 12), np.int32),) * 2
    for impl in ("ring", "ulysses"):
        t_attn._warned.clear()
        with pytest.warns(UserWarning, match="running dense attention"):
            _close(t_attn.attention(q, k, v, causal=True, impl=impl), want)
        with pytest.raises(NotImplementedError) as jax_err, \
                jax_mesh.active_mesh(jax_sp_mesh):
            jax_attn.attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                               segment_ids=tuple(map(jnp.asarray, pair)),
                               impl=impl)
        with pytest.raises(NotImplementedError) as err, \
                port_mesh.active_mesh(sp_mesh):
            t_attn.attention(q, k, v, segment_ids=tuple(map(_t, pair)),
                             impl=impl)
        assert str(err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="unknown"):
        t_attn.attention(q, k, v, impl="splash")


def test_reference_attention_matches_jax():
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, 12, 12)
    segs = np.repeat(np.arange(3, dtype=np.int32), 4)[None].repeat(2, 0)
    for causal in (True, False):
        want = jax_attn.reference_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            segment_ids=jnp.asarray(segs))
        got = t_attn.reference_attention(_t(q), _t(k), _t(v), causal=causal,
                                         segment_ids=_t(segs))
        _close(got, want)


# ----------------------------------------------------------------- prefill
@pytest.mark.parametrize("ctx_lens", [(0, 0), (8, 0), (8, 16)])
def test_paged_prefill_matches_jax(ctx_lens):
    """New tokens starting at a page-aligned cached prefix attend to the
    prefix and themselves; with and without the ctx part."""
    rng = np.random.default_rng(6)
    b, hq, hkv, d, page, mp, s_new = 2, 4, 2, 16, 8, 6, 12
    lengths = [c + s_new for c in ctx_lens]
    pool, bt, lens, _ = _filled_pool(rng, b=b, hq=hq, hkv=hkv, d=d,
                                     page=page, num_pages=32, mp=mp,
                                     lengths=lengths)
    pos = np.stack([np.arange(c, c + s_new) for c in ctx_lens]).astype(
        np.int32)
    q = rng.standard_normal((b, s_new, hq, d)).astype(np.float32)
    k_all, v_all = (np.asarray(x) for x in jax_paged.gather_kv(
        jnp.asarray(pool), jnp.asarray(bt)))
    k_new = np.stack([k_all[i, c:c + s_new] for i, c in enumerate(ctx_lens)])
    v_new = np.stack([v_all[i, c:c + s_new] for i, c in enumerate(ctx_lens)])
    jax_prefill = jax.jit(jax_paged.paged_prefill_attention,
                          static_argnames=("ctx_pages", "impl"))
    for ctx_pages in ((mp, 0) if max(ctx_lens) == 0 else (mp,)):
        want = jax_prefill(
            jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
            jnp.asarray(pool), jnp.asarray(bt), jnp.asarray(pos),
            jnp.asarray(lens), ctx_pages=ctx_pages, impl="reference")
        got = t_paged.paged_prefill_attention(
            _t(q), _t(k_new), _t(v_new), _t(pool), _t(bt), _t(pos),
            _t(lens), ctx_pages=ctx_pages)
        _close(got, want)
    oracle = t_paged.paged_attention_reference(_t(q), _t(pool), _t(bt),
                                               _t(pos))
    _close(got, oracle.numpy(), rtol=2e-5, atol=2e-5)


def test_merge_attention_matches_jax_and_joint_softmax():
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 4, 10, hq=3, hkv=3, d=8)
    parts = []
    for lo, hi in ((0, 6), (6, 10)):
        parts += list(t_flash.flash_attention(
            _t(q), _t(k[:, lo:hi]), _t(v[:, lo:hi]), causal=False,
            return_lse=True))
    got = t_paged.merge_attention(*parts)
    want = jax_paged.merge_attention(*(jnp.asarray(p.numpy())
                                       for p in parts))
    _close(got, want)
    joint = t_attn.reference_attention(_t(q), _t(k), _t(v), causal=False)
    _close(got, joint.numpy())
