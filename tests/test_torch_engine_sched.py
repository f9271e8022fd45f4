"""ray_tpu_torch's Serve-LLM engine, the parts past the legacy scheduler:
chunked prefill and prefix-aware admission (scheduler v2), prompt-lookup
speculative decoding, request deadlines, the P/D KV handoff (within the
port and across the two packages), warmup and measure_prefill, plus the
paged prefill op at a first position that is not a page multiple and the
head-dim refusal of a CUDA engine or trainer.

Each JAX test of ``tests/test_llm_serve.py`` and
``tests/test_serve_admission.py`` that these mirror is cited by line.
Engines run on the CPU (device="cpu") in float32 on the tiny config of
``benchmarks/sharded_serve.py``; greedy tokens must match the JAX
engine's exactly. One JAX engine serves the whole file (a module
fixture, given the port's seeded parameters as a Flax tree, so no Flax
init is compiled): its compiled functions depend only on shapes, so each
mode is set on its config between runs, with a drained pipeline and a
fresh page allocator (no prefix-cache hit from an earlier run). Prompts
stay within the buckets those runs compile.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.sharded_serve import ENGINE_CFG, parity_prompts
from ray_tpu.ops.paged_attention import \
    paged_prefill_attention as jax_paged_prefill
from ray_tpu.serve.llm import EngineConfig as JaxEngineConfig
from ray_tpu.serve.llm import LLMEngine as JaxLLMEngine
from ray_tpu.serve.llm import SamplingParams as JaxSamplingParams
from ray_tpu.serve.llm.engine import Request as JaxRequest
from ray_tpu_torch.models.config import get_config
from ray_tpu_torch.models.convert import _LAYER_LEAVES, init_params
from ray_tpu_torch.models.llama import LlamaModel
from ray_tpu_torch.ops.paged_attention import (check_kernel_head_dim,
                                               paged_prefill_attention,
                                               paged_write)
from ray_tpu_torch.parallel.train_lib import ShardedTrainer
from ray_tpu_torch.serve.llm import (EngineConfig, LLMEngine, PageAllocator,
                                     Request, SamplingParams)
from ray_tpu_torch.serve.llm.engine import FINISHED, RUNNING

CPU_CFG = dict(ENGINE_CFG, device="cpu")
CHUNK, SPEC = 16, 4
# with two dispatches in flight a batched slot never has its whole tail
# on the host, so it is never drafted for: the speculative modes run one
# dispatch deep, where every greedy slot may draft at every step
MODES = {"chunked": dict(prefill_chunk_tokens=CHUNK),
         "spec": dict(spec_lookahead=SPEC, pipeline_depth=1),
         "both": dict(prefill_chunk_tokens=CHUNK, spec_lookahead=SPEC,
                      pipeline_depth=1)}
# parity_prompts() and a prompt that repeats a pattern, whose drafts come
# from the prompt itself
PROMPTS = {**{f"g{i}": p for i, p in enumerate(parity_prompts())},
           "pattern": [5, 6, 7, 8] * 4}
HANDOFF_PROMPT = list(range(1, 31))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs files in
    parallel workers, and tiny shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    """Seeded float32 parameters of the tiny config, as a state dict."""
    cfg = get_config("tiny", **ENGINE_CFG["model_overrides"])
    return init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                       torch.float32)


def _flax_tree(sd, num_layers):
    """The inverse of ``params_from_flax``: a state dict as the Flax tree
    of the JAX engine (layers stacked, kernels [in, out])."""
    def leaf(t, transpose):
        return jnp.asarray((t.T if transpose else t).numpy())

    tree = {"embed": leaf(sd["embed"], False),
            "final_norm": {"scale": leaf(sd["final_norm.scale"], False)},
            "lm_head": {"kernel": leaf(sd["lm_head.weight"], True)},
            "layers": {"layer": {}}}
    for path, (name, transpose) in _LAYER_LEAVES.items():
        node = tree["layers"]["layer"]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = jnp.stack([leaf(sd[f"layers.{i}.{name}"], transpose)
                                    for i in range(num_layers)])
    return tree


@pytest.fixture(scope="module")
def jax_engine(params):
    cfg = JaxEngineConfig(**ENGINE_CFG)
    return JaxLLMEngine(cfg, params=_flax_tree(params, 2))


def _jax_collect(engine, prompts, max_tokens):
    """{rid: prompt} through a JAX engine, greedy, to completion."""
    for rid, p in prompts.items():
        engine.add_request(rid, p, JaxSamplingParams(max_tokens=max_tokens))
    return _ids(_drain(engine))


def _jax_mode(engine, **mode):
    """Idle the shared JAX engine and give it `mode`'s config and an
    empty prefix cache."""
    while engine.has_work():
        engine.step()
    engine.config = JaxEngineConfig(**ENGINE_CFG, **mode)
    engine.allocator = type(engine.allocator)(ENGINE_CFG["num_pages"],
                                              ENGINE_CFG["page_size"])
    return engine


def _port(params, **overrides):
    return LLMEngine(EngineConfig(**dict(CPU_CFG, **overrides)),
                     params=params)


def _run(engine, prompts, sampling=None, max_steps=900):
    """Run {rid: prompt} to completion; returns {rid: {"ids", "fin"}}.
    Each request gets its own copy of `sampling` (preemption edits it)."""
    for rid, p in prompts.items():
        sp = dataclasses.replace(sampling) if sampling else \
            SamplingParams(max_tokens=8)
        engine.add_request(rid, p, sp)
    out = {rid: {"ids": [], "fin": None} for rid in prompts}
    for _ in range(max_steps):
        for d in engine.step():
            out[d.request_id]["ids"].extend(d.new_token_ids)
            if d.finished:
                out[d.request_id]["fin"] = d.finish_reason
        if all(r["fin"] for r in out.values()):
            return out
    raise AssertionError(f"unfinished after {max_steps} steps: {out}")


def _drain(engine, max_steps=900):
    """Step until the engine has no work; returns {rid: {"ids", "fin"}}
    of every delta on the way (injected requests included)."""
    out = {}
    for _ in range(max_steps):
        if not engine.has_work():
            return out
        for d in engine.step():
            rec = out.setdefault(d.request_id, {"ids": [], "fin": None})
            rec["ids"].extend(d.new_token_ids)
            if d.finished:
                rec["fin"] = d.finish_reason
    raise AssertionError(f"still working after {max_steps} steps: {out}")


def _ids(out):
    return {rid: r["ids"] for rid, r in out.items()}


def _prompts(seed, lengths, vocab=500):
    rng = np.random.default_rng(seed)
    return {f"r{i}": [int(t) for t in rng.integers(0, vocab, n)]
            for i, n in enumerate(lengths)}


# ------------------------------------------- parity with the JAX engine

@pytest.mark.parametrize("mode", sorted(MODES))
def test_modes_greedy_identical_to_jax_engine(jax_engine, params, mode):
    """parity_prompts() (and a repeating prompt) through the JAX engine
    and the port with the same prefill_chunk_tokens / spec_lookahead:
    identical greedy tokens, equal to the port's plain greedy decode; in
    the speculative modes both engines draft and accept the same
    numbers of tokens."""
    keys = ("spec_drafted_total", "spec_accepted_total")
    before = {k: jax_engine.stats()[k] for k in keys}
    want = _jax_collect(_jax_mode(jax_engine, **MODES[mode]), PROMPTS, 8)
    engine = _port(params, **MODES[mode])
    got = _ids(_run(engine, PROMPTS))
    plain = _ids(_run(_port(params), PROMPTS))
    assert got == want == plain
    if "spec_lookahead" in MODES[mode]:
        st, jst = engine.stats(), jax_engine.stats()
        assert st["spec_accepted_total"] > 0
        for key in keys:
            assert st[key] == jst[key] - before[key], key


def test_chunked_prefill_matches_unchunked():
    """test_llm_serve.py:457: chunked prefill (later chunks attend to the
    earlier chunks' pages through the ctx part) gives the whole-prompt
    scheduler's greedy tokens."""
    cfg = dict(prefill_buckets=(16, 32, 64, 128))
    prompts = _prompts(5, (70, 9, 33, 100))
    sp = SamplingParams(max_tokens=5)
    ref = _run(_port(None, **cfg), prompts, sp)
    chunked = _port(None, **cfg, prefill_chunk_tokens=CHUNK)
    out = _run(chunked, prompts, sp)
    assert out == ref


def test_chunked_prefill_interleave_bounds_itl():
    """test_llm_serve.py:479, counted in engine steps and prompt tokens
    instead of wall time: while a 250-token prompt prefills, a running
    request still gets a token every step, and the prompt tokens the
    engine dispatches between two of its tokens are one chunk with
    chunking on and the whole prompt with it off."""
    cfg = dict(num_pages=96, max_model_len=256,
               prefill_buckets=(16, 32, 64, 128, 256))
    long_prompt = [int(t) for t in
                   np.random.default_rng(8).integers(0, 500, 250)]

    def run(chunk):
        engine = _port(None, **cfg, prefill_chunk_tokens=chunk)
        dispatched = [0]
        compute = engine._compute_prefill

        def counting(rb, cp, bt, total, ids, positions, *rest):
            dispatched[0] += int((total - positions[:, 0]).clip(0).sum())
            return compute(rb, cp, bt, total, ids, positions, *rest)

        engine._compute_prefill = counting
        engine.add_request("fg", [1, 2, 3, 4, 5, 6, 7, 8],
                           SamplingParams(max_tokens=120))
        while ("fg" not in engine.requests
               or not engine.requests["fg"].decode_ready):
            engine.step()
        for _ in range(3):
            engine.step()
        engine.add_request("long", long_prompt, SamplingParams(max_tokens=4))
        gaps, step_gaps, last, steps = [], [], dispatched[0], 0
        for _ in range(100):
            deltas = engine.step()
            steps += 1
            if any(d.request_id == "fg" for d in deltas):
                gaps.append(dispatched[0] - last)
                step_gaps.append(steps)
                last, steps = dispatched[0], 0
            if any(d.request_id == "long" and d.new_token_ids
                   for d in deltas):
                break
        return max(gaps), max(step_gaps)

    gap_off, _ = run(0)
    gap_on, step_gap_on = run(32)
    assert gap_off >= len(long_prompt)
    assert 0 < gap_on <= 32
    assert step_gap_on <= 2


@pytest.mark.parametrize("chunk", [0, CHUNK])
def test_preemption_token_identical_after_readmission(chunk):
    """test_llm_serve.py:538, in both scheduler modes: page pressure
    preempts, re-admission recomputes, and the tokens equal each request
    served alone; every page comes back."""
    cfg = dict(num_pages=12, max_model_len=64, max_batch=2,
               prefill_buckets=(16, 32, 64), prefill_chunk_tokens=chunk)
    prompts = _prompts(4, (17, 17))
    sp = SamplingParams(max_tokens=40)
    solo = {}
    for rid, p in prompts.items():
        solo.update(_run(_port(None, **cfg), {rid: p}, sp))
    engine = _port(None, **cfg)
    out = _run(engine, prompts, sp)
    assert engine.stats()["preempted_total"] >= 1
    assert _ids(out) == _ids(solo)
    assert engine.allocator.num_free() == cfg["num_pages"] - 1


@pytest.mark.parametrize("chunk", [CHUNK, 0])
def test_prefix_aware_coadmission_skips_blocked_head(chunk):
    """test_llm_serve.py:565: in scheduler v2 a waiting request whose
    prefix is cached admits AHEAD of a page-blocked queue head; with
    prefill_chunk_tokens == 0 admission stays strict FIFO."""
    cfg = dict(num_pages=12, max_model_len=128, max_batch=3,
               prefill_buckets=(16, 32, 64, 128), prefill_chunk_tokens=chunk)
    engine = _port(None, **cfg)
    shared = [int(t) for t in np.random.default_rng(6).integers(0, 500, 16)]
    _run(engine, {"warm": shared + [9]}, SamplingParams(max_tokens=1))
    assert engine.allocator.cached_prefix_pages(shared + [11]) == 2
    engine.add_request("hog", [int(t) for t in np.random.default_rng(7)
                               .integers(0, 500, 33)],
                       SamplingParams(max_tokens=24))
    while ("hog" not in engine.requests
           or not engine.requests["hog"].decode_ready):
        engine.step()
    stranger = [int(t) for t in np.random.default_rng(9).integers(0, 500, 60)]
    engine.add_request("stranger", stranger, SamplingParams(max_tokens=4))
    engine.add_request("sharer", shared + [11], SamplingParams(max_tokens=4))
    first_seen = []
    for _ in range(600):
        for d in engine.step():
            if d.new_token_ids and d.request_id not in first_seen:
                first_seen.append(d.request_id)
        if {"stranger", "sharer"} <= set(first_seen):
            break
    sharer_first = first_seen.index("sharer") < first_seen.index("stranger")
    assert sharer_first == bool(chunk)


# ------------------------------------------------ speculative decoding

@pytest.mark.parametrize("drafts", ["oracle", "hostile"])
def test_spec_decode_oracle_and_adversarial_drafts(drafts):
    """test_llm_serve.py:607: verification is bit-exact by construction.
    Perfect drafts accept wholesale (fewer steps than tokens), hostile
    drafts reject wholesale; the tokens are plain greedy's either way."""
    cfg = dict(num_pages=96, max_model_len=256)
    prompt = [int(t) for t in np.random.default_rng(3).integers(0, 500, 24)]
    sp = SamplingParams(max_tokens=24)
    truth = _run(_port(None, **cfg), {"r": prompt}, sp)["r"]

    engine = _port(None, **cfg, spec_lookahead=7)
    if drafts == "oracle":
        engine._prompt_lookup_draft = lambda req, max_len: \
            truth["ids"][len(req.output_ids):len(req.output_ids) + max_len]
    else:
        engine._prompt_lookup_draft = lambda req, max_len: \
            [(truth["ids"][len(req.output_ids)] + 1) % 512] * min(max_len, 4)
    engine.add_request("r", prompt, dataclasses.replace(sp))
    done = {"ids": [], "fin": None}
    steps = 0
    while engine.has_work():
        steps += 1
        for d in engine.step():
            done["ids"].extend(d.new_token_ids)
            done["fin"] = d.finish_reason if d.finished else done["fin"]
    assert done == truth
    st = engine.stats()
    assert st["spec_drafted_total"] > 0
    if drafts == "oracle":
        assert st["spec_accepted_total"] == st["spec_drafted_total"]
        assert steps < 24
    else:
        assert st["spec_accepted_total"] == 0


def test_prompt_lookup_draft_unit():
    """test_llm_serve.py:650, and the JAX engine's drafts on the same
    sequences."""
    cases = [([1, 2, 3, 9, 1, 2, 3], [], 4, [9, 1, 2, 3]),
             ([5, 6], [7, 5, 6], 2, [7, 5]),
             ([1, 2, 3, 4, 5, 6], [], 4, [])]
    for prompt, output, n, want in cases:
        req = Request("x", prompt, SamplingParams())
        req.output_ids = list(output)
        jreq = JaxRequest("x", prompt, JaxSamplingParams())
        jreq.output_ids = list(output)
        assert LLMEngine._prompt_lookup_draft(req, n) == want
        assert JaxLLMEngine._prompt_lookup_draft(jreq, n) == want


# ----------------------------------------------------------- deadlines

def test_running_request_expires_mid_decode():
    """test_llm_serve.py:667: a RUNNING request whose deadline passes
    mid-decode finishes "expired" at the next step; its slot and pages
    come back. The deadline is moved into the past once tokens flow, so
    the test does not race the clock."""
    engine = _port(None)
    engine.add_request("d", [1, 2, 3, 4, 5], SamplingParams(max_tokens=100),
                       deadline=time.time() + 60)
    got, fin = 0, None
    for _ in range(200):
        if got >= 3 and "d" in engine.requests:
            engine.requests["d"].deadline_mono = time.monotonic() - 1e-3
        for d in engine.step():
            got += len(d.new_token_ids)
            fin = d.finish_reason if d.finished else fin
        if fin:
            break
    assert fin == "expired"
    assert 3 <= got < 100
    assert engine.stats()["expired_total"] == 1
    assert engine.allocator.num_free() == ENGINE_CFG["num_pages"] - 1
    assert not engine.running and not engine.waiting
    while engine.has_work():  # in-flight chunks of "d" are dropped
        assert not engine.step()


def test_engine_prunes_expired_waiting():
    """test_serve_admission.py:125, on queue bookkeeping alone."""
    eng = LLMEngine.__new__(LLMEngine)
    eng._expired_total = 0
    expired = Request("dead", [1, 2, 3], SamplingParams())
    expired.deadline_mono = time.monotonic() - 0.5
    alive = Request("alive", [1, 2, 3], SamplingParams())
    alive.deadline_mono = time.monotonic() + 60.0
    no_deadline = Request("nodl", [1, 2, 3], SamplingParams())
    eng.waiting = [expired, alive, no_deadline]
    eng.requests = {r.request_id: r for r in eng.waiting}
    deltas = []
    eng._prune_expired_waiting(deltas)
    assert [r.request_id for r in eng.waiting] == ["alive", "nodl"]
    assert expired.state == FINISHED and expired.finish_reason == "expired"
    assert "dead" not in eng.requests and eng._expired_total == 1
    assert len(deltas) == 1 and deltas[0].request_id == "dead"
    assert deltas[0].finished and deltas[0].finish_reason == "expired"
    eng._prune_expired_waiting(deltas)
    assert len(deltas) == 1 and len(eng.waiting) == 2


def test_engine_prunes_expired_running():
    """test_serve_admission.py:158: slot and pages freed, typed delta,
    stale pending token dropped, counted in expired_total."""
    eng = LLMEngine.__new__(LLMEngine)
    eng._expired_total = 0
    eng.allocator = PageAllocator(num_pages=8, page_size=4)
    eng.waiting = []
    eng._free_slots = [1]
    eng._slot_override = {0: 7}
    dead = Request("dead", [1, 2, 3], SamplingParams())
    dead.state, dead.slot = RUNNING, 0
    dead.pages = eng.allocator.allocate(2)
    dead.deadline_mono = time.monotonic() - 0.5
    alive = Request("alive", [1, 2, 3], SamplingParams())
    alive.state, alive.slot = RUNNING, 2
    alive.deadline_mono = time.monotonic() + 60.0
    eng.running = [dead, alive]
    eng._slot_req = {0: dead, 2: alive}
    eng.requests = {r.request_id: r for r in eng.running}
    deltas = []
    eng._prune_expired_running(deltas)
    assert [r.request_id for r in eng.running] == ["alive"]
    assert dead.state == FINISHED and dead.finish_reason == "expired"
    assert dead.slot == -1 and dead.pages == []
    assert eng.allocator.num_free() == 7
    assert sorted(eng._free_slots) == [0, 1]
    assert 0 not in eng._slot_override and 0 not in eng._slot_req
    assert eng._expired_total == 1 and "dead" not in eng.requests
    assert len(deltas) == 1 and deltas[0].finish_reason == "expired"
    eng._prune_expired_running(deltas)
    assert len(deltas) == 1 and len(eng.running) == 1


def test_engine_add_request_deadline_conversion():
    """test_serve_admission.py:205: the wall-clock deadline becomes a
    monotonic one."""
    eng = LLMEngine.__new__(LLMEngine)
    eng.config = EngineConfig(max_model_len=512)
    eng._intake = []
    eng._intake_lock = threading.Lock()
    eng.add_request("r1", [1, 2, 3], deadline=time.time() + 5.0)
    eng.add_request("r2", [1, 2, 3])
    r1, r2 = eng._intake
    assert 4.0 < r1.deadline_mono - time.monotonic() < 5.5
    assert r2.deadline_mono is None


# ------------------------------------------------------ P/D KV handoff

def _prefill_only(engine, prompts, max_tokens=8):
    """Serve {rid: prompt} with prefill_only on either package's engine;
    returns {rid: (first token, popped blob)}."""
    sp_cls = JaxSamplingParams if isinstance(engine, JaxLLMEngine) \
        else SamplingParams
    for rid, p in prompts.items():
        engine.add_request(rid, p, sp_cls(max_tokens=max_tokens,
                                          prefill_only=True))
    out = _drain(engine)
    assert {rid: r["fin"] for rid, r in out.items()} == \
        dict.fromkeys(prompts, "prefill_done")
    return {rid: (out[rid]["ids"], engine.pop_extracted(rid))
            for rid in prompts}


def test_pd_handoff_matches_single_engine(params):
    """test_llm_serve.py:242: extract_kv -> release -> inject -> decode
    reproduces one engine's greedy tokens; so does the prefill_only /
    pop_extracted path."""
    sp = SamplingParams(max_tokens=12)
    ref = _run(_port(params), {"ref": HANDOFF_PROMPT}, sp)["ref"]["ids"]

    prefill, decode = _port(params), _port(params)
    prefill.add_request("r", HANDOFF_PROMPT, dataclasses.replace(sp))
    first = []
    while not first:
        for d in prefill.step():
            first.extend(d.new_token_ids)
    blob = prefill.extract_kv("r")
    prefill.release_request("r")
    assert prefill.allocator.num_free() == ENGINE_CFG["num_pages"] - 1
    decode.inject_request("r2", blob, dataclasses.replace(sp))
    assert first + _drain(decode)["r2"]["ids"] == ref

    (first, blob), = _prefill_only(_port(params), {"p": HANDOFF_PROMPT},
                                   12).values()
    assert set(blob) == {"kv", "prompt_ids", "output_ids", "queued_s",
                         "prefill_s"}
    decode.inject_request("p2", blob, dataclasses.replace(sp))
    assert first + _drain(decode)["p2"]["ids"] == ref


def test_pd_prefill_respects_stop_on_first_token():
    """test_llm_serve.py:331: a first token that terminates finishes at
    the prefill engine with its real reason; nothing is stashed."""
    engine = _port(None)
    engine.add_request("r", [1, 2, 3, 4, 5],
                       SamplingParams(max_tokens=1, prefill_only=True))
    assert _drain(engine)["r"]["fin"] == "length"
    assert "r" not in engine.extracted
    assert engine.allocator.num_free() == ENGINE_CFG["num_pages"] - 1


PARITY = {f"g{i}": p for i, p in enumerate(parity_prompts())}


@pytest.fixture(scope="module")
def jax_handoff(jax_engine):
    """The JAX engine's greedy tokens for parity_prompts(), and the blobs
    of its prefill_only run of the same prompts (chunked mode, whose
    shapes the parity runs compile)."""
    mode = MODES["chunked"]
    want = _jax_collect(_jax_mode(jax_engine, **mode), PARITY, 8)
    blobs = _prefill_only(_jax_mode(jax_engine, **mode), PARITY)
    return want, blobs


def _decode_blobs(engine, blobs, sampling):
    """Inject {rid: (first token, blob)} into `engine` and decode them
    to the end; returns {rid: first token + decoded tokens}."""
    for rid, (_, blob) in blobs.items():
        engine.inject_request(rid, blob, sampling)
    out = _drain(engine)
    return {rid: first + out[rid]["ids"] for rid, (first, _) in
            blobs.items()}


def test_handoff_jax_prefill_to_torch_decode(params, jax_handoff):
    """JAX prefill_only blobs of parity_prompts(), unchanged, inject into
    the port and decode the single JAX engine's greedy tokens (f32)."""
    want, blobs = jax_handoff
    assert all(b["kv"].dtype == np.float32 for _, b in blobs.values())
    got = _decode_blobs(_port(params), blobs, SamplingParams(max_tokens=8))
    assert got == want


def test_handoff_torch_prefill_to_jax_decode(jax_engine, params,
                                             jax_handoff):
    """The reverse: the port's float32 blobs inject into the JAX engine
    and decode the single JAX engine's greedy tokens."""
    blobs = _prefill_only(_port(params), PARITY)
    assert all(b["kv"].dtype == np.float32 for _, b in blobs.values())
    got = _decode_blobs(_jax_mode(jax_engine, **MODES["chunked"]), blobs,
                        JaxSamplingParams(max_tokens=8))
    assert got == jax_handoff[0]


def test_handoff_jax_bf16_blob_injects_bit_for_bit(jax_handoff):
    """A JAX bf16 blob injects into a bf16 port engine without ml_dtypes:
    the pool's pages equal the blob bit for bit, and the port's own bf16
    blob carries the same values widened exactly to float32. The blob is
    the JAX f32 blob with its pages cast by JAX to bfloat16: the numpy
    array of ml_dtypes.bfloat16 a bf16 JAX engine's blob holds."""
    blob = dict(jax_handoff[1]["g2"][1])
    blob["kv"] = np.asarray(jnp.asarray(blob["kv"], jnp.bfloat16))
    assert blob["kv"].dtype.name == "bfloat16"
    engine = LLMEngine(EngineConfig(**dict(CPU_CFG, dtype="bfloat16")))
    engine.inject_request("t", blob, SamplingParams(max_tokens=4))
    assert engine._try_admit_injection([])  # the scatter, before decode
    pages = engine.requests["t"].pages
    got = engine.kv_pages[:, pages].view(torch.int16).numpy()
    np.testing.assert_array_equal(got, blob["kv"].view(np.int16))
    own = engine.extract_kv("t")
    assert own["kv_dtype"] == "bfloat16" and own["kv"].dtype == np.float32
    np.testing.assert_array_equal(
        torch.from_numpy(own["kv"]).to(torch.bfloat16).view(torch.int16)
        .numpy(), got)
    np.testing.assert_array_equal(own["kv"],
                                  blob["kv"].astype(np.float32))


def test_handoff_torch_bf16_blob_injects_into_jax_bit_for_bit(params):
    """A bf16 port engine's prefill_only blob injects into a bf16 JAX
    engine: JAX's cast of the widened values to its pool's bfloat16
    leaves its pages bit-identical to the port's."""
    engine = _port(params, dtype="bfloat16")
    (_, blob), = _prefill_only(engine, {"p": HANDOFF_PROMPT}).values()
    assert blob["kv_dtype"] == "bfloat16" and blob["kv"].dtype == np.float32
    sent = torch.from_numpy(blob["kv"]).to(torch.bfloat16)
    assert torch.equal(sent.float(), torch.from_numpy(blob["kv"]))
    jax_engine = JaxLLMEngine(JaxEngineConfig(**dict(ENGINE_CFG,
                                                     dtype="bfloat16")),
                              params=_flax_tree(params, 2))
    jax_engine.inject_request("p", blob, JaxSamplingParams(max_tokens=4))
    assert jax_engine._try_admit_injection([])  # the scatter alone
    pages = np.asarray(jax_engine.requests["p"].pages)
    got = np.asarray(jax_engine.kv_pages[:, pages])
    assert got.dtype.name == "bfloat16"
    np.testing.assert_array_equal(got.view(np.int16),
                                  sent.view(torch.int16).numpy())


@pytest.mark.parametrize("how", ["ttl", "cap", "abort"])
def test_unclaimed_blobs_are_dropped(how):
    """Unclaimed prefill blobs go after the TTL, past the count cap, or
    when the request is aborted; pop_extracted then raises KeyError."""
    engine = _port(None)
    if how == "cap":
        engine.extracted_max = 1
    _prefill_only(engine, {"keep": [1, 2, 3, 4, 5]})  # popped: none left
    for rid in ("a", "b"):  # stashed in this order, in one harvest
        engine.add_request(rid, [7, 8, 9, 1],
                           SamplingParams(max_tokens=4, prefill_only=True))
    assert {rid: r["fin"] for rid, r in _drain(engine).items()} == \
        {"a": "prefill_done", "b": "prefill_done"}
    if how == "ttl":
        engine.extracted_ttl_s = 0.0
        engine._evict_extracted()
        gone = ["a", "b"]
    elif how == "cap":
        gone = ["a"]  # the older one, evicted when "b" was stashed
    else:
        engine.abort("a")
        gone = ["a"]
    for rid in ("a", "b"):
        if rid in gone:
            with pytest.raises(KeyError, match="unavailable"):
                engine.pop_extracted(rid)
        else:
            assert engine.pop_extracted(rid)["prompt_ids"] == [7, 8, 9, 1]
    assert not engine.extracted and not engine._extracted_order


# ------------------------------------------- warmup and measure_prefill

@pytest.mark.parametrize("kwargs,mode", [
    (dict(prompt_buckets=(16,)), "both"),
    (dict(prompt_buckets=()), "chunked"),
    (dict(prompt_buckets=(16,), include_decode=False), "spec")])
def test_warmup_counts_like_jax_and_leaves_state(jax_engine, params,
                                                 kwargs, mode):
    """warmup() runs the JAX engine's count of shapes, and leaves pages
    1:, the decode carry and the allocator as they were."""
    want = _jax_mode(jax_engine, **MODES[mode]).warmup(**kwargs)
    engine = _port(params, **MODES[mode])
    _run(engine, {"a": [1, 2, 3, 1, 2, 3, 1, 2], "b": list(range(30))},
         SamplingParams(max_tokens=6))
    pages = engine.kv_pages[:, 1:].clone()
    slots = engine.slot_ids.clone()
    alloc = (dict(engine.allocator.stats), engine.allocator.num_free())
    assert pages.abs().sum() > 0
    assert engine.warmup(**kwargs) == want
    assert torch.equal(engine.kv_pages[:, 1:], pages)
    assert torch.equal(engine.slot_ids, slots)
    assert (dict(engine.allocator.stats),
            engine.allocator.num_free()) == alloc


def test_measure_prefill_keys_match_jax(jax_engine, params):
    kw = dict(seq_len=16, iters=2, peak_flops=1e12)
    want = _jax_mode(jax_engine).measure_prefill(**kw)
    got = _port(params).measure_prefill(**kw)
    assert set(got) == set(want)
    for key in ("seq_len", "rows", "iters"):
        assert got[key] == want[key], key


# ------------------------------------ ops and the head-dim refusal

@pytest.mark.parametrize("start", [5, 13])
def test_paged_prefill_attention_unaligned_start(start):
    """Rows that start at a position that is not a page multiple (as
    speculative verify's do, at total - 1): the port's paged prefill
    attention equals the JAX package's on the same pool."""
    rng = np.random.default_rng(start)
    b, s, hq, hkv, d, page, mp = 2, 6, 4, 2, 16, 4, 6
    bt = (rng.permutation(2 * mp) + 1).reshape(b, mp).astype(np.int32)
    prefix = rng.standard_normal((2, b, start, hkv, d)).astype(np.float32)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for h in (hq, hkv, hkv))
    positions = (start + np.arange(s, dtype=np.int32))[None].repeat(b, 0)
    total = np.full((b,), start + s - 1, np.int32)  # last column is padding
    pool = torch.zeros((1 + 2 * mp, hkv, page, 2 * d))
    paged_write(pool, torch.from_numpy(prefix[0]),
                torch.from_numpy(prefix[1]), torch.from_numpy(bt),
                torch.arange(start).expand(b, -1), torch.full((b,), start))
    paged_write(pool, torch.from_numpy(k), torch.from_numpy(v),
                torch.from_numpy(bt), torch.from_numpy(positions),
                torch.from_numpy(total))
    got = paged_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), pool,
        torch.from_numpy(bt), torch.from_numpy(positions),
        torch.from_numpy(total), ctx_pages=mp)
    want = jax.jit(jax_paged_prefill, static_argnames="ctx_pages")(
        q, k, v, pool.numpy(), bt, positions, total, ctx_pages=mp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("who", ["engine", "trainer"])
def test_cuda_model_with_unsupported_head_dim_is_refused(monkeypatch, who):
    """A CUDA engine or trainer whose head dim K2/K3/K4 lack (48 here) is
    refused at construction, naming the kernel; the card check is stubbed,
    and the refusal comes before anything touches a device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match=r"K2/K3/K4.*"
                       r"\(16, 32, 64, 96, 128, 256\)"):
        if who == "engine":
            LLMEngine(EngineConfig(model_overrides={"head_dim": 48},
                                   device="cuda"))
        else:
            with torch.device("meta"):
                model = LlamaModel(get_config("tiny", head_dim=48))
            ShardedTrainer(model, device="cuda")


def test_head_dim_contracts_cpu_takes_any():
    """The contracts per kernel, and a CPU engine, whose plain versions
    take any head dim, serving one the kernels lack."""
    for d in (16, 32, 64, 96, 128, 256):
        for dtype in (torch.bfloat16, torch.float32):
            check_kernel_head_dim(d, dtype, "cuda", decode=True, owner="t")
    with pytest.raises(ValueError, match="K2/K3/K4"):
        check_kernel_head_dim(48, torch.bfloat16, "cuda", decode=False,
                              owner="t")
    check_kernel_head_dim(24, torch.bfloat16, "cpu", decode=True, owner="t")
    engine = _port(None, model_overrides={"vocab_size": 512,
                                          "head_dim": 24})
    out = _run(engine, {"r": [1, 2, 3]}, SamplingParams(max_tokens=3))
    assert len(out["r"]["ids"]) == 3
