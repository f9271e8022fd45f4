"""Parity of ray_tpu_torch's Llama model with the JAX package's.

Both sides hold the same float32 parameters: the JAX init, converted by
``params_from_flax``. Logits agree within 1e-4 (float32; the two
frameworks sum in different orders).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models.llama import LlamaModel as JaxLlama
from ray_tpu.models.llama import get_config as jax_config
from ray_tpu_torch.models.config import get_config
from ray_tpu_torch.models.convert import (build_model, init_params,
                                          params_from_flax)
from ray_tpu_torch.models.llama import PagedCache

ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs files in
    parallel workers, and tiny shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_JAX_PARAMS = {}  # name -> (flax module, params): one init per config


def _jax_model(name, ids):
    """JAX float32 params of config `name` (PRNGKey(0)) and its logits."""
    if name not in _JAX_PARAMS:
        model = JaxLlama(jax_config(name, dtype=jnp.float32))
        _JAX_PARAMS[name] = (model, nn.meta.unbox(jax.jit(model.init)(
            jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]))
    model, params = _JAX_PARAMS[name]
    logits = jax.jit(model.apply)({"params": params}, jnp.asarray(ids))
    return jax.tree.map(np.asarray, params), np.asarray(logits)


def _port_model(name, params):
    cfg = get_config(name, dtype="float32")
    return build_model(cfg, params_from_flax(params, cfg), "cpu")


@pytest.fixture(scope="module")
def tiny():
    ids = (np.arange(12)[None] * 7 % 256).astype(np.int32)
    params, logits = _jax_model("tiny", ids)
    return _port_model("tiny", params), ids, logits


@pytest.mark.parametrize("name", ["tiny", "debug-sharded"])
def test_logits_match_jax(name):
    ids = np.random.default_rng(0).integers(0, 256, (2, 10)).astype(np.int32)
    params, want = _jax_model(name, ids)
    model = _port_model(name, params)
    with torch.inference_mode():
        got = model(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)


def test_causality(tiny):
    """Logits at position t must not depend on tokens after t."""
    model, ids, _ = tiny
    ids2 = ids.copy()
    ids2[0, -1] = 7
    with torch.inference_mode():
        a = model(torch.from_numpy(ids))
        b = model(torch.from_numpy(ids2))
    np.testing.assert_allclose(a[0, :-1].numpy(), b[0, :-1].numpy(),
                               atol=1e-5)


def test_paged_prefill_decode_and_ctx_prefill_match_full_forward(tiny):
    """Through the paged cache: prefill 8 tokens, decode 4 one at a time;
    then, in a fresh pool, prefill 8 and attend to them as a cached prefix
    from a 4-token second prefill (the ctx-merge path). Every step's
    logits equal the JAX full-sequence forward's."""
    model, ids, full = tiny
    cfg = model.cfg
    page, mp = 8, 4

    def fresh():
        pool = torch.zeros((cfg.num_layers, 8, cfg.num_kv_heads, page,
                            2 * cfg.head_dim_))
        return pool, torch.tensor([[3, 5, 0, 0]], dtype=torch.int32)

    def run(pool, bt, lo, hi, ctx_pages=0):
        cache = PagedCache(pool, bt, torch.tensor([hi], dtype=torch.int32),
                           ctx_pages=ctx_pages)
        with torch.inference_mode():
            return model(torch.from_numpy(ids[:, lo:hi]),
                         torch.arange(lo, hi)[None], cache).numpy()

    pool, bt = fresh()
    np.testing.assert_allclose(run(pool, bt, 0, 8), full[:, :8], atol=ATOL)
    for t in range(8, 12):
        np.testing.assert_allclose(run(pool, bt, t, t + 1), full[:, t:t + 1],
                                   atol=ATOL, err_msg=f"position {t}")
    pool, bt = fresh()
    run(pool, bt, 0, 8)
    np.testing.assert_allclose(run(pool, bt, 8, 12, ctx_pages=mp),
                               full[:, 8:12], atol=ATOL)


def test_init_params_match_flax_layout_and_scale():
    cfg = get_config("debug-sharded")
    gen = torch.Generator().manual_seed(0)
    sd = init_params(cfg, gen, "cpu", torch.float32)
    ids = np.zeros((1, 4), np.int32)
    params, _ = _jax_model("debug-sharded", ids)
    ref = params_from_flax(params, cfg)
    assert {k: tuple(v.shape) for k, v in sd.items()} \
        == {k: tuple(v.shape) for k, v in ref.items()}
    # lecun normal: std sqrt(1/fan_in); embed: std 0.02; norms: ones
    w = sd["layers.0.mlp.gate_up_proj.weight"]
    assert abs(float(w.std()) - cfg.hidden_size ** -0.5) < 0.05 * \
        cfg.hidden_size ** -0.5
    assert float(w.abs().max()) <= 2 * cfg.hidden_size ** -0.5 / 0.8796 + 1e-6
    assert abs(float(sd["embed"].std()) - 0.02) < 0.002
    assert (sd["final_norm.scale"] == 1).all()
    model = build_model(cfg, sd, "cpu", torch.bfloat16)
    assert model.embed.dtype == torch.bfloat16
    assert model.final_norm.scale.dtype == torch.float32
