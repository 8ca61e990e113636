"""The port's dense cache layout against the JAX model on the same weights:
the naive full-sequence MLA, the dense absorbed decode, ``model.prefill``
and the dense ``decode_step`` in both attention modes, and the dense serve
loop token for token.

Config: the reduced DeepSeek config without MoE, fp32, on the CPU, where
the port runs its kernels' plain versions and JAX its default (XLA) path.
Tolerance for activations, logits and caches: fp32 ``atol = rtol = 2e-5``
(the same operations in another summation order, through two layers); the
greedy tokens of the serve loops must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import mla as jmla
from repro.core.attn_spec import AttnSpec as JSpec
from repro.launch import serve as jserve
from repro.models import model as jmodel
from repro_torch.configs import get_config, reduced
from repro_torch.core import mla
from repro_torch.core.attn_spec import AttnSpec
from repro_torch.launch import serve
from repro_torch.models import attention, model
from repro_torch.models.convert import params_from_jax

TOL = dict(atol=2e-5, rtol=2e-5)
MODES = ["etap", "standard"]


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jreduced(jget_config("deepseek_r1_671b")),
                               moe=None)
    cfg = dataclasses.replace(reduced(get_config("deepseek_r1_671b")),
                              moe=None)
    jparams = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, params_from_jax(tree, device="cpu")


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **tol)


def _layer(jparams, params, i=0):
    return (jax.tree.map(lambda a: a[i], jparams["groups"][0]["b0"])["mix"],
            params["layers"][i]["mix"])


def _layer_caches(jcache):
    """The reference's stacked group cache → one [B, S, latent] per layer."""
    c = np.asarray(jcache[0]["b0"]["c"])
    return [c[i] for i in range(c.shape[0])]


def test_causal_attention_matches_jax():
    """Plain causal attention, walked by q_block, with grouped KV heads."""
    from repro.models import attention as jattention
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 16, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, 16, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 16, 2, 6)).astype(np.float32)
    ref = jattention.causal_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                      scale=0.3, q_block=8)
    out = attention.causal_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), scale=0.3, q_block=8)
    _close(out, ref)


def test_mla_train_matches_jax(weights):
    jcfg, cfg, jparams, params = weights
    jlp, lp = _layer(jparams, params)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    jout, jc = jmla.mla_train(jlp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                              return_cache=True)
    out, c = mla.mla_train(lp, cfg, torch.from_numpy(x),
                           torch.from_numpy(pos.copy()), return_cache=True)
    _close(out, jout)
    _close(c["c"], jc["c"])
    _close(mla.mla_prefill_cache(lp, cfg, torch.from_numpy(x),
                                 torch.from_numpy(pos.copy())),
           jmla.mla_prefill_cache(jlp, jcfg, jnp.asarray(x),
                                  jnp.asarray(pos)))


@pytest.mark.parametrize("mode", MODES)
def test_mla_decode_matches_jax(weights, mode):
    """Absorbed dense decode at pos 9 of a 16-row cache: output and the
    updated cache."""
    jcfg, cfg, jparams, params = weights
    jlp, lp = _layer(jparams, params)
    rng = np.random.default_rng(2)
    cache = rng.normal(size=(2, 16, cfg.mla.latent_dim)).astype(np.float32)
    x = rng.normal(size=(2, cfg.d_model)).astype(np.float32)
    jout, jc = jmla.mla_decode(jlp, jcfg, jnp.asarray(x),
                               {"c": jnp.asarray(cache)}, 9,
                               spec=JSpec(mode=mode))
    out, c = mla.mla_decode(lp, cfg, torch.from_numpy(x),
                            {"c": torch.from_numpy(cache.copy())}, 9,
                            spec=AttnSpec(mode=mode))
    _close(out, jout)
    _close(c["c"], jc["c"])


def test_prefill_matches_jax(weights):
    """model.prefill: the last position's logits, the padded per-layer
    caches and the position."""
    jcfg, cfg, jparams, params = weights
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                             size=(2, 10)).astype(np.int32)
    jlogits, jcache, jpos = jmodel.prefill(jparams, jcfg,
                                           {"tokens": jnp.asarray(toks)}, 14)
    logits, cache, pos = model.prefill(params, cfg, torch.from_numpy(toks),
                                       14)
    assert pos == jpos == 10
    _close(logits, jlogits)
    for c, jc in zip(cache, _layer_caches(jcache), strict=True):
        assert c["c"].shape == (2, 14, cfg.mla.latent_dim)
        _close(c["c"], jc)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kv_splits", [None, 2])
def test_prefill_then_dense_decode_match_jax(weights, mode, kv_splits):
    """model.prefill, then three dense decode steps: logits and every
    layer's cache match JAX (kv_splits 2 runs the split path)."""
    jcfg, cfg, jparams, params = weights
    spec = AttnSpec(mode=mode, kv_splits=kv_splits)
    jspec = JSpec(mode=mode, kv_splits=kv_splits)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                             size=(2, 11)).astype(np.int32)
    _, jcache, pos = jmodel.prefill(jparams, jcfg,
                                    {"tokens": jnp.asarray(toks[:, :8])}, 11)
    _, cache, _ = model.prefill(params, cfg, torch.from_numpy(toks[:, :8]),
                                11)
    for i in range(3):
        jlogits, jcache = jmodel.decode_step(jparams, jcfg, jcache,
                                             jnp.asarray(toks[:, 8 + i]),
                                             pos + i, spec=jspec)
        logits, cache = model.decode_step(params, cfg, cache,
                                          torch.from_numpy(toks[:, 8 + i]),
                                          pos + i, spec=spec,
                                          cache_layout="dense")
        _close(logits, jlogits)
    for c, jc in zip(cache, _layer_caches(jcache), strict=True):
        _close(c["c"], jc)


def test_forward_last_row_is_prefill_logits(weights):
    """forward's full logits end in prefill's last-row logits."""
    _, cfg, _, params = weights
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(2, 6)).astype(np.int32))
    full, _, _ = model.forward(params, cfg, toks)
    last, _, _ = model.prefill(params, cfg, toks, 6)
    assert full.shape == (2, 6, cfg.vocab_size)
    _close(full[:, -1], last)


def test_decode_step_defaults_to_dense(weights):
    """The reference's default layout is dense; paged must be asked for."""
    _, cfg, _, params = weights
    cache = model.init_cache(cfg, 1, 4, device="cpu")
    tok = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="pos"):
        model.decode_step(params, cfg, cache, tok)
    logits, _ = model.decode_step(params, cfg, cache, tok, 0)
    assert logits.shape == (1, cfg.vocab_size)
    with pytest.raises(ValueError, match="block_table"):
        model.decode_step(params, cfg, cache, tok, cache_layout="paged")


DENSE = ["--reduced", "--cache-layout", "dense", "--batch", "2",
         "--prompt", "12", "--gen", "5"]


@pytest.mark.parametrize("mode", MODES)
def test_run_dense_tokens_equal_jax(weights, mode):
    """Same weights, same prompts (the reference's jax.random draw): the
    port's dense serve loop emits the JAX loop's greedy tokens."""
    jcfg, cfg, _, params = weights
    flags = DENSE + ["--mode", mode]
    want = jserve.run_dense(jserve.parse_args(flags), jcfg)
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 12), 0,
                                            jcfg.vocab_size))
    got = serve.run_dense(serve.parse_args(flags + ["--device", "cpu"]), cfg,
                          params=params, tokens=prompts, device="cpu")
    np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))
    assert got["tokens_served"] == want["tokens_served"] == 10
