"""The port's Mamba path (falcon-mamba) against the JAX model on the same
weights.

Config: ``reduced(falcon_mamba_7b)`` (2 layers, d_model 64, d_inner 128,
N 4, chunk 8, fp32) on the CPU, where the port runs K10's plain version.
The reference runs both of its routes: the associative scan over chunks
(``use_kernels=False``) and its Pallas scan in interpret mode (``True``).
Weights are the reference's ``model.init``, carried across with
``params_from_jax``.  Tolerance for activations, states and logits: fp32
``atol = rtol = 2e-5`` — the same operations in another order (the
associative scan multiplies the decays in a tree), through two layers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.launch import serve as jserve
from repro.models import mamba as jmamba
from repro.models import model as jmodel
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve
from repro_torch.models import mamba, model
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import paged_cache as pc

TOL = dict(atol=2e-5, rtol=2e-5)
ROUTES = [False, True]
ROUTE_IDS = ["jax-assoc-scan", "jax-pallas"]


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **TOL)


@pytest.fixture(scope="module")
def weights():
    jcfg = jreduced(jget_config("falcon_mamba_7b"))
    cfg = reduced(get_config("falcon_mamba_7b"))
    jparams = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, params_from_jax(tree, device="cpu")


def _jcfg(jcfg, use_kernels):
    return dataclasses.replace(jcfg, use_kernels=use_kernels)


def _jlayer(jparams, i):
    return jax.tree.map(lambda a: a[i], jparams["groups"][0]["b0"]["mix"])


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


def test_config_and_dims(weights):
    jcfg, cfg, _, _ = weights
    assert cfg.ssm.chunk == jcfg.ssm.chunk == 8
    assert mamba._dims(cfg) == jmamba._dims(jcfg) == (128, 4, 4, 4)
    assert mamba._dims(get_config("falcon_mamba_7b")) == (8192, 256, 16, 4)


@pytest.mark.parametrize("use_kernels", ROUTES, ids=ROUTE_IDS)
@pytest.mark.parametrize("S", [16, 13, 2],
                         ids=["S16-two-chunks", "S13-left-pad",
                              "S2-short-conv-tail"])
def test_mamba_seq_matches_jax(weights, S, use_kernels):
    """Output, final state and conv tail of one Mamba layer over a full
    sequence: two chunks, a left pad to a chunk multiple, and a sequence
    shorter than the conv's K-1 taps."""
    jcfg, cfg, jparams, params = weights
    x = _x(cfg, 2, S, seed=S)
    out, st = mamba.mamba_seq(params["layers"][1]["mix"], cfg,
                              torch.from_numpy(x), return_state=True)
    jout, jst = jmamba.mamba_seq(_jlayer(jparams, 1), _jcfg(jcfg, use_kernels),
                                 jnp.asarray(x), return_state=True)
    assert out.shape == (2, S, cfg.d_model)
    _close(out, jout)
    assert st["h"].dtype == torch.float32 and st["h"].shape == (2, 128, 4)
    _close(st["h"], jst["h"])
    assert st["conv"].shape == (2, 3, 128) and st["conv"].is_contiguous()
    _close(st["conv"], jst["conv"])
    _close(mamba.mamba_seq(params["layers"][1]["mix"], cfg,
                           torch.from_numpy(x)), jout)


def test_mamba_decode_matches_jax(weights):
    jcfg, cfg, jparams, params = weights
    rng = np.random.default_rng(11)
    x = rng.normal(size=(3, cfg.d_model)).astype(np.float32)
    h = (rng.normal(size=(3, 128, 4)) * 0.5).astype(np.float32)
    conv = rng.normal(size=(3, 3, 128)).astype(np.float32)
    out, st = mamba.mamba_decode(
        params["layers"][0]["mix"], cfg, torch.from_numpy(x),
        {"h": torch.from_numpy(h), "conv": torch.from_numpy(conv)})
    jout, jst = jmamba.mamba_decode(
        _jlayer(jparams, 0), jcfg, jnp.asarray(x),
        {"h": jnp.asarray(h), "conv": jnp.asarray(conv)})
    _close(out, jout)
    _close(st["h"], jst["h"])
    np.testing.assert_array_equal(st["conv"].numpy(), np.asarray(jst["conv"]))


def test_softplus_is_jax_softplus():
    """logaddexp(x, 0), without torch's threshold at 20."""
    x = np.array([-100.0, -20.5, -4.0, 0.0, 3.0, 19.9, 20.5, 40.0],
                 np.float32)
    _close(mamba.softplus(torch.from_numpy(x)), jax.nn.softplus(x))


@pytest.mark.parametrize("use_kernels", ROUTES, ids=ROUTE_IDS)
def test_forward_matches_jax(weights, use_kernels):
    jcfg, cfg, jparams, params = weights
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                             size=(2, 13)).astype(np.int32)
    logits, _, _ = model.forward(params, cfg, torch.from_numpy(toks))
    jlogits, _, _ = jmodel.forward(jparams, _jcfg(jcfg, use_kernels),
                                   {"tokens": jnp.asarray(toks)})
    assert logits.shape == (2, 13, cfg.vocab_size)
    _close(logits, jlogits)


@pytest.mark.parametrize("use_kernels", ROUTES, ids=ROUTE_IDS)
def test_prefill_then_decode_matches_jax(weights, use_kernels):
    """model.prefill and three dense decode steps: logits each step, and
    each layer's state (h, conv) after the last."""
    jcfg, cfg, jparams, params = weights
    jc = _jcfg(jcfg, use_kernels)
    B, P = 2, 13
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                             size=(B, P + 3)).astype(np.int32)
    logits, cache, pos = model.prefill(params, cfg,
                                       torch.from_numpy(toks[:, :P]), P + 3)
    jlogits, jcache, jpos = jmodel.prefill(
        jparams, jc, {"tokens": jnp.asarray(toks[:, :P])}, P + 3)
    assert pos == jpos == P
    _close(logits, jlogits)
    for i in range(3):
        logits, cache = model.decode_step(params, cfg, cache,
                                          torch.from_numpy(toks[:, P + i]),
                                          pos + i)
        jlogits, jcache = jmodel.decode_step(jparams, jc, jcache,
                                             jnp.asarray(toks[:, P + i]),
                                             jpos + i)
        _close(logits, jlogits)
    assert len(cache) == cfg.num_layers
    for li, layer in enumerate(cache):
        assert set(layer) == {"h", "conv"}
        _close(layer["h"], jcache[0]["b0"]["h"][li])
        _close(layer["conv"], jcache[0]["b0"]["conv"][li])


def test_init_cache_matches_jax_layout(weights):
    jcfg, cfg, _, _ = weights
    cache = model.init_cache(cfg, 3, 20, device="cpu")
    jcache = jmodel.init_cache(jcfg, 3, 20)[0]["b0"]
    for layer in cache:
        for key in ("h", "conv"):
            assert tuple(layer[key].shape) == jcache[key].shape[1:]
            assert not layer[key].any()
        assert layer["h"].dtype == torch.float32


@pytest.mark.parametrize("mode", ["etap", "standard"])
def test_run_dense_tokens_equal_jax(weights, mode):
    """Same weights, same prompts (the reference's jax.random draw): the
    port's dense serve loop emits the JAX loop's greedy tokens; --mode is
    accepted and not read by a Mamba stack, as in the reference."""
    jcfg, cfg, _, params = weights
    flags = ["--arch", "falcon_mamba_7b", "--reduced", "--cache-layout",
             "dense", "--batch", "2", "--prompt", "13", "--gen", "5",
             "--mode", mode]
    want = jserve.run_dense(jserve.parse_args(flags), jcfg)
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 13), 0,
                                            jcfg.vocab_size))
    got = serve.run_dense(serve.parse_args(flags + ["--device", "cpu"]), cfg,
                          params=params, tokens=prompts, device="cpu")
    np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))
    assert got["tokens_served"] == want["tokens_served"] == 10


def test_paged_layout_refused_as_in_reference(weights):
    """Mamba state is per sequence, not per token: the paged cache and the
    paged serve loop raise the reference's ValueError."""
    jcfg, cfg, _, params = weights
    lay = pc.layout_for(2, 16, block_size=8)
    with pytest.raises(ValueError, match="attention-only"):
        model.init_paged_cache(cfg, lay, device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        jmodel.init_paged_cache(jcfg, lay)
    args = serve.parse_args(["--arch", "falcon_mamba_7b", "--reduced",
                             "--batch", "2", "--prompt", "8", "--gen", "2",
                             "--device", "cpu"])
    assert args.cache_layout == "paged"
    with pytest.raises(ValueError, match="attention-only"):
        serve.run_paged(args, cfg, params=params, device="cpu")


@pytest.mark.parametrize("arch,label", [
    ("qwen3_8b", None), ("recurrentgemma_9b", None), ("llava_next_34b", None),
    ("musicgen_large", None), ("falcon_mamba_7b", None),
    ("deepseek_r1_671b", None), ("dbrx_132b", None)])
def test_check_ported_labels(arch, label):
    """All-ssm stacks, GQA stacks (full or local attention, the hybrid
    RG-LRU cycle, behind a frontend or not) and MoE stacks, GQA or MLA,
    are admitted: every config the repo has is served."""
    cfg = get_config(arch)
    if label is None:
        model.check_ported(cfg)
        model.check_ported(reduced(cfg))
        return
    with pytest.raises(NotImplementedError, match=label):
        model.check_ported(cfg)


def test_params_carry_reference_dtypes():
    """A bf16 model converts with its fp32 leaves (dt_bias, log_neg_A, D) in
    fp32 and the rest in bf16, matching the port's own init leaf for leaf."""
    jcfg = dataclasses.replace(jreduced(jget_config("falcon_mamba_7b")),
                               dtype="bfloat16")
    cfg = dataclasses.replace(reduced(get_config("falcon_mamba_7b")),
                              dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jcfg))
    conv = params_from_jax(tree, device="cpu")
    own = model.init(cfg, seed=0, device="cpu")
    fp32 = {"dt_bias", "log_neg_A", "D"}
    assert len(conv["layers"]) == len(own["layers"]) == 2
    for lc, lo in zip(conv["layers"], own["layers"], strict=True):
        assert set(lc) == set(lo) == {"norm1", "mix"}
        assert set(lc["mix"]) == set(lo["mix"])
        for k, t in lc["mix"].items():
            want = torch.float32 if k in fp32 else torch.bfloat16
            assert t.dtype == lo["mix"][k].dtype == want, k
            assert t.shape == lo["mix"][k].shape, k
    assert conv["embed"].dtype == torch.bfloat16
    assert model.param_count(conv) == model.param_count(own)
