"""The port's hybrid and frontend models against the JAX package on the
same inputs and weights: the RG-LRU block, local (sliding-window)
attention, the ring-buffer decode of RecurrentGemma's local attention, the
hybrid rglru, rglru, attn stack, the audio and vision frontends, and the
paged layout's refusal of a hybrid stack.

Configs: ``reduced(recurrentgemma_9b, layers=3, d_model=512, heads=2,
kv_heads=1)`` — head_dim 256 (RecurrentGemma's own) and an attention layer
in the stack, window 32 (plain ``reduced(..., layers=2)`` has no attention
layer) — reduced MusicGen-large and LLaVA-NeXT-34B, fp32, on the CPU,
where the port runs its kernels' plain versions and JAX its default (XLA)
path.  Tolerances: the RG-LRU block fp32 ``atol = rtol = 1e-5`` (the port
scans the recurrence in another order than ``jax.lax.associative_scan``);
attention, logits and caches fp32 ``atol = rtol = 2e-5`` (through three
layers), as ``tests/test_torch_gqa.py``; the serve loops' greedy tokens
equal (``tests/test_torch_head64.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.attn_spec import AttnSpec as JSpec
from repro.models import attention as jattention
from repro.models import model as jmodel
from repro.models import rglru as jrglru
from repro_torch.configs import get_config, reduced
from repro_torch.core.attn_spec import AttnSpec
from repro_torch.models import attention, frontend, model, rglru
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import paged_cache as pc

TOL = dict(atol=2e-5, rtol=2e-5)
LRU_TOL = dict(atol=1e-5, rtol=1e-5)
RG = dict(layers=3, d_model=512, heads=2, kv_heads=1)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **tol)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.fixture(scope="module")
def rgemma():
    jcfg = jreduced(jget_config("recurrentgemma_9b"), **RG)
    cfg = reduced(get_config("recurrentgemma_9b"), **RG)
    jparams = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, params_from_jax(tree, device="cpu")


def test_reduced_config_is_the_hybrid_at_head_dim_256(rgemma):
    """The test config keeps the full config's head_dim 256, its one kv
    head and its cycle, with an attention layer; plain reduced() does
    not."""
    jcfg, cfg, _, params = rgemma
    full = get_config("recurrentgemma_9b")
    assert full.resolved_head_dim == cfg.resolved_head_dim == 256
    assert cfg.layer_kinds() == ["rglru", "rglru", "attn"]
    assert (cfg.attention_kind, cfg.window_size, cfg.num_kv_heads) == \
        ("local", 32, 1)
    assert "attn" not in reduced(full).layer_kinds()
    assert params["layers"][0]["mix"]["log_lambda"].dtype == torch.float32
    assert model.param_count(params) == sum(
        int(x.size) for x in jax.tree.leaves(rgemma[2]))


# ---------------------------------------------------------------- RG-LRU
def _rglru_layer(jparams, params):
    return (jax.tree.map(lambda a: a[0], jparams["groups"][0]["b0"])["mix"],
            params["layers"][0]["mix"])


@pytest.mark.parametrize("S", [2, 37])
def test_rglru_seq_and_decode_match_jax(rgemma, S):
    """rglru_seq without and with its state (S = 2 < 3 pads the conv tail),
    then two rglru_decode steps from that state: outputs and state."""
    jcfg, cfg, jparams, params = rgemma
    jlp, lp = _rglru_layer(jparams, params)
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    jseq = jax.jit(lambda p, x: jrglru.rglru_seq(p, jcfg, x,
                                                 return_state=True))
    jdecode = jax.jit(lambda p, x, st: jrglru.rglru_decode(p, jcfg, x, st))
    jout, jst = jseq(jlp, jnp.asarray(x))
    _close(rglru.rglru_seq(lp, cfg, *_t(x)), jout, LRU_TOL)
    out, st = rglru.rglru_seq(lp, cfg, *_t(x), return_state=True)
    _close(out, jout, LRU_TOL)
    assert st["h"].dtype == torch.float32
    for key in ("h", "conv"):
        _close(st[key], jst[key], LRU_TOL)
    for _ in range(2):
        xd = rng.normal(size=(2, cfg.d_model)).astype(np.float32)
        out, st = rglru.rglru_decode(lp, cfg, *_t(xd), st)
        jout, jst = jdecode(jlp, jnp.asarray(xd), jst)
        _close(out, jout, LRU_TOL)
        for key in ("h", "conv"):
            _close(st[key], jst[key], LRU_TOL)
    cache = rglru.init_rglru_cache(cfg, 2, torch.float32, device="cpu")
    jcache = jrglru.init_rglru_cache(jcfg, 2, jnp.float32)
    for key in ("h", "conv"):
        assert cache[key].shape == jcache[key].shape


def test_gelu_is_the_tanh_form():
    """The gate's GeLU is jax.nn.gelu's default (tanh), not torch's."""
    x = np.linspace(-4, 4, 41).astype(np.float32)
    _close(rglru._gelu(torch.from_numpy(x)), jax.nn.gelu(x), LRU_TOL)
    assert not np.allclose(torch.nn.functional.gelu(torch.from_numpy(x)),
                           jax.nn.gelu(x), atol=1e-5)


# ------------------------------------------------------- local attention
@pytest.mark.parametrize("S", [32, 64, 20])
def test_local_attention_matches_jax(S):
    """local_attention at S = window, 2 x window (chunk 1 sees chunk 0
    through the band) and S < window (one chunk of S), H = 4 over K = 2
    kv heads; S not a multiple of the window raises, as the reference
    asserts."""
    rng = np.random.default_rng(S)
    q = rng.normal(size=(2, S, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, S, 2, 16)).astype(np.float32)
            for _ in range(2))
    got = attention.local_attention(*_t(q, k, v), window=32, scale=0.25)
    want = jattention.local_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                      window=32, scale=0.25)
    _close(got, want)
    with pytest.raises(ValueError, match="window"):
        attention.local_attention(*_t(q, k, v), window=S // 2 + 1,
                                  scale=0.25)


def _stacked(jcache, g, j):
    """The reference's stacked group cache → one dict per repeat."""
    c = jax.tree.map(np.asarray, jcache[g][f"b{j}"])
    n = next(iter(c.values())).shape[0]
    return [{k: a[i] for k, a in c.items()} for i in range(n)]


def _ref_layers(jcache, cfg):
    """The reference's caches in the port's layer order."""
    out = []
    for g, grp in enumerate(jmodel.layer_groups(cfg)):
        reps = [_stacked(jcache, g, j) for j in range(len(grp["sigs"]))]
        for i in range(grp["n"]):
            out += [r[i] for r in reps]
    return out


@pytest.mark.parametrize("mode", ["etap", "standard"])
def test_ring_decode_matches_jax(rgemma, mode):
    """A prompt of 2 x window through model.prefill (the local layer's
    cache cut to the last window rows), then three decode steps past it —
    every one writes a wrapped slot pos % 32 — with two splits: logits at
    every step, the ring's contents and the RG-LRU states."""
    jcfg, cfg, jparams, params = rgemma
    P, steps = 2 * cfg.window_size, 3
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(2, P + steps)).astype(np.int32)
    jlast, jcache, pos = jmodel.prefill(
        jparams, jcfg, {"tokens": jnp.asarray(toks[:, :P])}, P + steps)
    last, cache, _ = model.prefill(params, cfg, torch.from_numpy(toks[:, :P]),
                                   P + steps)
    _close(last, jlast)
    assert cache[2]["k"].shape[1] == cfg.window_size
    spec = AttnSpec(mode=mode, kv_splits=2)
    jspec = JSpec(mode=mode, kv_splits=2)
    for i in range(steps):
        jlogits, jcache = jmodel.decode_step(
            jparams, jcfg, jcache, jnp.asarray(toks[:, P + i]), pos + i,
            spec=jspec)
        logits, cache = model.decode_step(
            params, cfg, cache, torch.from_numpy(toks[:, P + i]), pos + i,
            spec=spec)
        _close(logits, jlogits)
    for c, jc in zip(cache, _ref_layers(jcache, cfg), strict=True):
        assert set(c) == set(jc)
        for key in c:
            _close(c[key], jc[key])


def test_hybrid_forward_matches_jax(rgemma):
    """model.forward over the three-layer hybrid stack at S = 64 (two
    local-attention chunks)."""
    jcfg, cfg, jparams, params = rgemma
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size,
                                             size=(2, 64)).astype(np.int32)
    jlogits, _, _ = jmodel.forward(jparams, jcfg,
                                   {"tokens": jnp.asarray(toks)})
    _close(model.forward(params, cfg, torch.from_numpy(toks))[0], jlogits)


# -------------------------------------------------------------- frontends
@pytest.mark.parametrize("arch", ["musicgen_large", "llava_next_34b"])
def test_frontend_forward_matches_jax(arch):
    """forward on {"embeds"} (the audio / vision stub: precomputed frames or
    patches through the frontend's projection) and on {"tokens"}, for the
    reduced models, on converted weights."""
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    jparams = jmodel.init(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    d_in = frontend.FRONTEND_DIMS[cfg.frontend]
    assert params["frontend"]["proj"].shape == (d_in, cfg.d_model)
    rng = np.random.default_rng(7)
    emb = rng.normal(size=(2, 9, d_in)).astype(np.float32)
    jlogits, _, _ = jmodel.forward(jparams, jcfg,
                                   {"embeds": jnp.asarray(emb)})
    _close(model.forward(params, cfg, {"embeds": torch.from_numpy(emb)})[0],
           jlogits)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 9)).astype(np.int32)
    jlogits, _, _ = jmodel.forward(jparams, jcfg,
                                   {"tokens": jnp.asarray(toks)})
    _close(model.forward(params, cfg, {"tokens": torch.from_numpy(toks)})[0],
           jlogits)
    own = model.init(cfg, seed=0, device="cpu")
    assert model.param_count(own) == model.param_count(params)


# ------------------------------------------------------------------ pools
def test_paged_layout_refuses_hybrid(rgemma):
    """RG-LRU state is per sequence: init_paged_cache and the paged serve
    loop raise the reference's ValueError, and a local-window layer's
    paged entries refuse it too."""
    jcfg, cfg, _, params = rgemma
    lay = pc.layout_for(2, 16, block_size=8)
    with pytest.raises(ValueError, match="attention-only"):
        jmodel.init_paged_cache(jcfg, lay)
    with pytest.raises(ValueError, match="attention-only"):
        model.init_paged_cache(cfg, lay, device="cpu")
    from repro_torch.launch import serve
    args = serve.parse_args(["--arch", "recurrentgemma_9b", "--reduced",
                             "--batch", "2", "--prompt", "8", "--gen", "2",
                             "--device", "cpu"])
    with pytest.raises(ValueError, match="attention-only"):
        serve.run_paged(args, cfg, params=params, device="cpu")
    with pytest.raises(ValueError, match="local windows stay dense"):
        attention.init_attention_cache_paged(cfg, lay, torch.float32,
                                             device="cpu")


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "musicgen_large"])
def test_params_carry_reference_dtypes(arch):
    """A bf16 model converts with RG-LRU's log_lambda in fp32 and every
    other leaf (the frontend's projection too) in bf16, and the port's own
    init builds the same leaves, dtypes and shapes."""
    kw = dict(layers=3) if arch == "recurrentgemma_9b" else {}
    jcfg = dataclasses.replace(jreduced(jget_config(arch), **kw),
                               dtype="bfloat16")
    cfg = dataclasses.replace(reduced(get_config(arch), **kw),
                              dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jcfg))
    conv = params_from_jax(tree, device="cpu")
    own = model.init(cfg, seed=0, device="cpu")

    def leaves(p, prefix=""):
        if isinstance(p, dict):
            for k, v in p.items():
                yield from leaves(v, f"{prefix}/{k}")
        elif isinstance(p, list):
            for i, v in enumerate(p):
                yield from leaves(v, f"{prefix}/{i}")
        else:
            yield prefix, p

    got = dict(leaves({k: v for k, v in conv.items() if k != "embed_f32"}))
    want = dict(leaves({k: v for k, v in own.items() if k != "embed_f32"}))
    assert set(got) == set(want)
    for name, t in got.items():
        dt = torch.float32 if name.endswith("log_lambda") else torch.bfloat16
        assert t.dtype == want[name].dtype == dt, name
        assert t.shape == want[name].shape, name
    assert ("/frontend/proj" in got) == (arch == "musicgen_large")
