"""The last dense-decode widths against the JAX package on the same inputs
and weights: the plain K5-K8 at head_dim 64 and 256 and K5q-K8q at 64,
SmolLM-360M (G = 3), StableLM-1.6B and MusicGen-large (MHA, G = 1) at
head_dim 64, and the serve loops of every model this slice brings up
(those three, RecurrentGemma-9B and LLaVA-NeXT-34B).

Configs, fp32, on the CPU (where the port runs its kernels' plain versions
and JAX its default XLA path, or its Pallas kernels in interpret mode):
``reduced(stablelm_1_6b | musicgen_large, d_model=256, heads=4)`` (head_dim
64, G = 1), ``reduced(smollm_360m, d_model=384, heads=6, kv_heads=2)``
(head_dim 64, G = 3), ``reduced(recurrentgemma_9b, layers=3, d_model=512,
heads=2, kv_heads=1)`` (head_dim 256, window 32) and
``reduced(llava_next_34b, d_model=224, heads=7, kv_heads=1)`` (G = 7, the
full model's group).  Tolerances: the plain kernels fp32 ``atol = rtol =
1e-5`` against the Pallas kernels (the quantized ones fed the dequantized
rows and fp32 q, as the reference feeds them); logits fp32 2e-5 (through
two layers); greedy tokens equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import etap as jcore
from repro.core.attn_spec import AttnSpec as JSpec
from repro.kernels.etap import combine as jcombine
from repro.kernels.etap import etap as jetap
from repro.kernels.flash_decode import flash_decode as jfd
from repro.launch import serve as jserve
from repro.models import model as jmodel
from repro_torch.configs import get_config, reduced
from repro_torch.core import etap as core
from repro_torch.core.attn_spec import AttnSpec
from repro_torch.kernels import splitkv
from repro_torch.kernels.etap import combine, etap, schedule
from repro_torch.kernels.flash_decode import flash_decode as fd
from repro_torch.launch import serve
from repro_torch.models import model
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import paged_cache as pc

TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=2e-5, rtol=2e-5)
# the reduced configs: arch -> reduced() arguments, (head_dim, G)
CUTS = {
    "smollm_360m": (dict(d_model=384, heads=6, kv_heads=2), (64, 3)),
    "stablelm_1_6b": (dict(d_model=256, heads=4), (64, 1)),
    "musicgen_large": (dict(d_model=256, heads=4), (64, 1)),
    "recurrentgemma_9b": (dict(layers=3, d_model=512, heads=2, kv_heads=1),
                          (256, 2)),
    "llava_next_34b": (dict(d_model=224, heads=7, kv_heads=1), (32, 7)),
}
@pytest.fixture(scope="module")
def weights():
    """arch -> (JAX config, port config, port params, JAX params) of the
    reduced arch, the port's converted from the reference's init at
    PRNGKey(0), each made once for the module."""
    made = {}

    def get(arch):
        if arch not in made:
            kw = CUTS[arch][0]
            jcfg = jreduced(jget_config(arch), **kw)
            jparams = jmodel.init(jax.random.PRNGKey(0), jcfg)
            made[arch] = (jcfg, reduced(get_config(arch), **kw),
                          params_from_jax(jax.tree.map(np.asarray, jparams),
                                          device="cpu"), jparams)
        return made[arch]
    return get


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **tol)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("arch", list(CUTS))
def test_reduced_configs_keep_the_widths(arch):
    """The test configs have the head widths and groups this file is about;
    the full configs' head widths are the ones the card builds."""
    kw, (hd, G) = CUTS[arch]
    cfg = reduced(get_config(arch), **kw)
    assert (cfg.resolved_head_dim, cfg.num_heads // cfg.num_kv_heads) == \
        (hd, G)
    full = get_config(arch)
    assert full.resolved_head_dim == {"recurrentgemma_9b": 256,
                                      "llava_next_34b": 128}.get(arch, 64)


# ------------------------------------------- plain kernels against Pallas
KB, KS, KBLOCK = 3, 45, 16
KLEN = [45, 1, 20]


def _gqa_case(seed, G, hd):
    """q [B, H, hd] and a GQA cache k, v [B, S, K, hd] (H = K·G; one kv
    head at G = 16, as RecurrentGemma's, else two)."""
    Kv = 1 if G == 16 else 2
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(KB, Kv * G, hd)).astype(np.float32)
    k = rng.normal(size=(KB, KS, Kv, hd)).astype(np.float32)
    v = rng.normal(size=(KB, KS, Kv, hd)).astype(np.float32)
    return q, k, v, np.asarray(KLEN, np.int32)


def _run_pair(kernel, n_splits, rescale, qg, kt, vt, lt, jq, jk, jv, jlen,
              qkw=None):
    """The port's K5 / K7 (n = 1) or K6 / K8 + K2 (n = 2) — or their
    quantized twins with ``qkw`` — against the reference's Pallas kernels
    on (jq, jk, jv) zero-padded to the split geometry."""
    qkw = qkw or {}
    hd = qg.shape[-1]
    P = schedule.split_geometry(KS, KBLOCK, n_splits)[3]
    jk, jv = (jnp.pad(a, ((0, 0), (0, P - KS), (0, 0))) for a in (jk, jv))
    kw = dict(scale=hd ** -0.5, rescale=rescale)
    quant = bool(qkw)
    if n_splits == 1:
        jfn = jetap.etap_decode_pallas if kernel == "etap" else \
            jfd.flash_decode_pallas
        fn = {("etap", False): etap.etap_decode_dense,
              ("etap", True): etap.etap_decode_dense_quant,
              ("standard", False): fd.flash_decode,
              ("standard", True): fd.flash_decode_quant}[kernel, quant]
        _close(fn(qg, kt, vt, lt, block=KBLOCK, **qkw, **kw),
               jfn(jq, jk, jv, jlen, block=KBLOCK, **kw))
        return
    plan = schedule.dense_split_plan(KS, KBLOCK, n_splits)
    f32 = dict(out_dtype=torch.float32, rescale=rescale)
    if kernel == "etap":
        jst = jetap.etap_partial_pallas(jq, jk, jv, jlen, block=KBLOCK,
                                        n_splits=n_splits, **kw)
        fn = etap.etap_partial_dense_quant if quant else \
            etap.etap_partial_dense
        st = fn(qg, kt, vt, lt, plan=plan, **qkw, **kw)
        out = combine.combine_splits(*st, **f32)
    else:
        jst = jfd.flash_decode_partial_pallas(jq, jk, jv, jlen, block=KBLOCK,
                                              n_splits=n_splits, **kw)
        fn = fd.flash_decode_partial_quant if quant else \
            fd.flash_decode_partial
        st = fn(qg, kt, vt, lt, plan=plan, **qkw, **kw)
        out = combine.combine_splits_std(*st, **f32)
    for o, r in zip(st, jst, strict=True):
        _close(o, r)
    _close(out, jcombine.combine_splits_pallas(
        *jst, transposed=kernel == "etap", out_dtype=jnp.float32,
        rescale=rescale))


@pytest.mark.parametrize("n_splits,rescale", [(1, "amla"), (2, "mul")])
@pytest.mark.parametrize("hd,G", [(64, 1), (64, 3), (256, 16)])
@pytest.mark.parametrize("kernel", ["etap", "standard"])
def test_plain_kernels_at_new_widths_match_pallas(kernel, hd, G, n_splits,
                                                  rescale):
    """K5 / K7 (n = 1) and K6 / K8 + K2 (n = 2) at Dk = Dv = 64 and 256,
    handed the [B,S,K,hd] cache itself, against the Pallas kernels in
    interpret mode on the reference's grouped copy, at G = 1 (StableLM,
    MusicGen) and 3 (SmolLM) at 64 and 16 (RecurrentGemma) at 256, ragged
    lengths (one of them 1)."""
    q, k, v, lens = _gqa_case(hd + G + n_splits, G, hd)
    jq, jk, jv, _ = jcore.gqa_to_grouped(*(jnp.asarray(a) for a in (q, k, v)))
    jlen = jnp.repeat(jnp.asarray(lens), k.shape[2])
    qg, kt, vt, _ = core.gqa_grouped_view(*_t(q, k, v))
    lt = torch.from_numpy(lens).repeat_interleave(k.shape[2])
    _run_pair(kernel, n_splits, rescale, qg, kt, vt, lt, jq, jk, jv, jlen)


@pytest.mark.parametrize("n_splits,rescale,G", [(1, "amla", 1),
                                                (2, "mul", 3)])
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("kernel", ["etap", "standard"])
def test_plain_quant_kernels_at_64_match_pallas(kernel, kv_dtype, n_splits,
                                                rescale, G):
    """K5q / K7q (n = 1) and K6q / K8q + K2 (n = 2) at 64 over int8 / fp8
    code rows of a GQA cache read as its grouped rows, against the Pallas
    kernels on the dequantized fp32 rows with fp32 q, at G = 1 and 3."""
    q, k, v, lens = _gqa_case(7 + G + n_splits, G, 64)
    (kc, ks), (vc, vs) = (pc.quantize_rows(torch.from_numpy(a), kv_dtype)
                          for a in (k, v))
    jk, jv = (jnp.asarray(splitkv.grouped(pc.dequantize_rows(c, z)).numpy())
              for c, z in ((kc, ks), (vc, vs)))
    Kv = k.shape[2]
    qg = torch.from_numpy(q).reshape(KB * Kv, G, 64)
    lt = torch.from_numpy(lens).repeat_interleave(Kv)
    _run_pair(kernel, n_splits, rescale, qg, kc, vc, lt,
              jnp.asarray(qg.numpy()), jk, jv, jnp.asarray(lt.numpy()),
              qkw=dict(k_sz=ks, v_sz=vs))


# ----------------------------------------------------------------- model
@pytest.mark.parametrize("mode", ["etap", "standard"])
def test_smollm_decode_steps_match_jax(weights, mode):
    """SmolLM at head_dim 64, G = 3: model.prefill, then two dense decode
    steps with two splits (K6 / K8 + K2); logits and caches."""
    jcfg, cfg, params, jparams = weights("smollm_360m")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                             size=(2, 12)).astype(np.int32)
    _, jcache, pos = jmodel.prefill(jparams, jcfg,
                                    {"tokens": jnp.asarray(toks[:, :10])}, 12)
    _, cache, _ = model.prefill(params, cfg, torch.from_numpy(toks[:, :10]),
                                12)
    for i in range(2):
        jlogits, jcache = jmodel.decode_step(
            jparams, jcfg, jcache, jnp.asarray(toks[:, 10 + i]), pos + i,
            spec=JSpec(mode=mode, kv_splits=2))
        logits, cache = model.decode_step(
            params, cfg, cache, torch.from_numpy(toks[:, 10 + i]), pos + i,
            spec=AttnSpec(mode=mode, kv_splits=2))
        _close(logits, jlogits, MODEL_TOL)
    for key in ("k", "v"):
        want = np.asarray(jcache[0]["b0"][key])
        for i, c in enumerate(cache):
            _close(c[key], want[i], MODEL_TOL)


# ----------------------------------------------------------------- serve
PAGED = ["--reduced", "--batch", "2", "--prompt", "12", "--gen", "3",
         "--requests", "3", "--page-size", "8", "--prefill-chunk", "8"]
DENSE = ["--reduced", "--cache-layout", "dense", "--batch", "2", "--gen",
         "4"]
# each head-64 arch on fp and int8 pools and in both modes, two paged runs
SERVE = [
    ("smollm_360m", "paged", "etap", "fp"),
    ("smollm_360m", "paged", "standard", "int8"),
    ("stablelm_1_6b", "paged", "standard", "fp"),
    ("stablelm_1_6b", "paged", "etap", "int8"),
    ("musicgen_large", "paged", "etap", "fp"),
    ("musicgen_large", "paged", "standard", "int8"),
    ("smollm_360m", "dense", "standard", "fp"),
    ("stablelm_1_6b", "dense", "etap", "fp"),
    ("musicgen_large", "dense", "standard", "fp"),
    ("recurrentgemma_9b", "dense", "etap", "fp"),
    ("recurrentgemma_9b", "dense", "standard", "fp"),
    ("llava_next_34b", "dense", "etap", "fp")]


@pytest.mark.parametrize("arch,layout,mode,kv_dtype", SERVE)
def test_serve_tokens_equal_jax(weights, arch, layout, mode, kv_dtype):
    """Same weights, same flags: run_paged's outputs, batch_slots and counts
    (fp and int8 pools, both modes) and run_dense's greedy tokens (the
    reference's jax.random prompts; RecurrentGemma's prompt is twice its
    window, so every decode step writes a wrapped ring slot) equal the JAX
    loops'."""
    jcfg, cfg, params, _ = weights(arch)
    flags = ["--arch", arch, "--mode", mode, "--kv-dtype", kv_dtype]
    if layout == "paged":
        want = jserve.run_paged(jserve.parse_args(PAGED + flags), jcfg)
        got = serve.run_paged(serve.parse_args(PAGED + flags
                                               + ["--device", "cpu"]),
                              cfg, params=params, device="cpu")
        assert got["outputs"] == want["outputs"] and len(got["outputs"]) == 3
        for key in ("tokens_served", "prefill_tokens", "steps",
                    "batch_slots"):
            assert got[key] == want[key], key
        return
    S = 2 * cfg.window_size if cfg.attention_kind == "local" else 12
    flags += ["--prompt", str(S)]
    want = jserve.run_dense(jserve.parse_args(DENSE + flags), jcfg)
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, S), 0,
                                            jcfg.vocab_size))
    got = serve.run_dense(serve.parse_args(DENSE + flags + ["--device",
                                                            "cpu"]),
                          cfg, params=params, tokens=prompts, device="cpu")
    np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))
