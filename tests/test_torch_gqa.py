"""The port's GQA path against the JAX package on the same inputs and
weights: the dense decode kernels' plain versions at GQA shapes against
the Pallas kernels in interpret mode, the grouped form of the cache, the
attention module (qk-norm, rope, full causal attention, dense and paged
decode, chunked paged prefill), the model on both cache layouts, the serve
loops, and what was refused before quantized GQA pools and separate-V
paged pools were ported (A5b).

Configs: reduced Qwen3-8B with 2 kv heads for 4 heads (G = 2: plain
``reduced()`` gives qwen3 4 kv heads for 4 heads, which is MHA) and reduced
Granite-20B (one kv head: MQA, G = 4), fp32, on the CPU, where the port
runs its kernels' plain versions and JAX its default (XLA) path, or its
Pallas kernels in interpret mode.  Tolerance: fp32 ``atol = rtol = 2e-5``
(the same operations in another summation order; through two layers for
the model), as ``tests/test_torch_dense.py``; the grouped in-place view is
bitwise the grouped copy, and the serve loops' greedy tokens are equal.
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
from repro.models import attention as jattention
from repro.models import model as jmodel
from repro_torch.configs import get_config, reduced
from repro_torch.core import etap as core
from repro_torch.core.attn_spec import AttnSpec
from repro_torch.kernels import splitkv
from repro_torch.kernels.etap import combine, etap, schedule
from repro_torch.kernels.flash_decode import flash_decode as fd
from repro_torch.launch import serve
from repro_torch.models import attention, model
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import paged_cache as pc

TOL = dict(atol=2e-5, rtol=2e-5)
MODES = ["etap", "standard"]
ARCHS = ["qwen3_8b", "granite_20b"]


def _cfgs(arch):
    kw = {"kv_heads": 2} if arch == "qwen3_8b" else {}
    return (jreduced(jget_config(arch), **kw), reduced(get_config(arch), **kw))


@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    jcfg, cfg = _cfgs(request.param)
    jparams = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, params_from_jax(tree, device="cpu")


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **tol)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _layer(jparams, params, i=0):
    return (jax.tree.map(lambda a: a[i], jparams["groups"][0]["b0"])["mix"],
            params["layers"][i]["mix"])


def test_reduced_configs_are_gqa_and_mqa():
    """The two test configs have the group sizes this file is about."""
    for arch, G in (("qwen3_8b", 2), ("granite_20b", 4)):
        jcfg, cfg = _cfgs(arch)
        assert cfg.num_heads // cfg.num_kv_heads == G
        assert (cfg.num_kv_heads, cfg.resolved_head_dim) == \
            (jcfg.num_kv_heads, jcfg.resolved_head_dim)
    assert get_config("qwen3_8b").resolved_head_dim == 128


# ------------------------------------------------ kernels at GQA shapes
KB, KS, KHD, KBLOCK = 3, 45, 32, 16          # batch rows, S, head_dim, block
KLEN = [45, 1, 20]


def _gqa_case(seed, G, Kv=2):
    """q [B, H, hd] and a GQA cache k, v [B, S, K, hd] (H = K·G)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(KB, Kv * G, KHD)).astype(np.float32)
    k = rng.normal(size=(KB, KS, Kv, KHD)).astype(np.float32)
    v = rng.normal(size=(KB, KS, Kv, KHD)).astype(np.float32)
    return q, k, v, np.asarray(KLEN, np.int32)


@pytest.mark.parametrize("n_splits", [1, 2])
@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("kernel", MODES)
def test_plain_kernels_at_gqa_shapes_match_pallas(kernel, G, n_splits):
    """K5 / K7 (n = 1) and K6 / K8 + K2 (n = 2), handed the [B,S,K,hd]
    cache itself, against the Pallas kernels in interpret mode on the
    reference's grouped copy (zero-padded to the split geometry), at
    Dk = Dv = 32 and ragged lengths (one of them 1)."""
    q, k, v, lens = _gqa_case(10 + G + n_splits, G)
    jq, jk, jv, _ = jcore.gqa_to_grouped(*(jnp.asarray(a) for a in (q, k, v)))
    jlen = jnp.repeat(jnp.asarray(lens), k.shape[2])
    P = schedule.split_geometry(KS, KBLOCK, n_splits)[3]
    jk, jv = (jnp.pad(a, ((0, 0), (0, P - KS), (0, 0))) for a in (jk, jv))
    qg, kt, vt, _ = core.gqa_grouped_view(*_t(q, k, v))
    lt = torch.from_numpy(lens).repeat_interleave(k.shape[2])
    kw = dict(scale=KHD ** -0.5, rescale="amla")
    if n_splits == 1:
        jfn = jetap.etap_decode_pallas if kernel == "etap" else \
            jfd.flash_decode_pallas
        fn = etap.etap_decode_dense if kernel == "etap" else fd.flash_decode
        ref = jfn(jq, jk, jv, jlen, block=KBLOCK, **kw)
        _close(fn(qg, kt, vt, lt, block=KBLOCK, **kw), ref)
        return
    plan = schedule.dense_split_plan(KS, KBLOCK, n_splits)
    if kernel == "etap":
        jst = jetap.etap_partial_pallas(jq, jk, jv, jlen, block=KBLOCK,
                                        n_splits=n_splits, **kw)
        st = etap.etap_partial_dense(qg, kt, vt, lt, plan=plan, **kw)
        out = combine.combine_splits(*st, out_dtype=torch.float32,
                                     rescale="amla")
    else:
        jst = jfd.flash_decode_partial_pallas(jq, jk, jv, jlen, block=KBLOCK,
                                              n_splits=n_splits, **kw)
        st = fd.flash_decode_partial(qg, kt, vt, lt, plan=plan, **kw)
        out = combine.combine_splits_std(*st, out_dtype=torch.float32,
                                         rescale="amla")
    for o, r in zip(st, jst, strict=True):
        _close(o, r)
    _close(out, jcombine.combine_splits_pallas(
        *jst, transposed=kernel == "etap", out_dtype=jnp.float32,
        rescale="amla"))


def test_gqa_to_grouped_matches_reference():
    """The port's gqa_to_grouped is the reference's, bit for bit, and its
    restorer inverts the grouping of q."""
    q, k, v, _ = _gqa_case(20, 2)
    jq, jk, jv, jrestore = jcore.gqa_to_grouped(
        *(jnp.asarray(a) for a in (q, k, v)))
    qg, kg, vg, restore = core.gqa_to_grouped(*_t(q, k, v))
    for p, r in ((qg, jq), (kg, jk), (vg, jv)):
        np.testing.assert_array_equal(np.asarray(p), np.asarray(r))
    np.testing.assert_array_equal(np.asarray(restore(qg)), q)
    np.testing.assert_array_equal(np.asarray(jrestore(jq)), q)


@pytest.mark.parametrize("kv_splits", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_grouped_view_is_grouped_copy_bitwise(mode, kv_splits):
    """decode_attention over the [B,S,K,hd] cache (the in-place grouped
    view the kernels read) is bitwise decode_attention over
    gqa_to_grouped's copy."""
    q, k, v, lens = _gqa_case(21, 4)
    spec = AttnSpec(scale=KHD ** -0.5, mode=mode, kv_splits=kv_splits,
                    block=KBLOCK)
    lt = torch.from_numpy(lens).repeat_interleave(k.shape[2])
    qv, kv_, vv, restore = core.gqa_grouped_view(*_t(q, k, v))
    qc, kc, vc, restore_c = core.gqa_to_grouped(*_t(q, k, v))
    assert kv_.dim() == 4 and kc.dim() == 3
    view = restore(core.decode_attention(qv, kv_, vv, lt, spec=spec))
    copy = restore_c(core.decode_attention(qc, kc, vc, lt, spec=spec))
    assert torch.equal(view, copy)
    assert torch.equal(splitkv.grouped(kv_), kc)


# ------------------------------------------------------ attention module
def test_project_qkv_and_attention_train_match_jax(weights):
    """Projections with qk-norm (qwen3) or without (granite), rope, and the
    full causal attention with its cache rows."""
    jcfg, cfg, jparams, params = weights
    jlp, lp = _layer(jparams, params)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 15, dtype=np.int32), (2, 12)).copy()
    assert ("q_norm" in lp) == cfg.qk_norm == jcfg.qk_norm
    for p, r in zip(attention._project_qkv(lp, cfg, *_t(x, pos)),
                    jattention._project_qkv(jlp, jcfg, jnp.asarray(x),
                                            jnp.asarray(pos)), strict=True):
        _close(p, r)
    out, c = attention.attention_train(lp, cfg, *_t(x, pos),
                                       return_cache=True)
    jout, jc = jattention.attention_train(jlp, jcfg, jnp.asarray(x),
                                          jnp.asarray(pos), return_cache=True)
    _close(out, jout)
    for key in ("k", "v"):
        _close(c[key], jc[key])


@pytest.mark.parametrize("kv_splits", [None, 1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_attention_decode_matches_jax(weights, mode, kv_splits):
    """Dense decode at pos 9 of a 16-row cache: output and both caches."""
    jcfg, cfg, jparams, params = weights
    jlp, lp = _layer(jparams, params)
    rng = np.random.default_rng(2)
    shape = (2, 16, cfg.num_kv_heads, cfg.resolved_head_dim)
    kc, vc = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    x = rng.normal(size=(2, cfg.d_model)).astype(np.float32)
    jout, jc = jattention.attention_decode(
        jlp, jcfg, jnp.asarray(x), {"k": jnp.asarray(kc),
                                    "v": jnp.asarray(vc)}, 9,
        spec=JSpec(mode=mode, kv_splits=kv_splits))
    out, c = attention.attention_decode(
        lp, cfg, torch.from_numpy(x), dict(zip("kv", _t(kc, vc))), 9,
        spec=AttnSpec(mode=mode, kv_splits=kv_splits))
    _close(out, jout)
    for key in ("k", "v"):
        _close(c[key], jc[key])


def _paged_pools(cfg, rng, n_blocks=9, page=4):
    shape = (n_blocks, page, cfg.num_kv_heads, cfg.resolved_head_dim)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("mode", MODES)
def test_attention_paged_decode_and_chunk_match_jax(weights, mode):
    """Paged decode (ragged lengths, one idle slot on the null block) and
    a chunk of prefill through a shuffled block table: outputs and
    pools."""
    jcfg, cfg, jparams, params = weights
    jlp, lp = _layer(jparams, params)
    rng = np.random.default_rng(3)
    kp, vp = _paged_pools(cfg, rng)
    table = np.asarray([[3, 7, 1, 5], [2, 8, 4, 6], [0, 0, 0, 0]], np.int32)
    lengths = np.asarray([13, 6, 0], np.int32)
    x = rng.normal(size=(3, cfg.d_model)).astype(np.float32)
    out, c = attention.attention_decode_paged(
        lp, cfg, torch.from_numpy(x), dict(zip("kv", _t(kp, vp))),
        *_t(table, lengths), spec=AttnSpec(mode=mode))
    jout, jc = jattention.attention_decode_paged(
        jlp, jcfg, jnp.asarray(x), {"k": jnp.asarray(kp),
                                    "v": jnp.asarray(vp)},
        jnp.asarray(table), jnp.asarray(lengths), spec=JSpec(mode=mode))
    _close(out[:2], jout[:2])
    for key in ("k", "v"):
        _close(c[key][1:], jc[key][1:])
    xc = rng.normal(size=(2, 3, cfg.d_model)).astype(np.float32)
    out, c = attention.attention_prefill_chunk(
        lp, cfg, torch.from_numpy(xc), dict(zip("kv", _t(kp, vp))),
        *_t(table[:2], lengths[:2]))
    jout, jc = jattention.attention_prefill_chunk(
        jlp, jcfg, jnp.asarray(xc), {"k": jnp.asarray(kp),
                                     "v": jnp.asarray(vp)},
        jnp.asarray(table[:2]), jnp.asarray(lengths[:2]))
    _close(out, jout)
    for key in ("k", "v"):
        _close(c[key], jc[key])


# ----------------------------------------------------------------- model
def _stacked(jcache, key):
    """The reference's stacked group cache → one array per layer."""
    c = np.asarray(jcache[0]["b0"][key])
    return [c[i] for i in range(c.shape[0])]


def test_forward_and_prefill_match_jax(weights):
    """model.forward's logits, and model.prefill's last-row logits, padded
    {"k", "v"} caches and position."""
    jcfg, cfg, jparams, params = weights
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                             size=(2, 10)).astype(np.int32)
    jlogits, _, _ = jmodel.forward(jparams, jcfg,
                                   {"tokens": jnp.asarray(toks)})
    _close(model.forward(params, cfg, torch.from_numpy(toks))[0], jlogits)
    jlast, jcache, jpos = jmodel.prefill(jparams, jcfg,
                                         {"tokens": jnp.asarray(toks)}, 14)
    last, cache, pos = model.prefill(params, cfg, torch.from_numpy(toks), 14)
    assert pos == jpos == 10
    _close(last, jlast)
    for key in ("k", "v"):
        for c, jc in zip(cache, _stacked(jcache, key), strict=True):
            assert c[key].shape == (2, 14, cfg.num_kv_heads,
                                    cfg.resolved_head_dim)
            _close(c[key], jc)


@pytest.mark.parametrize("mode", MODES)
def test_prefill_then_decode_match_jax_on_both_layouts(weights, mode):
    """Dense: model.prefill, then three dense decode steps (two splits).
    Paged: model.prefill_chunk over the prompt in two chunks, then three
    paged decode steps.  Logits and every layer's cache or pool match JAX
    at each step."""
    jcfg, cfg, jparams, params = weights
    spec, jspec = (AttnSpec(mode=mode, kv_splits=2),
                   JSpec(mode=mode, kv_splits=2))
    B, P = 2, 8
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                             size=(B, P + 3)).astype(np.int32)
    _, jcache, pos = jmodel.prefill(jparams, jcfg,
                                    {"tokens": jnp.asarray(toks[:, :P])},
                                    P + 3)
    _, cache, _ = model.prefill(params, cfg, torch.from_numpy(toks[:, :P]),
                                P + 3)
    for i in range(3):
        jlogits, jcache = jmodel.decode_step(
            jparams, jcfg, jcache, jnp.asarray(toks[:, P + i]), pos + i,
            spec=jspec)
        logits, cache = model.decode_step(
            params, cfg, cache, torch.from_numpy(toks[:, P + i]), pos + i,
            spec=spec)
        _close(logits, jlogits)
    for key in ("k", "v"):
        for c, jc in zip(cache, _stacked(jcache, key), strict=True):
            _close(c[key], jc)

    lay = pc.layout_for(B, P + 3, block_size=4)
    bp = pc.BlockPool(lay, B)
    for _ in range(B):
        bp.admit(0, P + 3)
    pcache = model.init_paged_cache(cfg, lay, device="cpu")
    jpcache = jmodel.init_paged_cache(jcfg, lay)
    spec, jspec = AttnSpec(mode=mode), JSpec(mode=mode)
    for lo, hi in ((0, 5), (5, P)):
        table, lengths = bp.device_views("cpu")
        logits, pcache = model.prefill_chunk(
            params, cfg, pcache, torch.from_numpy(toks[:, lo:hi]), table,
            lengths, spec=spec)
        jlogits, jpcache = jmodel.prefill_chunk(
            jparams, jcfg, jpcache, jnp.asarray(toks[:, lo:hi]),
            jnp.asarray(bp.table), jnp.asarray(bp.lengths), spec=jspec)
        _close(logits, jlogits)
        for b in range(B):
            bp.extend(b, hi - lo)
    for i in range(P, P + 3):
        table, lengths = bp.device_views("cpu")
        logits, pcache = model.decode_step(
            params, cfg, pcache, torch.from_numpy(toks[:, i]), spec=spec,
            cache_layout="paged", block_table=table, lengths=lengths)
        jlogits, jpcache = jmodel.decode_step(
            jparams, jcfg, jpcache, jnp.asarray(toks[:, i]), None,
            spec=jspec, cache_layout="paged",
            block_table=jnp.asarray(bp.table),
            lengths=jnp.asarray(bp.lengths))
        _close(logits, jlogits)
        for b in range(B):
            bp.append(b)
    for key in ("k", "v"):
        for c, jc in zip(pcache, _stacked(jpcache, key), strict=True):
            _close(c[key][1:], jc[1:])


# ----------------------------------------------------------------- serve
PAGED = ["--reduced", "--batch", "2", "--prompt", "16", "--gen", "4",
         "--requests", "3", "--page-size", "8", "--prefill-chunk", "8"]
DENSE = ["--reduced", "--cache-layout", "dense", "--batch", "2",
         "--prompt", "12", "--gen", "5"]


@pytest.mark.parametrize("mode", MODES)
def test_serve_loops_tokens_equal_jax(weights, mode):
    """Same weights, same flags: run_paged's outputs and run_dense's greedy
    tokens (the reference's jax.random prompts) equal the JAX loops'."""
    jcfg, cfg, _, params = weights
    arch = ["--arch", cfg.name, "--mode", mode]
    want = jserve.run_paged(jserve.parse_args(PAGED + arch), jcfg)
    got = serve.run_paged(serve.parse_args(PAGED + arch + ["--device", "cpu"]),
                          cfg, params=params, device="cpu")
    assert got["outputs"] == want["outputs"] and len(got["outputs"]) == 3
    for key in ("tokens_served", "prefill_tokens", "steps", "batch_slots"):
        assert got[key] == want[key], key
    want = jserve.run_dense(jserve.parse_args(DENSE + arch), jcfg)
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 12), 0,
                                            jcfg.vocab_size))
    got = serve.run_dense(serve.parse_args(DENSE + arch + ["--device", "cpu"]),
                          cfg, params=params, tokens=prompts, device="cpu")
    np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))


# ------------------------------------------------------------- refusals
# (model.paged_row_bytes against the reference for every arch, GQA ones
# included, and every layout: tests/test_torch_quant.py)
def test_quantized_gqa_pools_refused():
    """Quantized GQA pools were refused (ROADMAP A5b) and are ported now:
    --kv-dtype int8|fp8 with a GQA arch on the paged layout parses, and
    init_paged_cache builds the reference's {"k", "v", "k_sz", "v_sz"}
    pools (codes zero, scale 1, zp 0), bitwise; the dense layout still
    takes and ignores the flag, as the reference's run_dense does."""
    for kvd in ("int8", "fp8"):
        assert serve.parse_args(["--arch", "qwen3_8b", "--kv-dtype",
                                 kvd]).kv_dtype == kvd
    args = serve.parse_args(["--arch", "qwen3_8b", "--kv-dtype", "int8",
                             "--cache-layout", "dense"])
    assert args.kv_dtype == "int8"
    jcfg, cfg = _cfgs("qwen3_8b")
    lay = pc.layout_for(1, 8, block_size=4)
    for kvd in ("int8", "fp8"):
        cache = model.init_paged_cache(cfg, lay, kv_dtype=kvd, device="cpu")
        jcache = jmodel.init_paged_cache(jcfg, lay, kv_dtype=kvd)
        for key in ("k", "v", "k_sz", "v_sz"):
            want = np.asarray(jcache[0]["b0"][key][0])
            got = pc.raw(cache[0][key]).numpy()
            assert got.shape == want.shape, key
            np.testing.assert_array_equal(
                got.view(np.uint8) if got.dtype.itemsize == 1 else got,
                want.view(np.uint8) if want.dtype.itemsize == 1 else want)


def test_refusal_message_names_a5b(capsys):
    """The GQA flag pair that was refused (A5b) serves now, and so do the
    separate-V paged pools, A5b's last part: Granite's per-layer pool (one
    kv head) read as one K and one V pool [N, page, hd] through the paged
    entries matches the reference's in both modes, decode (one split and
    auto), prefill and verify."""
    assert serve.parse_args(["--arch", "granite_20b", "--kv-dtype",
                             "fp8"]).kv_dtype == "fp8"
    assert capsys.readouterr().err == ""
    _, cfg = _cfgs("granite_20b")
    hd, H, page = cfg.resolved_head_dim, cfg.num_heads, 4
    assert cfg.num_kv_heads == 1
    rng = np.random.default_rng(3)
    k_pool, v_pool = (torch.from_numpy(rng.normal(size=(9, page, 1, hd))
                                       .astype(np.float32))[:, :, 0]
                      for _ in range(2))
    table = torch.tensor([[3, 1, 7, 0], [2, 8, 5, 4]], dtype=torch.int32)
    lengths = torch.tensor([10, 16], dtype=torch.int32)
    q = torch.from_numpy(rng.normal(size=(2, H, hd)).astype(np.float32))
    jargs = [jnp.asarray(x.numpy()) for x in (k_pool, v_pool, table)]
    for mode in MODES:
        for kv_splits in (1, None):
            got = core.decode_attention_paged(
                q, k_pool, v_pool, table, lengths,
                spec=AttnSpec(scale=hd ** -0.5, mode=mode,
                              kv_splits=kv_splits))
            want = jcore.decode_attention_paged(
                jnp.asarray(q.numpy()), *jargs, jnp.asarray(lengths.numpy()),
                spec=JSpec(scale=hd ** -0.5, mode=mode, kv_splits=kv_splits))
            _close(got, want)
    qp = torch.from_numpy(rng.normal(size=(2, 3, H, hd)).astype(np.float32))
    start = torch.tensor([7, 13], dtype=torch.int32)
    qpos = start[:, None] + torch.tensor([[0, 1, 1]], dtype=torch.int32)
    spec, jspec = AttnSpec(scale=hd ** -0.5), JSpec(scale=hd ** -0.5)
    jq, js = jnp.asarray(qp.numpy()), jnp.asarray(start.numpy())
    _close(core.prefill_attention_paged(qp, k_pool, v_pool, table, start,
                                        spec=spec),
           jcore.prefill_attention_paged(jq, *jargs, js, spec=jspec))
    _close(core.verify_attention_paged(qp, k_pool, v_pool, table, start, qpos,
                                       spec=spec),
           jcore.verify_attention_paged(jq, *jargs, js,
                                        jnp.asarray(qpos.numpy()),
                                        spec=jspec))