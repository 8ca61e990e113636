"""The port's decode over int8 / fp8 pools through the dense kernels (K5q-
K8q) against the JAX package on the same inputs and weights.

On the CPU the port runs its kernels' plain versions, which dequantize each
fetched block of codes (``codes*scale + zp``) and take q in fp32; the
reference gathers the pools, dequantizes them to fp32 and runs its dense
Pallas kernels (interpret mode) or its XLA loops on the fp32 rows.

  * GQA pools [N, page, K, hd] with one (scale, zp) per row and kv head
    ([N, page, K, 2]): the codes and pairs written by ``append_rows_quant``
    / ``append_chunk_quant`` are bitwise the reference's, fp8 through
    ``raw``'s uint8 view;
  * the plain K5q / K6q (ETAP) and K7q / K8q (the baseline) over a GQA
    cache [B, S, K, hd] read as its grouped rows, and K7q / K8q over a
    latent with V its first Dv columns, against the reference's Pallas
    kernels fed the dequantized rows and fp32 q: both modes, both rescale
    modes, n = 1 and n = 2 (K2 after it), ragged lengths, fp32
    ``atol = rtol = 1e-5``;
  * the reference's RMSE gates against the fp64 oracle at its geometry;
  * ``decode_step`` and ``prefill_chunk`` of reduced Qwen3 (G = 2: both
    code types in both modes) and Granite (MQA, G = 4: int8 etap, fp8
    standard) over quantized paged pools: logits and pair pools within
    2e-5, code pools bitwise;
  * the serve loop: greedy tokens, ``batch_slots`` and counts equal to
    JAX's ``run_paged`` for Qwen3 int8 / fp8 in both modes and DeepSeek's
    ``--layers 1 --mode standard --kv-dtype int8|fp8``; and inside the
    port, swap preemption and prefix-cache sharing over a Qwen3 fp8 pool
    bitwise the uncontended run.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.kernels.etap import combine as jcombine
from repro.kernels.etap import etap as jetap
from repro.kernels.etap import ref as jref
from repro.kernels.flash_decode import flash_decode as jfd
from repro.launch import serve as jserve
from repro.models import model as jmodel
from repro.runtime import paged_cache as jpc
from repro_torch.configs import get_config, reduced
from repro_torch.core import etap as core
from repro_torch.core.attn_spec import AttnSpec
from repro_torch.kernels import splitkv
from repro_torch.kernels.etap import combine, etap, ref, schedule
from repro_torch.kernels.flash_decode import flash_decode as fd
from repro_torch.launch import serve
from repro_torch.models import model
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import paged_cache as pc

TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=2e-5, rtol=2e-5)
LAYOUTS = ["int8", "fp8"]
RESCALE = ["amla", "mul"]
RMSE_GATE = {"int8": 6.12e-4, "fp8": 2.22e-3}   # tests/test_softmax_state.py


def _bits(x):
    """The bits of a code or fp32 array (torch or JAX) as numpy."""
    if isinstance(x, torch.Tensor):
        x = pc.raw(x).numpy()
    x = np.asarray(x)
    return x.view(np.uint8) if x.dtype.itemsize == 1 else x.view(np.int32)


def _to_jax(x):
    """A torch tensor as a JAX array of the same bits (fp8 codes too)."""
    if x.dtype == torch.float8_e4m3fn:
        return jnp.asarray(pc.raw(x).numpy()).view(jnp.float8_e4m3fn)
    return jnp.asarray(x.numpy())


def _close(port, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(want), **tol)


# --------------------------------------------------------------- pools
@pytest.mark.parametrize("kv_dtype", LAYOUTS)
def test_gqa_pool_writes_bitwise_reference(kv_dtype):
    """One row per sequence, then a chunk, quantized into GQA pools
    [N, page, K, hd] and their (scale, zp) pools [N, page, K, 2] through a
    shuffled table (an idle slot on the null block): codes and pairs are
    the reference's bit for bit."""
    rng = np.random.default_rng(1)
    N, page, K, hd = 9, 4, 2, 16
    table = np.asarray([[3, 7, 1, 5], [2, 8, 4, 6], [0, 0, 0, 0]], np.int32)
    lengths = np.asarray([9, 2, 0], np.int32)
    codes = torch.zeros(N, page, K, hd, dtype=torch.uint8).view(
        pc.quant_dtype(kv_dtype))
    sz = torch.zeros(N, page, K, 2)
    sz[..., 0] = 1.0
    jcodes, jsz = _to_jax(codes), jnp.asarray(sz.numpy())
    row = (rng.normal(size=(3, K, hd)) * 5).astype(np.float32)
    chunk = (rng.normal(size=(3, 3, K, hd)) * 3).astype(np.float32)
    t, lt = torch.from_numpy(table), torch.from_numpy(lengths)
    codes, sz = pc.append_rows_quant(codes, sz, t, lt, torch.from_numpy(row))
    jcodes, jsz = jpc.append_rows_quant(jcodes, jsz, jnp.asarray(table),
                                        jnp.asarray(lengths),
                                        jnp.asarray(row))
    lengths += 1
    lengths[2] = 0
    lt = torch.from_numpy(lengths)
    codes, sz = pc.append_chunk_quant(codes, sz, t, lt,
                                      torch.from_numpy(chunk))
    jcodes, jsz = jpc.append_chunk_quant(jcodes, jsz, jnp.asarray(table),
                                         jnp.asarray(lengths),
                                         jnp.asarray(chunk))
    # the idle slot's rows land in the null block on both sides; compare
    # the real blocks
    np.testing.assert_array_equal(_bits(codes)[1:], _bits(jcodes)[1:])
    np.testing.assert_array_equal(_bits(sz)[1:], _bits(jsz)[1:])


# ------------------------------------------- plain kernels against Pallas
KB, KS, KBLOCK = 3, 45, 16
KLEN = [45, 1, 20]


def _case(seed, shape, kv_dtype):
    """q [BG, G, Dk] fp32, code rows and their pairs, ragged lengths [BG]:
    "gqa", a cache [B, S, K, hd] of K = 2 kv heads of G = 2 (separate V),
    or "latent", rows [B, S, 40] with V their first 32 columns (fused)."""
    rng = np.random.default_rng(seed)
    if shape == "gqa":
        Kv, G, Dk, Dv = 2, 2, 32, 32
        k = rng.normal(size=(KB, KS, Kv, Dk)).astype(np.float32)
        v = rng.normal(size=(KB, KS, Kv, Dv)).astype(np.float32)
        kc, ks = pc.quantize_rows(torch.from_numpy(k), kv_dtype)
        vc, vs = pc.quantize_rows(torch.from_numpy(v), kv_dtype)
    else:
        Kv, G, Dk, Dv = 1, 4, 40, 32
        k = rng.normal(size=(KB, KS, Dk)).astype(np.float32)
        kc, ks = pc.quantize_rows(torch.from_numpy(k), kv_dtype)
        vc, vs = kc[..., :Dv], ks
    q = torch.from_numpy(rng.normal(size=(KB * Kv, G, Dk)).astype(np.float32))
    lengths = torch.tensor(KLEN, dtype=torch.int32).repeat_interleave(Kv)
    return q, kc, ks, vc, vs, lengths


def _grouped_rows(codes, sz):
    """The reference's view: dequantized fp32 rows, grouped [BG, S, D]."""
    return jnp.asarray(splitkv.grouped(pc.dequantize_rows(codes, sz)).numpy())


@pytest.mark.parametrize("n_splits", [1, 2])
@pytest.mark.parametrize("rescale", RESCALE)
@pytest.mark.parametrize("kv_dtype", LAYOUTS)
@pytest.mark.parametrize("kernel,shape", [("etap", "gqa"),
                                          ("standard", "gqa"),
                                          ("standard", "latent")])
def test_plain_quant_kernels_match_pallas(kernel, shape, kv_dtype, rescale,
                                          n_splits):
    """K5q / K7q (n = 1) and K6q / K8q + K2 (n = 2), handed codes and pairs
    (a GQA cache in place, or a latent with fused V), against the
    reference's Pallas kernels in interpret mode on the dequantized fp32
    rows (zero-padded to the split geometry) with fp32 q."""
    q, kc, ks, vc, vs, lens = _case(10 + n_splits, shape, kv_dtype)
    jk, jv = _grouped_rows(kc, ks), _grouped_rows(vc, vs)
    P = schedule.split_geometry(KS, KBLOCK, n_splits)[3]
    jk, jv = (jnp.pad(a, ((0, 0), (0, P - KS), (0, 0))) for a in (jk, jv))
    jq, jlen = jnp.asarray(q.numpy()), jnp.asarray(lens.numpy())
    kw = dict(scale=q.shape[-1] ** -0.5, rescale=rescale)
    qkw = dict(k_sz=ks, v_sz=vs)
    if n_splits == 1:
        jfn = jetap.etap_decode_pallas if kernel == "etap" else \
            jfd.flash_decode_pallas
        fn = etap.etap_decode_dense_quant if kernel == "etap" else \
            fd.flash_decode_quant
        out = fn(q, kc, vc, lens, block=KBLOCK, **qkw, **kw)
        assert out.dtype == torch.float32
        _close(out, jfn(jq, jk, jv, jlen, block=KBLOCK, **kw))
        return
    plan = schedule.dense_split_plan(KS, KBLOCK, n_splits)
    if kernel == "etap":
        jst = jetap.etap_partial_pallas(jq, jk, jv, jlen, block=KBLOCK,
                                        n_splits=n_splits, **kw)
        st = etap.etap_partial_dense_quant(q, kc, vc, lens, plan=plan, **qkw,
                                           **kw)
        out = combine.combine_splits(*st, out_dtype=torch.float32,
                                     rescale=rescale)
    else:
        jst = jfd.flash_decode_partial_pallas(jq, jk, jv, jlen, block=KBLOCK,
                                              n_splits=n_splits, **kw)
        st = fd.flash_decode_partial_quant(q, kc, vc, lens, plan=plan, **qkw,
                                           **kw)
        out = combine.combine_splits_std(*st, out_dtype=torch.float32,
                                         rescale=rescale)
    for o, r in zip(st, jst, strict=True):
        _close(o, r)
    _close(out, jcombine.combine_splits_pallas(
        *jst, transposed=kernel == "etap", out_dtype=jnp.float32,
        rescale=rescale))


@pytest.mark.parametrize("kv_splits", [1, 2])
@pytest.mark.parametrize("mode", ["etap", "standard"])
def test_quant_decode_attention_entry(mode, kv_splits):
    """decode_attention over code rows picks the quantized kernels (fp32
    output) and equals the plain K5q / K7q of the rows dequantized first
    and handed to the fp entry; the split path (K6q / K8q + K2) equals the
    single pass within fp32 tolerance."""
    q, kc, ks, vc, vs, lens = _case(30, "gqa", "int8")
    spec = AttnSpec(scale=32 ** -0.5, mode=mode, kv_splits=kv_splits,
                    block=KBLOCK)
    out = core.decode_attention(q, kc, vc, lens, spec=spec, k_sz=ks, v_sz=vs)
    assert out.dtype == torch.float32
    want = core.decode_attention(q, pc.dequantize_rows(kc, ks),
                                 pc.dequantize_rows(vc, vs), lens,
                                 spec=spec.replace(kv_splits=1))
    _close(out, want)


# ----------------------------------------------------------- RMSE gates
@pytest.mark.parametrize("rescale", RESCALE)
@pytest.mark.parametrize("kv_dtype", LAYOUTS)
def test_rmse_gates_against_fp64_oracle(kv_dtype, rescale):
    """The reference's accuracy test (tests/test_softmax_state.py:258) at
    its geometry and seed, fp32 q: the baseline's K7q and K8q (n = 4) + K2
    over the latent's codes (V its first 512 columns) hold the gates, int8
    <= 6.12e-4 and fp8 <= 2.22e-3; at the 128-wide head with a separate V
    (the same rows' first 128 columns as K, the next 128 as V) K5q and K7q
    are within 1% of the reference's own route (its XLA decode on the
    dequantized rows) and int8 holds its gate there too (fp8 at this width
    is above 2.22e-3 on the reference's route itself)."""
    from repro.core import etap as jcore
    from repro.core.attn_spec import AttnSpec as JSpec
    B, H, S = 2, 16, 1024
    rng = np.random.default_rng(0)
    q = rng.normal(size=(B, H, 576)).astype(np.float32)
    kv = rng.normal(size=(B, S, 576)).astype(np.float32)
    lengths = torch.tensor([S // 2 + 3, S], dtype=torch.int32)
    oracle = ref.etap_decode_ref(torch.from_numpy(q).double(),
                                 torch.from_numpy(kv).double(),
                                 torch.from_numpy(kv[..., :512]).double(),
                                 lengths, scale=576 ** -0.5,
                                 dtype=torch.float64)
    codes, sz = pc.quantize_rows(torch.from_numpy(kv), kv_dtype)
    kw = dict(scale=576 ** -0.5, rescale=rescale, k_sz=sz, v_sz=sz)
    qt = torch.from_numpy(q)
    o7 = fd.flash_decode_quant(qt, codes, codes[..., :512], lengths,
                               block=64, **kw)
    o8 = combine.combine_splits_std(*fd.flash_decode_partial_quant(
        qt, codes, codes[..., :512], lengths,
        plan=schedule.dense_split_plan(S, 64, 4), **kw),
        out_dtype=torch.float32, rescale=rescale)
    for out in (o7, o8):
        rmse = float(((out.double() - oracle) ** 2).mean().sqrt())
        assert rmse <= RMSE_GATE[kv_dtype], rmse

    qh, kh, vh = q[..., :128], kv[..., :128], kv[..., 128:256]
    oracle = ref.etap_decode_ref(*(torch.from_numpy(a).double()
                                   for a in (qh, kh, vh)), lengths,
                                 scale=128 ** -0.5, dtype=torch.float64)
    (kc, ks), (vc, vs) = (pc.quantize_rows(torch.from_numpy(a), kv_dtype)
                          for a in (kh, vh))
    jroute = jcore.decode_attention(
        jnp.asarray(qh), *(jnp.asarray(pc.dequantize_rows(c, z).numpy())
                           for c, z in ((kc, ks), (vc, vs))),
        jnp.asarray(lengths.numpy()),
        spec=JSpec(scale=128 ** -0.5, block=64, rescale=rescale,
                   kv_splits=1))
    want = float(((torch.from_numpy(np.array(jroute)).double() - oracle)
                  ** 2).mean().sqrt())
    for fn in (etap.etap_decode_dense_quant, fd.flash_decode_quant):
        out = fn(torch.from_numpy(qh), kc, vc, lengths, k_sz=ks, v_sz=vs,
                 scale=128 ** -0.5, block=64, rescale=rescale)
        rmse = float(((out.double() - oracle) ** 2).mean().sqrt())
        assert rmse <= want * 1.01, (rmse, want)
        if kv_dtype == "int8":
            assert rmse <= RMSE_GATE[kv_dtype], rmse


# ----------------------------------------------------------------- model
@pytest.fixture(scope="module")
def models():
    """Reduced Qwen3 with 2 kv heads (G = 2) and reduced Granite (MQA,
    G = 4), fp32: arch -> (JAX config, port config, JAX params, port
    params)."""
    out = {}
    for arch in ("qwen3_8b", "granite_20b"):
        kw = {"kv_heads": 2} if arch == "qwen3_8b" else {}
        jcfg = jreduced(jget_config(arch), **kw)
        jparams = jmodel.init(jax.random.PRNGKey(0), jcfg)
        tree = jax.tree.map(np.asarray, jparams)
        out[arch] = (jcfg, reduced(get_config(arch), **kw), jparams,
                     params_from_jax(tree, device="cpu"))
    return out


def _stacked(jcache, key):
    c = np.asarray(jcache[0]["b0"][key])
    return [c[i] for i in range(c.shape[0])]


@pytest.mark.parametrize("arch,kv_dtype,mode", [
    ("qwen3_8b", "int8", "etap"), ("qwen3_8b", "fp8", "etap"),
    ("qwen3_8b", "int8", "standard"), ("qwen3_8b", "fp8", "standard"),
    ("granite_20b", "int8", "etap"), ("granite_20b", "fp8", "standard")])
def test_prefill_chunk_and_decode_step_match_jax(models, arch, kv_dtype,
                                                 mode):
    """prefill_chunk over the prompt in two chunks (the reference's fp32
    product on the dequantized rows), then two paged decode steps (K5q /
    K7q, then with two splits K6q / K8q + K2) over int8 / fp8 pools: logits
    within 2e-5 of JAX's at every step; every layer's code pools bitwise
    the reference's, and its (scale, zp) pools within the same 2e-5 (the
    rows come from the two frameworks' fp32 projections, which differ in
    the last bits through the layers, and a pair is a row's max and min;
    on the same rows the pairs are bitwise, as
    test_gqa_pool_writes_bitwise_reference holds)."""
    jcfg, cfg, jparams, params = models[arch]
    B, P = 2, 8
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                             size=(B, P + 2)).astype(np.int32)
    lay = pc.layout_for(B, P + 2, block_size=4)
    bp = pc.BlockPool(lay, B)
    for _ in range(B):
        bp.admit(0, P + 2)
    cache = model.init_paged_cache(cfg, lay, kv_dtype=kv_dtype, device="cpu")
    jcache = jmodel.init_paged_cache(jcfg, lay, kv_dtype=kv_dtype)
    from repro.core.attn_spec import AttnSpec as JSpec
    for lo, hi in ((0, 5), (5, P)):
        table, lengths = bp.device_views("cpu")
        logits, cache = model.prefill_chunk(
            params, cfg, cache, torch.from_numpy(toks[:, lo:hi]), table,
            lengths, spec=AttnSpec(mode=mode))
        jlogits, jcache = jmodel.prefill_chunk(
            jparams, jcfg, jcache, jnp.asarray(toks[:, lo:hi]),
            jnp.asarray(bp.table), jnp.asarray(bp.lengths),
            spec=JSpec(mode=mode))
        _close(logits, jlogits, MODEL_TOL)
        for b in range(B):
            bp.extend(b, hi - lo)
    for i in range(P, P + 2):
        kv_splits = 1 + i - P
        table, lengths = bp.device_views("cpu")
        logits, cache = model.decode_step(
            params, cfg, cache, torch.from_numpy(toks[:, i]),
            spec=AttnSpec(mode=mode, kv_splits=kv_splits),
            cache_layout="paged", block_table=table, lengths=lengths)
        jlogits, jcache = jmodel.decode_step(
            jparams, jcfg, jcache, jnp.asarray(toks[:, i]), None,
            spec=JSpec(mode=mode, kv_splits=kv_splits), cache_layout="paged",
            block_table=jnp.asarray(bp.table),
            lengths=jnp.asarray(bp.lengths))
        _close(logits, jlogits, MODEL_TOL)
        for b in range(B):
            bp.append(b)
    for key in ("k", "v"):
        for c, jc in zip(cache, _stacked(jcache, key), strict=True):
            np.testing.assert_array_equal(_bits(c[key])[1:], _bits(jc)[1:])
    for key in ("k_sz", "v_sz"):
        for c, jc in zip(cache, _stacked(jcache, key), strict=True):
            _close(c[key][1:], jc[1:], MODEL_TOL)


# ----------------------------------------------------------------- serve
PAGED = ["--reduced", "--batch", "2", "--prompt", "16", "--gen", "4",
         "--requests", "3", "--page-size", "8", "--prefill-chunk", "8"]


@pytest.fixture(scope="module")
def serve_weights():
    """Converted weights of reduced Qwen3 (2 kv heads) and of reduced
    DeepSeek cut to its first (dense) layer."""
    out = {}
    for arch, jcfg, cfg in (
            ("qwen3_8b", jreduced(jget_config("qwen3_8b"), kv_heads=2),
             reduced(get_config("qwen3_8b"), kv_heads=2)),
            ("deepseek_r1_671b",
             dataclasses.replace(jreduced(jget_config("deepseek_r1_671b")),
                                 num_layers=1),
             dataclasses.replace(reduced(get_config("deepseek_r1_671b")),
                                 num_layers=1))):
        tree = jax.tree.map(np.asarray,
                            jmodel.init(jax.random.PRNGKey(0), jcfg))
        out[arch] = (jcfg, cfg, params_from_jax(tree, device="cpu"))
    return out


@pytest.mark.parametrize("arch,mode,kv_dtype", [
    ("qwen3_8b", "etap", "int8"), ("qwen3_8b", "etap", "fp8"),
    ("qwen3_8b", "standard", "int8"), ("qwen3_8b", "standard", "fp8"),
    ("deepseek_r1_671b", "standard", "int8"),
    ("deepseek_r1_671b", "standard", "fp8")])
def test_serve_quantized_pools_tokens_equal_jax(serve_weights, arch, mode,
                                                kv_dtype):
    """Same weights, same flags: run_paged's greedy outputs, batch_slots
    (the quantized pool sized to the fp pool's bytes) and counts equal the
    JAX loop's — Qwen3 (G = 2) over int8 / fp8 pools in both modes, and
    DeepSeek (its first layer: ``--layers 1``) in the standard mode over
    its quantized latent pool."""
    jcfg, cfg, params = serve_weights[arch]
    flags = PAGED + ["--arch", arch, "--mode", mode, "--kv-dtype", kv_dtype]
    want = jserve.run_paged(jserve.parse_args(flags), jcfg)
    extra = ["--layers", "1"] if arch == "deepseek_r1_671b" else []
    args = serve.parse_args(flags + extra + ["--device", "cpu"])
    if extra:                     # qwen3's test config has 2 kv heads
        assert serve.config_for(args) == cfg
    got = serve.run_paged(args, cfg, params=params, device="cpu")
    assert got["outputs"] == want["outputs"] and len(got["outputs"]) == 3
    for key in ("tokens_served", "prefill_tokens", "steps", "batch_slots",
                "kv_dtype"):
        assert got[key] == want[key], key
    assert got["batch_slots"] > 2          # the fp pool's bytes buy more


CONTENDED = ["--reduced", "--arch", "qwen3_8b", "--batch", "1", "--prompt",
             "24", "--gen", "8", "--requests", "6", "--page-size", "8",
             "--prefill-chunk", "8", "--priority-classes", "3",
             "--arrival-rate", "0.25", "--trace", "burst", "--burst-size",
             "3", "--retry-backoff", "4", "--paranoia", "1", "--shared-prefix",
             "16", "--device", "cpu"]


def test_serve_gqa_quant_swap_and_prefix_bitwise(serve_weights):
    """Inside the port, over a Qwen3 fp8 pool (its codes move through their
    uint8 view; tests/test_torch_quant.py swaps an int8 latent pool): the
    contended burst trace preempts by swap (codes and the "k_sz" / "v_sz"
    pairs go to the host and back) and maps shared prompt blocks from the
    prefix cache (copy-on-write copies codes and pairs), and every request
    gets the uncontended, uncached run's outputs bitwise."""
    _, cfg, params = serve_weights["qwen3_8b"]
    kv_dtype = "fp8"

    def run(flags):
        return serve.run_paged(serve.parse_args(flags), cfg, params=params,
                               device="cpu")
    i = CONTENDED.index("--batch") + 1
    calm = run(CONTENDED[:i] + ["8"] + CONTENDED[i + 1:]
               + ["--kv-dtype", kv_dtype, "--no-prefix-cache"])
    assert calm["sched"]["preemptions"] == 0
    busy = run(CONTENDED + ["--kv-dtype", kv_dtype, "--preemption", "swap"])
    assert busy["sched"]["preemptions"] > 0
    assert busy["prefix"]["hits"] > 0
    assert busy["outputs"] == calm["outputs"] and len(busy["outputs"]) == 6
