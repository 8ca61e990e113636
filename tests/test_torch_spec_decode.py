"""The port's speculative decoding against the JAX package's.

Drafters and greedy acceptance against ``repro.runtime.spec_decode`` on the
same inputs (counters included); the head drafter's table against the
reference's, and the blocked table against itself at two block sizes;
``model.verify_step`` against JAX's on the same weights (the reference's
``model.init``, converted), over fp, int8 and fp8 pools, with a linear and
a tree-shaped ``qpos``, for the MLA (reduced DeepSeek-R1 without MoE) and
the GQA stack (reduced Qwen3-8B, 2 kv heads): logits within fp32 ``atol =
rtol = 2e-5`` (the same operations in another summation order, through two
layers), fp pools within the same tolerance, code pools bitwise; inside the
port, linear ``verify_step`` bitwise ``prefill_chunk``; and ``run_paged``
with ``--spec-tokens`` 1, 2, 4 and 8 (the reference's own serve flags,
``--paranoia 1``): outputs equal spec off, and outputs and the ``"spec"``
dict equal the JAX loop's spec-on run, also over int8 with the prefix
cache and with the head drafter; and the reference's flag refusals.
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
from repro.launch import serve as jserve
from repro.models import model as jmodel
from repro.runtime import paged_cache as jpc
from repro.runtime import spec_decode as jspec_decode
from repro.runtime import telemetry as jtelemetry
from repro_torch.configs import get_config, reduced
from repro_torch.core.attn_spec import AttnSpec
from repro_torch.launch import serve
from repro_torch.models import model
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import paged_cache as pc
from repro_torch.runtime import spec_decode, telemetry

TOL = dict(atol=2e-5, rtol=2e-5)


def _bytes(x):
    """A pool's bits, whatever its dtype (fp8 codes through their bytes)."""
    if isinstance(x, torch.Tensor):
        return pc.raw(x).contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


# ------------------------------------------------------------- proposers
RNG_HISTORIES = [np.random.default_rng(s).integers(0, 5, size=n).tolist()
                 for s, n in ((0, 12), (1, 30), (2, 7), (3, 50))]


@pytest.mark.parametrize("history,k", [
    ([1, 2, 3, 1, 2, 3, 1, 2], 3),          # repetitive: continue the loop
    ([1, 2, 7, 1, 2, 8, 1, 2], 1),          # the most recent match wins
    ([4], 3),                               # nothing to match: repeat last
    ([1, 2, 3, 4, 5], 2),                   # no suffix recurs: repeat last
    ([9, 1, 9, 1], 3),                      # continuation runs into suffix
    *[(h, k) for h in RNG_HISTORIES for k in (1, 3, 7)]])
def test_ngram_propose_matches_reference(history, k):
    assert spec_decode.ngram_propose(history, k) == \
        jspec_decode.ngram_propose(history, k)
    assert spec_decode.ngram_propose(np.asarray(history), k, max_n=2) == \
        jspec_decode.ngram_propose(np.asarray(history), k, max_n=2)


@pytest.mark.parametrize("drafts,preds", [
    ([5, 7], [5, 9, 4]), ([5, 9], [5, 9, 4]), ([6, 9], [5, 9, 4]),
    ([], [8]),
    ([6, 5], [5, 5, 4]),                    # a match after a miss: rejected
    *[(list(np.random.default_rng(s).integers(0, 3, size=k - 1)),
       list(np.random.default_rng(s + 50).integers(0, 3, size=k)))
      for s, k in ((0, 4), (1, 8), (2, 2), (3, 5), (4, 4))]])
def test_accept_greedy_matches_reference(drafts, preds):
    assert spec_decode.accept_greedy(drafts, np.asarray(preds)) == \
        jspec_decode.accept_greedy(drafts, np.asarray(preds))


def _embed(kind, V=200, D=12):
    rng = np.random.default_rng(7)
    if kind == "normal":
        return rng.normal(size=(V, D)).astype(np.float32)
    # small integers: every product exact, many exact ties (lowest index)
    return rng.integers(-2, 3, size=(V, D)).astype(np.float32)


@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_head_table_matches_reference(kind):
    """The blocked table equals the reference's whole-matrix one, with its
    tie rule (lowest index) and no fixpoint, at two block sizes."""
    e = _embed(kind)
    want = jspec_decode.HeadDraft(e).table
    for block in (7, 64, 2048):
        got = spec_decode.head_table(torch.from_numpy(e), block)
        np.testing.assert_array_equal(got, want)
    assert (want != np.arange(len(want))).all()
    head = spec_decode.HeadDraft(torch.from_numpy(e), block=13)
    ref = jspec_decode.HeadDraft(e)
    for hist in ([3], [0, 5, 199], [42]):
        assert head.propose(hist, 5) == ref.propose(hist, 5)


def test_make_drafter_and_counters_match_reference():
    """The factory's kinds, its refusal, and the wrapped proposer's
    counters (spec/draft_calls, spec/draft_len) as the reference's."""
    assert spec_decode.make_drafter("ngram", None) is \
        spec_decode.ngram_propose
    with pytest.raises(ValueError, match="unknown draft kind"):
        spec_decode.make_drafter("oracle", None)
    e = _embed("normal", V=64, D=8)
    for kind in spec_decode.DRAFT_KINDS:
        reg, jreg = telemetry.MetricsRegistry(), jtelemetry.MetricsRegistry()
        fn = spec_decode.make_drafter(kind, {"embed": torch.from_numpy(e)},
                                      metrics=reg)
        jfn = jspec_decode.make_drafter(kind, {"embed": e}, metrics=jreg)
        for hist, k in ((RNG_HISTORIES[1], 3), ([1, 2, 1], 1), ([5], 7)):
            assert fn(hist, k) == jfn(hist, k)
        assert reg.snapshot() == jreg.snapshot()
        assert reg.value("spec/draft_calls") == 3


# ------------------------------------------------------ model.verify_step
@pytest.fixture(scope="module")
def stacks():
    """arch -> (JAX config, port config, JAX params, port params): reduced
    DeepSeek-R1 without MoE, and reduced Qwen3-8B with 2 kv heads."""
    out = {}
    for arch, jcfg, cfg in (
            ("mla", dataclasses.replace(
                jreduced(jget_config("deepseek_r1_671b")), moe=None),
             dataclasses.replace(reduced(get_config("deepseek_r1_671b")),
                                 moe=None)),
            ("gqa", jreduced(jget_config("qwen3_8b"), kv_heads=2),
             reduced(get_config("qwen3_8b"), kv_heads=2))):
        jparams = jmodel.init(jax.random.PRNGKey(0), jcfg)
        tree = jax.tree.map(np.asarray, jparams)
        out[arch] = (jcfg, cfg, jparams, params_from_jax(tree, device="cpu"))
    return out


STARTS, K, PAGE = (5, 8), 4, 4
QPOS = {"linear": [0, 1, 2, 3], "tree": [0, 1, 1, 2]}


def _prefilled(stack, kv_dtype):
    """Both frameworks' paged caches after per-row chunked prefills of
    STARTS[b] prompt tokens (ragged starts), the pool holding each row's
    STARTS[b] + K positions.  Returns (bp, cache, jcache, tokens [B, S+K])."""
    jcfg, cfg, jparams, params = stack
    B = len(STARTS)
    total = max(STARTS) + K
    lay = pc.layout_for(B, total, block_size=PAGE)
    bp = pc.BlockPool(lay, B)
    for _ in range(B):
        bp.admit(0, total)
    toks = np.random.default_rng(11).integers(
        0, cfg.vocab_size, size=(B, total)).astype(np.int32)
    cache = model.init_paged_cache(cfg, lay, kv_dtype=kv_dtype, device="cpu")
    jcache = jmodel.init_paged_cache(jcfg, lay, kv_dtype=kv_dtype)
    for b, n in enumerate(STARTS):
        t = toks[b:b + 1, :n]
        _, cache = model.prefill_chunk(
            params, cfg, cache, torch.from_numpy(t),
            torch.from_numpy(bp.table[b:b + 1]),
            torch.from_numpy(bp.lengths[b:b + 1]), spec=AttnSpec())
        _, jcache = jmodel.prefill_chunk(
            jparams, jcfg, jcache, jnp.asarray(t),
            jnp.asarray(bp.table[b:b + 1]), jnp.asarray(bp.lengths[b:b + 1]),
            spec=JSpec())
        bp.extend(b, n)
    return bp, cache, jcache, toks


def _drafts(toks):
    """Each row's K verify tokens: its next committed token and a draft."""
    return np.stack([toks[b, n:n + K] for b, n in enumerate(STARTS)])


@pytest.mark.parametrize("qkind", ["linear", "tree"])
@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "fp8"])
@pytest.mark.parametrize("arch", ["mla", "gqa"])
def test_verify_step_matches_jax(stacks, arch, kv_dtype, qkind):
    """verify_step over ragged starts: logits within 2e-5 of JAX's
    verify_step, and every layer's pools after the append: fp rows within
    2e-5, codes bitwise, (scale, zp) pairs within 2e-5 (a row's max and
    min, from the two frameworks' fp32 projections)."""
    jcfg, cfg, jparams, params = stacks[arch]
    bp, cache, jcache, toks = _prefilled(stacks[arch], kv_dtype)
    draft = _drafts(toks)
    qpos = bp.lengths[:, None] + np.asarray(QPOS[qkind], np.int32)[None, :]
    table, lengths = bp.device_views("cpu")
    logits, cache = model.verify_step(
        params, cfg, cache, torch.from_numpy(draft), table, lengths,
        spec=AttnSpec(), qpos=torch.from_numpy(qpos.astype(np.int32)))
    jlogits, jcache = jmodel.verify_step(
        jparams, jcfg, jcache, jnp.asarray(draft), jnp.asarray(bp.table),
        jnp.asarray(bp.lengths), spec=JSpec(),
        qpos=jnp.asarray(qpos, jnp.int32))
    assert logits.shape == (len(STARTS), K, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    for key in cache[0]:
        jc = np.asarray(jcache[0]["b0"][key])
        for li, layer in enumerate(cache):
            got, want = layer[key][1:], jc[li][1:]   # block 0: the null
            if key.endswith("_sz") or kv_dtype == "fp":
                np.testing.assert_allclose(got.numpy(), want, **TOL)
            else:
                np.testing.assert_array_equal(_bytes(got), _bytes(want))


@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "fp8"])
@pytest.mark.parametrize("arch", ["mla", "gqa"])
def test_linear_verify_step_bitwise_prefill_chunk(stacks, arch, kv_dtype):
    """Inside the port, verify_step on a linear chain (qpos None) is
    prefill_chunk on the same tokens: logits and every pool, bitwise."""
    _, cfg, _, params = stacks[arch]
    bp, cache, _, toks = _prefilled(stacks[arch], kv_dtype)
    other = [{k: v.clone() for k, v in layer.items()} for layer in cache]
    draft = torch.from_numpy(_drafts(toks))
    table, lengths = bp.device_views("cpu")
    lp, cache = model.prefill_chunk(params, cfg, cache, draft, table, lengths,
                                    spec=AttnSpec())
    lv, other = model.verify_step(params, cfg, other, draft, table, lengths,
                                  spec=AttnSpec())
    np.testing.assert_array_equal(_bytes(lv), _bytes(lp))
    for a, b in zip(cache, other, strict=True):
        for key in a:
            np.testing.assert_array_equal(_bytes(a[key]), _bytes(b[key]))


# ------------------------------------------------------ serve: spec slots
SPEC_BASE = ["--reduced", "--batch", "2", "--prompt", "16", "--gen", "8",
             "--requests", "3", "--page-size", "8", "--prefill-chunk", "8",
             "--cache-layout", "paged", "--paranoia", "1", "--seed", "0"]
SPEC_KEYS = ("serve/spec_verify_steps", "serve/spec_proposed",
             "serve/spec_accepted", "spec/draft_calls", "serve/decode_tokens",
             "serve/decode_steps")


def _port(stack, flags):
    return serve.run_paged(serve.parse_args(flags + ["--device", "cpu"]),
                           stack[1], params=stack[3], device="cpu")


_JAX_RUNS: dict = {}


def _jax(stack, flags):
    """The JAX loop's run of ``flags`` (each run once a module)."""
    key = (stack[1].name, tuple(flags))
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = jserve.run_paged(jserve.parse_args(flags), stack[0])
    return _JAX_RUNS[key]


def _spec_matches(got, want, off):
    """Spec on: the spec-off run's outputs and tokens, and the JAX spec-on
    run's outputs, "spec" dict, counters and proposal-length histogram."""
    assert got["outputs"] == off["outputs"]
    assert got["tokens_served"] == off["tokens_served"]
    assert got["outputs"] == want["outputs"]
    assert got["spec"] == want["spec"]
    for key in SPEC_KEYS:
        assert got["metrics"]["counters"][key] == \
            want["metrics"]["counters"][key], key
    assert got["metrics"]["histograms"]["spec/draft_len"] == \
        want["metrics"]["histograms"]["spec/draft_len"]


@pytest.fixture(scope="module")
def spec_off(stacks):
    return _port(stacks["mla"], SPEC_BASE)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_serve_spec_equals_spec_off_and_jax(stacks, spec_off, k):
    """At every window k the port's spec-on outputs are the spec-off
    outputs (k 8 == --gen: slots fall back to the one-token step once
    fewer than k tokens are left), and outputs, "spec" dict and counters
    are the JAX loop's spec-on run's."""
    flags = SPEC_BASE + ["--spec-tokens", str(k)]
    got = _port(stacks["mla"], flags)
    _spec_matches(got, _jax(stacks["mla"], flags), spec_off)
    assert got["spec"]["k"] == k and got["spec"]["draft"] == "ngram"
    if k > 1:
        assert got["spec"]["proposed"] > 0 and got["spec"]["steps"] > 0


@pytest.mark.parametrize("arch,kvd,prefix,draft", [
    ("mla", "int8", True, "ngram"), ("mla", "int8", False, "head"),
    ("gqa", "fp8", False, "ngram")],
    ids=["int8-prefix-ngram", "int8-head", "gqa-fp8-ngram"])
def test_serve_spec_quant_prefix_head_gqa(stacks, arch, kvd, prefix, draft):
    """k 4 over an int8 pool with a shared prompt prefix (the prefix cache
    looked up, as in the reference's test), the head drafter over an int8 pool, and the GQA stack over an
    fp8 pool: spec on == spec off in the port, and == the JAX loop's spec-on
    run."""
    base = SPEC_BASE + ["--kv-dtype", kvd]
    if arch == "gqa":
        base += ["--arch", "qwen3_8b"]
    if prefix:
        base += ["--shared-prefix", "8"]
    flags = base + ["--spec-tokens", "4", "--spec-draft", draft]
    off = _port(stacks[arch], base)
    got = _port(stacks[arch], flags)
    _spec_matches(got, _jax(stacks[arch], flags), off)
    if prefix:
        assert got["prefix"]["lookups"] > 0
        assert got["prefix"] == _jax(stacks[arch], flags)["prefix"]


@pytest.mark.parametrize("flags,words", [
    (["--spec-tokens", "-1"], "--spec-tokens must be >= 0"),
    (["--spec-tokens", "2", "--cache-layout", "dense"],
     "--spec-tokens requires --cache-layout paged"),
    (["--spec-tokens", "2", "--spec-draft", "head", "--kv-dtype", "fp8"],
     "--spec-draft head is not supported with --kv-dtype fp8")])
def test_spec_flag_refusals_match_reference(flags, words, capsys):
    with pytest.raises(SystemExit):
        jserve.parse_args(flags)
    assert words in capsys.readouterr().err
    with pytest.raises(SystemExit):
        serve.parse_args(flags + ["--device", "cpu"])
    assert words in capsys.readouterr().err


def test_spec_flags_parse():
    args = serve.parse_args(["--spec-tokens", "3", "--spec-draft", "head"])
    assert (args.spec_tokens, args.spec_draft) == (3, "head")
    assert serve.parse_args([]).spec_draft == "ngram"
    assert serve.parse_args(["--spec-tokens", "2", "--kv-dtype", "fp8"]) \
        .spec_tokens == 2
    assert spec_decode.DRAFT_KINDS == jspec_decode.DRAFT_KINDS


def test_jax_pools_layout_matches(stacks):
    """The pools verify_step appends to are laid out as the reference's
    (the comparisons above index the JAX cache as one stacked group)."""
    for arch in ("mla", "gqa"):
        jcfg, cfg, _, _ = stacks[arch]
        assert len(jmodel.layer_groups(jcfg)) == 1
        lay = jpc.layout_for(1, 8, block_size=PAGE)
        c = model.init_paged_cache(cfg, lay, kv_dtype="int8", device="cpu")
        jc = jmodel.init_paged_cache(jcfg, lay, kv_dtype="int8")
        assert set(c[0]) == set(jc[0]["b0"])
        for key in c[0]:
            assert tuple(c[0][key].shape) == jc[0]["b0"][key].shape[1:]
