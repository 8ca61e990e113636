"""The port's MoE FFN and the MoE model paths against the JAX package.

``models/moe.py``: the slot assignment is integer arithmetic and must equal
the reference's exactly, drops included; ``moe_ffn`` is held to JAX's in
both capacity rules (training / single-shot prefill, and the dropless
serving rule) on reduced DeepSeek-R1 (shared expert), DBRX (top-k > 1, no
shared expert) and Llama-4-Maverick (top-1 and a shared expert), with equal
routes, the output within fp32 ``atol = rtol = 1e-5`` and the aux losses
within 1e-6.  The model: reduced DeepSeek-R1 with its MoE layer (layer 0
dense, layer 1 MoE), fp32 on the CPU, where the port runs its kernels'
plain versions and JAX its default (XLA) path; logits within ``atol = rtol
= 2e-5`` (the same operations in another summation order, through two
layers) for ``forward``, ``prefill``, ``prefill_chunk``, the paged and
dense ``decode_step`` and ``verify_step``, and the serve loops' greedy
tokens equal to JAX's on the same weights and requests.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.attn_spec import AttnSpec as JSpec
from repro.launch import serve as jserve
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.runtime import paged_cache as jpc
from repro_torch.configs import get_config, reduced
from repro_torch.core.attn_spec import AttnSpec
from repro_torch.launch import serve
from repro_torch.models import model, moe
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import paged_cache as pc

TOL = dict(atol=2e-5, rtol=2e-5)
FFN_TOL = dict(atol=1e-5, rtol=1e-5)
AUX_TOL = dict(atol=1e-6, rtol=1e-6)
ARCHS = ["deepseek_r1_671b", "dbrx_132b", "llama4_maverick_400b"]
# the reference's MoE functions, each compiled once a shape (op by op they
# dispatch dozens of small programs)
j_assign_slots = jax.jit(jmoe._assign_slots, static_argnums=(1, 2))
j_moe_ffn = jax.jit(jmoe.moe_ffn, static_argnums=(1,),
                    static_argnames=("dropless",))


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **tol)


def _cfgs(arch, **moe_kw):
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    if moe_kw:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, **moe_kw))
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))
    return jcfg, cfg


def _moe_params(jcfg, seed=0):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tree = jax.tree.map(np.asarray, jp)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return torch.from_numpy(np.array(t))
    return jp, tree, conv(tree)


# ------------------------------------------------------------ slot assignment
def _slots_equal(idx, E, C):
    slot, tos = moe._assign_slots(torch.from_numpy(idx), E, C)
    jslot, jtos = j_assign_slots(jnp.asarray(idx), E, C)
    assert slot.dtype == tos.dtype == torch.int32
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(tos.numpy(), np.asarray(jtos))
    return slot.numpy(), tos.numpy()


@pytest.mark.parametrize("G,S,k,E,C,seed", [
    (1, 16, 1, 2, 4, 0), (2, 24, 2, 4, 8, 1), (3, 32, 3, 8, 4, 2),
    (1, 8, 8, 256, 8, 3), (2, 40, 2, 16, 2, 4), (1, 5, 4, 4, 5, 5)])
def test_assign_slots_equal_jax(G, S, k, E, C, seed):
    """Random choices (distinct experts a token, as top-k gives), some
    experts over capacity: slots and their inverse equal JAX's exactly."""
    rng = np.random.default_rng(seed)
    idx = np.stack([np.stack([rng.choice(E, size=k, replace=False)
                              for _ in range(S)]) for _ in range(G)])
    slot, _ = _slots_equal(idx.astype(np.int32), E, C)
    if (G, S, k, E, C) == (2, 40, 2, 16, 2):
        assert (slot == E * C).any()          # this case drops


def test_capacity_drops_are_earliest_token_wins():
    """All 16 tokens to expert 0 at C = 4: the first four keep slots 0-3,
    the rest are dropped, as in the reference's test."""
    slot, tos = _slots_equal(np.zeros((1, 16, 1), np.int32), 2, 4)
    assert slot[0, :4].tolist() == [0, 1, 2, 3]
    assert (slot[0, 4:] == 8).all()
    assert tos[0, :4].tolist() == [0, 1, 2, 3]
    assert (tos[0, 4:] == 16).all()


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2 ** 16), E=st.sampled_from([2, 4, 8]),
       k=st.integers(1, 3), C=st.integers(1, 12))
def test_property_slot_assignment_matches_jax(seed, E, k, C):
    """Any choices (repeats allowed) at any capacity: equal to JAX's, kept
    pairs in distinct slots, and the inverse map consistent."""
    rng = np.random.default_rng(seed)
    S = 24
    idx = rng.integers(0, E, size=(2, S, k)).astype(np.int32)
    slot, tos = _slots_equal(idx, E, C)
    for g in range(2):
        s = slot[g]
        kept = s[s < E * C]
        assert len(np.unique(kept)) == len(kept)
        for f, sl in enumerate(s):
            if sl < E * C:
                assert tos[g, sl] == f // k


# ----------------------------------------------------------------- moe_ffn
def _routes_equal(p, cfg, jp, jcfg, x):
    _, _, gate_k, idx_k = moe.route(p, cfg, torch.from_numpy(x))
    logits = jnp.einsum("gsd,de->gse", jnp.asarray(x), jp["router"])
    jgate, jidx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                                jcfg.moe.top_k)
    np.testing.assert_array_equal(idx_k.numpy(), np.asarray(jidx))
    _close(gate_k, jgate, FFN_TOL)
    return idx_k


@pytest.mark.parametrize("dropless", [False, True],
                         ids=["capacity", "dropless"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(arch, dropless):
    """Equal routes, output within 1e-5, aux within 1e-6, in both capacity
    rules (the reduced configs' capacity factor 8 drops nothing; the
    overflow cases below do)."""
    jcfg, cfg = _cfgs(arch)
    jp, _, p = _moe_params(jcfg)
    assert ("shared" in p) == cfg.moe.shared_expert
    x = np.random.default_rng(3).normal(size=(2, 12, cfg.d_model)).astype(
        np.float32)
    _routes_equal(p, cfg, jp, jcfg, x)
    out, aux = moe.moe_ffn(p, cfg, torch.from_numpy(x), dropless=dropless)
    jout, jaux = j_moe_ffn(jp, jcfg, jnp.asarray(x), dropless=dropless)
    _close(out, jout, FFN_TOL)
    assert set(aux) == set(jaux) == set(model.AUX_KEYS)
    for key in aux:
        _close(aux[key], jaux[key], AUX_TOL)
    assert float(aux["load_balance"]) >= 1.0 - 1e-3


@pytest.mark.parametrize("dropless", [False, True],
                         ids=["capacity", "dropless"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_overflow_matches_jax(arch, dropless):
    """Forced overflow: 16 experts, capacity factor 1, and a router skewed
    toward experts 3 and 11, so that both capacity rules drop pairs (the
    dropless rule's C = 4 ceil(k S / E) is below S = 32); the port drops
    the same pairs and gives JAX's output."""
    jcfg, cfg = _cfgs(arch, num_experts=16, capacity_factor=1.0)
    jp, tree, p = _moe_params(jcfg, seed=1)
    skew = np.zeros((1, 16), np.float32)
    skew[0, [3, 11]] = 4.0
    jp = dict(jp, router=jp["router"] + skew)
    p = dict(p, router=p["router"] + torch.from_numpy(skew))
    S = 32
    x = np.random.default_rng(4).normal(size=(2, S, cfg.d_model)).astype(
        np.float32)
    idx_k = _routes_equal(p, cfg, jp, jcfg, x)
    C = moe.capacity(cfg, S, dropless)
    assert C < S
    slot, _ = moe._assign_slots(idx_k, 16, C)
    assert int((slot == 16 * C).sum()) > 0            # pairs are dropped
    out, aux = moe.moe_ffn(p, cfg, torch.from_numpy(x), dropless=dropless)
    jout, jaux = j_moe_ffn(jp, jcfg, jnp.asarray(x), dropless=dropless)
    _close(out, jout, FFN_TOL)
    for key in aux:
        _close(aux[key], jaux[key], AUX_TOL)


@pytest.mark.parametrize("S,dropless", [(1, True), (8, True), (200, True),
                                        (3, False), (64, False),
                                        (512, False)])
def test_capacity_rules_match_reference(S, dropless):
    """The capacity of both rules at DeepSeek-R1's full width (E 256, k 8)
    equals the reference's formula."""
    cfg, m = get_config("deepseek_r1_671b"), get_config(
        "deepseek_r1_671b").moe
    if dropless:
        want = min(S, max(m.top_k, 4 * -(-m.top_k * S // m.num_experts)))
    else:
        want = min(jmoe._capacity(S, jget_config("deepseek_r1_671b")),
                   max(4, S))
    assert moe.capacity(cfg, S, dropless) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_matches_reference_layout(arch):
    """The port's own init gives the reference's leaves, shapes and dtypes
    at a bf16 model: the router fp32, the experts bf16."""
    jcfg, cfg = _cfgs(arch)
    jtree = jax.tree.map(np.asarray, jmoe.init_moe(
        jax.random.PRNGKey(0), jcfg, jnp.bfloat16))
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, cfg, torch.bfloat16, "cpu")

    def flat(t, pre=""):
        if isinstance(t, dict):
            return {n: v for k, sub in t.items()
                    for n, v in flat(sub, f"{pre}{k}.").items()}
        return {pre[:-1]: t}
    got, want = flat(p), flat(jtree)
    assert sorted(got) == sorted(want)
    for key, t in got.items():
        assert tuple(t.shape) == want[key].shape, key
        assert str(t.dtype).split(".")[-1] == want[key].dtype.name, key
    assert p["router"].dtype == torch.float32


# -------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def deepseek():
    jcfg, cfg = _cfgs("deepseek_r1_671b")
    assert [s[1] for s in model.signatures(cfg)] == [False, True]
    jparams = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, tree, params_from_jax(tree, device="cpu")


def test_params_carry_moe_leaves(deepseek):
    """The MoE leaves convert bitwise, unstacked per layer; a bf16 model
    keeps its fp32 router."""
    jcfg, cfg, _, tree, params = deepseek
    ffn, jffn = params["layers"][1]["ffn"], tree["groups"][1]["b0"]["ffn"]
    assert sorted(ffn) == ["router", "shared", "w_down", "w_gate", "w_up"]
    for key in ("router", "w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(ffn[key].numpy(), jffn[key][0])
    np.testing.assert_array_equal(ffn["shared"]["w_up"].numpy(),
                                  jffn["shared"]["w_up"][0])
    bcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    btree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0),
                                                 bcfg))
    bffn = params_from_jax(btree, device="cpu")["layers"][1]["ffn"]
    assert bffn["router"].dtype == torch.float32
    assert bffn["w_gate"].dtype == torch.bfloat16
    own = model.init(dataclasses.replace(cfg, dtype="bfloat16"), seed=0,
                     device="cpu")
    assert model.param_count(own) == model.param_count(params) == sum(
        a.size for a in jax.tree.leaves(btree))


def test_forward_logits_and_aux_match_jax(deepseek):
    """forward: logits within 2e-5, the aux losses summed over the layers
    within 1e-6, and the cache rows it collects those of JAX's."""
    jcfg, cfg, jparams, _, params = deepseek
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                             size=(2, 16)).astype(np.int32)
    logits, aux, cache = model.forward(params, cfg, torch.from_numpy(toks),
                                       collect_cache=True)
    jlogits, jaux, jcache = jmodel.forward(
        jparams, jcfg, {"tokens": jnp.asarray(toks)}, collect_cache=True)
    _close(logits, jlogits)
    for key in model.AUX_KEYS:
        _close(aux[key], jaux[key], AUX_TOL)
    assert float(aux["load_balance"]) > 0
    for i, layer in enumerate(cache):
        _close(layer["c"], jcache[i]["b0"]["c"][0])
    assert model.forward(params, cfg, torch.from_numpy(toks))[2] is None


def test_prefill_and_dense_decode_match_jax(deepseek):
    """Single-shot prefill (capacity routing) and three dense decode steps
    (one dropless group of B tokens a MoE layer) against JAX's."""
    jcfg, cfg, jparams, _, params = deepseek
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                             size=(2, 10)).astype(np.int32)
    last, cache, pos = model.prefill(params, cfg, torch.from_numpy(toks), 16)
    jlast, jcache, jpos = jmodel.prefill(jparams, jcfg,
                                         {"tokens": jnp.asarray(toks)}, 16)
    assert pos == jpos == 10
    _close(last, jlast)
    nxt = np.argmax(np.asarray(jlast), -1).astype(np.int32)
    for step in range(3):
        logits, cache = model.decode_step(params, cfg, cache,
                                          torch.from_numpy(nxt), pos + step)
        jlogits, jcache = jmodel.decode_step(jparams, jcfg, jcache,
                                             jnp.asarray(nxt), jpos + step,
                                             spec=JSpec())
        _close(logits, jlogits)
        nxt = np.argmax(np.asarray(jlogits), -1).astype(np.int32)


def _paged(cfg, B, ctx, bs=8):
    lay = pc.layout_for(B, ctx, block_size=bs)
    bp = pc.BlockPool(lay, B)
    for _ in range(B):
        bp.admit(0, ctx)
    return lay, bp


@pytest.mark.parametrize("mode", ["etap", "standard"])
def test_paged_prefill_chunk_decode_verify_match_jax(deepseek, mode):
    """On the paged layout: two prompt chunks (dropless, G = B), two decode
    steps and a verify step with a tree qpos, each against JAX's on the
    same pools; the pools stay within 2e-5 too."""
    jcfg, cfg, jparams, _, params = deepseek
    B, P = 2, 12
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                             size=(B, P + 6)).astype(np.int32)
    lay, bp = _paged(cfg, B, 32)
    cache = model.init_paged_cache(cfg, lay, device="cpu")
    jcache = jmodel.init_paged_cache(jcfg, lay)
    spec, jspec = AttnSpec(mode=mode), JSpec(mode=mode)

    def views():
        table, lengths = bp.device_views("cpu")
        return table, lengths, jnp.asarray(bp.table), jnp.asarray(bp.lengths)

    for lo, hi in ((0, 7), (7, P)):
        table, lengths, jt, jl = views()
        lg, cache = model.prefill_chunk(params, cfg, cache,
                                        torch.from_numpy(toks[:, lo:hi]),
                                        table, lengths, spec=spec)
        jlg, jcache = jmodel.prefill_chunk(jparams, jcfg, jcache,
                                           jnp.asarray(toks[:, lo:hi]), jt,
                                           jl, spec=jspec)
        _close(lg, jlg)
        for b in range(B):
            bp.extend(b, hi - lo)
    for i in range(P, P + 2):
        table, lengths, jt, jl = views()
        lg, cache = model.decode_step(params, cfg, cache,
                                      torch.from_numpy(toks[:, i]), spec=spec,
                                      cache_layout="paged", block_table=table,
                                      lengths=lengths)
        jlg, jcache = jmodel.decode_step(jparams, jcfg, jcache,
                                         jnp.asarray(toks[:, i]), None,
                                         spec=jspec, cache_layout="paged",
                                         block_table=jt, lengths=jl)
        _close(lg, jlg)
        for b in range(B):
            bp.append(b)
    qpos = np.asarray(bp.lengths)[:, None] + np.array([0, 1, 1, 2])[None, :]
    for b in range(B):
        bp.extend(b, 4)
    table, _, jt, _ = views()
    lengths = torch.from_numpy(np.asarray(bp.lengths) - 4)
    vt = toks[:, P + 2:P + 6]
    lg, cache = model.verify_step(params, cfg, cache, torch.from_numpy(vt),
                                  table, lengths, spec=spec,
                                  qpos=torch.from_numpy(qpos))
    jlg, jcache = jmodel.verify_step(jparams, jcfg, jcache, jnp.asarray(vt),
                                     jt, jnp.asarray(lengths.numpy()),
                                     spec=jspec,
                                     qpos=jnp.asarray(qpos, jnp.int32))
    _close(lg, jlg)
    for li, layer in enumerate(cache):
        _close(layer["c"][1:], np.asarray(jcache[li]["b0"]["c"][0])[1:])


def test_chunked_prefill_self_consistent(deepseek):
    """Many chunks against one chunk, both dropless through prefill_chunk:
    the self-consistency oracle of the reference's MoE chunk test, at
    fp32 2e-5 here (these inputs route alike in both chunkings)."""
    _, cfg, _, _, params = deepseek
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, size=(2, 24)).astype(np.int32))

    def run(chunks):
        lay, bp = _paged(cfg, 2, 24)
        cache = model.init_paged_cache(cfg, lay, device="cpu")
        out, lo = [], 0
        for c in chunks:
            table, lengths = bp.device_views("cpu")
            lg, cache = model.prefill_chunk(params, cfg, cache,
                                            toks[:, lo:lo + c], table,
                                            lengths)
            out.append(lg)
            lo += c
            for b in range(2):
                bp.extend(b, c)
        return torch.cat(out, dim=1)

    _close(run((5, 11, 8)), run((24,)))


# ------------------------------------------------------------- serve loops
PAGED = ["--reduced", "--batch", "2", "--prompt", "24", "--gen", "4",
         "--requests", "4", "--page-size", "8", "--prefill-chunk", "8"]


@pytest.mark.parametrize("extra", [[], ["--mode", "standard"],
                                   ["--kv-dtype", "int8"],
                                   ["--spec-tokens", "3"]],
                         ids=["etap", "standard", "int8", "spec"])
def test_run_paged_tokens_equal_jax(deepseek, extra):
    """The reduced DeepSeek-R1 with its MoE layer served by the paged loop:
    the port's greedy outputs equal the JAX loop's on the same weights and
    requests (spec on: drafts verified through verify_step's MoE path)."""
    jcfg, cfg, _, _, params = deepseek
    want = jserve.run_paged(jserve.parse_args(PAGED + extra), jcfg)
    got = serve.run_paged(serve.parse_args(PAGED + extra
                                           + ["--device", "cpu"]),
                          cfg, params=params, device="cpu")
    assert got["outputs"] == want["outputs"]
    assert len(got["outputs"]) == 4
    for key in ("tokens_served", "prefill_chunks", "steps", "batch_slots"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("mode", ["etap", "standard"])
def test_run_dense_tokens_equal_jax(deepseek, mode):
    """The dense loop (capacity-routed prefill, dropless decode): the JAX
    loop's greedy tokens on the same weights and prompts."""
    jcfg, cfg, _, _, params = deepseek
    flags = ["--reduced", "--cache-layout", "dense", "--batch", "2",
             "--prompt", "12", "--gen", "5", "--mode", mode]
    want = jserve.run_dense(jserve.parse_args(flags), jcfg)
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 12),
                                            0, jcfg.vocab_size))
    got = serve.run_dense(serve.parse_args(flags + ["--device", "cpu"]), cfg,
                          params=params, tokens=prompts, device="cpu")
    np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))


# ------------------------------------------------------- GQA + MoE models
@pytest.mark.parametrize("layout", ["paged", "dense"])
@pytest.mark.parametrize("arch", ["dbrx_132b", "llama4_maverick_400b"])
def test_gqa_moe_decode_matches_jax(arch, layout):
    """Reduced DBRX (every layer MoE, top-2 of 4, no shared expert) and
    Llama-4-Maverick (top-1 and a shared expert): forward, then a prompt
    and two decode steps on either layout, within 2e-5 of JAX's."""
    jcfg, cfg = _cfgs(arch)
    jparams = jmodel.init(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    B, P = 2, 9
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size,
                                             size=(B, P + 2)).astype(np.int32)
    if layout == "dense":
        logits, aux, _ = model.forward(params, cfg,
                                       torch.from_numpy(toks[:, :P]))
        jlogits, jaux, _ = jmodel.forward(jparams, jcfg,
                                          {"tokens": jnp.asarray(toks[:, :P])})
        _close(logits, jlogits)
        for key in model.AUX_KEYS:
            _close(aux[key], jaux[key], AUX_TOL)
        _, cache, pos = model.prefill(params, cfg,
                                      torch.from_numpy(toks[:, :P]), 16)
        _, jcache, _ = jmodel.prefill(jparams, jcfg,
                                      {"tokens": jnp.asarray(toks[:, :P])}, 16)
        for i in range(P, P + 2):
            lg, cache = model.decode_step(params, cfg, cache,
                                          torch.from_numpy(toks[:, i]), i)
            jlg, jcache = jmodel.decode_step(jparams, jcfg, jcache,
                                             jnp.asarray(toks[:, i]), i,
                                             spec=JSpec())
            _close(lg, jlg)
        return
    lay, bp = _paged(cfg, B, 16)
    cache = model.init_paged_cache(cfg, lay, device="cpu")
    jcache = jmodel.init_paged_cache(jcfg, lay)
    table, lengths = bp.device_views("cpu")
    lg, cache = model.prefill_chunk(params, cfg, cache,
                                    torch.from_numpy(toks[:, :P]), table,
                                    lengths)
    jlg, jcache = jmodel.prefill_chunk(jparams, jcfg, jcache,
                                       jnp.asarray(toks[:, :P]),
                                       jnp.asarray(bp.table),
                                       jnp.asarray(bp.lengths), spec=JSpec())
    _close(lg, jlg)
    for b in range(B):
        bp.extend(b, P)
    for i in range(P, P + 2):
        table, lengths = bp.device_views("cpu")
        lg, cache = model.decode_step(params, cfg, cache,
                                      torch.from_numpy(toks[:, i]),
                                      cache_layout="paged",
                                      block_table=table, lengths=lengths)
        jlg, jcache = jmodel.decode_step(jparams, jcfg, jcache,
                                         jnp.asarray(toks[:, i]), None,
                                         spec=JSpec(), cache_layout="paged",
                                         block_table=jnp.asarray(bp.table),
                                         lengths=jnp.asarray(bp.lengths))
        _close(lg, jlg)
        for b in range(B):
            bp.append(b)


def test_paged_pool_is_jax_pool_layout(deepseek):
    """The MoE stack's paged pools: one latent pool a layer, the reference's
    shapes (MoE layers page like dense ones)."""
    jcfg, cfg, _, _, _ = deepseek
    lay = pc.layout_for(2, 16, block_size=8)
    cache = model.init_paged_cache(cfg, lay, device="cpu")
    jcache = jmodel.init_paged_cache(jcfg, lay)
    assert len(cache) == cfg.num_layers
    for i, layer in enumerate(cache):
        assert tuple(layer["c"].shape) == jcache[i]["b0"]["c"].shape[1:]
    assert model.paged_row_bytes(cfg) == jmodel.paged_row_bytes(jcfg)
    assert jpc.row_bytes(cfg.mla.latent_dim, "fp", jnp.float32) == \
        pc.row_bytes(cfg.mla.latent_dim, "fp", torch.float32)
