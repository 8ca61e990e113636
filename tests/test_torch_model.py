"""The port's model slice against the JAX model on the same weights.

Config: the reduced DeepSeek config without MoE, fp32, on the CPU, where the
port runs its kernels' plain versions and JAX its default (XLA) path.
Tolerance for activations, logits and pools: fp32 ``atol = rtol = 2e-5`` —
the same operations in another summation order, through two layers.  The
paged-cache scatters and the weight conversion are bitwise.
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
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.runtime import paged_cache as jpc
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.core import mla
from repro_torch.models import layers, model
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import paged_cache as pc

TOL = dict(atol=2e-5, rtol=2e-5)


def _cfgs():
    jcfg = dataclasses.replace(jreduced(jget_config("deepseek_r1_671b")),
                               moe=None)
    cfg = dataclasses.replace(reduced(get_config("deepseek_r1_671b")),
                              moe=None)
    return jcfg, cfg


@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = _cfgs()
    jparams = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, tree, params_from_jax(tree, device="cpu")


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **tol)


def _np(x):
    return np.asarray(x)


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_reference(arch):
    """Every field of every config (and of its reduced form) matches the
    reference, apart from the reference-only ``use_kernels`` switch."""
    for port, ref in ((get_config(arch), jget_config(arch)),
                      (reduced(get_config(arch)),
                       jreduced(jget_config(arch)))):
        want = dataclasses.asdict(ref)
        want.pop("use_kernels")
        assert dataclasses.asdict(port) == want
        assert port.torch_dtype == getattr(torch, ref.dtype)
        assert model.layer_groups(port) == jmodel.layer_groups(ref)


# ---------------------------------------------------------------- weights
def test_params_from_jax_round_trip(weights):
    """Every converted leaf equals its JAX leaf bitwise, in layer order."""
    jcfg, cfg, _, tree, params = weights
    assert len(params["layers"]) == cfg.num_layers
    np.testing.assert_array_equal(params["embed"].numpy(), tree["embed"])
    np.testing.assert_array_equal(params["embed_f32"].numpy(), tree["embed"])
    np.testing.assert_array_equal(params["final_norm"].numpy(),
                                  tree["final_norm"])
    stacked = tree["groups"][0]["b0"]
    for i, lp in enumerate(params["layers"]):
        flat = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda a, i=i: a[i], stacked))[0]
        for path, leaf in flat:
            node = lp
            for key in path:
                node = node[key.key]
            np.testing.assert_array_equal(node.numpy(), leaf)
    n = sum(x.size for x in jax.tree.leaves(tree))
    assert model.param_count(params) == n


def test_bf16_leaves_convert_by_bits():
    a = np.asarray(jnp.asarray([1.5, -2.0, 3.140625], jnp.bfloat16))
    got = params_from_jax({"embed": a[None], "final_norm": a,
                           "groups": []}, device="cpu")
    assert got["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["final_norm"].float().numpy(),
                                  a.astype(np.float32))


# ----------------------------------------------------------------- layers
def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    pos = np.arange(10, 15, dtype=np.int32)[None, :].repeat(2, 0)
    _close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos)))
    w = {k: rng.normal(size=s).astype(np.float32) * 0.2 for k, s in
         (("w_gate", (16, 8)), ("w_up", (16, 8)), ("w_down", (8, 16)))}
    _close(layers.mlp({k: torch.from_numpy(v) for k, v in w.items()},
                      torch.from_numpy(x)),
           jlayers.mlp({k: jnp.asarray(v) for k, v in w.items()},
                       jnp.asarray(x)))
    table = rng.normal(size=(11, 16)).astype(np.float32)
    toks = np.asarray([[3, 10, 0]], np.int32)
    np.testing.assert_array_equal(
        layers.embed(torch.from_numpy(table), torch.from_numpy(toks)).numpy(),
        _np(jlayers.embed(jnp.asarray(table), jnp.asarray(toks))))
    _close(layers.unembed(layers.unembed_table(torch.from_numpy(table)),
                          torch.from_numpy(x)),
           jlayers.unembed(jnp.asarray(table), jnp.asarray(x)))


# ------------------------------------------------------------ paged cache
def _pool_case(seed, B=3, nb=4, bs=8, F=6):
    rng = np.random.default_rng(seed)
    N = 1 + B * nb
    pool = rng.normal(size=(N, bs, F)).astype(np.float32)
    table = (rng.permutation(N - 1) + 1).reshape(B, nb).astype(np.int32)
    return rng, pool, table


def test_append_rows_chunk_copy_bitwise():
    rng, pool, table = _pool_case(0)
    lengths = np.asarray([0, 7, 20], np.int32)
    rows = rng.normal(size=(3, 6)).astype(np.float32)
    got = pc.append_rows(torch.from_numpy(pool.copy()),
                         torch.from_numpy(table), torch.from_numpy(lengths),
                         torch.from_numpy(rows))
    want = jpc.append_rows(jnp.asarray(pool), jnp.asarray(table),
                           jnp.asarray(lengths), jnp.asarray(rows))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    chunk = rng.normal(size=(3, 5, 6)).astype(np.float32)   # straddles blocks
    got = pc.append_chunk(got, torch.from_numpy(table),
                          torch.from_numpy(lengths), torch.from_numpy(chunk))
    want = jpc.append_chunk(want, jnp.asarray(table), jnp.asarray(lengths),
                            jnp.asarray(chunk))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    got = pc.copy_block(got, 3, 9)
    want = jpc.copy_block(want, 3, 9)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    np.testing.assert_array_equal(
        pc.gather_blocks(got, torch.from_numpy(table)).numpy(),
        _np(jpc.gather_blocks(want, jnp.asarray(table))))


def test_block_pool_matches_reference():
    """The allocator is the reference's: the same admit / extend / append /
    COW / truncate / release sequence gives the same tables and lengths,
    and device_views hands over owned copies."""
    lay, jlay = pc.layout_for(3, 40, block_size=8), jpc.layout_for(3, 40, 8)
    assert dataclasses.asdict(lay) == dataclasses.asdict(jlay)
    bp, jbp = pc.BlockPool(lay, 3), jpc.BlockPool(jlay, 3)
    for pool in (bp, jbp):
        s0 = pool.admit(0, 40)
        pool.extend(s0, 20)
        pool.append(s0)
        s1, cow = pool.admit_shared(12, 30, pool.block_ids(s0)[:2])
        assert cow == [(int(pool.block_ids(s0)[1]), int(pool.block_ids(s1)[1]))]
        pool.truncate(s0, 9)
        pool.release(s1)
        pool.audit()
    np.testing.assert_array_equal(bp.table, jbp.table)
    np.testing.assert_array_equal(bp.lengths, jbp.lengths)
    table, lengths = bp.device_views("cpu")
    bp.append(0)
    assert int(lengths[0]) == 9 and table.dtype == torch.int32


def test_read_write_paged_blocks_round_trip(weights):
    _, cfg, _, _, _ = weights
    lay = pc.layout_for(2, 16, block_size=8)
    cache = model.init_paged_cache(cfg, lay, device="cpu")
    for i, layer in enumerate(cache):
        layer["c"].copy_(torch.randn(layer["c"].shape,
                                     generator=torch.Generator().manual_seed(i)))
    rows = model.read_paged_blocks(cache, [1, 3])
    assert rows["c"].shape == (cfg.num_layers, 2, 8, cfg.mla.latent_dim)
    saved = [layer["c"].clone() for layer in cache]
    model.copy_paged_block(cache, 2, 1)
    assert torch.equal(cache[0]["c"][1], saved[0][2])
    model.write_paged_blocks(cache, [1, 3], rows)
    for layer, s in zip(cache, saved, strict=True):
        assert torch.equal(layer["c"], s)


# ---------------------------------------------------------------- MLA
def _paged_state(cfg, B, prompt, seed):
    """A layout, a table of fresh blocks per sequence, and a random latent
    pool (numpy) — the state both frameworks start from."""
    lay = pc.layout_for(B, prompt + 4, block_size=8)
    bp = pc.BlockPool(lay, B)
    for _ in range(B):
        bp.admit(0, prompt + 4)
    rng = np.random.default_rng(seed)
    pool = rng.normal(size=(lay.num_blocks, 8, cfg.mla.latent_dim)).astype(
        np.float32)
    return bp, pool, rng


def test_mla_decode_and_prefill_chunk_match_jax(weights):
    jcfg, cfg, jparams, _, params = weights
    jlp = jax.tree.map(lambda a: a[0], jparams["groups"][0]["b0"])["mix"]
    lp = params["layers"][0]["mix"]
    bp, pool, rng = _paged_state(cfg, 2, 20, 1)
    table = bp.table.copy()
    lengths = np.asarray([5, 13], np.int32)
    x = rng.normal(size=(2, cfg.d_model)).astype(np.float32)
    out, cache = mla.mla_decode_paged(
        lp, cfg, torch.from_numpy(x), {"c": torch.from_numpy(pool.copy())},
        torch.from_numpy(table), torch.from_numpy(lengths))
    jout, jcache = jmla.mla_decode_paged(
        jlp, jcfg, jnp.asarray(x), {"c": jnp.asarray(pool)},
        jnp.asarray(table), jnp.asarray(lengths))
    _close(out, jout)
    _close(cache["c"], jcache["c"])
    xc = rng.normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    out, cache = mla.mla_prefill_chunk(
        lp, cfg, torch.from_numpy(xc), {"c": torch.from_numpy(pool.copy())},
        torch.from_numpy(table), torch.from_numpy(lengths))
    jout, jcache = jmla.mla_prefill_chunk(
        jlp, jcfg, jnp.asarray(xc), {"c": jnp.asarray(pool)},
        jnp.asarray(table), jnp.asarray(lengths))
    _close(out, jout)
    _close(cache["c"], jcache["c"])


@pytest.mark.parametrize("kv_splits", [None, 2])
def test_model_prefill_then_decode_match_jax(weights, kv_splits):
    """model.prefill_chunk over a whole prompt in two chunks, then three
    paged decode steps: logits and every layer's pool match JAX."""
    from repro.core.attn_spec import AttnSpec as JSpec
    from repro_torch.core.attn_spec import AttnSpec
    jcfg, cfg, jparams, _, params = weights
    B, P = 2, 12
    lay = pc.layout_for(B, P + 3, block_size=8)
    bp = pc.BlockPool(lay, B)
    for _ in range(B):
        bp.admit(0, P + 3)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                             size=(B, P + 3)).astype(np.int32)
    cache = model.init_paged_cache(cfg, lay, device="cpu")
    jcache = jmodel.init_paged_cache(jcfg, lay)
    spec, jspec = AttnSpec(kv_splits=kv_splits), JSpec(kv_splits=kv_splits)
    for lo, hi in ((0, 8), (8, P)):
        table, lengths = bp.device_views("cpu")
        logits, cache = model.prefill_chunk(params, cfg, cache,
                                            torch.from_numpy(toks[:, lo:hi]),
                                            table, lengths, spec=spec)
        jlogits, jcache = jmodel.prefill_chunk(
            jparams, jcfg, jcache, jnp.asarray(toks[:, lo:hi]),
            jnp.asarray(bp.table), jnp.asarray(bp.lengths), spec=jspec)
        _close(logits, jlogits)
        for b in range(B):
            bp.extend(b, hi - lo)
    for i in range(P, P + 3):
        table, lengths = bp.device_views("cpu")
        logits, cache = model.decode_step(
            params, cfg, cache, torch.from_numpy(toks[:, i]), spec=spec,
            cache_layout="paged", block_table=table, lengths=lengths)
        jlogits, jcache = jmodel.decode_step(
            jparams, jcfg, jcache, jnp.asarray(toks[:, i]), None, spec=jspec,
            cache_layout="paged", block_table=jnp.asarray(bp.table),
            lengths=jnp.asarray(bp.lengths))
        _close(logits, jlogits)
        for b in range(B):
            bp.append(b)
    for li, layer in enumerate(cache):
        _close(layer["c"][1:], _np(jcache[0]["b0"]["c"][li])[1:])


def test_unported_paths_raise(weights):
    from repro_torch.core.attn_spec import AttnSpec
    jcfg, cfg, _, _, params = weights
    full = get_config("deepseek_r1_671b")
    model.check_ported(dataclasses.replace(full, num_layers=4))  # MoE (A3)
    model.check_ported(dataclasses.replace(full, num_layers=3))
    with pytest.raises(NotImplementedError, match="no port"):
        model.check_ported(dataclasses.replace(full, block_pattern=("conv",)))
    qwen = reduced(get_config("qwen3_8b"))
    model.check_ported(qwen)                 # the GQA path is ported (A5)
    assert model.paged_row_bytes(qwen, "int8") == jmodel.paged_row_bytes(
        jreduced(jget_config("qwen3_8b")), "int8")
    # quantized GQA pools (A5b(a)) and the baseline over a quantized pool
    # (A12) were refused here; both are ported now and run
    lay = pc.layout_for(1, 8, block_size=8)
    qcache = model.init_paged_cache(qwen, lay, kv_dtype="int8", device="cpu")
    assert set(qcache[0]) == {"k", "v", "k_sz", "v_sz"}
    cache = model.init_paged_cache(cfg, lay, kv_dtype="int8", device="cpu")
    logits, _ = model.decode_step(
        params, cfg, cache, torch.zeros(1, dtype=torch.int32),
        spec=AttnSpec(mode="standard"), cache_layout="paged",
        block_table=torch.ones(1, 1, dtype=torch.int32),
        lengths=torch.zeros(1, dtype=torch.int32))
    assert logits.shape == (1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
