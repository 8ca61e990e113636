"""The port's dense-layout kernels in their plain form — the dense ETAP
decode K5 / K6, the untransposed baseline K7 / K8 and the [n,H,Dv]
orientation of the combine K2 — against the JAX Pallas kernels in interpret
mode on the same numpy inputs; the entry points against the JAX entries;
and the port's own bitwise contracts.

Tolerance: fp32 ``atol = rtol = 1e-5`` — both sides compute in fp32 and
differ only in summation order.  Inputs: ragged lengths (one of them 1), a
context S that is not a multiple of the block (the wrappers pad it as the
reference's ``ops`` do), both rescale modes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.etap import combine as jcombine
from repro.kernels.etap import etap as jetap
from repro.kernels.flash_decode import flash_decode as jfd
from repro_torch.core.attn_spec import AttnSpec
from repro_torch.kernels.etap import combine, etap, schedule
from repro_torch.kernels.etap import ops as etap_ops
from repro_torch.kernels.flash_decode import flash_decode as fd
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.launch import dense_split_tiles

TOL = dict(atol=1e-5, rtol=1e-5)
MODES = ["amla", "mul"]
B, H, DK, DV, S, BLOCK = 3, 4, 40, 32, 45, 16
SCALE = DK ** -0.5
LENGTHS = [45, 1, 20]


def _case(seed, S_=S):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, DK)).astype(np.float32)
    k = rng.normal(size=(B, S_, DK)).astype(np.float32)
    v = rng.normal(size=(B, S_, DV)).astype(np.float32)
    return q, k, v, np.asarray(LENGTHS, np.int32)


def _pad(x, rows):
    return np.pad(x, ((0, 0), (0, rows - x.shape[1]), (0, 0)))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **TOL)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _padded(n_splits):
    """The reference's padded extent for n_splits splits of BLOCK rows."""
    return schedule.split_geometry(S, BLOCK, n_splits)[3]


# ------------------------------------------------------ plain vs Pallas
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kernel", ["etap", "standard"])
def test_single_pass_plain_matches_pallas(kernel, mode):
    """K5 vs etap_decode_pallas, K7 vs flash_decode_pallas (the port pads
    S to the block itself)."""
    q, k, v, length = _case(0)
    P = _padded(1)
    jfn = jetap.etap_decode_pallas if kernel == "etap" else \
        jfd.flash_decode_pallas
    fn = etap.etap_decode_dense if kernel == "etap" else fd.flash_decode
    ref = jfn(*_j(q, _pad(k, P), _pad(v, P), length), scale=SCALE,
              block=BLOCK, rescale=mode)
    out = fn(*_t(q, k, v, length), scale=SCALE, block=BLOCK, rescale=mode)
    _close(out, ref)


@pytest.mark.parametrize("mode", MODES)
def test_mla_fused_plain_matches_pallas(mode):
    """K5 with V = the latent's first dv columns vs etap_decode_mla_pallas,
    and bitwise the separate-V K5 on a copy of those columns."""
    q, k, _, length = _case(1)
    P = _padded(1)
    ref = jetap.etap_decode_mla_pallas(*_j(q, _pad(k, P)), DV,
                                       *_j(length), scale=SCALE, block=BLOCK,
                                       rescale=mode)
    qt, kt, lt = _t(q, k, length)
    fused = etap.etap_decode_mla_dense(qt, kt, DV, lt, scale=SCALE,
                                       block=BLOCK, rescale=mode)
    _close(fused, ref)
    sep = etap.etap_decode_dense(qt, kt, kt[..., :DV].clone(), lt,
                                 scale=SCALE, block=BLOCK, rescale=mode)
    np.testing.assert_array_equal(_bits(sep), _bits(fused))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n_splits", [2, 3])
@pytest.mark.parametrize("kernel", ["etap", "standard"])
def test_partial_plain_matches_pallas(kernel, n_splits, mode):
    """K6 vs etap_partial_pallas and K8 vs flash_decode_partial_pallas,
    stats and all — including splits that hold only padding (the length-1
    row)."""
    q, k, v, length = _case(2)
    P = _padded(n_splits)
    if kernel == "etap":
        ref = jetap.etap_partial_pallas(*_j(q, _pad(k, P), _pad(v, P),
                                            length), scale=SCALE, block=BLOCK,
                                        n_splits=n_splits, rescale=mode)
        fn = etap.etap_partial_dense
    else:
        ref = jfd.flash_decode_partial_pallas(
            *_j(q, _pad(k, P), _pad(v, P), length), scale=SCALE, block=BLOCK,
            n_splits=n_splits, rescale=mode)
        fn = fd.flash_decode_partial
    out = fn(*_t(q, k, v, length), scale=SCALE, rescale=mode,
             plan=schedule.dense_split_plan(S, BLOCK, n_splits))
    for o, r in zip(out, ref, strict=True):
        _close(o, r)


@pytest.mark.parametrize("mode", MODES)
def test_combine_rows_plain_matches_pallas(mode):
    """K2 [n,H,Dv] vs combine_splits_pallas(transposed=False), on K8 stats
    with a fully masked split."""
    q, k, v, length = _case(3)
    P = _padded(3)
    m, l, acc = (np.asarray(x) for x in jfd.flash_decode_partial_pallas(
        *_j(q, _pad(k, P), _pad(v, P), length), scale=SCALE, block=BLOCK,
        n_splits=3, rescale=mode))
    assert (m[1, 1:] <= -1e29).all()              # masked splits
    ref = jcombine.combine_splits_pallas(*_j(m, l, acc), transposed=False,
                                         out_dtype=jnp.float32, rescale=mode)
    out = combine.combine_splits_std(*_t(m, l, acc), out_dtype=torch.float32,
                                     rescale=mode)
    _close(out, ref)


# --------------------------------------------------- bitwise in the port
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kernel", ["etap", "standard"])
def test_one_split_plus_combine_is_single_pass_bitwise(kernel, mode):
    """K6(n=1) + K2 == K5 and K8(n=1) + K2[n,H,Dv] == K7, bitwise."""
    q, k, v, length = _t(*_case(4))
    kw = dict(scale=SCALE, rescale=mode)
    one = schedule.dense_split_plan(S, BLOCK, 1)
    if kernel == "etap":
        single = etap.etap_decode_dense(q, k, v, length, block=BLOCK, **kw)
        st = etap.etap_partial_dense(q, k, v, length, plan=one, **kw)
        two = combine.combine_splits(*st, out_dtype=torch.float32,
                                     rescale=mode)
    else:
        single = fd.flash_decode(q, k, v, length, block=BLOCK, **kw)
        st = fd.flash_decode_partial(q, k, v, length, plan=one, **kw)
        two = combine.combine_splits_std(*st, out_dtype=torch.float32,
                                         rescale=mode)
    np.testing.assert_array_equal(_bits(two), _bits(single))


@pytest.mark.parametrize("mode", MODES)
def test_dense_is_paged_bitwise_at_block_aligned_lengths(mode):
    """K5 over a dense latent cache == K3 over the same rows paged through a
    shuffled block table, at block == page and block-aligned lengths; the
    same holds for the split paths K6 == K1."""
    page, nb = 8, 4
    rng = np.random.default_rng(5)
    dense = rng.normal(size=(B, nb * page, DK)).astype(np.float32)
    q = rng.normal(size=(B, H, DK)).astype(np.float32)
    lengths = np.asarray([32, 8, 16], np.int32)
    table = (rng.permutation(B * nb) + 1).reshape(B, nb).astype(np.int32)
    pool = np.zeros((1 + B * nb, page, DK), np.float32)
    for b in range(B):
        for j in range(nb):
            pool[table[b, j]] = dense[b, j * page:(j + 1) * page]
    qt, dt, lt, pt, tt = _t(q, dense, lengths, pool, table)
    kw = dict(scale=SCALE, rescale=mode)
    d = etap.etap_decode_mla_dense(qt, dt, DV, lt, block=page, **kw)
    p = etap.etap_decode_mla_paged(qt, pt, DV, tt, lt, **kw)
    np.testing.assert_array_equal(_bits(d), _bits(p))
    ds = etap.etap_partial_dense(
        qt, dt, dt[..., :DV], lt,
        plan=schedule.dense_split_plan(nb * page, page, 2), **kw)
    ps = etap.etap_paged_partial(qt, pt, DV, tt, lt, n_splits=2, **kw)
    for a, b_ in zip(ds, ps, strict=True):
        np.testing.assert_array_equal(_bits(a), _bits(b_))


# ------------------------------------------------------- entry points
@pytest.mark.parametrize("kv_splits", [None, 1, 2])
@pytest.mark.parametrize("kernel", ["etap", "standard"])
def test_splitkv_entries_match_jax_ops(kernel, kv_splits):
    """etap_ops.etap_decode_splitkv and fd_ops.flash_decode_splitkv against
    the JAX entries on the Pallas kernels, at auto, forced-single and
    forced-two splits (a longer context, so auto may split too)."""
    from repro.core.attn_spec import AttnSpec as JSpec
    from repro.kernels.etap import ops as jops
    from repro.kernels.flash_decode import ops as jfd_ops
    q, k, v, length = _case(6, S_=150)
    spec = AttnSpec(scale=SCALE, block=BLOCK, kv_splits=kv_splits,
                    rescale="amla")
    jspec = JSpec(scale=SCALE, block=BLOCK, kv_splits=kv_splits,
                  rescale="amla")
    if kernel == "etap":
        ref = jops.etap_decode_splitkv(*_j(q, k, v, length), spec=jspec)
        out = etap_ops.etap_decode_splitkv(*_t(q, k, v, length), spec=spec)
    else:
        ref = jfd_ops.flash_decode_splitkv(*_j(q, k, v, length), spec=jspec)
        out = fd_ops.flash_decode_splitkv(*_t(q, k, v, length), spec=spec)
    _close(out, ref)


@pytest.mark.parametrize("mode", ["etap", "standard"])
def test_decode_attention_matches_jax(mode):
    """The dense entry core.etap.decode_attention (both modes, default
    block 512 and auto splits, no length) against the JAX entry."""
    from repro.core import etap as jcore
    from repro.core.attn_spec import AttnSpec as JSpec
    from repro_torch.core import etap as core
    q, k, v, _ = _case(7)
    ref = jcore.decode_attention(*_j(q, k, v), spec=JSpec(scale=SCALE,
                                                          mode=mode))
    out = core.decode_attention(*_t(q, k, v),
                                spec=AttnSpec(scale=SCALE, mode=mode))
    _close(out, ref)


@pytest.mark.parametrize("kv_splits", [None, 2])
def test_paged_standard_matches_jax(kv_splits):
    """decode_attention_paged in the standard mode: the gathered pool
    through the baseline (block = page), against the JAX entry."""
    from repro.core import etap as jcore
    from repro.core.attn_spec import AttnSpec as JSpec
    from repro_torch.core import etap as core
    page, nb = 8, 5
    rng = np.random.default_rng(8)
    pool = rng.normal(size=(1 + B * nb, page, DK)).astype(np.float32)
    table = (rng.permutation(B * nb) + 1).reshape(B, nb).astype(np.int32)
    q = rng.normal(size=(B, H, DK)).astype(np.float32)
    lengths = np.asarray([37, 1, 20], np.int32)
    ref = jcore.decode_attention_paged(
        *_j(q, pool), None, *_j(table, lengths), dv=DV,
        spec=JSpec(scale=SCALE, mode="standard", kv_splits=kv_splits))
    out = core.decode_attention_paged(
        *_t(q, pool), None, *_t(table, lengths), dv=DV,
        spec=AttnSpec(scale=SCALE, mode="standard", kv_splits=kv_splits))
    _close(out, ref)


@pytest.mark.parametrize("S_,block,n", [(1, 512, 4), (45, 16, 2), (45, 16, 9),
                                        (544, 512, 4), (4128, 512, 4),
                                        (4096, 64, 3), (100, 512, 1)])
def test_split_geometry_matches_reference(S_, block, n):
    from repro.kernels.etap import schedule as jsched
    assert schedule.split_geometry(S_, block, n) == \
        jsched.split_geometry(S_, block, n)
    g = schedule.split_geometry(S_, block, n)
    p = schedule.dense_split_plan(S_, block, n)
    assert (p.block, p.n_splits, p.nb_per_split, p.padded_s) == g
    plan = schedule.plan_splits(2, S_, 16, 512, block=block)
    want = jsched.plan_splits(2, S_, 16, 512, block=block)
    assert plan.padded_s == want.padded_s


@pytest.mark.parametrize("S_,block,n,tiles", [(544, 512, 1, 16),
                                              (4128, 512, 4, 24),
                                              (4160, 64, 4, 17),
                                              (2080, 512, 2, 24)])
def test_dense_split_tiles_of_main_path_plans(S_, block, n, tiles):
    """The 64-row tiles per split that the dense split kernels get for the
    serve paths' plans (S 4128 in 4 splits is 3 effective splits)."""
    plan = schedule.dense_split_plan(S_, block, n)
    assert dense_split_tiles(S_, plan, what="t") == tiles


def test_dense_split_tiles_refuses_bad_plans():
    """Split boundaries off the 64-row tiles, and a plan short of S, raise;
    so does the plain walk under a plan short of S."""
    with pytest.raises(NotImplementedError, match="64-row"):
        dense_split_tiles(S, schedule.dense_split_plan(S, BLOCK, 2), what="t")
    short = schedule.SplitPlan(n_splits=1, block=BLOCK, nb_per_split=2)
    with pytest.raises(ValueError, match="covers"):
        dense_split_tiles(S, short, what="t")
    q, k, v, length = _t(*_case(9))
    with pytest.raises(ValueError, match="covers"):
        fd.flash_decode_partial(q, k, v, length, scale=SCALE, plan=short)
