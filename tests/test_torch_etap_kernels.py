"""The port's four ETAP kernels, in their plain form, against the JAX Pallas
kernels in interpret mode (same numpy inputs), and the port's own bitwise
contracts.

Tolerance: fp32 ``atol = rtol = 1e-5`` — both sides compute in fp32 and
differ only in summation order.  Inputs: ragged lengths, block tables padded
with the null block 0, both rescale modes, a tree-shaped verify ``qpos``,
and K4's edge shapes (columns not a multiple of the card kernel's unit,
several query rows a unit, start 0, a horizon mid-page, an idle row on the
null block, a horizon past the table).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.etap import combine as jcombine
from repro.kernels.etap import etap as jetap
from repro_torch.core.attn_spec import AttnSpec
from repro_torch.kernels.etap import combine, etap, ops, schedule

TOL = dict(atol=1e-5, rtol=1e-5)
MODES = ["amla", "mul"]
B, H, DK, DV, PAGE, NB = 3, 4, 40, 32, 8, 5
SCALE = DK ** -0.5


def _case(seed, lengths):
    """A random fp32 pool, a shuffled block table whose entries past each
    row's length are the null block, and q."""
    rng = np.random.default_rng(seed)
    n_blocks = 1 + B * NB
    pool = rng.normal(size=(n_blocks, PAGE, DK)).astype(np.float32)
    table = (rng.permutation(n_blocks - 1) + 1).reshape(B, NB).astype(np.int32)
    for b, n in enumerate(lengths):
        table[b, -(-n // PAGE):] = 0
    q = rng.normal(size=(B, H, DK)).astype(np.float32)
    return q, pool, table, np.asarray(lengths, np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **TOL)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("mode", MODES)
def test_decode_plain_matches_pallas(mode):
    """K3 plain vs etap_decode_mla_paged_pallas."""
    q, pool, table, lengths = _case(0, [37, 1, 20])
    ref = jetap.etap_decode_mla_paged_pallas(*_j(q, pool), DV, *_j(table,
                                             lengths), scale=SCALE,
                                             rescale=mode)
    out = etap.etap_decode_mla_paged(*_t(q, pool), DV, *_t(table, lengths),
                                     scale=SCALE, rescale=mode)
    _close(out, ref)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n_splits", [2, 3])
def test_partial_plain_matches_pallas(mode, n_splits):
    """K1 plain vs etap_paged_partial_pallas(fused_dv=dv), stats and all —
    including a split that holds only padding (the length-1 row)."""
    q, pool, table, lengths = _case(1, [37, 1, 20])
    n, _, padded = schedule.paged_split_geometry(NB, n_splits)
    table = np.pad(table, ((0, 0), (0, padded - NB)))
    ref = jetap.etap_paged_partial_pallas(
        *_j(q, pool), None, *_j(table, lengths), scale=SCALE, n_splits=n,
        fused_dv=DV, rescale=mode)
    out = etap.etap_paged_partial(*_t(q, pool), DV, *_t(table, lengths),
                                  scale=SCALE, n_splits=n, rescale=mode)
    for o, r in zip(out, ref, strict=True):
        _close(o, r)


@pytest.mark.parametrize("mode", MODES)
def test_combine_plain_matches_pallas(mode):
    """K2 plain vs combine_splits_pallas(transposed=True), on partial stats
    with one fully masked split."""
    q, pool, table, lengths = _case(2, [37, 1, 20])
    table = np.pad(table, ((0, 0), (0, 1)))
    m, l, acc = (np.asarray(x) for x in jetap.etap_paged_partial_pallas(
        *_j(q, pool), None, *_j(table, lengths), scale=SCALE, n_splits=3,
        fused_dv=DV, rescale=mode))
    ref = jcombine.combine_splits_pallas(*_j(m, l, acc), transposed=True,
                                         out_dtype=jnp.float32, rescale=mode)
    out = combine.combine_splits(*_t(m, l, acc), out_dtype=torch.float32,
                                 rescale=mode)
    _close(out, ref)


def _chunk_case(seed, Cq=4):
    start = [10, 0, 25]
    q, pool, table, _ = _case(seed, [s + Cq for s in start])
    rng = np.random.default_rng(seed + 100)
    qc = rng.normal(size=(B, Cq, H, DK)).astype(np.float32)
    return qc, pool, table, np.asarray(start, np.int32)


@pytest.mark.parametrize("mode", MODES)
def test_prefill_plain_matches_pallas(mode):
    """K4 plain vs etap_prefill_mla_paged_pallas (causal chunk mask)."""
    q, pool, table, start = _chunk_case(3)
    ref = jetap.etap_prefill_mla_paged_pallas(*_j(q, pool), DV,
                                              *_j(table, start), scale=SCALE,
                                              rescale=mode)
    out = etap.etap_prefill_mla_paged(*_t(q, pool), DV, *_t(table, start),
                                      scale=SCALE, rescale=mode)
    _close(out, ref)


@pytest.mark.parametrize("mode", MODES)
def test_verify_tree_plain_matches_pallas(mode):
    """K4 with a tree-shaped qpos (siblings share a horizon) vs
    etap_verify_mla_paged_pallas."""
    q, pool, table, start = _chunk_case(4)
    qpos = (start[:, None] + np.asarray([0, 1, 1, 2])[None, :]).astype(
        np.int32)
    ref = jetap.etap_verify_mla_paged_pallas(*_j(q, pool), DV,
                                             *_j(table, start, qpos),
                                             scale=SCALE, rescale=mode)
    out = etap.etap_verify_mla_paged(*_t(q, pool), DV,
                                     *_t(table, start, qpos), scale=SCALE,
                                     rescale=mode)
    _close(out, ref)


# The edges of K4's tiling on the card (units of 64 or 32 of the Cq*H
# columns of one batch row, each walking up to its largest horizon), at
# reduced widths: (H, Cq, start per row, tree-shaped verify qpos).
EDGES = {
    "columns_not_a_unit_multiple": (7, 3, [10, 2, 25], False),
    "several_rows_per_unit": (2, 9, [5, 17, 0], False),
    "start_zero": (4, 6, [0, 0, 0], False),
    "horizon_mid_page": (4, 5, [11, 19, 3], False),
    "idle_row_on_null_block": (4, 4, [10, 25, 0], False),
    "tree_qpos": (5, 7, [10, 0, 25], True),
    # row 1's horizons lie past its five-page table (an odd page count)
    "horizon_past_the_table": (4, 4, [10, 41, 3], False),
}


def _edge_case(name, seed=20):
    """q [B,Cq,H',DK] with H' heads a row, the pool and table of _case
    (the null block past each row's chunk; every entry of an idle row's
    table the null block, its chunk at start 0), start and the verify
    qpos (None for a prefill)."""
    H_, Cq, start, tree = EDGES[name]
    _, pool, table, _ = _case(seed, [s + Cq for s in start])
    if name == "idle_row_on_null_block":
        table[2] = 0
    rng = np.random.default_rng(seed + 1)
    q = rng.normal(size=(B, Cq, H_, DK)).astype(np.float32)
    start = np.asarray(start, np.int32)
    qpos = None
    if tree:
        depth = np.asarray([0] + [1 + (c - 1) // 3 for c in range(1, Cq)])
        qpos = (start[:, None] + depth[None, :]).astype(np.int32)
    return q, pool, table, start, qpos


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(EDGES))
def test_prefill_edges_plain_match_pallas(name, mode):
    """K4 plain (prefill, or verify with a tree qpos) vs the Pallas kernel
    at the edge shapes of the card's tiling."""
    q, pool, table, start, qpos = _edge_case(name)
    kw = dict(scale=SCALE, rescale=mode)
    if qpos is None:
        ref = jetap.etap_prefill_mla_paged_pallas(*_j(q, pool), DV,
                                                  *_j(table, start), **kw)
        out = etap.etap_prefill_mla_paged(*_t(q, pool), DV,
                                          *_t(table, start), **kw)
    else:
        ref = jetap.etap_verify_mla_paged_pallas(*_j(q, pool), DV,
                                                 *_j(table, start, qpos),
                                                 **kw)
        out = etap.etap_verify_mla_paged(*_t(q, pool), DV,
                                         *_t(table, start, qpos), **kw)
    assert out.shape == (B, q.shape[1], q.shape[2], DV)
    _close(out, ref)


@pytest.mark.parametrize("mode", MODES)
def test_partial_one_split_plus_combine_is_single_pass_bitwise(mode):
    """Inside the port: partial(n=1) + combine == single-pass, bitwise."""
    q, pool, table, lengths = (torch.from_numpy(x) for x in
                               _case(5, [37, 1, 20]))
    single = etap.etap_decode_mla_paged(q, pool, DV, table, lengths,
                                        scale=SCALE, rescale=mode)
    st = etap.etap_paged_partial(q, pool, DV, table, lengths, scale=SCALE,
                                 n_splits=1, rescale=mode)
    two = combine.combine_splits(*st, out_dtype=torch.float32, rescale=mode)
    np.testing.assert_array_equal(_bits(two), _bits(single))


@pytest.mark.parametrize("mode", MODES)
def test_verify_linear_is_prefill_bitwise(mode):
    """Inside the port: verify with qpos = start + arange(Cq) == prefill."""
    q, pool, table, start = (torch.from_numpy(x) for x in _chunk_case(6))
    qpos = start[:, None] + torch.arange(q.shape[1], dtype=torch.int32)
    pre = etap.etap_prefill_mla_paged(q, pool, DV, table, start, scale=SCALE,
                                      rescale=mode)
    ver = etap.etap_verify_mla_paged(q, pool, DV, table, start, qpos,
                                     scale=SCALE, rescale=mode)
    np.testing.assert_array_equal(_bits(ver), _bits(pre))


@pytest.mark.parametrize("kv_splits", [None, 1, 2, 3, 9])
def test_splitkv_entry_matches_jax_ops(kv_splits):
    """ops.etap_decode_mla_paged_splitkv (auto, forced and over-asked
    split counts) against the JAX entry on the Pallas kernels."""
    from repro.core.attn_spec import AttnSpec as JSpec
    from repro.kernels.etap import ops as jops
    q, pool, table, lengths = _case(7, [37, 1, 20])
    ref = jops.etap_decode_mla_paged_splitkv(
        *_j(q, pool), DV, *_j(table, lengths),
        spec=JSpec(scale=SCALE, kv_splits=kv_splits, rescale="amla"))
    out = ops.etap_decode_mla_paged_splitkv(
        *_t(q, pool), DV, *_t(table, lengths),
        spec=AttnSpec(scale=SCALE, kv_splits=kv_splits, rescale="amla"))
    _close(out, ref)


@pytest.mark.parametrize("B_,nb,H_", [(1, 65, 128), (4, 65, 128), (8, 9, 128),
                                      (2, 4, 4), (16, 1024, 16)])
def test_split_plan_matches_reference_on_cpu(B_, nb, H_):
    """On CPU tensors the scheduler keeps the reference's 8 cores, so the
    split plans are the reference's."""
    from repro.kernels.etap import schedule as jsched
    cores = schedule.num_cores("cpu")
    assert cores == jsched.DEFAULT_CORES
    got = schedule.plan_splits_paged(B_, nb, 64, H_, 512, num_cores=cores)
    want = jsched.plan_splits_paged(B_, nb, 64, H_, 512)
    assert got == schedule.SplitPlan(want.n_splits, want.block,
                                     want.nb_per_split)
    assert schedule.paged_split_geometry(nb, 3) == \
        jsched.paged_split_geometry(nb, 3)


def test_decode_ref_oracles_agree():
    """The port's direct oracle and its blockless state-API degenerate agree
    with the JAX oracle."""
    from repro.kernels.etap import ref as jref
    from repro_torch.kernels.etap import ref
    rng = np.random.default_rng(8)
    q = rng.normal(size=(2, 8, 64)).astype(np.float32)
    k = rng.normal(size=(2, 96, 64)).astype(np.float32)
    v = rng.normal(size=(2, 96, 48)).astype(np.float32)
    length = np.asarray([51, 96], np.int32)
    want = jref.etap_decode_ref(*_j(q, k, v, length), scale=0.125)
    _close(ref.etap_decode_ref(*_t(q, k, v, length), scale=0.125), want)
    for mode in MODES:
        _close(ref.etap_decode_state_ref(*_t(q, k, v, length), scale=0.125,
                                         rescale=mode), want)
