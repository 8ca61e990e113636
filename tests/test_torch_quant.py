"""The port's quantized (int8 / fp8) latent pools against the JAX package.

Same numpy inputs through both frameworks, on the CPU, where the port runs
its kernels' plain versions and JAX its Pallas kernels in interpret mode:

  * ``quantize_rows`` / ``dequantize_rows``: codes and (scale, zp) bitwise
    the reference's, requantization bitwise stable, ``append_*_quant``
    pools bitwise the reference's, the byte-budget sizing equal;
  * K3q, K1q (n = 1 and 4), K4q prefill and verify (tree and linear qpos),
    plain versions against the quantized Pallas kernels in both rescale
    modes, fp32 ``atol = rtol = 1e-5`` (both sides dequantize to fp32 and
    differ only in summation order); the port's bitwise contracts on the
    quantized pool;
  * the accuracy gates of the reference (int8 RMSE <= 6.12e-4, fp8 <=
    2.22e-3 against the fp64 oracle, tests/test_softmax_state.py) at its
    geometry and seed;
  * the reduced DeepSeek model on converted weights (fp32, no MoE):
    prefill then decode over quantized pools, the serve loop's prefix-cache
    and swap contracts inside the int8 layout, and what was refused before
    (the baseline over a quantized pool, and separate-V paged pools).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.kernels.etap import etap as jetap
from repro.kernels.etap import ref as jref
from repro.models import model as jmodel
from repro.runtime import paged_cache as jpc
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.core import etap as core_etap
from repro_torch.core.attn_spec import AttnSpec
from repro_torch.kernels.etap import combine, etap, ops, ref, schedule
from repro_torch.launch import serve
from repro_torch.models import model
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import paged_cache as pc

TOL = dict(atol=1e-5, rtol=1e-5)
MODES = ["amla", "mul"]
LAYOUTS = ["int8", "fp8"]
B, H, DK, DV, PAGE, NB = 3, 4, 40, 32, 8, 5
SCALE = DK ** -0.5


def _bytes(x):
    """The bits of a code or fp32 array (torch or JAX) as a numpy array."""
    if isinstance(x, torch.Tensor):
        x = pc.raw(x).numpy()
    x = np.asarray(x)
    return x.view(np.uint8) if x.dtype.itemsize == 1 else x.view(np.int32)


def _to_jax(x):
    """A torch code / fp32 tensor as a JAX array of the same bits."""
    if x.dtype == torch.float8_e4m3fn:
        return jnp.asarray(pc.raw(x).numpy()).view(jnp.float8_e4m3fn)
    return jnp.asarray(x.numpy())


def _close(port, want):
    np.testing.assert_allclose(np.asarray(port), np.asarray(want), **TOL)


# ------------------------------------------------------------ quantization
def _adversarial_rows(rng):
    """The reference's adversarial rows (tests/test_quant.py:45): all-zero,
    a single outlier, all negative, constant, gaussian, a tiny range — and
    a block of gaussian rows of mixed scales."""
    F = 64
    rows = np.zeros((6, F), np.float32)
    rows[1, 3] = 1000.0
    rows[2] = -rng.uniform(1.0, 2.0, F)
    rows[3] = 5.0
    rows[4] = rng.normal(size=F)
    rows[5, 7] = -1e-3
    more = rng.normal(size=(250, F)) * rng.uniform(1e-3, 1e3, size=(250, 1))
    return np.concatenate([rows, more.astype(np.float32)])


@pytest.mark.parametrize("kv_dtype", LAYOUTS)
def test_quantize_rows_bitwise_reference(kv_dtype):
    """Codes and (scale, zp) bitwise the reference's; the dequantized rows
    too."""
    rows = _adversarial_rows(np.random.default_rng(0))
    jc, js = jpc.quantize_rows(jnp.asarray(rows), kv_dtype)
    c, s = pc.quantize_rows(torch.from_numpy(rows), kv_dtype)
    assert c.dtype == pc.quant_dtype(kv_dtype) and s.dtype == torch.float32
    assert pc.kv_dtype_of(c) == kv_dtype == jpc.kv_dtype_of(jc)
    np.testing.assert_array_equal(_bytes(c), _bytes(jc))
    np.testing.assert_array_equal(_bytes(s), _bytes(js))
    np.testing.assert_array_equal(
        _bytes(pc.dequantize_rows(c, s)),
        _bytes(jpc.dequantize_rows(jc, js)))
    np.testing.assert_array_equal(
        _bytes(ref.dequantize(c, s)), _bytes(jref.dequantize(jc, js)))
    # the all-zero row round-trips exactly (scale 1, zp 0)
    assert torch.equal(pc.dequantize_rows(c, s)[0], torch.zeros(64))


@pytest.mark.parametrize("kv_dtype", LAYOUTS)
def test_requantization_bitwise_stable(kv_dtype):
    """The same rows give the same bits every time, and requantizing the
    dequantized rows lands on the same dequantized values."""
    rows = torch.from_numpy(
        np.random.default_rng(1).normal(size=(16, 48)).astype(np.float32))
    c1, s1 = pc.quantize_rows(rows, kv_dtype)
    c2, s2 = pc.quantize_rows(rows.clone(), kv_dtype)
    np.testing.assert_array_equal(_bytes(c1), _bytes(c2))
    np.testing.assert_array_equal(_bytes(s1), _bytes(s2))
    deq = pc.dequantize_rows(c1, s1)
    c3, s3 = pc.quantize_rows(deq, kv_dtype)
    np.testing.assert_allclose(pc.dequantize_rows(c3, s3).numpy(),
                               deq.numpy(), atol=1e-6)


def test_row_bytes_and_layout_for_bytes_match_reference():
    """The byte accounting and the byte-budget sizing equal the
    reference's over a grid; at the fp row size the sizing is
    ``layout_for``."""
    for feat in (40, 576):
        for kvd in ("fp", "int8", "fp8"):
            for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                             (torch.float32, jnp.float32)):
                assert pc.row_bytes(feat, kvd, tdt) == \
                    jpc.row_bytes(feat, kvd, jdt)
    for budget in (0, 1000, 123_457, 10**7):
        for row in (48, 100, 1152):
            for max_len, bs, spare in ((96, 16, 0), (64, 8, 2), (4097, 64, 1)):
                got = pc.layout_for_bytes(budget, row, max_len, bs, spare)
                want = jpc.layout_for_bytes(budget, row, max_len, bs, spare)
                assert got[1] == want[1]
                assert dataclasses.asdict(got[0]) == \
                    dataclasses.asdict(want[0])
    base = pc.layout_for(4, 64, block_size=8)
    lay, slots = pc.layout_for_bytes((base.num_blocks - 1) * 8 * 100, 100,
                                     64, block_size=8)
    assert (lay, slots) == (base, 4)


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
def test_paged_row_bytes_match_reference(reduce):
    """model.paged_row_bytes equals the reference's for every config and
    every layout, full and reduced (the GQA formula too: one (scale, zp)
    per kv head); int8 rows cost under half the bf16 ones."""
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        if reduce:
            cfg, jcfg = reduced(cfg), jreduced(jcfg)
        for kvd in ("fp", "int8", "fp8"):
            assert model.paged_row_bytes(cfg, kvd) == \
                jmodel.paged_row_bytes(jcfg, kvd), (arch, kvd)
        if not reduce and cfg.attention_kind == "mla":
            assert model.paged_row_bytes(cfg, "int8") * 1.9 < \
                model.paged_row_bytes(cfg, "fp")


@pytest.mark.parametrize("kv_dtype", LAYOUTS)
def test_append_quant_bitwise_reference(kv_dtype):
    """A chunk then token-by-token rows through append_chunk_quant /
    append_rows_quant give code and sz pools bitwise the reference's, and
    the codes of quantizing the rows wholesale."""
    Bq, S, F, page = 2, 32, 24, 8
    rng = np.random.default_rng(2)
    dense = rng.normal(size=(Bq, S, F)).astype(np.float32)
    layout = pc.layout_for(Bq, S, block_size=page)
    bp = pc.BlockPool(layout, Bq)
    for _ in range(Bq):
        bp.admit(S, S)
    table = bp.table.copy()
    codes = torch.zeros(layout.num_blocks, page, F, dtype=torch.uint8).view(
        pc.quant_dtype(kv_dtype))
    sz = torch.zeros(layout.num_blocks, page, 2)
    sz[..., 0] = 1.0
    jcodes, jsz = _to_jax(codes), jnp.asarray(sz.numpy())
    C = 20
    lens = np.zeros((Bq,), np.int32)
    codes, sz = pc.append_chunk_quant(codes, sz, torch.from_numpy(table),
                                      torch.from_numpy(lens),
                                      torch.from_numpy(dense[:, :C]))
    jcodes, jsz = jpc.append_chunk_quant(jcodes, jsz, jnp.asarray(table),
                                         jnp.asarray(lens),
                                         jnp.asarray(dense[:, :C]))
    for t in range(C, S):
        lens = np.full((Bq,), t, np.int32)
        codes, sz = pc.append_rows_quant(codes, sz, torch.from_numpy(table),
                                         torch.from_numpy(lens),
                                         torch.from_numpy(dense[:, t]))
        jcodes, jsz = jpc.append_rows_quant(jcodes, jsz, jnp.asarray(table),
                                            jnp.asarray(lens),
                                            jnp.asarray(dense[:, t]))
    np.testing.assert_array_equal(_bytes(codes), _bytes(jcodes))
    np.testing.assert_array_equal(_bytes(sz), _bytes(jsz))
    live = table.reshape(-1)
    whole, whole_sz = pc.quantize_rows(torch.from_numpy(dense), kv_dtype)
    np.testing.assert_array_equal(
        _bytes(codes[torch.from_numpy(live)]).reshape(Bq, S, F),
        _bytes(whole))
    np.testing.assert_array_equal(
        _bytes(sz[torch.from_numpy(live)]).reshape(Bq, S, 2),
        _bytes(whole_sz))


# ------------------------------------------------------------- kernels
def _quant_case(seed, lengths, kv_dtype):
    """Random fp32 latent rows quantized into a pool (every block, the
    null block too), a shuffled table whose entries past each row's length
    are the null block, and q."""
    rng = np.random.default_rng(seed)
    n_blocks = 1 + B * NB
    rows = rng.normal(size=(n_blocks, PAGE, DK)).astype(np.float32)
    codes, sz = pc.quantize_pool(torch.from_numpy(rows), kv_dtype)
    table = (rng.permutation(n_blocks - 1) + 1).reshape(B, NB).astype(np.int32)
    for b, n in enumerate(lengths):
        table[b, -(-n // PAGE):] = 0
    q = rng.normal(size=(B, H, DK)).astype(np.float32)
    return (torch.from_numpy(q), codes, sz, torch.from_numpy(table),
            torch.tensor(lengths, dtype=torch.int32))


def _jax_args(*tensors):
    return [_to_jax(t) for t in tensors]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kv_dtype", LAYOUTS)
def test_decode_quant_plain_matches_pallas(kv_dtype, mode):
    """K3q plain vs etap_decode_mla_paged_pallas with kv_sz."""
    q, codes, sz, table, lengths = _quant_case(0, [37, 1, 20], kv_dtype)
    jq, jc, js, jt, jl = _jax_args(q, codes, sz, table, lengths)
    want = jetap.etap_decode_mla_paged_pallas(jq, jc, DV, jt, jl, scale=SCALE,
                                              kv_sz=js, rescale=mode)
    got = etap.etap_decode_mla_paged_quant(q, codes, sz, DV, table, lengths,
                                           scale=SCALE, rescale=mode)
    assert got.dtype == torch.float32              # q's dtype
    _close(got, want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n_splits", [1, 4])
@pytest.mark.parametrize("kv_dtype", LAYOUTS)
def test_partial_quant_plain_matches_pallas(kv_dtype, n_splits, mode):
    """K1q plain vs etap_paged_partial_pallas(fused_dv, k_sz), stats and
    all, with a split that holds only padding (the length-1 row)."""
    q, codes, sz, table, lengths = _quant_case(1, [37, 1, 20], kv_dtype)
    n, _, padded = schedule.paged_split_geometry(NB, n_splits)
    table = torch.nn.functional.pad(table, (0, padded - NB))
    jq, jc, js, jt, jl = _jax_args(q, codes, sz, table, lengths)
    want = jetap.etap_paged_partial_pallas(
        jq, jc, None, jt, jl, scale=SCALE, n_splits=n, fused_dv=DV, k_sz=js,
        rescale=mode)
    got = etap.etap_paged_partial_quant(q, codes, sz, DV, table, lengths,
                                        scale=SCALE, n_splits=n,
                                        rescale=mode)
    for o, r in zip(got, want, strict=True):
        _close(o, r)


def _quant_chunk_case(seed, kv_dtype, Cq=4):
    start = [10, 0, 25]
    _, codes, sz, table, _ = _quant_case(seed, [s + Cq for s in start],
                                         kv_dtype)
    q = np.random.default_rng(seed + 100).normal(
        size=(B, Cq, H, DK)).astype(np.float32)
    return (torch.from_numpy(q), codes, sz, table,
            torch.tensor(start, dtype=torch.int32))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kv_dtype", LAYOUTS)
def test_prefill_quant_plain_matches_pallas(kv_dtype, mode):
    """K4q plain vs etap_prefill_mla_paged_pallas with kv_sz."""
    q, codes, sz, table, start = _quant_chunk_case(3, kv_dtype)
    want = jetap.etap_prefill_mla_paged_pallas(
        *_jax_args(q, codes), DV, *_jax_args(table, start), scale=SCALE,
        kv_sz=_to_jax(sz), rescale=mode)
    got = etap.etap_prefill_mla_paged_quant(q, codes, sz, DV, table, start,
                                            scale=SCALE, rescale=mode)
    _close(got, want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", ["tree", "linear"])
@pytest.mark.parametrize("kv_dtype", LAYOUTS)
def test_verify_quant_plain_matches_pallas(kv_dtype, shape, mode):
    """K4q with an explicit qpos (siblings sharing a horizon, or a linear
    chain) vs etap_verify_mla_paged_pallas with kv_sz."""
    q, codes, sz, table, start = _quant_chunk_case(4, kv_dtype)
    depth = [0, 1, 1, 2] if shape == "tree" else [0, 1, 2, 3]
    qpos = start[:, None] + torch.tensor(depth, dtype=torch.int32)[None, :]
    want = jetap.etap_verify_mla_paged_pallas(
        *_jax_args(q, codes), DV, *_jax_args(table, start, qpos),
        scale=SCALE, kv_sz=_to_jax(sz), rescale=mode)
    got = etap.etap_verify_mla_paged_quant(q, codes, sz, DV, table, start,
                                           qpos, scale=SCALE, rescale=mode)
    _close(got, want)


# The edges of K4q's tiling on the card (csrc/etap_prefill.cu: units of 64
# or 32 of the Cq*H columns of one batch row, each walking up to its
# largest horizon), at reduced widths: (H, Cq, start per row, tree-shaped
# verify qpos).
QUANT_EDGES = {
    "columns_not_a_unit_multiple": (7, 3, [10, 2, 25], False),
    "start_zero": (4, 6, [0, 0, 0], False),
    "idle_row_on_null_block": (4, 4, [10, 25, 0], False),
    "tree_qpos": (5, 7, [20, 0, 30], True),
    # row 1's horizons lie past its five-page table (40 rows)
    "horizon_past_the_table": (4, 4, [30, 45, 3], False),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kv_dtype", LAYOUTS)
@pytest.mark.parametrize("name", list(QUANT_EDGES))
def test_prefill_quant_edges_plain_match_pallas(name, kv_dtype, mode):
    """K4q over the fused latent code pool, plain vs
    etap_prefill_mla_paged_pallas / etap_verify_mla_paged_pallas with kv_sz
    at the edge shapes of the card's tiling (fp32 q, both sides in fp32:
    fp32 atol = rtol = 1e-5); an idle row's table is all null blocks, its
    chunk at start 0."""
    H_, Cq, start, tree = QUANT_EDGES[name]
    _, codes, sz, table, _ = _quant_case(7, [s + Cq for s in start],
                                         kv_dtype)
    if name == "idle_row_on_null_block":
        table[2] = 0
    start = torch.tensor(start, dtype=torch.int32)
    q = torch.from_numpy(np.random.default_rng(8).normal(
        size=(B, Cq, H_, DK)).astype(np.float32))
    kw = dict(scale=SCALE, rescale=mode)
    jkw = dict(kw, kv_sz=_to_jax(sz))
    if tree:
        qpos = start[:, None] + torch.tensor(
            [0] + [1 + (c - 1) // 3 for c in range(1, Cq)],
            dtype=torch.int32)[None, :]
        want = jetap.etap_verify_mla_paged_pallas(
            *_jax_args(q, codes), DV, *_jax_args(table, start, qpos), **jkw)
        got = etap.etap_verify_mla_paged_quant(q, codes, sz, DV, table,
                                               start, qpos, **kw)
    else:
        want = jetap.etap_prefill_mla_paged_pallas(
            *_jax_args(q, codes), DV, *_jax_args(table, start), **jkw)
        got = etap.etap_prefill_mla_paged_quant(q, codes, sz, DV, table,
                                                start, **kw)
    assert got.dtype == torch.float32 and got.shape == (B, Cq, H_, DV)
    _close(got, want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kv_dtype", LAYOUTS)
def test_quant_bitwise_contracts(kv_dtype, mode):
    """Inside the port, on the quantized pool: partial(n=1) + combine ==
    single pass, and verify with a linear qpos == prefill, bitwise."""
    q, codes, sz, table, lengths = _quant_case(5, [37, 1, 20], kv_dtype)
    kw = dict(scale=SCALE, rescale=mode)
    single = etap.etap_decode_mla_paged_quant(q, codes, sz, DV, table,
                                              lengths, **kw)
    st = etap.etap_paged_partial_quant(q, codes, sz, DV, table, lengths,
                                       n_splits=1, **kw)
    two = combine.combine_splits(*st, out_dtype=torch.float32, rescale=mode)
    np.testing.assert_array_equal(_bytes(two), _bytes(single))
    q, codes, sz, table, start = _quant_chunk_case(6, kv_dtype)
    qpos = start[:, None] + torch.arange(q.shape[1], dtype=torch.int32)
    pre = etap.etap_prefill_mla_paged_quant(q, codes, sz, DV, table, start,
                                            **kw)
    ver = etap.etap_verify_mla_paged_quant(q, codes, sz, DV, table, start,
                                           qpos, **kw)
    np.testing.assert_array_equal(_bytes(ver), _bytes(pre))


@pytest.mark.parametrize("kv_splits", [None, 1, 2, 9])
@pytest.mark.parametrize("kv_dtype", LAYOUTS)
def test_splitkv_entry_quant_matches_jax_ops(kv_dtype, kv_splits):
    """ops.etap_decode_mla_paged_splitkv with kv_sz (auto, single, split
    and over-asked split counts) against the JAX entry on the Pallas
    kernels: the same plan, the stats merged by K2, q's dtype out."""
    from repro.core.attn_spec import AttnSpec as JSpec
    from repro.kernels.etap import ops as jops
    q, codes, sz, table, lengths = _quant_case(7, [37, 1, 20], kv_dtype)
    jq, jc, js, jt, jl = _jax_args(q, codes, sz, table, lengths)
    want = jops.etap_decode_mla_paged_splitkv(
        jq, jc, DV, jt, jl, kv_sz=js,
        spec=JSpec(scale=SCALE, kv_splits=kv_splits, rescale="amla"))
    got = ops.etap_decode_mla_paged_splitkv(
        q, codes, DV, table, lengths, kv_sz=sz,
        spec=AttnSpec(scale=SCALE, kv_splits=kv_splits, rescale="amla"))
    _close(got, want)


def test_quant_ref_oracle_matches_reference():
    """The port's quantized oracle (dense dequant, then the direct
    softmax) against the reference's, MLA-fused and separate V."""
    rng = np.random.default_rng(8)
    q = rng.normal(size=(2, 4, 40)).astype(np.float32)
    k = rng.normal(size=(2, 24, 40)).astype(np.float32)
    v = rng.normal(size=(2, 24, 16)).astype(np.float32)
    length = torch.tensor([13, 24], dtype=torch.int32)
    kc, ks = pc.quantize_rows(torch.from_numpy(k), "int8")
    vc, vs = pc.quantize_rows(torch.from_numpy(v), "fp8")
    for args, kw in (((kc, ks, None, None), dict(dv=16)),
                     ((kc, ks, vc, vs), {})):
        want = jref.etap_decode_quant_ref(
            jnp.asarray(q), *[a if a is None else _to_jax(a) for a in args],
            _to_jax(length), scale=0.2, **kw)
        got = ref.etap_decode_quant_ref(torch.from_numpy(q), *args, length,
                                        scale=0.2, **kw)
        _close(got, want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kv_dtype", LAYOUTS)
def test_rmse_gate_vs_fp64_oracle(kv_dtype, mode):
    """The reference's acceptance gates at its geometry and seed
    (tests/test_softmax_state.py:test_rmse_quant_vs_fp64_oracle): the
    port's quantized decode over the quantized pool against the fp64
    oracle on the unquantized rows, int8 <= 6.12e-4, fp8 <= 2.22e-3."""
    Bq, Hq, S, page = 2, 16, 1024, 64
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(Bq, Hq, 576)).astype(np.float32))
    kv = torch.from_numpy(rng.normal(size=(Bq, S, 576)).astype(np.float32))
    lengths = [S // 2 + 3, S]
    layout = pc.layout_for(Bq, S, block_size=page)
    bp = pc.BlockPool(layout, Bq)
    pool = torch.zeros(layout.num_blocks, page, 576)
    for b, n in enumerate(lengths):          # the reference's dense_to_paged
        bp.admit(n, n)
        ids = bp.block_ids(b)
        rows = torch.zeros(len(ids) * page, 576)
        rows[:n] = kv[b, :n]
        pool[torch.as_tensor(ids)] = rows.reshape(len(ids), page, 576)
    table, lens = bp.device_views("cpu")
    oracle = ref.etap_decode_ref(q.double(), kv.double(),
                                 kv[..., :512].double(),
                                 torch.tensor(lengths), scale=576 ** -0.5,
                                 dtype=torch.float64)
    codes, sz = pc.quantize_pool(pool, kv_dtype)
    out = etap.etap_decode_mla_paged_quant(q, codes, sz, 512, table, lens,
                                           scale=576 ** -0.5, rescale=mode)
    rmse = float(((out.double() - oracle) ** 2).mean().sqrt())
    assert rmse <= {"int8": 6.12e-4, "fp8": 2.22e-3}[kv_dtype], rmse


def test_standard_and_separate_v_over_quant_pools_refused():
    """The untransposed baseline over a quantized pool was refused (A12)
    and is ported now: it gathers codes and pairs and runs K7q / K8q, and
    matches the reference's standard route (which gathers the rows
    dequantized to fp32) with one split and with two, fp32 output.
    Separate-V paged pools (A5b) are ported too: an int8 K pool with a V
    pool quantized on its own, through the decode (etap, two splits) and
    prefill entries, matches the reference's route."""
    from repro.core import etap as jcore
    from repro.core.attn_spec import AttnSpec as JSpec
    for kv_dtype in LAYOUTS:
        q, codes, sz, table, lengths = _quant_case(9, [37, 1, 20], kv_dtype)
        for kv_splits in (1, 2):
            out = core_etap.decode_attention_paged(
                q, codes, None, table, lengths, dv=DV, k_sz=sz,
                spec=AttnSpec(scale=SCALE, mode="standard",
                              kv_splits=kv_splits))
            want = jcore.decode_attention_paged(
                _to_jax(q), _to_jax(codes), None, *_jax_args(table, lengths),
                dv=DV, k_sz=_to_jax(sz),
                spec=JSpec(scale=SCALE, mode="standard", kv_splits=kv_splits))
            assert out.dtype == torch.float32
            _close(out, want)
    q, codes, sz, table, lengths = _quant_case(9, [37, 1, 20], "int8")
    rows = np.random.default_rng(10).normal(size=(codes.shape[0], PAGE, DV))
    v_codes, v_sz = pc.quantize_pool(
        torch.from_numpy((2 * rows).astype(np.float32)), "int8")
    spec = dict(scale=SCALE, kv_splits=2)
    for fn, jfn, qq, extra in (
            (core_etap.decode_attention_paged, jcore.decode_attention_paged,
             q, lengths),
            (core_etap.prefill_attention_paged, jcore.prefill_attention_paged,
             q[:, None], lengths - 1)):
        out = fn(qq, codes, v_codes, table, extra, k_sz=sz, v_sz=v_sz,
                 spec=AttnSpec(**spec))
        want = jfn(*_jax_args(qq, codes, v_codes, table, extra),
                   k_sz=_to_jax(sz), v_sz=_to_jax(v_sz), spec=JSpec(**spec))
        assert out.dtype == torch.float32 and out.shape[-1] == DV
        _close(out, want)


# --------------------------------------------------------------- model
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
    return jcfg, cfg, jparams, params_from_jax(tree, device="cpu")


@pytest.mark.parametrize("kv_dtype", LAYOUTS)
def test_init_and_block_ops_carry_quant_pools(weights, kv_dtype):
    """init_paged_cache lays out codes (zero bits) and a (scale 1, zp 0)
    pool as the reference does; copy_paged_block, read_paged_blocks and
    write_paged_blocks move codes and pairs bitwise."""
    jcfg, cfg, _, _ = weights
    lay = pc.layout_for(2, 16, block_size=8)
    cache = model.init_paged_cache(cfg, lay, kv_dtype=kv_dtype, device="cpu")
    jcache = jmodel.init_paged_cache(jcfg, lay, kv_dtype=kv_dtype)
    for li, layer in enumerate(cache):
        assert set(layer) == {"c", "c_sz"}
        for key in layer:
            np.testing.assert_array_equal(
                _bytes(layer[key]), _bytes(jcache[0]["b0"][key][li]))
    rng = np.random.default_rng(3)
    for layer in cache:
        codes, sz = pc.quantize_pool(torch.from_numpy(rng.normal(
            size=layer["c"].shape).astype(np.float32)), kv_dtype)
        layer["c"].copy_(codes)
        layer["c_sz"].copy_(sz)
    saved = [{k: v.clone() for k, v in layer.items()} for layer in cache]
    rows = model.read_paged_blocks(cache, [1, 3])
    assert rows["c"].dtype == pc.quant_dtype(kv_dtype)
    assert rows["c"].shape == (cfg.num_layers, 2, 8, cfg.mla.latent_dim)
    model.copy_paged_block(cache, 2, 1)
    for layer, s in zip(cache, saved, strict=True):
        for key in layer:
            np.testing.assert_array_equal(_bytes(layer[key][1]),
                                          _bytes(s[key][2]))
    model.write_paged_blocks(cache, [1, 3], rows)
    for layer, s in zip(cache, saved, strict=True):
        for key in layer:
            np.testing.assert_array_equal(_bytes(layer[key]), _bytes(s[key]))


@pytest.mark.parametrize("kv_dtype", LAYOUTS)
def test_model_prefill_then_decode_quant_match_jax(weights, kv_dtype):
    """model.prefill_chunk over a prompt in two chunks, then three paged
    decode steps, on int8 / fp8 pools: logits within 2e-5 of JAX's, the
    (scale, zp) pools within fp32 noise, and the codes bitwise JAX's."""
    from repro.core.attn_spec import AttnSpec as JSpec
    jcfg, cfg, jparams, params = weights
    Bm, P = 2, 12
    lay = pc.layout_for(Bm, P + 3, block_size=8)
    bp = pc.BlockPool(lay, Bm)
    for _ in range(Bm):
        bp.admit(0, P + 3)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                             size=(Bm, P + 3)).astype(np.int32)
    cache = model.init_paged_cache(cfg, lay, kv_dtype=kv_dtype, device="cpu")
    jcache = jmodel.init_paged_cache(jcfg, lay, kv_dtype=kv_dtype)
    spec, jspec = AttnSpec(kv_dtype=kv_dtype), JSpec(kv_dtype=kv_dtype)
    tol = dict(atol=2e-5, rtol=2e-5)
    for lo, hi in ((0, 8), (8, P)):
        table, lengths = bp.device_views("cpu")
        logits, cache = model.prefill_chunk(params, cfg, cache,
                                            torch.from_numpy(toks[:, lo:hi]),
                                            table, lengths, spec=spec)
        jlogits, jcache = jmodel.prefill_chunk(
            jparams, jcfg, jcache, jnp.asarray(toks[:, lo:hi]),
            jnp.asarray(bp.table), jnp.asarray(bp.lengths), spec=jspec)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **tol)
        for b in range(Bm):
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
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **tol)
        for b in range(Bm):
            bp.append(b)
    for li, layer in enumerate(cache):
        np.testing.assert_array_equal(
            _bytes(layer["c"][1:]), _bytes(jcache[0]["b0"]["c"][li][1:]))
        np.testing.assert_allclose(
            layer["c_sz"][1:].numpy(),
            np.asarray(jcache[0]["b0"]["c_sz"][li][1:]), atol=1e-6,
            rtol=1e-6)


# ---------------------------------------------------------------- serve
FLAGS = ["--reduced", "--batch", "1", "--prompt", "24", "--gen", "4",
         "--requests", "8", "--page-size", "8", "--prefill-chunk", "8",
         "--shared-prefix", "16", "--device", "cpu"]


def _port(params, flags):
    args = serve.parse_args(flags)
    return serve.run_paged(args, _cfgs()[1], params=params, device="cpu")


def test_serve_int8_prefix_cache_on_off_bitwise(weights):
    """The reference's test_quant.py:308 through the port: int8 admits
    >= 1.8x the fp slots under the same pool bytes, every request is
    served, the prefix cache hits, and on / off outputs are bitwise
    equal within the int8 layout."""
    params = weights[3]
    fp = _port(params, FLAGS)
    on = _port(params, FLAGS + ["--kv-dtype", "int8"])
    off = _port(params, FLAGS + ["--kv-dtype", "int8", "--no-prefix-cache"])
    assert on["kv_dtype"] == "int8" and fp["kv_dtype"] == "fp"
    assert on["batch_slots"] >= 1.8 * fp["batch_slots"]
    assert on["outputs"] == off["outputs"]
    assert len(on["outputs"]) == 8
    assert on["prefix"]["hits"] > 0 and on["prefill_tokens_saved"] > 0
    assert on["prefill_tokens"] + on["prefill_tokens_saved"] == \
        off["prefill_tokens"]


CONTENDED = ["--reduced", "--batch", "1", "--prompt", "24", "--gen", "8",
             "--requests", "6", "--page-size", "8", "--prefill-chunk", "8",
             "--priority-classes", "3", "--arrival-rate", "0.25", "--trace",
             "burst", "--burst-size", "3", "--retry-backoff", "4",
             "--paranoia", "1", "--kv-dtype", "int8", "--device", "cpu"]


def test_serve_int8_swap_restores_bitwise(weights):
    """The contended burst trace on an int8 pool: swap preemption moves
    codes and pairs to the host and back, and every request gets the
    uncontended run's outputs bitwise."""
    params = weights[3]
    calm = _port(params, CONTENDED[:2] + ["8"] + CONTENDED[3:])
    assert calm["sched"]["preemptions"] == 0
    busy = _port(params, CONTENDED + ["--preemption", "swap"])
    assert busy["sched"]["preemptions"] > 0
    assert len(busy["outputs"]) == 6
    assert busy["outputs"] == calm["outputs"]


@pytest.mark.parametrize("kv_dtype", LAYOUTS)
def test_standard_mode_with_quant_refused_dense_layout_served(kv_dtype,
                                                              capsys):
    """--mode standard over a quantized paged pool was refused as not yet
    ported (A12) and parses now; the dense layout takes the flag and, as
    the reference's run_dense does, does not read it."""
    args = serve.parse_args(["--device", "cpu", "--mode", "standard",
                             "--kv-dtype", kv_dtype])
    assert (args.mode, args.kv_dtype) == ("standard", kv_dtype)
    assert capsys.readouterr().err == ""
    for mode in ("etap", "standard"):
        args = serve.parse_args(["--cache-layout", "dense", "--mode", mode,
                                 "--kv-dtype", kv_dtype])
        assert args.kv_dtype == kv_dtype
    assert serve.parse_args(["--kv-dtype", kv_dtype]).kv_dtype == kv_dtype
