"""The paged ETAP kernels over separate K and V pools (K3, K1, K4 and their
quantized twins) against the JAX package, and the port's own contracts.

Same numpy inputs through both frameworks on the CPU, where the port runs
the kernels' plain versions and JAX its Pallas kernels in interpret mode
(``etap_decode_paged_pallas``, ``etap_paged_partial_pallas``,
``etap_prefill_paged_pallas``, ``etap_verify_paged_pallas``) or, for the
attention entries, its default route.  Reduced shapes: B 3, H 4, Dk 32,
Dv 24, page 16, a shuffled five-column table with null blocks past each
row's length, lengths 37, 1 and 70 (unaligned).  Code pools are made by the
port's ``quantize_rows`` with K and V drawn independently, so V's (scale,
zp) differ from K's.

Tolerance: fp32 ``atol = rtol = 1e-5`` (both sides compute in fp32, over
codes on the same dequantized rows, and differ only in summation order).
Bitwise: split(n = 1) + K2 == single pass; verify with a linear qpos ==
prefill; paged == dense at block-aligned lengths; a separate V equal to
``pool[..., :dv]`` (with K's pairs) == the MLA-fused kernels.  The CUDA
branch is faked on CPU tensors: an unbuilt width or a dtype the kernels do
not take raises, and nothing falls back to the plain version.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import etap as jcore
from repro.core.attn_spec import AttnSpec as JSpec
from repro.kernels.etap import etap as jetap
from repro_torch.core import etap as core
from repro_torch.core.attn_spec import AttnSpec
from repro_torch.kernels import build
from repro_torch.kernels.etap import combine, ops, schedule
from repro_torch.kernels.etap import etap as K
from repro_torch.runtime import paged_cache as pc

TOL = dict(atol=1e-5, rtol=1e-5)
MODES = ["amla", "mul"]
CODES = ["int8", "fp8"]
B, H, DK, DV, PAGE, NB = 3, 4, 32, 24, 16, 5
LENGTHS = [37, 1, 70]
SCALE = DK ** -0.5
CSRC = Path(K.__file__).resolve().parents[1] / "csrc"


def _case(seed, lengths=LENGTHS, kv_dtype="fp"):
    """q [B,H,DK], separate K [N,PAGE,DK] and V [N,PAGE,DV] pools drawn
    independently (as codes with their own (scale, zp) pools over int8 /
    fp8), a shuffled table with the null block past each row's length,
    and the lengths — all torch, fp32."""
    rng = np.random.default_rng(seed)
    n = 1 + B * NB
    k = torch.from_numpy(rng.normal(size=(n, PAGE, DK)).astype(np.float32))
    v = torch.from_numpy(
        (rng.normal(size=(n, PAGE, DV)) * 3.0 + 0.5).astype(np.float32))
    table = (rng.permutation(n - 1) + 1).reshape(B, NB).astype(np.int32)
    for b, m in enumerate(lengths):
        table[b, -(-m // PAGE):] = 0
    q = torch.from_numpy(rng.normal(size=(B, H, DK)).astype(np.float32))
    pools = {"k_pool": k, "v_pool": v}
    if kv_dtype != "fp":
        (kc, ks), (vc, vs) = (pc.quantize_rows(x, kv_dtype) for x in (k, v))
        pools = {"k_pool": kc, "k_sz": ks, "v_pool": vc, "v_sz": vs}
    return q, pools, torch.from_numpy(table), torch.tensor(
        lengths, dtype=torch.int32)


def _j(x):
    """A torch tensor (fp8 codes through their bytes) as a JAX array."""
    if x.dtype == torch.float8_e4m3fn:
        return jnp.asarray(pc.raw(x).numpy()).view(jnp.float8_e4m3fn)
    return jnp.asarray(x.numpy())


def _jpools(pools):
    return {k: _j(v) for k, v in pools.items()}


def _close(port, want):
    np.testing.assert_allclose(np.asarray(port), np.asarray(want), **TOL)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _tree(start, Cq):
    """A tree-shaped verify horizon [B, Cq]: siblings share a depth."""
    depth = torch.tensor([0] + [1 + (c - 1) // 3 for c in range(1, Cq)],
                         dtype=torch.int32)
    return start[:, None] + depth[None, :]


def _port_args(pools, quant):
    """The wrappers' leading pool arguments: (k, v) or (k, k_sz, v, v_sz)."""
    if quant:
        return pools["k_pool"], pools["k_sz"], pools["v_pool"], pools["v_sz"]
    return pools["k_pool"], pools["v_pool"]


def _sfx(kv_dtype):
    return "" if kv_dtype == "fp" else "_quant"


# ------------------------------------------- plain versions vs Pallas
@pytest.mark.parametrize("kv_dtype", ["fp", *CODES])
@pytest.mark.parametrize("mode", MODES)
def test_decode_plain_matches_pallas(kv_dtype, mode):
    """K3 / K3q plain vs etap_decode_paged_pallas (separate V); over codes
    with independent K and V pairs."""
    q, pools, table, lengths = _case(0, kv_dtype=kv_dtype)
    jp = _jpools(pools)
    want = jetap.etap_decode_paged_pallas(
        _j(q), jp["k_pool"], jp["v_pool"], _j(table), _j(lengths),
        scale=SCALE, k_sz=jp.get("k_sz"), v_sz=jp.get("v_sz"), rescale=mode)
    got = getattr(K, f"etap_decode_paged{_sfx(kv_dtype)}")(
        q, *_port_args(pools, kv_dtype != "fp"), table, lengths, scale=SCALE,
        rescale=mode)
    assert got.dtype == torch.float32 and got.shape == (B, H, DV)
    _close(got, want)


@pytest.mark.parametrize("kv_dtype", ["fp", *CODES])
def test_partial_plain_matches_pallas(kv_dtype):
    """K1 / K1q plain vs etap_paged_partial_pallas(fused_dv=0), stats and
    all, over the table padded to 3 splits (a split of only padding for
    the length-1 row); the two rescale modes alternate by code type."""
    mode = {"fp": "amla", "int8": "mul", "fp8": "amla"}[kv_dtype]
    q, pools, table, lengths = _case(1, kv_dtype=kv_dtype)
    n, _, padded = schedule.paged_split_geometry(NB, 3)
    table = ops._pad_table(table, padded)
    jp = _jpools(pools)
    want = jetap.etap_paged_partial_pallas(
        _j(q), jp["k_pool"], jp["v_pool"], _j(table), _j(lengths),
        scale=SCALE, n_splits=n, fused_dv=0, k_sz=jp.get("k_sz"),
        v_sz=jp.get("v_sz"), rescale=mode)
    got = getattr(K, f"etap_paged_partial_sepv{_sfx(kv_dtype)}")(
        q, *_port_args(pools, kv_dtype != "fp"), table, lengths, scale=SCALE,
        n_splits=n, rescale=mode)
    assert got[2].shape == (B, n, DV, H)
    for o, r in zip(got, want, strict=True):
        _close(o, r)


@pytest.mark.parametrize("kv_dtype,verify,mode", [
    ("fp", False, "amla"), ("fp", True, "mul"), ("int8", True, "amla"),
    ("fp8", False, "mul")])
def test_prefill_and_verify_plain_match_pallas(kv_dtype, verify, mode):
    """K4 / K4q plain vs etap_prefill_paged_pallas, or with a tree-shaped
    qpos vs etap_verify_paged_pallas (the same _prefill_call with its qpos
    operand)."""
    Cq = 6
    q, pools, table, _ = _case(2, kv_dtype=kv_dtype)
    start = torch.tensor([37 - Cq, 0, 70 - Cq], dtype=torch.int32)
    qp = torch.from_numpy(np.random.default_rng(3).normal(
        size=(B, Cq, H, DK)).astype(np.float32))
    jp = _jpools(pools)
    kw = dict(scale=SCALE, rescale=mode)
    jkw = dict(kw, k_sz=jp.get("k_sz"), v_sz=jp.get("v_sz"))
    args = (*_port_args(pools, kv_dtype != "fp"), table, start)
    jargs = (_j(qp), jp["k_pool"], jp["v_pool"], _j(table), _j(start))
    sfx = _sfx(kv_dtype)
    if verify:
        qpos = _tree(start, Cq)
        want = jetap.etap_verify_paged_pallas(*jargs, _j(qpos), **jkw)
        got = getattr(K, f"etap_verify_paged{sfx}")(qp, *args, qpos, **kw)
    else:
        want = jetap.etap_prefill_paged_pallas(*jargs, **jkw)
        got = getattr(K, f"etap_prefill_paged{sfx}")(qp, *args, **kw)
    assert got.shape == (B, Cq, H, DV)
    _close(got, want)


# The edges of K4's tiling on the card (units of 64 or 32 of the Cq*H
# columns of one batch row, each walking up to its largest horizon), at
# reduced widths: (H, Cq, start per row, tree-shaped verify qpos).
EDGES = {
    "columns_not_a_unit_multiple": (7, 3, [10, 2, 25], False),
    "several_rows_per_unit": (2, 9, [5, 17, 0], False),
    "start_zero": (4, 6, [0, 0, 0], False),
    "horizon_mid_page": (4, 5, [11, 60, 3], False),
    "idle_row_on_null_block": (4, 4, [10, 25, 0], False),
    "tree_qpos": (5, 7, [30, 0, 60], True),
    # row 1's horizons lie past its five-page table (an odd page count)
    "horizon_past_the_table": (4, 4, [40, 85, 3], False),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(EDGES))
def test_prefill_edges_plain_match_pallas(name, mode):
    """K4 over separate bf16-layout pools (fp32 here), plain vs
    etap_prefill_paged_pallas / etap_verify_paged_pallas at the edge
    shapes of the card's tiling; an idle row's table is all null blocks,
    its chunk at start 0."""
    H_, Cq, start, tree = EDGES[name]
    start = torch.tensor(start, dtype=torch.int32)
    _, pools, table, _ = _case(5, lengths=[int(s) + Cq for s in start])
    if name == "idle_row_on_null_block":
        table[2] = 0
    qp = torch.from_numpy(np.random.default_rng(6).normal(
        size=(B, Cq, H_, DK)).astype(np.float32))
    jp = _jpools(pools)
    kw = dict(scale=SCALE, rescale=mode)
    args = (pools["k_pool"], pools["v_pool"], table, start)
    jargs = (_j(qp), jp["k_pool"], jp["v_pool"], _j(table), _j(start))
    if tree:
        qpos = _tree(start, Cq)
        want = jetap.etap_verify_paged_pallas(*jargs, _j(qpos), **kw)
        got = K.etap_verify_paged(qp, *args, qpos, **kw)
    else:
        want = jetap.etap_prefill_paged_pallas(*jargs, **kw)
        got = K.etap_prefill_paged(qp, *args, **kw)
    assert got.shape == (B, Cq, H_, DV)
    _close(got, want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kv_dtype", CODES)
@pytest.mark.parametrize("name", list(EDGES))
def test_prefill_quant_edges_plain_match_pallas(name, kv_dtype, mode):
    """K4q over separate code pools (K and V each with its own pairs),
    plain vs etap_prefill_paged_pallas / etap_verify_paged_pallas with
    k_sz and v_sz at the edge shapes of the card's tiling (K4's EDGES);
    an idle row's table is all null blocks, its chunk at start 0."""
    H_, Cq, start, tree = EDGES[name]
    start = torch.tensor(start, dtype=torch.int32)
    _, pools, table, _ = _case(9, lengths=[int(s) + Cq for s in start],
                               kv_dtype=kv_dtype)
    if name == "idle_row_on_null_block":
        table[2] = 0
    qp = torch.from_numpy(np.random.default_rng(10).normal(
        size=(B, Cq, H_, DK)).astype(np.float32))
    jp = _jpools(pools)
    kw = dict(scale=SCALE, rescale=mode)
    jkw = dict(kw, k_sz=jp["k_sz"], v_sz=jp["v_sz"])
    args = (*_port_args(pools, True), table, start)
    jargs = (_j(qp), jp["k_pool"], jp["v_pool"], _j(table), _j(start))
    if tree:
        qpos = _tree(start, Cq)
        want = jetap.etap_verify_paged_pallas(*jargs, _j(qpos), **jkw)
        got = K.etap_verify_paged_quant(qp, *args, qpos, **kw)
    else:
        want = jetap.etap_prefill_paged_pallas(*jargs, **jkw)
        got = K.etap_prefill_paged_quant(qp, *args, **kw)
    assert got.dtype == torch.float32 and got.shape == (B, Cq, H_, DV)
    _close(got, want)


# ------------------------------------------- the attention entries vs JAX
@pytest.mark.parametrize("kv_dtype", ["fp", *CODES])
def test_entries_match_reference(kv_dtype):
    """core.etap's paged entries with a v_pool against the reference's on
    the same pools: decode in both modes with kv_splits 1, 3 and auto
    (None), prefill and verify (tree qpos); fp32 q.  The reference's
    default route plans the etap splits as the port does (the auto plan's
    count is compared with the explicit one it equals) and runs its
    standard baseline without splits, so each of those is called once."""
    q, pools, table, lengths = _case(4, kv_dtype=kv_dtype)
    jp = _jpools(pools)
    jt, jl = _j(table), _j(lengths)
    auto = schedule.paged_split_geometry(NB, schedule.plan_splits_paged(
        B, NB, PAGE, H, DV).n_splits)[0]
    want = {}
    for mode in ("etap", "standard"):
        for kv_splits in (1, 3, None):
            spec = AttnSpec(scale=SCALE, mode=mode, kv_splits=kv_splits)
            got = core.decode_attention_paged(q, table=table,
                                              lengths=lengths, spec=spec,
                                              **pools)
            key = (mode, auto if kv_splits is None else kv_splits) \
                if mode == "etap" else mode
            if key not in want:
                want[key] = jcore.decode_attention_paged(
                    _j(q), table=jt, lengths=jl, spec=JSpec(
                        scale=SCALE, mode=mode, kv_splits=kv_splits), **jp)
            assert got.dtype == torch.float32
            _close(got, want[key])
    Cq = 5
    start = torch.tensor([32, 0, 65], dtype=torch.int32)
    qp = torch.from_numpy(np.random.default_rng(5).normal(
        size=(B, Cq, H, DK)).astype(np.float32))
    spec, jspec = AttnSpec(scale=SCALE), JSpec(scale=SCALE)
    got = core.prefill_attention_paged(qp, table=table, start=start,
                                       spec=spec, **pools)
    want = jcore.prefill_attention_paged(_j(qp), table=jt, start=_j(start),
                                         spec=jspec, **jp)
    _close(got, want)
    qpos = _tree(start, Cq)
    got = core.verify_attention_paged(qp, table=table, start=start,
                                      qpos=qpos, spec=spec, **pools)
    want = jcore.verify_attention_paged(_j(qp), table=jt, start=_j(start),
                                        qpos=_j(qpos), spec=jspec, **jp)
    _close(got, want)


def test_splitkv_entry_matches_jax_ops():
    """ops.etap_decode_paged_splitkv under the auto plan against the
    reference's ops entry (Pallas interpret, its own plan); a request for
    more splits than table columns degrades to the effective 5, bitwise."""
    from repro.kernels.etap import ops as jops
    q, pools, table, lengths = _case(6)
    k, v = pools["k_pool"], pools["v_pool"]
    got = ops.etap_decode_paged_splitkv(q, k, v, table, lengths,
                                        spec=AttnSpec(scale=SCALE))
    want = jops.etap_decode_paged_splitkv(
        _j(q), _j(k), _j(v), _j(table), _j(lengths),
        spec=JSpec(scale=SCALE, use_kernels=True))
    _close(got, want)
    nine, five = (ops.etap_decode_paged_splitkv(
        q, k, v, table, lengths, spec=AttnSpec(scale=SCALE, kv_splits=n))
        for n in (9, 5))
    np.testing.assert_array_equal(_bits(nine), _bits(five))


# ------------------------------------------- the port's own contracts
@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
@pytest.mark.parametrize("mode", MODES)
def test_one_split_plus_combine_is_single_pass_bitwise(kv_dtype, mode):
    q, pools, table, lengths = _case(7, kv_dtype=kv_dtype)
    args = _port_args(pools, kv_dtype != "fp")
    kw = dict(scale=SCALE, rescale=mode)
    single = getattr(K, f"etap_decode_paged{_sfx(kv_dtype)}")(
        q, *args, table, lengths, **kw)
    st = getattr(K, f"etap_paged_partial_sepv{_sfx(kv_dtype)}")(
        q, *args, table, lengths, n_splits=1, **kw)
    two = combine.combine_splits(*st, out_dtype=torch.float32, rescale=mode)
    np.testing.assert_array_equal(_bits(two), _bits(single))


@pytest.mark.parametrize("kv_dtype", ["fp", "fp8"])
def test_verify_linear_is_prefill_bitwise(kv_dtype):
    Cq = 4
    _, pools, table, _ = _case(8, kv_dtype=kv_dtype)
    start = torch.tensor([33, 0, 66], dtype=torch.int32)
    qp = torch.from_numpy(np.random.default_rng(9).normal(
        size=(B, Cq, H, DK)).astype(np.float32))
    pools = dict(pools)
    spec = AttnSpec(scale=SCALE)
    linear = start[:, None] + torch.arange(Cq, dtype=torch.int32)[None, :]
    pre = core.prefill_attention_paged(qp, table=table, start=start,
                                       spec=spec, **pools)
    ver = core.verify_attention_paged(qp, table=table, start=start,
                                      qpos=linear, spec=spec, **pools)
    np.testing.assert_array_equal(_bits(ver), _bits(pre))


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_paged_equals_dense_at_block_aligned_lengths(kv_dtype):
    """K3 over the pools == K5 on the gathered rows with block = page, and
    K1 == K6 under the same split plan, bitwise: the reference's
    invariant."""
    q, pools, table, lengths = _case(10, [48, 16, 80], kv_dtype=kv_dtype)
    quant = kv_dtype != "fp"
    k, v = (pc.gather_blocks(pools[x], table) for x in ("k_pool", "v_pool"))
    dense_kw = {}
    if quant:
        dense_kw = dict(k_sz=pc.gather_blocks(pools["k_sz"], table),
                        v_sz=pc.gather_blocks(pools["v_sz"], table))
    sfx = _sfx(kv_dtype)
    args = _port_args(pools, quant)
    paged = getattr(K, f"etap_decode_paged{sfx}")(q, *args, table, lengths,
                                                  scale=SCALE)
    dense = getattr(K, f"etap_decode_dense{sfx}")(q, k, v, lengths,
                                                  scale=SCALE, block=PAGE,
                                                  **dense_kw)
    np.testing.assert_array_equal(_bits(paged), _bits(dense))
    plan = schedule.dense_split_plan(k.shape[1], PAGE, NB)
    st = getattr(K, f"etap_paged_partial_sepv{sfx}")(
        q, *args, table, lengths, scale=SCALE, n_splits=NB)
    st_d = getattr(K, f"etap_partial_dense{sfx}")(q, k, v, lengths,
                                                  scale=SCALE, plan=plan,
                                                  **dense_kw)
    for a, b in zip(st, st_d, strict=True):
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "fp8"])
def test_separate_v_of_the_latent_is_the_fused_entry_bitwise(kv_dtype):
    """A V pool holding the latent pool's first dv columns (its pairs a
    copy of K's) gives the fused entries' bits: decode (one split and
    three), prefill and verify."""
    rng = np.random.default_rng(11)
    n = 1 + B * NB
    lat = torch.from_numpy(rng.normal(size=(n, PAGE, DK)).astype(np.float32))
    _, _, table, lengths = _case(11)
    q = torch.from_numpy(rng.normal(size=(B, H, DK)).astype(np.float32))
    if kv_dtype == "fp":
        fused = dict(k_pool=lat)
        sep = dict(k_pool=lat, v_pool=lat[..., :DV].contiguous())
    else:
        codes, sz = pc.quantize_rows(lat, kv_dtype)
        fused = dict(k_pool=codes, k_sz=sz)
        sep = dict(k_pool=codes, k_sz=sz,
                   v_pool=pc.raw(codes)[..., :DV].contiguous().view(
                       codes.dtype), v_sz=sz.clone())
    for kv_splits in (1, 3):
        spec = AttnSpec(scale=SCALE, kv_splits=kv_splits)
        a = core.decode_attention_paged(q, v_pool=None, table=table,
                                        lengths=lengths, spec=spec, dv=DV,
                                        **fused)
        b = core.decode_attention_paged(q, table=table, lengths=lengths,
                                        spec=spec, **sep)
        np.testing.assert_array_equal(_bits(a), _bits(b))
    start = torch.tensor([30, 0, 64], dtype=torch.int32)
    qp = torch.from_numpy(rng.normal(size=(B, 4, H, DK)).astype(np.float32))
    spec = AttnSpec(scale=SCALE)
    a = core.prefill_attention_paged(qp, v_pool=None, table=table,
                                     start=start, spec=spec, dv=DV, **fused)
    b = core.prefill_attention_paged(qp, table=table, start=start, spec=spec,
                                     **sep)
    np.testing.assert_array_equal(_bits(a), _bits(b))
    qpos = _tree(start, 4)
    a = core.verify_attention_paged(qp, v_pool=None, table=table,
                                    start=start, qpos=qpos, spec=spec, dv=DV,
                                    **fused)
    b = core.verify_attention_paged(qp, table=table, start=start, qpos=qpos,
                                    spec=spec, **sep)
    np.testing.assert_array_equal(_bits(a), _bits(b))


def test_pools_that_disagree_are_refused():
    """A V pool of another page or block count, or one pairs pool without
    the other, is refused on any device."""
    q, pools, table, lengths = _case(12, kv_dtype="int8")
    k, ks, v, vs = _port_args(pools, True)
    with pytest.raises(ValueError, match="blocks and page"):
        K.etap_decode_paged_quant(q, k, ks, v[:, :8], vs[:, :8], table,
                                  lengths, scale=SCALE)
    with pytest.raises(ValueError, match="blocks and page"):
        K.etap_paged_partial_sepv(q, k.float(), v[1:].float(), table,
                                  lengths, scale=SCALE, n_splits=1)
    with pytest.raises(ValueError, match="together"):
        K.etap_prefill_paged_quant(q[:, None], k, ks, v, None, table,
                                   lengths, scale=SCALE)


# ------------------------------------------- the CUDA branch, faked
class _FakeLib:
    """The kernel library as the wrappers see it: the width query and the
    page, and each separate-V entry recording its calls."""

    def __init__(self, widths, err=0):
        self.widths, self.err, self.calls = widths, err, []

    def etap_paged_sepv_widths(self, buf, cap):
        for i, (dk, dv) in enumerate(self.widths):
            buf[2 * i], buf[2 * i + 1] = dk, dv
        return len(self.widths)

    def etap_page(self):
        return 64

    def __getattr__(self, name):
        if not name.startswith("etap_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return self.err
        return entry


ENTRIES = {
    "fp": ("etap_decode_paged", "etap_paged_partial_sepv",
           "etap_prefill_paged"),
    "quant": ("etap_decode_paged_quant", "etap_paged_partial_sepv_quant",
              "etap_prefill_paged_quant"),
}


@pytest.fixture
def fake_cuda(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors: device_of says cuda, the
    stream is 0, and no plain version may be reached."""
    monkeypatch.setattr(K, "device_of", lambda *t: torch.device("cuda"))
    monkeypatch.setattr(K, "stream", lambda dev: 0)

    def no_fallback(*a, **k):
        raise AssertionError("fell back to the plain version")

    for names in ENTRIES.values():
        for name in names:
            monkeypatch.setattr(K, name + "_plain", no_fallback)

    def use(lib):
        from repro_torch.kernels import launch
        launch.dense_widths.cache_clear()
        monkeypatch.setattr(build, "library", lambda: lib)
        return lib
    yield use
    from repro_torch.kernels import launch
    launch.dense_widths.cache_clear()


def _granite(kv_dtype, dk=128, dv=128, q_dtype=torch.bfloat16, n=5):
    """Granite-shaped operands on the CPU: q [2, 48, dk], pools of 64-row
    pages (bf16, or codes with fp32 pairs)."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 48, dk, generator=g).to(q_dtype)
    k = torch.randn(n, 64, dk, generator=g)
    v = torch.randn(n, 64, dv, generator=g)
    table = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    lengths = torch.tensor([100, 30], dtype=torch.int32)
    if kv_dtype == "fp":
        return q, (k.bfloat16(), v.bfloat16()), table, lengths
    (kc, ks), (vc, vs) = (pc.quantize_rows(x, kv_dtype) for x in (k, v))
    return q, (kc, ks, vc, vs), table, lengths


def _call(kind, i, q, args, table, lengths):
    """Entry i (decode, partial, prefill) of ENTRIES[kind] through its
    wrapper."""
    name = ENTRIES[kind][i]
    fn = getattr(K, name)
    if i == 0:
        return fn(q, *args, table, lengths, scale=0.1)
    if i == 1:
        return fn(q, *args, table, lengths, scale=0.1, n_splits=2)
    return fn(q[:, None], *args, table, lengths, scale=0.1)


@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "fp8"])
def test_built_widths_launch_once_and_failure_raises(fake_cuda, kv_dtype):
    """Each entry launches its kernel once at (128, 128) and (576, 512),
    counted on its wrapper, with the output in v_pool's dtype (q's over
    codes); a failed launch raises."""
    kind = "fp" if kv_dtype == "fp" else "quant"
    lib = fake_cuda(_FakeLib([(576, 512), (128, 128)]))
    for dk, dv in ((128, 128), (576, 512)):
        for qdt in ((torch.bfloat16,) if kind == "fp" else
                    (torch.bfloat16, torch.float32)):
            q, args, table, lengths = _granite(kv_dtype, dk, dv, qdt)
            for i, name in enumerate(ENTRIES[kind]):
                wrapper = getattr(K, name)
                before, calls = wrapper.launches, len(lib.calls)
                out = _call(kind, i, q, args, table, lengths)
                assert wrapper.launches == before + 1
                assert len(lib.calls) == calls + 1
                assert lib.calls[-1][0] == name
                if i != 1:
                    assert out.dtype == qdt and out.shape[-1] == dv
    fake_cuda(_FakeLib([(576, 512), (128, 128)], err=1))
    q, args, table, lengths = _granite(kv_dtype)
    for i in range(3):
        with pytest.raises(RuntimeError, match="cudaError 1"):
            _call(kind, i, q, args, table, lengths)


@pytest.mark.parametrize("kind", ["fp", "quant"])
def test_unbuilt_width_or_dtype_raises_not_falls_back(fake_cuda, kind):
    """(64, 64) and (256, 256) are not built and raise naming the width
    list; so do fp32 pools, a V pool of another type, fp16 q over codes, a
    page other than 64, and codes without pairs; nothing launches."""
    lib = fake_cuda(_FakeLib([(576, 512), (128, 128)]))
    before = {n: getattr(K, n).launches for n in ENTRIES[kind]}
    kvd = "fp" if kind == "fp" else "int8"
    for w in (64, 256):
        q, args, table, lengths = _granite(kvd, w, w)
        for i in range(3):
            with pytest.raises(NotImplementedError, match="PagedSepWidths"):
                _call(kind, i, q, args, table, lengths)
    q, args, table, lengths = _granite(kvd)
    if kind == "fp":
        bad = [(q, (args[0].float(), args[1].float()), "bf16"),
               (q.float(), args, "bf16"),
               (q, (args[0], args[1].half()), "V's pool"),
               (q, (args[0][:, :32], args[1][:, :32]), "page 64")]
    else:
        kc, ks, vc, vs = args
        v8, vs8 = pc.quantize_rows(torch.ones(5, 64, 128), "fp8")
        bad = [(q.half(), args, "bf16 or fp32 q"),
               (q, (kc, ks, v8, vs8), "V's pool"),
               (q, (kc, ks.double(), vc, vs), "k_sz must be fp32")]
    for qq, aa, msg in bad:
        for i in range(3):
            with pytest.raises(NotImplementedError, match=msg):
                _call(kind, i, qq, aa, table, lengths)
    if kind == "quant":                    # codes through the fp entries
        for i in range(3):
            with pytest.raises(NotImplementedError, match="code pools"):
                _call("fp", i, q, (args[0], args[2]), table, lengths)
    assert lib.calls == []
    assert {n: getattr(K, n).launches for n in ENTRIES[kind]} == before


def test_width_list_and_bindings():
    """PagedSepWidths is read from its one place in the sources: the
    latent and Granite-20B's MQA head (one kv head of 128, so its per-layer
    cache is one K and one V pool); every new entry is bound."""
    from repro_torch.configs import get_config
    m = re.search(r"using PagedSepWidths\s*=\s*Widths<([^>]*)>",
                  (CSRC / "mma_tile.cuh").read_text())
    w = [x.strip() for x in m.group(1).split(",")]
    assert w == ["LATENT_DK", "LATENT_DV", "128", "128"]
    cfg = get_config("granite_20b")
    assert (cfg.num_kv_heads, cfg.resolved_head_dim) == (1, 128)
    assert (CSRC / "etap_sepv.cu").exists()
    for names in ENTRIES.values():
        for name in names:
            assert name in build.SIGNATURES
    for name in ("etap_paged_sepv_widths", "etap_paged_sepv_attrs"):
        assert name in build.SIGNATURES


def test_bf16_chunk_kernel_is_the_hopper_source():
    """K4 over bf16 pools and K4q over code pools, fused and separate-V,
    are defined in etap_prefill.cu alone (wgmma over TMA-loaded boxes: no
    mma.sync, no cp.async page loads), under their unchanged C signatures;
    the mma.sync ETAP body is gone, and the decode kernel keeps no prefill
    / verify address."""
    src = (CSRC / "etap_prefill.cu").read_text()
    for name in ("etap_prefill_mla_paged", "etap_prefill_paged",
                 "etap_prefill_mla_paged_quant", "etap_prefill_paged_quant"):
        defs = [f.name for f in sorted(CSRC.glob("*.cu"))
                if re.search(rf"\bint {name}\(", f.read_text())]
        assert defs == ["etap_prefill.cu"], (name, defs)
    assert len(build.SIGNATURES["etap_prefill_mla_paged"]) == 13
    assert len(build.SIGNATURES["etap_prefill_paged"]) == 16
    assert len(build.SIGNATURES["etap_prefill_mla_paged_quant"]) == 16
    assert len(build.SIGNATURES["etap_prefill_paged_quant"]) == 20
    assert "etap_prefill_attrs" in build.SIGNATURES
    assert "etap_prefill_quant_attrs" in build.SIGNATURES
    assert "wgmma" in src and "tma_load_4d" in src
    for banned in ("mma16816(", "cp_async", '#include "etap_body.cuh"'):
        assert banned not in src
    assert not (CSRC / "etap_body.cuh").exists()
    body = (CSRC / "etap_decode.cuh").read_text()
    for gone in ("qpos", "hz_off"):
        assert gone not in body
