"""Decode and prefill attention entry points — the port of the dispatchers
of ``repro/core/etap.py``: the dense entry :func:`decode_attention`, the
GQA regrouping (:func:`gqa_to_grouped` and its copy-free twin
:func:`gqa_grouped_view`), and the paged entries for the MLA-fused pool.

Decode attention computes, per (batch, kv-group):
    standard:  S = Q Kᵀ,  P = softmax_rows(S),  O = P V   (thin M = heads)
    ETAP:      Sᵀ = K Qᵀ,  Pᵀ = softmax_cols(Sᵀ),  Oᵀ = Vᵀ Pᵀ,  O = (Oᵀ)ᵀ

The reference routes to its Pallas kernels only when ``use_kernels`` is set
and otherwise runs XLA twins; the port has one route per entry: the kernel
wrappers in :mod:`repro_torch.kernels.etap.ops` (ETAP) and
:mod:`repro_torch.kernels.flash_decode.ops` (the untransposed ``standard``
baseline), whose operands' device picks the CUDA kernel or its plain
version.  A GQA cache [B, S, K, hd] decodes through the dense entry in its
grouped form (BG = B·K rows of G = H/K query columns): the reference copies
the cache into that form, the port hands the kernels the cache itself and
they read it in place.  The dense entry also takes int8 / fp8 code rows
with their (scale, zp) rows ``k_sz`` / ``v_sz`` (the gathered rows of a
quantized GQA pool, or of the latent pool): K5q / K6q or K7q / K8q read the
codes, where the reference dequantizes them to fp32 first, and the output
is fp32.  The paged entries take the MLA-fused latent pool in fp or as
int8 / fp8 codes with their per-row (scale, zp) pool ``k_sz`` (the
quantized bodies dequantize in registers; the ``standard`` baseline
gathers codes and pairs for K7q / K8q).  Separate-V paged pools (their
kernels are reached only from ``kernels/etap/ops.py`` in the reference; the
GQA paged path gathers its pools to the dense layout instead) are not
ported yet and raise ``NotImplementedError`` naming the ROADMAP item.
"""
from __future__ import annotations

from repro_torch.core.attn_spec import AttnSpec
from repro_torch.kernels.etap import ops as etap_ops
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.splitkv import grouped
from repro_torch.runtime.paged_cache import gather_blocks


def _check(v_pool, v_sz) -> None:
    if v_pool is not None or v_sz is not None:
        raise NotImplementedError(
            "separate-V paged pools (fp or quantized) are not ported yet: "
            "ROADMAP A5b")


def _restorer(B: int, H: int):
    def restore(o):                                     # [B·K, G, Dv]
        return o.reshape(B, H, o.shape[-1])
    return restore


def gqa_to_grouped(q, k, v):
    """[B,H,D], [B,S,K,D], [B,S,K,Dv] → the grouped (BG = B·K) form
    q [BG,G,D], k [BG,S,D], v [BG,S,Dv] and a restorer [BG,G,Dv] →
    [B,H,Dv] — the reference's ``gqa_to_grouped``: head h is query column
    g = h % G of grouped row b·K + h // G.  k and v are copies; the serve
    path uses :func:`gqa_grouped_view`."""
    B, H, D = q.shape
    K = k.shape[2]
    return (q.reshape(B * K, H // K, D), grouped(k), grouped(v),
            _restorer(B, H))


def gqa_grouped_view(q, k, v):
    """:func:`gqa_to_grouped` without the copies: q [BG,G,D] (a view of a
    contiguous q), and k, v left as the [B,S,K,D*] cache, which the dense
    decode entries take as the grouped rows — the CUDA kernels read them in
    place through the kv-head stride (bitwise the kernel on the copy), the
    plain versions copy them."""
    B, H, D = q.shape
    K = k.shape[2]
    return q.reshape(B * K, H // K, D), k, v, _restorer(B, H)


def decode_attention(q, k, v, length=None, *, spec: AttnSpec, k_sz=None,
                     v_sz=None):
    """Dense decode attention. q [BG,H,Dk]; k [BG,S,Dk] and v [BG,S,Dv], or
    a GQA cache [B,S,K,D*] standing for its grouped rows (BG = B·K,
    :func:`gqa_grouped_view`); length [BG] valid-prefix lengths (None = all
    S).  spec.mode "etap" (the paper) or "standard" (the untransposed
    baseline); spec.kv_splits None = auto split-KV on both.  ``k_sz`` /
    ``v_sz``: the (scale, zp) rows [..., 2] of int8 / fp8 code rows k, v
    (the quantized kernels run; q as the caller leaves it).  Returns
    [BG,H,Dv] in v's dtype, fp32 over codes."""
    if spec.mode == "etap":
        return etap_ops.etap_decode_splitkv(q, k, v, length, spec=spec,
                                            k_sz=k_sz, v_sz=v_sz)
    return fd_ops.flash_decode_splitkv(q, k, v, length, spec=spec,
                                       k_sz=k_sz, v_sz=v_sz)


def _gather_kv(k_pool, table, dv: int):
    """The dense (k, v) view of an MLA-fused paged pool: the pages gathered
    through the table (one cache-sized copy), V their first ``dv``
    columns (a view)."""
    k = gather_blocks(k_pool, table)
    return k, k[..., :dv]


def decode_attention_paged(q, k_pool, v_pool, table, lengths, *,
                           spec: AttnSpec, dv: int = 0, k_sz=None,
                           v_sz=None):
    """Paged decode attention. q [B,H,Dk]; k_pool [N,page,Dk] the latent
    pool (v_pool None: V = its first ``dv`` columns); table [B,max_blocks];
    lengths [B].  spec.kv_splits None = auto split-KV.  The "standard"
    baseline runs on the gathered dense layout with block = page, as the
    reference's does (it exists for comparison, not serving).  Returns
    [B,H,dv].  ``k_sz``: the (scale, zp) pool of an int8 / fp8 code pool:
    ETAP reads the pool in place (K3q / K1q); the baseline gathers the
    codes and their pairs, and K7q / K8q read them with V the codes' first
    ``dv`` columns (the reference gathers the rows dequantized to fp32);
    the output is then q's dtype (ETAP) or fp32 (the baseline, as the
    reference's)."""
    _check(v_pool, v_sz)
    if spec.mode == "etap":
        return etap_ops.etap_decode_mla_paged_splitkv(
            q, k_pool, dv, table, lengths, spec=spec, kv_sz=k_sz)
    k, v = _gather_kv(k_pool, table, dv)
    sz = None if k_sz is None else gather_blocks(k_sz, table)
    return fd_ops.flash_decode_splitkv(
        q, k, v, lengths, spec=spec.replace(block=k_pool.shape[1]), k_sz=sz,
        v_sz=sz)


def prefill_attention_paged(q, k_pool, v_pool, table, start, *,
                            spec: AttnSpec, dv: int = 0, k_sz=None,
                            v_sz=None):
    """Chunked paged prefill attention. q [B,Cq,H,Dk]; start [B] tokens in
    the pool before the chunk, whose rows must already be appended.
    ``spec.mode`` is ignored, as in the reference: prefill always runs the
    transposed loop.  ``k_sz``: the (scale, zp) pool of an int8 / fp8
    code pool.  Returns [B,Cq,H,dv]."""
    _check(v_pool, v_sz)
    return etap_ops.etap_prefill_mla_paged(q, k_pool, dv, table, start,
                                           spec=spec, kv_sz=k_sz)


def verify_attention_paged(q, k_pool, v_pool, table, start, qpos, *,
                           spec: AttnSpec, dv: int = 0, k_sz=None,
                           v_sz=None):
    """Draft-verify attention: :func:`prefill_attention_paged` with the
    explicit per-row horizon qpos [B,Cq].  A linear qpos is bitwise the
    prefill entry."""
    _check(v_pool, v_sz)
    return etap_ops.etap_verify_mla_paged(q, k_pool, dv, table, start, qpos,
                                          spec=spec, kv_sz=k_sz)
