"""Decode and prefill attention entry points — the port of the dispatchers
of ``repro/core/etap.py``: the dense entry :func:`decode_attention`, the
GQA regrouping (:func:`gqa_to_grouped` and its copy-free twin
:func:`gqa_grouped_view`), and the paged entries.

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
is fp32.  The paged entries take the MLA-fused latent pool (``v_pool``
None: V its first ``dv`` columns) or separate K and V pools (the
reference's separate-V layout, e.g. Granite-20B's MQA head), in fp or as
int8 / fp8 codes with their per-row (scale, zp) pools ``k_sz`` / ``v_sz``:
ETAP reads the pools in place through the block table (K3 / K1 + K2 / K4,
or K3q / K1q / K4q over codes, which dequantize in registers); the
``standard`` baseline gathers the pools (codes and pairs) for K7 / K8 (K7q
/ K8q, fp32 out, where the reference dequantizes before its kernel).  In
the reference no serve loop reaches the separate-V pools (the GQA paged
path gathers its pools to the dense layout): they are reached through
these entries and ``kernels/etap/ops.py``.
"""
from __future__ import annotations

from repro_torch.core.attn_spec import AttnSpec
from repro_torch.kernels.etap import ops as etap_ops
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.splitkv import grouped
from repro_torch.runtime.paged_cache import gather_blocks


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


def _gather_kv(k_pool, v_pool, table, dv: int, k_sz=None, v_sz=None):
    """The dense view of a paged cache for the baseline: (k, v, k pairs, v
    pairs), each pool gathered through the table (one cache-sized copy
    each; codes stay codes, and their (scale, zp) pools are gathered
    beside them).  ``v_pool`` None: the MLA-fused pool, V its first ``dv``
    columns (a view) with K's pairs."""
    k = gather_blocks(k_pool, table)
    ksz = None if k_sz is None else gather_blocks(k_sz, table)
    if v_pool is None:
        return k, k[..., :dv], ksz, ksz
    v = gather_blocks(v_pool, table)
    return k, v, ksz, None if v_sz is None else gather_blocks(v_sz, table)


def decode_attention_paged(q, k_pool, v_pool, table, lengths, *,
                           spec: AttnSpec, dv: int = 0, k_sz=None,
                           v_sz=None):
    """Paged decode attention. q [B,H,Dk]; k_pool [N,page,Dk] and v_pool
    [N,page,Dv], or v_pool None: the latent pool, V its first ``dv``
    columns; table [B,max_blocks]; lengths [B].  spec.kv_splits None =
    auto split-KV.  ETAP reads the pools in place (K3, or K1 + K2); the
    "standard" baseline runs on the gathered dense layout with block =
    page, as the reference's does (it exists for comparison, not serving).
    ``k_sz`` / ``v_sz``: the (scale, zp) pools of int8 / fp8 code pools
    (``v_sz`` None with the latent pool: V takes K's pairs): ETAP reads the
    codes in place (K3q / K1q); the baseline gathers codes and pairs for
    K7q / K8q (the reference gathers the rows dequantized to fp32).
    Returns [B,H,Dv]: the V pool's dtype over fp pools; over codes q's
    (ETAP) or fp32 (the baseline, as the reference's)."""
    if spec.mode == "etap":
        if v_pool is None:
            return etap_ops.etap_decode_mla_paged_splitkv(
                q, k_pool, dv, table, lengths, spec=spec, kv_sz=k_sz)
        return etap_ops.etap_decode_paged_splitkv(
            q, k_pool, v_pool, table, lengths, spec=spec, k_sz=k_sz,
            v_sz=v_sz)
    k, v, ksz, vsz = _gather_kv(k_pool, v_pool, table, dv, k_sz, v_sz)
    return fd_ops.flash_decode_splitkv(
        q, k, v, lengths, spec=spec.replace(block=k_pool.shape[1]), k_sz=ksz,
        v_sz=vsz)


def prefill_attention_paged(q, k_pool, v_pool, table, start, *,
                            spec: AttnSpec, dv: int = 0, k_sz=None,
                            v_sz=None):
    """Chunked paged prefill attention (K4, or K4q over code pools). q
    [B,Cq,H,Dk]; start [B] tokens in the pool before the chunk, whose rows
    must already be appended.  Pools as :func:`decode_attention_paged`
    takes them.  ``spec.mode`` is ignored, as in the reference: prefill
    always runs the transposed loop.  Returns [B,Cq,H,Dv]."""
    if v_pool is None:
        return etap_ops.etap_prefill_mla_paged(q, k_pool, dv, table, start,
                                               spec=spec, kv_sz=k_sz)
    return etap_ops.etap_prefill_paged(q, k_pool, v_pool, table, start,
                                       spec=spec, k_sz=k_sz, v_sz=v_sz)


def verify_attention_paged(q, k_pool, v_pool, table, start, qpos, *,
                           spec: AttnSpec, dv: int = 0, k_sz=None,
                           v_sz=None):
    """Draft-verify attention: :func:`prefill_attention_paged` with the
    explicit per-row horizon qpos [B,Cq].  A linear qpos is bitwise the
    prefill entry."""
    if v_pool is None:
        return etap_ops.etap_verify_mla_paged(q, k_pool, dv, table, start,
                                              qpos, spec=spec, kv_sz=k_sz)
    return etap_ops.etap_verify_paged(q, k_pool, v_pool, table, start, qpos,
                                      spec=spec, k_sz=k_sz, v_sz=v_sz)
