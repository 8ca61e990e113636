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

Under a mesh whose ``model`` axis sequence-shards a long dense cache
(:func:`repro_torch.sharding.rules.seq_shardable`), decode runs
:func:`seq_sharded_decode` (the MLA latent) or
:func:`seq_sharded_gqa_decode` (a GQA cache): each rank holds S/n rows of
the cache, runs K6 over them and exchanges only the softmax statistics.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.attn_spec import AttnSpec
from repro_torch.kernels import softmax_state
from repro_torch.kernels.etap import etap as etap_kernels
from repro_torch.kernels.etap import ops as etap_ops
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.splitkv import grouped, split_plan
from repro_torch.launch import mesh as mesh_mod
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


# ------------------------------------------------- sequence-sharded decode
def _write_owned(cache, row, pos: int, start: int) -> None:
    """Write ``row`` [B, ...] at global position ``pos`` of a rank's slice
    of S/n rows starting at global row ``start``, if the slice holds it."""
    if start <= pos < start + cache.shape[1]:
        cache[:, pos - start] = row


def _shard_partial(q, k, v, pos: int, start: int, *, scale, block, mode):
    """The rank's local partial: K6 (its plain version on CPU operands)
    over the slice's valid rows, ``clamp(pos + 1 - start, 0, S/n)`` of
    them, under the slice's own (auto) split plan, and the plan's splits
    merged here.  q [BG, G, Dk]; k, v [BG, S/n, D*] or a GQA slice [B, S/n, K,
    D*].  Returns fp32 (m [BG, G], l [BG, G], accT [BG, Dv, G])."""
    n_local = k.shape[1]
    length = torch.full((q.shape[0],), min(max(pos + 1 - start, 0), n_local),
                        dtype=torch.int32, device=q.device)
    plan = split_plan(q, k, v, spec=AttnSpec(block=block))
    m, l, acc = etap_kernels.etap_partial_dense(q, k, v, length, scale=scale,
                                                plan=plan, rescale=mode)
    return softmax_state.merge_splits(m, l, acc, axis=1, mode=mode,
                                      expand=lambda w: w[:, :, None, :])


def _combine_shards(m, l, acc, *, axis: str, mode: str):
    """The cross-rank combine over ``axis`` of the current mesh: an
    all-reduce MAX of m, then one all-reduce SUM of l·w and accᵀ·w packed
    in one buffer, w = :func:`softmax_state.merge_weights` (m, m*).
    Returns Oᵀ = acc* / l* [BG, Dv, G] fp32."""
    mesh = mesh_mod.get_mesh()
    m_g = mesh_mod.all_reduce(m.clone(), dist.ReduceOp.MAX, mesh, axis)
    w = softmax_state.merge_weights(m, m_g, mode=mode)
    buf = torch.cat([(l * w).reshape(-1),
                     (acc * w[:, None, :]).reshape(-1)])
    mesh_mod.all_reduce(buf, dist.ReduceOp.SUM, mesh, axis)
    seq_sharded_decode.reduced_bytes += (m_g.numel() + buf.numel()) * 4
    l_g = buf[:l.numel()].view_as(l)
    acc_g = buf[l.numel():].view_as(acc)
    return acc_g / l_g[:, None, :]


def _slice_start(cache, axis: str) -> int:
    mesh = mesh_mod.get_mesh()
    if mesh is None:
        raise ValueError("sequence-sharded decode needs a mesh (use_mesh)")
    return mesh.coord(axis) * cache.shape[1]


def seq_sharded_decode(q, cache, new_row, pos: int, *, dv: int, scale: float,
                       axis: str = "model", block: int = 512,
                       rescale: str | None = None):
    """Sequence-sharded MLA decode over ``axis`` of the current mesh.

    The MLA latent cache [B, S, L] has NO head dimension, so tensor
    parallelism cannot shard it — instead S is sharded over the model
    axis: each rank holds rows [start, start + S/n), start = its index ·
    S/n, and (1) writes the new latent row if it owns position ``pos`` (a
    host int), (2) runs the ETAP partial K6 over its slice (whatever the
    spec's mode, as the reference does), merging the slice's own splits,
    and (3) the ranks exchange the (m, l, accᵀ) stats (flash-decode-style
    cross-device softmax combine).  q [B, H, L] whole on every rank; cache
    the rank's slice [B, S/n, L], written in place; new_row [B, L].
    Returns (O [B, H, dv] in the cache's dtype, cache)."""
    mode = softmax_state.resolve(rescale)
    start = _slice_start(cache, axis)
    _write_owned(cache, new_row, pos, start)
    m, l, acc = _shard_partial(q, cache, cache[..., :dv], pos, start,
                               scale=scale, block=block, mode=mode)
    oT = _combine_shards(m, l, acc, axis=axis, mode=mode)
    return oT.transpose(1, 2).to(cache.dtype), cache


def seq_sharded_gqa_decode(q, k_cache, v_cache, new_k, new_v, pos: int, *,
                           scale: float, axis: str = "model",
                           block: int = 512, rescale: str | None = None):
    """Sequence-sharded GQA decode — the generic-attention analogue of
    :func:`seq_sharded_decode`: each rank holds an S/n slice of the [B, S,
    K, hd] caches, writes the new K/V rows if ``pos`` falls in it, runs K6
    over the slice in its grouped form (B·K rows of G = H/K columns, read
    in place: :func:`gqa_grouped_view`), and the ranks exchange only the
    (m, l, accᵀ) stats.  q [B, H, hd] (head h = kv head h // G, column h
    % G); new_k, new_v [B, K, hd].  Returns (O [B, H, Dv], k_cache,
    v_cache)."""
    mode = softmax_state.resolve(rescale)
    start = _slice_start(k_cache, axis)
    _write_owned(k_cache, new_k, pos, start)
    _write_owned(v_cache, new_v, pos, start)
    qg, k, v, restore = gqa_grouped_view(q.contiguous(), k_cache, v_cache)
    m, l, acc = _shard_partial(qg, k, v, pos, start, scale=scale,
                               block=block, mode=mode)
    oT = _combine_shards(m, l, acc, axis=axis, mode=mode)
    return restore(oT.transpose(1, 2)).to(v_cache.dtype), k_cache, v_cache


seq_sharded_decode.reduced_bytes = 0
