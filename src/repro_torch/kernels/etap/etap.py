"""ETAP kernels: wrappers, launch counters and plain versions.

The port of ``repro/kernels/etap/etap.py``: the paged kernels at the MLA
latent's widths (Dk 576, Dv 512), over separate K and V pools also at
Granite-20B's MQA head (128, 128), the dense ones also at the GQA heads
(Dk = Dv = 128, 64 and 256; ``kernels/csrc/mma_tile.cuh`` lists the pairs
each kernel is built for).  Sixteen kernels, two CUDA kernels on one
design (wgmma and TMA for Hopper), each source's header saying what
bounds it on the H100 and how the design answers it: K4 and K4q, the
chunked prefill and verify over bf16 and int8 / fp8 pools, fused and with
a separate V, are ``kernels/csrc/etap_prefill.cu``; the decode kernels
K1, K3, K5 and K6 and their twins over int8 / fp8 codes K1q, K3q, K5q
and K6q are ``kernels/csrc/etap_decode.cuh``'s kernel (``etap_decode.cu``
builds the paged bf16 ones, fused and over separate pools, ``etap.cu``
the dense bf16 ones, ``etap_quant.cu`` the fused paged and the dense ones
over codes, ``etap_sepv.cu`` the paged ones over separate code pools):

  K3 :func:`etap_decode_mla_paged`   single-pass paged decode
     (replaces ``repro/kernels/etap/etap.py:237``, ``_paged_call``)
  K1 :func:`etap_paged_partial`      split-KV phase 1, paged
     (replaces ``repro/kernels/etap/etap.py:713``)
  K4 :func:`etap_prefill_mla_paged` / :func:`etap_verify_mla_paged`
     chunked paged prefill and draft verify
     (replaces ``repro/kernels/etap/etap.py:430``, ``_prefill_call``)
  K5 :func:`etap_decode_dense` (and its fused form
     :func:`etap_decode_mla_dense`)  single-pass dense decode
     (replaces ``repro/kernels/etap/etap.py:154``, ``_call``)
  K6 :func:`etap_partial_dense`      split-KV phase 1, dense
     (replaces ``repro/kernels/etap/etap.py:603``)
     K5 and K6 also read a GQA cache [B, S, K, hd] in place as its grouped
     form [B·K, S, hd] (:mod:`repro_torch.kernels.splitkv`).
  K3q, K1q, K4q :func:`etap_decode_mla_paged_quant`,
     :func:`etap_paged_partial_quant`, :func:`etap_prefill_mla_paged_quant`
     / :func:`etap_verify_mla_paged_quant`: K3, K1 and K4 over an int8 or
     fp8 (e4m3) code pool with its per-row (scale, zp) pool ``kv_sz``
     (replace the reference's quantized MLA-fused bodies under the same
     three ``pallas_call`` sites, ``etap.py:116, :639, :340, :367``).  The
     codes enter the tensor cores as exact bf16 values and the affine is
     applied around the products in fp32, so no dequantized row is rounded
     to bf16; q is bf16 or fp32 and the output takes q's dtype.
  K5q, K6q :func:`etap_decode_dense_quant`, :func:`etap_partial_dense_quant`:
     K5 and K6 over dense int8 / fp8 code rows (a GQA cache [B, S, K, hd]
     read in place) with their (scale, zp) rows ``k_sz`` / ``v_sz``, at
     the 128- and 64-wide heads: the GQA decode over a quantized paged
     pool, which gathers codes and pairs where the reference gathers them
     dequantized to fp32 and hands K5 / K6 the fp32 rows (the same two
     ``pallas_call`` sites, ``etap.py:154, :603``).  Codes and affine as
     in K3q; q bf16 or fp32; the output is fp32, as the reference's (V's
     fp32 type).
  K3, K1, K4 over separate K and V pools :func:`etap_decode_paged`,
     :func:`etap_paged_partial_sepv`, :func:`etap_prefill_paged` /
     :func:`etap_verify_paged`, and over int8 / fp8 code pools, each with
     its own (scale, zp) pool, :func:`etap_decode_paged_quant`,
     :func:`etap_paged_partial_sepv_quant`, :func:`etap_prefill_paged_quant`
     / :func:`etap_verify_paged_quant`: the reference's separate-V bodies
     under the same three ``pallas_call`` sites (``etap.py:98, :110, :271,
     :334, :348, :360, :619, :631``), at (576, 512) and (128, 128).  One
     table reads both pools; V's tile replaces K's first Dv columns after
     the score product, so at the latent over ``v_pool = pool[..., :Dv]``
     they give the fused kernels' bits.

Each wrapper dispatches on the device of its operands: CPU tensors run the
``*_plain`` version, CUDA tensors launch the kernel (or raise on a shape or
dtype the kernel does not take).  There is no fallback.  The plain versions
walk the KV tiles (pool pages through the block table, dequantized to fp32
rows for a code pool, or ``block``-row blocks of the dense cache as the
reference does) with :func:`repro_torch.kernels.softmax_state.update`, the
recurrence the kernel runs.  Each wrapper's ``launches`` attribute counts
its kernel launches; a K4 / K4q verify launch (``etap_verify_mla_paged``,
``etap_verify_mla_paged_quant``) is counted on its own wrapper and, as the
K4 / K4q launch it is, on ``etap_prefill_mla_paged`` /
``etap_prefill_mla_paged_quant``.

Column convention: a query tile is [B, C, Dk] with C columns; column c is
live for key position kpos iff ``kpos <= horizon[b, c]`` — decode uses
``lengths - 1``, prefill ``start + c // H``, verify the explicit ``qpos``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, softmax_state
from repro_torch.kernels.etap.schedule import dense_split_plan
from repro_torch.kernels.launch import (CODES, amla_flag, check_widths,
                                        dense_partial, dense_single,
                                        dense_widths, device_of, i32, ptr,
                                        refuse_grad, stream)
from repro_torch.kernels.splitkv import split_walks_plain
from repro_torch.runtime.paged_cache import dequantize_rows, raw

NEG_INF = softmax_state.NEG_INF


# ----------------------------------------------------------- plain versions
def _walk_plain(q, fetch, tiles, block, horizon, *, scale, dv, mode):
    """Online-softmax walk over KV ``tiles`` for query columns q [B, C, Dk]
    with per-column horizons [B, C].  ``fetch(j)`` returns tile j's K
    [B, block, Dk] and V [B, block, dv] rows; tile j holds key positions
    [j·block, (j+1)·block).  Returns the fp32 state (m [B,C], l [B,C],
    accT [B,dv,C])."""
    B, C, _ = q.shape
    qf = q.float()
    arange = torch.arange(block, device=q.device, dtype=torch.int32)
    state = softmax_state.init((B, C), (B, dv, C), device=q.device)
    for j in tiles:
        k, v = (x.float().contiguous() for x in fetch(j))
        sT = torch.einsum("bpd,bcd->bpc", k, qf) * scale       # Sᵀ = K·Qᵀ
        kpos = j * block + arange
        live = kpos[None, :, None] <= horizon[:, None, :]
        sT = torch.where(live, sT, NEG_INF)
        state = softmax_state.update(
            state, sT, lambda p, v=v: torch.einsum("bpv,bpc->bvc", v, p),
            axis=1, mode=mode, expand=lambda c: c[:, None, :])
    return state


def _pool_rows(pool, sz, ids):
    """Blocks ``ids`` of a pool [N, page, D], dequantized to fp32 rows
    (``codes*scale + zp``) when ``sz`` holds the code pool's pairs."""
    blk = raw(pool)[ids].view(pool.dtype)                      # [B,page,D]
    return blk if sz is None else dequantize_rows(blk, sz[ids])


def _pool_fetch(pool, table, dv, sz=None, v_pool=None, v_sz=None):
    """Tile j of every row: pool block table[:, j] (dequantized with its
    pairs ``sz`` over codes); V is its first ``dv`` columns (sliced after
    the dequant), or with ``v_pool`` block table[:, j] of the V pool
    (dequantized with its own pairs ``v_sz``)."""
    def fetch(j):
        ids = table[:, j].long()
        k = _pool_rows(pool, sz, ids)
        if v_pool is None:
            return k, k[..., :dv]
        return k, _pool_rows(v_pool, v_sz, ids)
    return fetch


def _finalize(state, dtype):
    """O = (Accᵀ / ℓ)ᵀ in the output dtype: [B, C, dv]."""
    oT = softmax_state.finalize(state, expand=lambda l: l[:, None, :])
    return oT.transpose(1, 2).to(dtype)


def _decode_horizon(lengths, H):
    return (lengths.to(torch.int32) - 1)[:, None].expand(-1, H)


def _chunk_horizon(start, qpos, Cq, H, device):
    if qpos is not None:
        return qpos.to(torch.int32).repeat_interleave(H, dim=1)  # [B, Cq*H]
    col = torch.arange(Cq * H, device=device, dtype=torch.int32) // H
    return start.to(torch.int32)[:, None] + col[None, :]


def _out_dtype(q, kv_pool, kv_sz, v_pool=None):
    """A quantized pool's outputs take q's dtype (as the reference's), an
    fp pool's its own (V's, when V has a pool of its own)."""
    if kv_sz is not None:
        return q.dtype
    return (kv_pool if v_pool is None else v_pool).dtype


def _decode_plain(q, kv_pool, kv_sz, dv, table, lengths, *, scale, rescale,
                  v_pool=None, v_sz=None):
    mode = softmax_state.resolve(rescale)
    state = _walk_plain(q, _pool_fetch(kv_pool, table, dv, kv_sz, v_pool,
                                       v_sz),
                        range(table.shape[1]), kv_pool.shape[1],
                        _decode_horizon(lengths, q.shape[1]), scale=scale,
                        dv=dv, mode=mode)
    return _finalize(state, _out_dtype(q, kv_pool, kv_sz, v_pool))


def _partial_plain(q, kv_pool, kv_sz, dv, table, lengths, *, scale,
                   n_splits, rescale, v_pool=None, v_sz=None):
    mode = softmax_state.resolve(rescale)
    nb = table.shape[1]
    if nb % n_splits:
        raise ValueError(f"table width {nb} not a multiple of {n_splits}")
    npb = nb // n_splits
    horizon = _decode_horizon(lengths, q.shape[1])
    fetch = _pool_fetch(kv_pool, table, dv, kv_sz, v_pool, v_sz)
    parts = [_walk_plain(q, fetch, range(s * npb, (s + 1) * npb),
                         kv_pool.shape[1], horizon, scale=scale, dv=dv,
                         mode=mode) for s in range(n_splits)]
    return tuple(torch.stack(x, dim=1) for x in zip(*parts, strict=True))


def _prefill_plain(q, kv_pool, kv_sz, dv, table, start, qpos, *, scale,
                   rescale, v_pool=None, v_sz=None):
    mode = softmax_state.resolve(rescale)
    B, Cq, H, Dk = q.shape
    horizon = _chunk_horizon(start, qpos, Cq, H, q.device)
    state = _walk_plain(q.reshape(B, Cq * H, Dk),
                        _pool_fetch(kv_pool, table, dv, kv_sz, v_pool, v_sz),
                        range(table.shape[1]), kv_pool.shape[1], horizon,
                        scale=scale, dv=dv, mode=mode)
    return _finalize(state, _out_dtype(q, kv_pool, kv_sz, v_pool)).reshape(
        B, Cq, H, dv)


def etap_decode_mla_paged_plain(q, kv_pool, dv, table, lengths, *, scale,
                                rescale=None):
    """Plain K3. q [B,H,Dk]; pool [N,page,Dk]; table [B,nb]; lengths [B].
    Returns [B,H,dv] in the pool dtype."""
    return _decode_plain(q, kv_pool, None, dv, table, lengths, scale=scale,
                         rescale=rescale)


def etap_paged_partial_plain(q, kv_pool, dv, table, lengths, *, scale,
                             n_splits, rescale=None):
    """Plain K1.  The table width must be a multiple of ``n_splits``; split
    s walks columns [s·npb, (s+1)·npb).  Returns fp32 (m [B,n,H],
    l [B,n,H], accT [B,n,dv,H])."""
    return _partial_plain(q, kv_pool, None, dv, table, lengths, scale=scale,
                          n_splits=n_splits, rescale=rescale)


def etap_prefill_mla_paged_plain(q, kv_pool, dv, table, start, *, scale,
                                 rescale=None, qpos=None):
    """Plain K4. q [B,Cq,H,Dk]; start [B] rows in the pool before the chunk
    (whose rows are already appended); qpos [B,Cq] explicit per-row
    horizons (verify) or None (prefill).  Returns [B,Cq,H,dv]."""
    return _prefill_plain(q, kv_pool, None, dv, table, start, qpos,
                          scale=scale, rescale=rescale)


def etap_verify_mla_paged_plain(q, kv_pool, dv, table, start, qpos, **kw):
    """Plain K4 with the explicit per-row horizon qpos [B,Cq]."""
    return etap_prefill_mla_paged_plain(q, kv_pool, dv, table, start,
                                        qpos=qpos, **kw)


def etap_decode_mla_paged_quant_plain(q, kv_pool, kv_sz, dv, table, lengths,
                                      *, scale, rescale=None):
    """Plain K3q: K3 over an int8 / fp8 code pool [N,page,Dk] with its
    (scale, zp) pool kv_sz [N,page,2].  Each row is dequantized to fp32 and
    q taken in fp32, as the reference does.  Returns [B,H,dv] in q's
    dtype."""
    return _decode_plain(q, kv_pool, kv_sz, dv, table, lengths, scale=scale,
                         rescale=rescale)


def etap_paged_partial_quant_plain(q, kv_pool, kv_sz, dv, table, lengths, *,
                                   scale, n_splits, rescale=None):
    """Plain K1q: K1 over a quantized pool.  Returns fp32 (m, l, accT)."""
    return _partial_plain(q, kv_pool, kv_sz, dv, table, lengths, scale=scale,
                          n_splits=n_splits, rescale=rescale)


def etap_prefill_mla_paged_quant_plain(q, kv_pool, kv_sz, dv, table, start,
                                       *, scale, rescale=None, qpos=None):
    """Plain K4q: K4 (prefill, or verify with ``qpos``) over a quantized
    pool.  Returns [B,Cq,H,dv] in q's dtype."""
    return _prefill_plain(q, kv_pool, kv_sz, dv, table, start, qpos,
                          scale=scale, rescale=rescale)


def etap_verify_mla_paged_quant_plain(q, kv_pool, kv_sz, dv, table, start,
                                      qpos, **kw):
    """Plain K4q with the explicit per-row horizon qpos [B,Cq]."""
    return etap_prefill_mla_paged_quant_plain(q, kv_pool, kv_sz, dv, table,
                                              start, qpos=qpos, **kw)


def etap_decode_paged_plain(q, k_pool, v_pool, table, lengths, *, scale,
                            rescale=None):
    """Plain K3 over separate pools: K block table[b, j] of k_pool
    [N,page,Dk], V the same block of v_pool [N,page,Dv].  Returns [B,H,Dv]
    in v_pool's dtype."""
    return _decode_plain(q, k_pool, None, v_pool.shape[-1], table, lengths,
                         scale=scale, rescale=rescale, v_pool=v_pool)


def etap_paged_partial_sepv_plain(q, k_pool, v_pool, table, lengths, *,
                                  scale, n_splits, rescale=None):
    """Plain K1 over separate pools (table width a multiple of
    ``n_splits``).  Returns fp32 (m [B,n,H], l [B,n,H], accT
    [B,n,Dv,H])."""
    return _partial_plain(q, k_pool, None, v_pool.shape[-1], table, lengths,
                          scale=scale, n_splits=n_splits, rescale=rescale,
                          v_pool=v_pool)


def etap_prefill_paged_plain(q, k_pool, v_pool, table, start, *, scale,
                             rescale=None, qpos=None):
    """Plain K4 over separate pools (verify with ``qpos`` [B,Cq]).
    Returns [B,Cq,H,Dv] in v_pool's dtype."""
    return _prefill_plain(q, k_pool, None, v_pool.shape[-1], table, start,
                          qpos, scale=scale, rescale=rescale, v_pool=v_pool)


def etap_decode_paged_quant_plain(q, k_pool, k_sz, v_pool, v_sz, table,
                                  lengths, *, scale, rescale=None):
    """Plain K3q over separate int8 / fp8 code pools, each dequantized to
    fp32 with its own (scale, zp) pool (k_sz, v_sz [N,page,2]), q taken in
    fp32.  Returns [B,H,Dv] in q's dtype."""
    return _decode_plain(q, k_pool, k_sz, v_pool.shape[-1], table, lengths,
                         scale=scale, rescale=rescale, v_pool=v_pool,
                         v_sz=v_sz)


def etap_paged_partial_sepv_quant_plain(q, k_pool, k_sz, v_pool, v_sz,
                                        table, lengths, *, scale, n_splits,
                                        rescale=None):
    """Plain K1q over separate code pools.  Returns fp32 (m, l, accT)."""
    return _partial_plain(q, k_pool, k_sz, v_pool.shape[-1], table, lengths,
                          scale=scale, n_splits=n_splits, rescale=rescale,
                          v_pool=v_pool, v_sz=v_sz)


def etap_prefill_paged_quant_plain(q, k_pool, k_sz, v_pool, v_sz, table,
                                   start, *, scale, rescale=None, qpos=None):
    """Plain K4q over separate code pools (verify with ``qpos``).  Returns
    [B,Cq,H,Dv] in q's dtype."""
    return _prefill_plain(q, k_pool, k_sz, v_pool.shape[-1], table, start,
                          qpos, scale=scale, rescale=rescale, v_pool=v_pool,
                          v_sz=v_sz)


def _dense_splits_plain(q, k, v, length, plan, *, scale, mode, k_sz=None,
                        v_sz=None):
    """Per-split fp32 states of a dense walk over ``plan.block``-row blocks,
    the cache zero-padded to the plan as the reference pads it (code rows
    dequantized block by block with their pairs ``k_sz`` / ``v_sz``)."""
    horizon = _decode_horizon(length, q.shape[1])
    return split_walks_plain(k, v, plan, lambda fetch, tiles: _walk_plain(
        q, fetch, tiles, plan.block, horizon, scale=scale, dv=v.shape[-1],
        mode=mode), k_sz=k_sz, v_sz=v_sz)


def etap_decode_dense_plain(q, k, v, length, *, scale, block=512,
                            rescale=None):
    """Plain K5. q [BG,H,Dk]; k [BG,S,Dk] and v [BG,S,Dv], or a GQA cache
    [B,S,K,D*] (BG = B·K); length [BG].  Walks ``min(block, S)``-row
    blocks, S zero-padded to a block multiple.  Returns [BG,H,Dv] in v's
    dtype."""
    (state,) = _dense_splits_plain(q, k, v, length,
                                   dense_split_plan(k.shape[1], block, 1),
                                   scale=scale,
                                   mode=softmax_state.resolve(rescale))
    return _finalize(state, v.dtype)


def etap_partial_dense_plain(q, k, v, length, *, scale, plan, rescale=None):
    """Plain K6: split s walks blocks [s·npb, (s+1)·npb) of the cache
    padded to ``plan.padded_s`` rows.  Returns fp32 (m [BG,n,H],
    l [BG,n,H], accT [BG,n,Dv,H])."""
    parts = _dense_splits_plain(q, k, v, length, plan, scale=scale,
                                mode=softmax_state.resolve(rescale))
    return tuple(torch.stack(x, dim=1) for x in zip(*parts, strict=True))


def etap_decode_dense_quant_plain(q, k, v, length, *, k_sz, v_sz, scale,
                                  block=512, rescale=None):
    """Plain K5q: K5 over int8 / fp8 code rows k, v (as
    :func:`etap_decode_dense_plain` takes them) with their (scale, zp)
    rows k_sz, v_sz [..., 2]; each fetched block is dequantized to fp32
    and q taken in fp32, as the reference's K5 on its dequantized rows.
    Returns [BG,H,Dv] fp32."""
    (state,) = _dense_splits_plain(q, k, v, length,
                                   dense_split_plan(k.shape[1], block, 1),
                                   scale=scale,
                                   mode=softmax_state.resolve(rescale),
                                   k_sz=k_sz, v_sz=v_sz)
    return _finalize(state, torch.float32)


def etap_partial_dense_quant_plain(q, k, v, length, *, k_sz, v_sz, scale,
                                   plan, rescale=None):
    """Plain K6q: K6 over code rows with their pairs.  Returns fp32 (m, l,
    accT) as :func:`etap_partial_dense_plain`."""
    parts = _dense_splits_plain(q, k, v, length, plan, scale=scale,
                                mode=softmax_state.resolve(rescale),
                                k_sz=k_sz, v_sz=v_sz)
    return tuple(torch.stack(x, dim=1) for x in zip(*parts, strict=True))


# ----------------------------------------------------------- CUDA launches
def _check_cuda(q, kv_pool, dv, *, what):
    lib = build.library()
    check_widths(q, kv_pool, dv, {(lib.etap_dk(), lib.etap_dv())}, what=what)
    if kv_pool.shape[1] != lib.etap_page():
        raise NotImplementedError(
            f"{what}: the CUDA kernel takes page {lib.etap_page()}, got "
            f"{kv_pool.shape[1]}")
    return lib


def etap_decode_mla_paged(q, kv_pool, dv, table, lengths, *, scale,
                          rescale=None):
    """K3: single-pass paged MLA-fused ETAP decode. q [B,H,Dk]; pool
    [N,page,Dk]; table [B,nb] (null block 0 in padded entries); lengths [B].
    Returns [B,H,dv] in the pool dtype."""
    dev = device_of(q, kv_pool, table, lengths)
    if dev.type == "cpu":
        return etap_decode_mla_paged_plain(q, kv_pool, dv, table, lengths,
                                           scale=scale, rescale=rescale)
    refuse_grad(q, kv_pool, what="etap_decode_mla_paged")
    lib = _check_cuda(q, kv_pool, dv, what="etap_decode_mla_paged")
    B, H, _ = q.shape
    q, pool, table, lengths = (q.contiguous(), kv_pool.contiguous(),
                               i32(table), i32(lengths))
    out = torch.empty(B, H, dv, dtype=kv_pool.dtype, device=dev)
    etap_decode_mla_paged.launches += 1
    build.check(lib.etap_decode_mla_paged(
        ptr(q), ptr(pool), table.data_ptr(), lengths.data_ptr(), ptr(out),
        B, H, table.shape[1], float(scale), amla_flag(rescale), stream(dev)),
        "etap_decode_mla_paged")
    return out


def etap_paged_partial(q, kv_pool, dv, table, lengths, *, scale, n_splits,
                       rescale=None):
    """K1: split-KV phase 1 over the paged latent pool.  The table width
    must be a multiple of ``n_splits`` (``ops._pad_table`` pads it with
    null blocks).  Returns fp32 (m [B,n,H], l [B,n,H], accT [B,n,dv,H])."""
    dev = device_of(q, kv_pool, table, lengths)
    if dev.type == "cpu":
        return etap_paged_partial_plain(q, kv_pool, dv, table, lengths,
                                        scale=scale, n_splits=n_splits,
                                        rescale=rescale)
    refuse_grad(q, kv_pool, what="etap_paged_partial")
    lib = _check_cuda(q, kv_pool, dv, what="etap_paged_partial")
    B, H, _ = q.shape
    nb = table.shape[1]
    if nb % n_splits:
        raise ValueError(f"table width {nb} not a multiple of {n_splits}")
    q, pool, table, lengths = (q.contiguous(), kv_pool.contiguous(),
                               i32(table), i32(lengths))
    f32 = dict(dtype=torch.float32, device=dev)
    m = torch.empty(B, n_splits, H, **f32)
    l = torch.empty(B, n_splits, H, **f32)
    acc = torch.empty(B, n_splits, dv, H, **f32)
    etap_paged_partial.launches += 1
    build.check(lib.etap_paged_partial(
        ptr(q), ptr(pool), table.data_ptr(), lengths.data_ptr(),
        m.data_ptr(), l.data_ptr(), acc.data_ptr(), B, H, nb, n_splits,
        float(scale), amla_flag(rescale), stream(dev)), "etap_paged_partial")
    return m, l, acc


def _prefill(q, kv_pool, dv, table, start, qpos, *, scale, rescale, what):
    dev = device_of(q, kv_pool, table, start, qpos)
    if dev.type == "cpu":
        return etap_prefill_mla_paged_plain(q, kv_pool, dv, table, start,
                                            scale=scale, rescale=rescale,
                                            qpos=qpos)
    refuse_grad(q, kv_pool, what=what)
    lib = _check_cuda(q, kv_pool, dv, what=what)
    B, Cq, H, Dk = q.shape
    C = Cq * H
    q = q.reshape(B, C, Dk).contiguous()
    pool, table, start = kv_pool.contiguous(), i32(table), i32(start)
    cols = _chunk_horizon(start, qpos, Cq, H, dev).contiguous() \
        if qpos is not None else None
    out = torch.empty(B, C, dv, dtype=kv_pool.dtype, device=dev)
    etap_prefill_mla_paged.launches += 1
    if qpos is not None:
        etap_verify_mla_paged.launches += 1
    build.check(lib.etap_prefill_mla_paged(
        ptr(q), ptr(pool), table.data_ptr(), start.data_ptr(),
        cols.data_ptr() if cols is not None else None, ptr(out),
        B, C, H, table.shape[1], float(scale), amla_flag(rescale), stream(dev)),
        what)
    return out.reshape(B, Cq, H, dv)


def etap_prefill_mla_paged(q, kv_pool, dv, table, start, *, scale,
                           rescale=None):
    """K4: chunked paged MLA-fused prefill. q [B,Cq,H,Dk]; start [B] tokens
    in the pool before the chunk (the chunk's own rows already appended).
    Causal: row c attends to positions <= start + c.  Returns
    [B,Cq,H,dv]."""
    return _prefill(q, kv_pool, dv, table, start, None, scale=scale,
                    rescale=rescale, what="etap_prefill_mla_paged")


def etap_verify_mla_paged(q, kv_pool, dv, table, start, qpos, *, scale,
                          rescale=None):
    """K4 with an explicit per-row horizon: row c attends to positions
    <= qpos[b, c].  A linear qpos (start + arange(Cq)) is bitwise
    :func:`etap_prefill_mla_paged`.  Counts as a K4 launch and as a verify
    launch."""
    return _prefill(q, kv_pool, dv, table, start, qpos, scale=scale,
                    rescale=rescale, what="etap_verify_mla_paged")


def _check_quant(q, kv_pool, kv_sz, dv, *, what):
    """The quantized bodies take bf16 or fp32 q, an int8 or e4m3 code pool
    at the fp kernels' widths and page, and its fp32 (scale, zp) pool.
    Returns (library, code type 0 int8 / 1 e4m3, q is fp32)."""
    lib = build.library()
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(
            f"{what}: the CUDA kernel takes bf16 or fp32 q, got {q.dtype}")
    code = {torch.int8: 0, torch.float8_e4m3fn: 1}.get(kv_pool.dtype)
    if code is None:
        raise NotImplementedError(
            f"{what}: the CUDA kernel takes an int8 or float8_e4m3fn code "
            f"pool, got {kv_pool.dtype}")
    want = (lib.etap_dk(), lib.etap_dv(), lib.etap_page())
    got = (q.shape[-1], dv, kv_pool.shape[1])
    if got != want or kv_pool.shape[-1] != want[0]:
        raise NotImplementedError(
            f"{what}: the CUDA kernel takes (Dk, Dv, page) = {want}, got "
            f"({q.shape[-1]}/{kv_pool.shape[-1]}, {dv}, {kv_pool.shape[1]})")
    if kv_sz.dtype != torch.float32 or \
            tuple(kv_sz.shape) != (*kv_pool.shape[:2], 2):
        raise NotImplementedError(
            f"{what}: kv_sz must be fp32 [N, page, 2] beside the code pool, "
            f"got {kv_sz.dtype} {tuple(kv_sz.shape)}")
    return lib, code, int(q.dtype == torch.float32)


def etap_decode_mla_paged_quant(q, kv_pool, kv_sz, dv, table, lengths, *,
                                scale, rescale=None):
    """K3q: single-pass paged decode over an int8 / fp8 code pool
    [N,page,Dk] and its per-row (scale, zp) pool kv_sz [N,page,2].  q
    [B,H,Dk] bf16 or fp32.  Returns [B,H,dv] in q's dtype."""
    dev = device_of(q, kv_pool, kv_sz, table, lengths)
    if dev.type == "cpu":
        return etap_decode_mla_paged_quant_plain(
            q, kv_pool, kv_sz, dv, table, lengths, scale=scale,
            rescale=rescale)
    refuse_grad(q, kv_pool, kv_sz, what="etap_decode_mla_paged_quant")
    lib, code, qf32 = _check_quant(q, kv_pool, kv_sz, dv,
                                   what="etap_decode_mla_paged_quant")
    B, H, _ = q.shape
    q, pool, sz, table, lengths = (q.contiguous(), kv_pool.contiguous(),
                                   kv_sz.contiguous(), i32(table),
                                   i32(lengths))
    out = torch.empty(B, H, dv, dtype=q.dtype, device=dev)
    etap_decode_mla_paged_quant.launches += 1
    build.check(lib.etap_decode_mla_paged_quant(
        ptr(q), ptr(pool), ptr(sz), table.data_ptr(), lengths.data_ptr(),
        ptr(out), B, H, table.shape[1], float(scale), amla_flag(rescale),
        code, qf32, stream(dev)), "etap_decode_mla_paged_quant")
    return out


def etap_paged_partial_quant(q, kv_pool, kv_sz, dv, table, lengths, *,
                             scale, n_splits, rescale=None):
    """K1q: split-KV phase 1 over a quantized pool (table width a multiple
    of ``n_splits``).  Returns fp32 (m [B,n,H], l [B,n,H],
    accT [B,n,dv,H])."""
    dev = device_of(q, kv_pool, kv_sz, table, lengths)
    if dev.type == "cpu":
        return etap_paged_partial_quant_plain(
            q, kv_pool, kv_sz, dv, table, lengths, scale=scale,
            n_splits=n_splits, rescale=rescale)
    refuse_grad(q, kv_pool, kv_sz, what="etap_paged_partial_quant")
    lib, code, qf32 = _check_quant(q, kv_pool, kv_sz, dv,
                                   what="etap_paged_partial_quant")
    B, H, _ = q.shape
    nb = table.shape[1]
    if nb % n_splits:
        raise ValueError(f"table width {nb} not a multiple of {n_splits}")
    q, pool, sz, table, lengths = (q.contiguous(), kv_pool.contiguous(),
                                   kv_sz.contiguous(), i32(table),
                                   i32(lengths))
    f32 = dict(dtype=torch.float32, device=dev)
    m = torch.empty(B, n_splits, H, **f32)
    l = torch.empty(B, n_splits, H, **f32)
    acc = torch.empty(B, n_splits, dv, H, **f32)
    etap_paged_partial_quant.launches += 1
    build.check(lib.etap_paged_partial_quant(
        ptr(q), ptr(pool), ptr(sz), table.data_ptr(), lengths.data_ptr(),
        m.data_ptr(), l.data_ptr(), acc.data_ptr(), B, H, nb, n_splits,
        float(scale), amla_flag(rescale), code, qf32, stream(dev)),
        "etap_paged_partial_quant")
    return m, l, acc


def _prefill_quant(q, kv_pool, kv_sz, dv, table, start, qpos, *, scale,
                   rescale, what):
    dev = device_of(q, kv_pool, kv_sz, table, start, qpos)
    if dev.type == "cpu":
        return etap_prefill_mla_paged_quant_plain(
            q, kv_pool, kv_sz, dv, table, start, scale=scale,
            rescale=rescale, qpos=qpos)
    refuse_grad(q, kv_pool, kv_sz, what=what)
    lib, code, qf32 = _check_quant(q, kv_pool, kv_sz, dv, what=what)
    B, Cq, H, Dk = q.shape
    C = Cq * H
    q = q.reshape(B, C, Dk).contiguous()
    pool, sz, table, start = (kv_pool.contiguous(), kv_sz.contiguous(),
                              i32(table), i32(start))
    cols = _chunk_horizon(start, qpos, Cq, H, dev).contiguous() \
        if qpos is not None else None
    out = torch.empty(B, C, dv, dtype=q.dtype, device=dev)
    etap_prefill_mla_paged_quant.launches += 1
    if qpos is not None:
        etap_verify_mla_paged_quant.launches += 1
    build.check(lib.etap_prefill_mla_paged_quant(
        ptr(q), ptr(pool), ptr(sz), table.data_ptr(), start.data_ptr(),
        cols.data_ptr() if cols is not None else None, ptr(out),
        B, C, H, table.shape[1], float(scale), amla_flag(rescale), code,
        qf32, stream(dev)), what)
    return out.reshape(B, Cq, H, dv)


def etap_prefill_mla_paged_quant(q, kv_pool, kv_sz, dv, table, start, *,
                                 scale, rescale=None):
    """K4q: chunked paged prefill over a quantized pool.  q [B,Cq,H,Dk]
    bf16 or fp32; start [B].  Returns [B,Cq,H,dv] in q's dtype."""
    return _prefill_quant(q, kv_pool, kv_sz, dv, table, start, None,
                          scale=scale, rescale=rescale,
                          what="etap_prefill_mla_paged_quant")


def etap_verify_mla_paged_quant(q, kv_pool, kv_sz, dv, table, start, qpos, *,
                                scale, rescale=None):
    """K4q with an explicit per-row horizon qpos [B,Cq]; a linear qpos is
    bitwise :func:`etap_prefill_mla_paged_quant`.  Counts as a K4q launch
    and as a verify launch."""
    return _prefill_quant(q, kv_pool, kv_sz, dv, table, start, qpos,
                          scale=scale, rescale=rescale,
                          what="etap_verify_mla_paged_quant")


def _check_pools(k_pool, v_pool, k_sz=None, v_sz=None, *, what):
    """Separate K and V pools on any device: V's pool [N, page, Dv] shares
    K's blocks and page (one table reads both), and code pools come with
    both (scale, zp) pools."""
    if v_pool.dim() != 3 or tuple(v_pool.shape[:2]) != \
            tuple(k_pool.shape[:2]):
        raise ValueError(f"{what}: v_pool {tuple(v_pool.shape)} must have "
                         f"k_pool's blocks and page {tuple(k_pool.shape[:2])}")
    if (k_sz is None) != (v_sz is None):
        raise ValueError(f"{what}: k_sz and v_sz come together")


def _sepv_operands(q, k_pool, v_pool, k_sz, v_sz, table, *, what):
    """Check separate-V pools for the CUDA kernels and return the library,
    the leading pointers (q, k[, k_sz], v[, v_sz], table), the trailing
    (code type, q is fp32) of the quantized entries, and the tensors the
    launch must keep alive.  The kernels take bf16 pools, or int8 / e4m3
    code pools with fp32 (scale, zp) pools [N, page, 2] and bf16 or fp32
    q, at a (Dk, Dv) of the library's ``etap_paged_sepv_widths``
    (``csrc/mma_tile.cuh:PagedSepWidths``) and page 64."""
    lib = build.library()
    widths = dense_widths(lib, "etap_paged_sepv_widths")
    got = (q.shape[-1], v_pool.shape[-1])
    if got not in widths or k_pool.shape[-1] != got[0]:
        raise NotImplementedError(
            f"{what}: the CUDA kernels over separate pools are built at "
            f"(Dk, Dv) in {sorted(widths)} (csrc/mma_tile.cuh: "
            f"PagedSepWidths), got ({q.shape[-1]}/{k_pool.shape[-1]}, "
            f"{got[1]})")
    check_widths(q, k_pool, got[1], widths, what=what)
    if v_pool.dtype != k_pool.dtype:
        raise NotImplementedError(
            f"{what}: the CUDA kernel takes V's pool in K's type "
            f"({k_pool.dtype}), got {v_pool.dtype}")
    if k_pool.shape[1] != lib.etap_page():
        raise NotImplementedError(
            f"{what}: the CUDA kernel takes page {lib.etap_page()}, got "
            f"{k_pool.shape[1]}")
    quant = k_pool.dtype in CODES
    if quant != (k_sz is not None):
        raise NotImplementedError(
            f"{what}: (scale, zp) pools go with int8 / float8_e4m3fn code "
            f"pools, and only with them (got {k_pool.dtype})")
    q, table = q.contiguous(), i32(table)
    k_pool, v_pool = k_pool.contiguous(), v_pool.contiguous()
    ptrs = [ptr(q), ptr(k_pool)]
    keep = [q, table, k_pool, v_pool]
    tail = []
    if quant:
        for name, sz in (("k_sz", k_sz), ("v_sz", v_sz)):
            if sz.dtype != torch.float32 or \
                    tuple(sz.shape) != (*k_pool.shape[:2], 2):
                raise NotImplementedError(
                    f"{what}: {name} must be fp32 {(*k_pool.shape[:2], 2)} "
                    f"beside its code pool, got {sz.dtype} "
                    f"{tuple(sz.shape)}")
        k_sz, v_sz = k_sz.contiguous(), v_sz.contiguous()
        keep += [k_sz, v_sz]
        ptrs += [ptr(k_sz), ptr(v_pool), ptr(v_sz)]
        tail = [CODES[k_pool.dtype], int(q.dtype == torch.float32)]
    else:
        ptrs.append(ptr(v_pool))
    return lib, ptrs + [table.data_ptr()], tail, keep


def _decode_sepv(wrapper, fn, q, k_pool, v_pool, k_sz, v_sz, table, lengths,
                 *, scale, rescale, n_splits=None):
    """Launch the separate-V decode kernel ``fn`` (K3 / K3q, or with
    ``n_splits`` K1 / K1q), counting it on ``wrapper.launches``."""
    refuse_grad(q, k_pool, v_pool, k_sz, v_sz, what=fn)
    lib, ptrs, tail, keep = _sepv_operands(q, k_pool, v_pool, k_sz, v_sz,
                                           table, what=fn)
    B, H, dk = q.shape
    dv, nb, dev = v_pool.shape[-1], table.shape[1], q.device
    lengths = i32(lengths)
    if n_splits is None:
        out = torch.empty(B, H, dv, device=dev,
                          dtype=_out_dtype(q, k_pool, k_sz, v_pool))
        res, outs, shape = out, [ptr(out)], [B, H, nb]
    else:
        if nb % n_splits:
            raise ValueError(f"table width {nb} not a multiple of "
                             f"{n_splits}")
        f32 = dict(dtype=torch.float32, device=dev)
        res = (torch.empty(B, n_splits, H, **f32),
               torch.empty(B, n_splits, H, **f32),
               torch.empty(B, n_splits, dv, H, **f32))
        outs, shape = [x.data_ptr() for x in res], [B, H, nb, n_splits]
    wrapper.launches += 1
    build.check(getattr(lib, fn)(
        *ptrs, lengths.data_ptr(), *outs, *shape, dk, dv, float(scale),
        amla_flag(rescale), *tail, stream(dev)), fn)
    del keep
    return res


def _prefill_sepv(wrapper, fn, q, k_pool, v_pool, k_sz, v_sz, table, start,
                  qpos, *, scale, rescale, what):
    """Launch the separate-V chunk kernel ``fn`` (K4 / K4q: prefill, or
    verify with ``qpos``), counting it on ``wrapper.launches``."""
    refuse_grad(q, k_pool, v_pool, k_sz, v_sz, what=what)
    B, Cq, H, Dk = q.shape
    C, dv, dev = Cq * H, v_pool.shape[-1], q.device
    lib, ptrs, tail, keep = _sepv_operands(q.reshape(B, C, Dk), k_pool,
                                           v_pool, k_sz, v_sz, table,
                                           what=what)
    start = i32(start)
    cols = _chunk_horizon(start, qpos, Cq, H, dev).contiguous() \
        if qpos is not None else None
    out = torch.empty(B, C, dv, dtype=_out_dtype(q, k_pool, k_sz, v_pool),
                      device=dev)
    wrapper.launches += 1
    build.check(getattr(lib, fn)(
        *ptrs, start.data_ptr(), cols.data_ptr() if cols is not None else None,
        ptr(out), B, C, H, table.shape[1], Dk, dv, float(scale),
        amla_flag(rescale), *tail, stream(dev)), what)
    del keep
    return out.reshape(B, Cq, H, dv)


def etap_decode_paged(q, k_pool, v_pool, table, lengths, *, scale,
                      rescale=None):
    """K3 over separate pools: single-pass paged ETAP decode. q [B,H,Dk];
    k_pool [N,page,Dk] and v_pool [N,page,Dv] read through one table
    [B,nb] (null block 0 in padded entries); lengths [B].  Returns
    [B,H,Dv] in v_pool's dtype."""
    _check_pools(k_pool, v_pool, what="etap_decode_paged")
    if device_of(q, k_pool, v_pool, table, lengths).type == "cpu":
        return etap_decode_paged_plain(q, k_pool, v_pool, table, lengths,
                                       scale=scale, rescale=rescale)
    return _decode_sepv(etap_decode_paged, "etap_decode_paged", q, k_pool,
                        v_pool, None, None, table, lengths, scale=scale,
                        rescale=rescale)


def etap_paged_partial_sepv(q, k_pool, v_pool, table, lengths, *, scale,
                            n_splits, rescale=None):
    """K1 over separate pools: split-KV phase 1 (table width a multiple of
    ``n_splits``).  Returns fp32 (m [B,n,H], l [B,n,H], accT
    [B,n,Dv,H])."""
    _check_pools(k_pool, v_pool, what="etap_paged_partial_sepv")
    if device_of(q, k_pool, v_pool, table, lengths).type == "cpu":
        return etap_paged_partial_sepv_plain(
            q, k_pool, v_pool, table, lengths, scale=scale,
            n_splits=n_splits, rescale=rescale)
    return _decode_sepv(etap_paged_partial_sepv, "etap_paged_partial_sepv",
                        q, k_pool, v_pool, None, None, table, lengths,
                        scale=scale, rescale=rescale, n_splits=n_splits)


def _prefill_paged(q, k_pool, v_pool, table, start, qpos, *, scale, rescale,
                   what):
    _check_pools(k_pool, v_pool, what=what)
    if device_of(q, k_pool, v_pool, table, start, qpos).type == "cpu":
        return etap_prefill_paged_plain(q, k_pool, v_pool, table, start,
                                        scale=scale, rescale=rescale,
                                        qpos=qpos)
    return _prefill_sepv(etap_prefill_paged, "etap_prefill_paged", q, k_pool,
                         v_pool, None, None, table, start, qpos, scale=scale,
                         rescale=rescale, what=what)


def etap_prefill_paged(q, k_pool, v_pool, table, start, *, scale,
                       rescale=None):
    """K4 over separate pools: chunked paged prefill. q [B,Cq,H,Dk]; start
    [B] tokens before the chunk (its rows already appended); row c attends
    to positions <= start + c.  Returns [B,Cq,H,Dv]."""
    return _prefill_paged(q, k_pool, v_pool, table, start, None, scale=scale,
                          rescale=rescale, what="etap_prefill_paged")


def etap_verify_paged(q, k_pool, v_pool, table, start, qpos, *, scale,
                      rescale=None):
    """K4 over separate pools with the explicit per-row horizon qpos
    [B,Cq]; a linear qpos is bitwise :func:`etap_prefill_paged`.  Counts
    as a K4 launch."""
    return _prefill_paged(q, k_pool, v_pool, table, start, qpos, scale=scale,
                          rescale=rescale, what="etap_verify_paged")


def etap_decode_paged_quant(q, k_pool, k_sz, v_pool, v_sz, table, lengths, *,
                            scale, rescale=None):
    """K3q over separate int8 / fp8 code pools [N,page,Dk], [N,page,Dv],
    each with its own (scale, zp) pool k_sz, v_sz [N,page,2].  q [B,H,Dk]
    bf16 or fp32.  Returns [B,H,Dv] in q's dtype."""
    _check_pools(k_pool, v_pool, k_sz, v_sz, what="etap_decode_paged_quant")
    if device_of(q, k_pool, k_sz, v_pool, v_sz, table,
                 lengths).type == "cpu":
        return etap_decode_paged_quant_plain(
            q, k_pool, k_sz, v_pool, v_sz, table, lengths, scale=scale,
            rescale=rescale)
    return _decode_sepv(etap_decode_paged_quant, "etap_decode_paged_quant",
                        q, k_pool, v_pool, k_sz, v_sz, table, lengths,
                        scale=scale, rescale=rescale)


def etap_paged_partial_sepv_quant(q, k_pool, k_sz, v_pool, v_sz, table,
                                  lengths, *, scale, n_splits, rescale=None):
    """K1q over separate code pools (table width a multiple of
    ``n_splits``).  Returns fp32 (m [B,n,H], l [B,n,H], accT
    [B,n,Dv,H])."""
    _check_pools(k_pool, v_pool, k_sz, v_sz,
                what="etap_paged_partial_sepv_quant")
    if device_of(q, k_pool, k_sz, v_pool, v_sz, table,
                 lengths).type == "cpu":
        return etap_paged_partial_sepv_quant_plain(
            q, k_pool, k_sz, v_pool, v_sz, table, lengths, scale=scale,
            n_splits=n_splits, rescale=rescale)
    return _decode_sepv(etap_paged_partial_sepv_quant,
                        "etap_paged_partial_sepv_quant", q, k_pool, v_pool,
                        k_sz, v_sz, table, lengths, scale=scale,
                        rescale=rescale, n_splits=n_splits)


def _prefill_paged_quant(q, k_pool, k_sz, v_pool, v_sz, table, start, qpos,
                         *, scale, rescale, what):
    _check_pools(k_pool, v_pool, k_sz, v_sz, what=what)
    if device_of(q, k_pool, k_sz, v_pool, v_sz, table, start,
                 qpos).type == "cpu":
        return etap_prefill_paged_quant_plain(
            q, k_pool, k_sz, v_pool, v_sz, table, start, scale=scale,
            rescale=rescale, qpos=qpos)
    return _prefill_sepv(etap_prefill_paged_quant, "etap_prefill_paged_quant",
                         q, k_pool, v_pool, k_sz, v_sz, table, start, qpos,
                         scale=scale, rescale=rescale, what=what)


def etap_prefill_paged_quant(q, k_pool, k_sz, v_pool, v_sz, table, start, *,
                             scale, rescale=None):
    """K4q over separate code pools: chunked paged prefill.  q
    [B,Cq,H,Dk] bf16 or fp32.  Returns [B,Cq,H,Dv] in q's dtype."""
    return _prefill_paged_quant(q, k_pool, k_sz, v_pool, v_sz, table, start,
                                None, scale=scale, rescale=rescale,
                                what="etap_prefill_paged_quant")


def etap_verify_paged_quant(q, k_pool, k_sz, v_pool, v_sz, table, start,
                            qpos, *, scale, rescale=None):
    """K4q over separate code pools with the explicit horizon qpos [B,Cq];
    a linear qpos is bitwise :func:`etap_prefill_paged_quant`.  Counts as
    a K4q launch."""
    return _prefill_paged_quant(q, k_pool, k_sz, v_pool, v_sz, table, start,
                                qpos, scale=scale, rescale=rescale,
                                what="etap_verify_paged_quant")


def etap_decode_dense(q, k, v, length, *, scale, block=512, rescale=None):
    """K5: single-pass dense ETAP decode. q [BG,H,Dk]; k [BG,S,Dk];
    v [BG,S,Dv] (``k[..., :Dv]`` for the MLA latent: read in place), or a
    GQA cache k, v [B,S,K,hd] read in place as its grouped form (BG = B·K);
    length [BG].  ``block`` is the reference's padding unit, which the
    plain version walks; the kernel walks 64-row tiles and reads rows past
    S as zero, so no padded copy is made.  Returns [BG,H,Dv] in v's
    dtype."""
    if device_of(q, k, v, length).type == "cpu":
        return etap_decode_dense_plain(q, k, v, length, scale=scale,
                                       block=block, rescale=rescale)
    return dense_single(etap_decode_dense, "etap_decode_dense",
                        "etap_dense_widths", q, k, v, length, scale=scale,
                        rescale=rescale)


def etap_decode_mla_dense(q, kv, dv, length, *, scale, block=512,
                          rescale=None):
    """K5, MLA-fused: one latent stream kv [BG,S,Dk], V = kv[..., :dv]
    (the reference's ``etap_decode_mla_pallas``).  Counts as a K5
    launch."""
    return etap_decode_dense(q, kv, kv[..., :dv], length, scale=scale,
                             block=block, rescale=rescale)


def etap_partial_dense(q, k, v, length, *, scale, plan, rescale=None):
    """K6: dense split-KV phase 1 under ``plan`` (a
    :class:`repro_torch.kernels.etap.schedule.SplitPlan`, as
    :func:`repro_torch.kernels.splitkv.split_plan` works it out).  Split s
    covers rows [s·npb·block, (s+1)·npb·block) of the cache padded to
    ``plan.padded_s`` rows; rows past S read as zero, no copy.  k, v as
    :func:`etap_decode_dense` takes them.  Returns fp32 (m [BG,n,H],
    l [BG,n,H], accT [BG,n,Dv,H])."""
    if device_of(q, k, v, length).type == "cpu":
        return etap_partial_dense_plain(q, k, v, length, scale=scale,
                                        plan=plan, rescale=rescale)
    return dense_partial(etap_partial_dense, "etap_partial_dense",
                         "etap_dense_widths", q, k, v, length, plan=plan,
                         transposed=True, scale=scale, rescale=rescale)


def etap_decode_dense_quant(q, k, v, length, *, k_sz, v_sz, scale,
                            block=512, rescale=None):
    """K5q: single-pass dense ETAP decode over int8 / fp8 code rows.  q
    [BG,H,Dk] bf16 or fp32; k, v code rows as :func:`etap_decode_dense`
    takes them (a GQA cache [B,S,K,hd] read in place) and k_sz, v_sz their
    fp32 (scale, zp) rows [..., 2], read in place too.  Returns [BG,H,Dv]
    fp32."""
    if device_of(q, k, v, length, k_sz, v_sz).type == "cpu":
        return etap_decode_dense_quant_plain(q, k, v, length, k_sz=k_sz,
                                             v_sz=v_sz, scale=scale,
                                             block=block, rescale=rescale)
    return dense_single(etap_decode_dense_quant, "etap_decode_dense_quant",
                        "etap_dense_quant_widths", q, k, v, length,
                        scale=scale, rescale=rescale, k_sz=k_sz, v_sz=v_sz)


def etap_partial_dense_quant(q, k, v, length, *, k_sz, v_sz, scale, plan,
                             rescale=None):
    """K6q: dense split-KV phase 1 over code rows under ``plan``, as
    :func:`etap_partial_dense`.  Returns fp32 (m [BG,n,H], l [BG,n,H],
    accT [BG,n,Dv,H])."""
    if device_of(q, k, v, length, k_sz, v_sz).type == "cpu":
        return etap_partial_dense_quant_plain(q, k, v, length, k_sz=k_sz,
                                              v_sz=v_sz, scale=scale,
                                              plan=plan, rescale=rescale)
    return dense_partial(etap_partial_dense_quant, "etap_partial_dense_quant",
                         "etap_dense_quant_widths", q, k, v, length,
                         plan=plan, transposed=True, scale=scale,
                         rescale=rescale, k_sz=k_sz, v_sz=v_sz)


etap_decode_mla_paged.launches = 0
etap_paged_partial.launches = 0
etap_prefill_mla_paged.launches = 0
etap_verify_mla_paged.launches = 0
etap_decode_dense.launches = 0
etap_partial_dense.launches = 0
etap_decode_mla_paged_quant.launches = 0
etap_paged_partial_quant.launches = 0
etap_prefill_mla_paged_quant.launches = 0
etap_verify_mla_paged_quant.launches = 0
etap_decode_dense_quant.launches = 0
etap_partial_dense_quant.launches = 0
etap_decode_paged.launches = 0
etap_paged_partial_sepv.launches = 0
etap_prefill_paged.launches = 0
etap_decode_paged_quant.launches = 0
etap_paged_partial_sepv_quant.launches = 0
etap_prefill_paged_quant.launches = 0
