"""Public wrappers for the ETAP kernels — the port of
``repro/kernels/etap/ops.py``: default lengths, the split-KV scheduling and
the two-phase split path over the dense cache, and table padding over the
paged pools (the MLA-fused latent pool, or separate K and V pools).  Every
entry takes one :class:`repro_torch.core.attn_spec.AttnSpec` and goes
through :func:`repro_torch.core.attn_spec.attn_entry`, the kernel profiler's
choke point.  The kernels are called through the ``etap`` and ``combine``
modules' attributes, never bound here.

The reference pads a dense cache to its block and split multiples here
(``_pad_seq``); in the port the kernel wrappers take the unpadded cache and
the split plan (:mod:`repro_torch.kernels.splitkv`) and pad the same
geometry themselves — the plain versions with zeros, the CUDA kernels by
reading rows past S as zero — so serving never copies the cache."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.core.attn_spec import attn_entry
from repro_torch.kernels import splitkv
from repro_torch.kernels.etap import combine as combine_mod
from repro_torch.kernels.etap import etap as K
from repro_torch.kernels.etap.schedule import (dense_split_plan, num_cores,
                                               paged_split_geometry,
                                               plan_splits_paged)


# ------------------------------------------------------------------- dense
@attn_entry(uses=("block", "rescale"))
def etap_decode(q, k, v, length=None, *, spec):
    """ETAP decode attention (K5). q [BG,H,Dk]; k [BG,S,Dk]; v [BG,S,Dv];
    length [BG] valid-prefix lengths (None = all S).  Returns [BG,H,Dv]."""
    if length is None:
        length = splitkv.full_length(q, k.shape[1])
    return K.etap_decode_dense(q, k, v, length, scale=spec.scale,
                               block=spec.block, rescale=spec.rescale)


@attn_entry(uses=("block", "kv_splits", "rescale"))
def etap_partial(q, k, v, length=None, *, spec):
    """Phase-1 split-KV stats (m, l, accT): [BG,n,H], [BG,n,H],
    [BG,n,Dv,H] fp32, n the effective count of spec.kv_splits (None -> 2)."""
    if length is None:
        length = splitkv.full_length(q, k.shape[1])
    n_splits = 2 if spec.kv_splits is None else int(spec.kv_splits)
    return K.etap_partial_dense(
        q, k, v, length, scale=spec.scale, rescale=spec.rescale,
        plan=dense_split_plan(k.shape[1], spec.block, n_splits))


@attn_entry(uses=("block", "kv_splits", "rescale"))
def etap_decode_splitkv(q, k, v, length=None, *, spec, k_sz=None,
                        v_sz=None):
    """Two-phase split-KV ETAP decode over the dense cache.  spec.kv_splits
    None/0 → auto (the scheduler, sized to the device); 1 → the
    single-pass kernel K5; else K6 + the transposed combine K2.  ``k_sz`` /
    ``v_sz``: the (scale, zp) rows of int8 / fp8 code rows k, v — K5q /
    K6q run and the output is fp32."""
    quant = k_sz is not None
    return splitkv.decode_splitkv(
        q, k, v, length, spec=spec,
        single=K.etap_decode_dense_quant if quant else K.etap_decode_dense,
        partial=K.etap_partial_dense_quant if quant
        else K.etap_partial_dense,
        combine=combine_mod.combine_splits, k_sz=k_sz, v_sz=v_sz)


# ------------------------------------------------------------------- paged
def _pad_table(table, multiple: int):
    """Pad the block table to a column multiple with null blocks (id 0);
    padded entries are masked via ``lengths``."""
    pad = (-table.shape[1]) % multiple
    if pad:
        table = F.pad(table, (0, pad))
    return table


def _paged_partial(q, kv_pool, dv, table, lengths, *, scale, n_splits,
                   rescale, kv_sz=None, v_pool=None, v_sz=None):
    """Phase 1 over the table padded to the split geometry: the MLA-fused
    K1 / K1q (``v_pool`` None: V the first ``dv`` pool columns) or K1 /
    K1q over a separate V pool (with its ``v_sz`` over codes)."""
    n_splits, _, padded_nb = paged_split_geometry(table.shape[1], n_splits)
    table = _pad_table(table, padded_nb)
    kw = dict(scale=scale, n_splits=n_splits, rescale=rescale)
    if v_pool is not None:
        if kv_sz is not None:
            return K.etap_paged_partial_sepv_quant(q, kv_pool, kv_sz, v_pool,
                                                   v_sz, table, lengths, **kw)
        return K.etap_paged_partial_sepv(q, kv_pool, v_pool, table, lengths,
                                         **kw)
    if kv_sz is not None:
        return K.etap_paged_partial_quant(q, kv_pool, kv_sz, dv, table,
                                          lengths, **kw)
    return K.etap_paged_partial(q, kv_pool, dv, table, lengths, **kw)


def _paged_n_splits(q, table, page: int, dv: int, spec) -> int:
    """The effective split count of a paged decode: spec.kv_splits, or
    None/0 → the paged scheduler sized to q's device; more splits than
    table columns degrade to the effective count."""
    B, H, _ = q.shape
    n_splits = int(spec.kv_splits or 0)
    if not n_splits:
        n_splits = plan_splits_paged(B, table.shape[1], page, H, dv,
                                     num_cores=num_cores(q.device)).n_splits
    return paged_split_geometry(table.shape[1], n_splits)[0]


@attn_entry(uses=("kv_splits", "rescale"))
def etap_decode_mla_paged_splitkv(q, kv_pool, dv: int, table, lengths, *,
                                  spec, kv_sz=None):
    """Two-phase split-KV decode over a paged MLA latent pool (V = the first
    ``dv`` pool columns).  spec.kv_splits None/0 → auto (the paged scheduler,
    sized to the device); 1 → the single-pass kernel K3.  Requests for more
    splits than table columns degrade to the effective count.  ``kv_sz``:
    the (scale, zp) pool of an int8 / fp8 code pool — the quantized bodies
    K3q / K1q run, the split count is planned as for fp, and the output
    takes q's dtype."""
    n_splits = _paged_n_splits(q, table, kv_pool.shape[1], dv, spec)
    kw = dict(scale=spec.scale, rescale=spec.rescale)
    if n_splits <= 1:
        if kv_sz is not None:
            return K.etap_decode_mla_paged_quant(q, kv_pool, kv_sz, dv, table,
                                                 lengths, **kw)
        return K.etap_decode_mla_paged(q, kv_pool, dv, table, lengths, **kw)
    m, l, accT = _paged_partial(q, kv_pool, dv, table, lengths,
                                n_splits=n_splits, kv_sz=kv_sz, **kw)
    out_dtype = q.dtype if kv_sz is not None else kv_pool.dtype
    return combine_mod.combine_splits(m, l, accT, out_dtype=out_dtype,
                                      rescale=spec.rescale)


@attn_entry(uses=("rescale",))
def etap_prefill_mla_paged(q, kv_pool, dv: int, table, start, *, spec,
                           kv_sz=None):
    """Chunked paged MLA-fused prefill (K4, or K4q over a quantized pool
    with its ``kv_sz``). q [B,Cq,H,Dk]; start [B]."""
    kw = dict(scale=spec.scale, rescale=spec.rescale)
    if kv_sz is not None:
        return K.etap_prefill_mla_paged_quant(q, kv_pool, kv_sz, dv, table,
                                              start, **kw)
    return K.etap_prefill_mla_paged(q, kv_pool, dv, table, start, **kw)


@attn_entry(uses=("rescale",))
def etap_verify_mla_paged(q, kv_pool, dv: int, table, start, qpos, *, spec,
                          kv_sz=None):
    """Paged MLA-fused draft verify (K4 / K4q with explicit qpos [B,Cq])."""
    kw = dict(scale=spec.scale, rescale=spec.rescale)
    if kv_sz is not None:
        return K.etap_verify_mla_paged_quant(q, kv_pool, kv_sz, dv, table,
                                             start, qpos, **kw)
    return K.etap_verify_mla_paged(q, kv_pool, dv, table, start, qpos, **kw)


# ------------------------------------------------- paged, separate V pool
@attn_entry(uses=("rescale",))
def etap_decode_paged(q, k_pool, v_pool, table, lengths, *, spec, k_sz=None,
                      v_sz=None):
    """Paged ETAP decode over separate pools (K3, or K3q over code pools
    with their (scale, zp) pools ``k_sz`` / ``v_sz``). q [B,H,Dk]; pools
    [N,page,D*]; table [B,max_blocks]; lengths [B].  Returns [B,H,Dv]:
    v_pool's dtype, q's over codes.  Bitwise the dense kernel at block ==
    page on the same rows."""
    kw = dict(scale=spec.scale, rescale=spec.rescale)
    if k_sz is not None:
        return K.etap_decode_paged_quant(q, k_pool, k_sz, v_pool, v_sz, table,
                                         lengths, **kw)
    return K.etap_decode_paged(q, k_pool, v_pool, table, lengths, **kw)


@attn_entry(uses=("rescale",))
def etap_prefill_paged(q, k_pool, v_pool, table, start, *, spec, k_sz=None,
                       v_sz=None):
    """Chunked paged prefill over separate pools (K4, or K4q over code
    pools). q [B,Cq,H,Dk]; start [B] tokens before the chunk, whose rows
    are already appended.  Returns [B,Cq,H,Dv]."""
    kw = dict(scale=spec.scale, rescale=spec.rescale)
    if k_sz is not None:
        return K.etap_prefill_paged_quant(q, k_pool, k_sz, v_pool, v_sz,
                                          table, start, **kw)
    return K.etap_prefill_paged(q, k_pool, v_pool, table, start, **kw)


@attn_entry(uses=("rescale",))
def etap_verify_paged(q, k_pool, v_pool, table, start, qpos, *, spec,
                      k_sz=None, v_sz=None):
    """Draft verify over separate pools: K4 / K4q with the explicit
    per-row horizon qpos [B,Cq]."""
    kw = dict(scale=spec.scale, rescale=spec.rescale)
    if k_sz is not None:
        return K.etap_verify_paged_quant(q, k_pool, k_sz, v_pool, v_sz, table,
                                         start, qpos, **kw)
    return K.etap_verify_paged(q, k_pool, v_pool, table, start, qpos, **kw)


@attn_entry(uses=("kv_splits", "rescale"))
def etap_decode_paged_splitkv(q, k_pool, v_pool, table, lengths, *, spec,
                              k_sz=None, v_sz=None):
    """Two-phase split-KV decode over separate pools: the split count
    planned with ``plan_splits_paged(..., v_pool.shape[2])`` (spec.kv_splits
    None/0 → auto), one split → the single-pass K3 / K3q (bitwise K1 with
    n = 1 + K2), else K1 / K1q over the padded table + K2ᵀ.  Output in
    v_pool's dtype, q's over codes."""
    n_splits = _paged_n_splits(q, table, k_pool.shape[1], v_pool.shape[2],
                               spec)
    if n_splits <= 1:
        return etap_decode_paged(q, k_pool, v_pool, table, lengths,
                                 spec=spec, k_sz=k_sz, v_sz=v_sz)
    m, l, accT = _paged_partial(q, k_pool, v_pool.shape[2], table, lengths,
                                scale=spec.scale, n_splits=n_splits,
                                rescale=spec.rescale, kv_sz=k_sz,
                                v_pool=v_pool, v_sz=v_sz)
    out_dtype = q.dtype if k_sz is not None else v_pool.dtype
    return combine_mod.combine_splits(m, l, accT, out_dtype=out_dtype,
                                      rescale=spec.rescale)
