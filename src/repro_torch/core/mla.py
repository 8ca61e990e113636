"""Multi-head Latent Attention (DeepSeek) — the port of
``repro/core/mla.py``: the naive (decompressed) form for a whole prompt,
and the absorbed-form decode over the dense or paged latent cache, chunked
paged prefill and draft verification.

In the absorbed form the per-head up-projections W_uk / W_uv are folded
into the query and the output, so attention runs over the shared 576-wide
latent cache c = [rmsnorm(c_kv) ; rope(k_r)], one stream serving K and V
(V = its first kv_lora_rank columns).  The attention itself is the decode
kernels' (ETAP, or the untransposed baseline); a chunk (prefill, or the k
rows of a draft verification) runs the chunked prefill kernel K4 (K4q over
code pools).

Under tensor parallelism a rank's W_uq, W_uk, W_uv hold its heads'
columns and W_o their rows: every function reads the head count from
the pieces (:func:`local_heads`); W_dq's and W_dkv's column pieces have
their outputs gathered, so the latent cache is whole on every rank.
"""
from __future__ import annotations

import torch

from repro_torch.core.attn_spec import AttnSpec
from repro_torch.core.etap import (decode_attention, decode_attention_paged,
                                   prefill_attention_paged,
                                   seq_sharded_decode, verify_attention_paged)
from repro_torch.launch.mesh import get_mesh
from repro_torch.models import layers
from repro_torch.models.attention import causal_attention
from repro_torch.runtime import paged_cache
from repro_torch.sharding.rules import seq_sharded


def init_mla(gen, cfg, dtype, device):
    m = cfg.mla
    D, H = cfg.d_model, cfg.num_heads
    leaf = layers.leaf

    def dense(name, i, o):
        return leaf(name, layers.init_dense(gen, i, o, dtype, device))

    def zeros(name, n):
        return leaf(name, torch.zeros(n, dtype=dtype, device=device))
    return {
        "w_dq": dense("w_dq", D, m.q_lora_rank),
        "q_norm": zeros("q_norm", m.q_lora_rank),
        "w_uq": dense("w_uq", m.q_lora_rank, H * m.qk_head_dim),
        # fused down-projection: [kv_lora | rope] columns
        "w_dkv": dense("w_dkv", D, m.kv_lora_rank + m.qk_rope_head_dim),
        "kv_norm": zeros("kv_norm", m.kv_lora_rank),
        "w_uk": dense("w_uk", m.kv_lora_rank, H * m.qk_nope_head_dim),
        "w_uv": dense("w_uv", m.kv_lora_rank, H * m.v_head_dim),
        "w_o": dense("w_o", H * m.v_head_dim, D),
    }


def local_heads(params, cfg) -> int:
    """The heads this rank's weights hold: all of them, or under tensor
    parallelism its piece's (W_uk's columns over the nope width)."""
    return params["w_uk"].shape[1] // cfg.mla.qk_nope_head_dim


def _own_heads(o, params, cfg):
    """This rank's heads of ``o`` [B, H, ...] over all heads."""
    n = local_heads(params, cfg)
    h0 = layers.model_offset(n, cfg.num_heads)
    return o[:, h0:h0 + n]


def _queries(params, cfg, x, positions):
    """x: [..., D] -> (q_nope [..., H, nope], q_rope [..., H, rope]) for
    this rank's H heads (:func:`local_heads`); a column piece of W_dq has
    its outputs gathered before ``q_norm``."""
    m, H = cfg.mla, local_heads(params, cfg)
    cq = layers.rms_norm(layers.dense_col(x, params["w_dq"], m.q_lora_rank),
                         params["q_norm"], cfg.norm_eps)
    q, = layers.tp_columns(cq, (params["w_uq"],), H != cfg.num_heads)
    q = q.reshape(*x.shape[:-1], H, m.qk_head_dim)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_rope = layers.apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _latent(params, cfg, x, positions):
    """x: [..., D] -> latent cache rows [..., kv_lora+rope], whole on every
    rank (a column piece of W_dkv has its outputs gathered)."""
    m = cfg.mla
    dkv = layers.dense_col(x, params["w_dkv"], m.latent_dim)
    c_kv = layers.rms_norm(dkv[..., :m.kv_lora_rank], params["kv_norm"],
                           cfg.norm_eps)
    k_rope = layers.apply_rope(dkv[..., m.kv_lora_rank:], positions,
                               cfg.rope_theta)
    return torch.cat([c_kv, k_rope], dim=-1)


def mla_train(params, cfg, x, positions, *, return_cache: bool = False):
    """Naive (decompressed) MLA over a whole sequence (the training and
    dense-prefill form).  x: [B,S,D]; positions: [B,S].  Returns out
    [B,S,D], and with ``return_cache`` also the latent cache rows {"c":
    [B,S,latent]}.  Under tensor parallelism attention runs over the
    rank's heads and the row piece of W_o's partial products are summed
    over `model`; the latent, whole on every rank, enters the rank's
    heads' work through ``layers.tp_columns`` and ``layers.tp_input``
    (W_dkv's column pieces mix latent and rope columns, so its product is
    gathered first)."""
    m, H = cfg.mla, local_heads(params, cfg)
    B, S, _ = x.shape
    q_nope, q_rope = _queries(params, cfg, x, positions)
    c = _latent(params, cfg, x, positions)                    # [B,S,latent]
    cut = H != cfg.num_heads
    c_kv, k_rope = c[..., :m.kv_lora_rank], c[..., m.kv_lora_rank:]
    k_nope, v = layers.tp_columns(c_kv, (params["w_uk"], params["w_uv"]),
                                  cut)
    k_nope = k_nope.reshape(B, S, H, m.qk_nope_head_dim)
    v = v.reshape(B, S, H, m.v_head_dim)
    # the shared rope key, expanded to the rank's heads (in fp32 while
    # training, so its gradient is summed over the heads and ranks once)
    k_rope = layers.tp_input(k_rope, cut)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.qk_rope_head_dim).to(c.dtype)], dim=-1)
    o = causal_attention(q, k, v, scale=m.qk_head_dim ** -0.5)
    out = layers.dense_row(o.reshape(B, S, H * m.v_head_dim), params["w_o"],
                           cfg.num_heads * m.v_head_dim)
    if return_cache:
        return out, {"c": c}
    return out


def _absorbed_query(params, cfg, x, positions):
    """q_c[b,h] = q_nope[b,h] · W_uk[:,h] (kv_lora wide), q = [q_c ; q_rope].
    x: [B,D]; positions: [B,1].  Returns q: [B,H,latent] over the rank's
    heads."""
    m, H = cfg.mla, local_heads(params, cfg)
    q_nope, q_rope = _queries(params, cfg, x[:, None, :], positions)
    q_nope, q_rope = q_nope[:, 0], q_rope[:, 0]               # [B,H,*]
    w_uk = params["w_uk"].reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
    q_c = layers.fixed_rows(q_nope.float(), lambda a: torch.einsum(
        "bhd,chd->bhc", a, w_uk.float())).to(x.dtype)
    return torch.cat([q_c, q_rope], dim=-1)


def _absorbed_out(params, cfg, o_lat, dtype):
    """o[b,h] = o_latent[b,h] · W_uvᵀ → W_o. o_lat: [B,H,kv] over the
    rank's heads.  Returns [B,D] (a row piece of W_o summed over
    `model`)."""
    m, H = cfg.mla, local_heads(params, cfg)
    w_uv = params["w_uv"].reshape(m.kv_lora_rank, H, m.v_head_dim)
    o = layers.fixed_rows(o_lat.float(), lambda a: torch.einsum(
        "bhc,chd->bhd", a, w_uv.float())).to(dtype)
    return layers.dense_row(o.reshape(o.shape[0], -1), params["w_o"],
                            cfg.num_heads * m.v_head_dim)


def mla_decode(params, cfg, x, cache, pos: int, *,
               spec: AttnSpec | None = None):
    """Absorbed-form decode over the dense latent cache.

    x: [B,D]; cache: {"c": [B,Smax,latent]}; pos: the new token's position,
    shared by every row.  The new latent row is written at ``pos`` in place;
    attention runs over positions <= pos with K = the whole latent and V =
    its first kv_lora_rank columns (a view: the cache is read in place).
    Under a mesh that sequence-shards the cache (S >= SEQ_SHARD_MIN_S, S a
    multiple of the ``model`` extent), ``cache`` is this rank's slice with
    the whole cache's row count under "seq_rows", and decode runs
    :func:`repro_torch.core.etap.seq_sharded_decode` (the latent has no
    head dim to shard).  Under tensor parallelism the rank's heads attend
    over the whole latent (its batch rows), and in the sequence-sharded
    branch q is gathered over its heads first (the slice's partial needs
    every head, as the reference's takes q replicated) and the rank keeps
    its heads of the output.  Returns (out [B,D], the cache dict)."""
    spec = spec or AttnSpec()
    m = cfg.mla
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = _absorbed_query(params, cfg, x, positions)
    c_t = _latent(params, cfg, x[:, None, :], positions)[:, 0]  # [B,latent]
    cache_c = cache["c"]
    scale = m.qk_head_dim ** -0.5
    if seq_sharded(cache, "c", get_mesh()):
        o_lat, cache_c = seq_sharded_decode(
            layers.gather_model(q, cfg.num_heads, dim=1), cache_c, c_t, pos,
            dv=m.kv_lora_rank, scale=scale, block=spec.block,
            rescale=spec.rescale)
        return (_absorbed_out(params, cfg, _own_heads(o_lat, params, cfg),
                              x.dtype),
                {"c": cache_c, "seq_rows": cache["seq_rows"]})
    cache_c[:, pos] = c_t
    length = torch.full((B,), pos + 1, dtype=torch.int32, device=x.device)
    o_lat = decode_attention(
        q, cache_c, cache_c[..., :m.kv_lora_rank], length,
        spec=spec.replace(scale=scale))                       # [B,H,kv]
    return _absorbed_out(params, cfg, o_lat, x.dtype), {"c": cache_c}


def _pools(pool, sz):
    """A paged layer cache: the latent pool, and the (scale, zp) pool of a
    quantized layout."""
    return {"c": pool} if sz is None else {"c": pool, "c_sz": sz}


def mla_decode_paged(params, cfg, x, cache, table, lengths, *,
                     spec: AttnSpec | None = None):
    """Absorbed-form decode against a paged latent cache.

    x: [B,D]; cache: {"c": pool [num_blocks, page, latent]}; table:
    [B,max_blocks]; lengths: [B] — sequence b's new token is written at
    position lengths[b].  A quantized cache also holds "c_sz", the per-row
    (scale, zp) pool: the new row is quantized on write and attention runs
    over the codes.  Returns (out [B,D], cache) — the pools are updated in
    place."""
    spec = spec or AttnSpec()
    m = cfg.mla
    positions = lengths[:, None].to(torch.int32)              # [B,1]
    q = _absorbed_query(params, cfg, x, positions)
    c_t = _latent(params, cfg, x[:, None, :], positions)[:, 0]  # [B,latent]
    sz = cache.get("c_sz")     # quantized layout: the (scale, zp) pool
    if sz is None:
        pool = paged_cache.append_rows(cache["c"], table, lengths, c_t)
    else:
        pool, sz = paged_cache.append_rows_quant(cache["c"], sz, table,
                                                 lengths, c_t)
    o_lat = decode_attention_paged(
        q, pool, None, table, lengths + 1,
        spec=spec.replace(scale=m.qk_head_dim ** -0.5), dv=m.kv_lora_rank,
        k_sz=sz)
    return _absorbed_out(params, cfg, o_lat, x.dtype), _pools(pool, sz)


def _mla_chunk(params, cfg, x, cache, table, lengths, positions, *, spec,
               qpos=None, n_cached: int = 0):
    """Append the chunk's latent rows through the table (all but the first
    ``n_cached``, which the pool holds already), then run absorbed
    attention over pool positions <= each query row's horizon.
    ``positions`` [B,C] drives rope; ``qpos`` None is the prefill entry
    (horizon start + row index, implied by the kernel), else the verify
    entry with the explicit per-row horizon ``qpos``."""
    m, H = cfg.mla, local_heads(params, cfg)
    B, C, _ = x.shape
    q_nope, q_rope = _queries(params, cfg, x, positions)      # [B,C,H,*]
    w_uk = params["w_uk"].reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
    q_c = torch.einsum("bchd,khd->bchk", q_nope.float(),
                       w_uk.float()).to(x.dtype)
    q = torch.cat([q_c, q_rope], dim=-1)                      # [B,C,H,latent]
    c_rows = _latent(params, cfg, x, positions)[:, n_cached:]
    at = lengths + n_cached
    sz = cache.get("c_sz")     # quantized layout: the (scale, zp) pool
    if sz is None:
        pool = paged_cache.append_chunk(cache["c"], table, at, c_rows)
    else:
        pool, sz = paged_cache.append_chunk_quant(cache["c"], sz, table, at,
                                                  c_rows)
    kw = dict(spec=spec.replace(scale=m.qk_head_dim ** -0.5),
              dv=m.kv_lora_rank, k_sz=sz)
    if qpos is None:
        o_lat = prefill_attention_paged(q, pool, None, table, lengths, **kw)
    else:
        o_lat = verify_attention_paged(q, pool, None, table, lengths, qpos,
                                       **kw)                  # [B,C,H,kv]
    w_uv = params["w_uv"].reshape(m.kv_lora_rank, H, m.v_head_dim)
    o = torch.einsum("bchk,khd->bchd", o_lat.float(),
                     w_uv.float()).to(x.dtype)
    out = layers.dense_row(o.reshape(B, C, H * m.v_head_dim), params["w_o"],
                           cfg.num_heads * m.v_head_dim)
    return out, _pools(pool, sz)


def mla_prefill_chunk(params, cfg, x, cache, table, lengths, *,
                      spec: AttnSpec | None = None, n_cached: int = 0):
    """Absorbed-form chunked prefill against the paged latent cache.

    x: [B,C,D] — C prompt tokens at positions lengths[b] + c; lengths: [B]
    tokens already written (the chunk start).  The chunk's rows are appended
    first (quantized on write for an int8 / fp8 cache; the first
    ``n_cached``, already in the pool, are not), then attention runs
    causally over chunk + earlier context.  Returns (out [B,C,D], cache)."""
    spec = spec or AttnSpec()
    C = x.shape[1]
    positions = lengths[:, None].to(torch.int32) + torch.arange(
        C, dtype=torch.int32, device=x.device)[None, :]
    return _mla_chunk(params, cfg, x, cache, table, lengths, positions,
                      spec=spec, n_cached=n_cached)


def mla_verify_chunk(params, cfg, x, cache, table, lengths, qpos, *,
                     spec: AttnSpec | None = None):
    """Absorbed-form draft verification against the paged latent cache:
    score k draft rows in one chunked-prefill-shaped pass (K4, or K4q over
    an int8 / fp8 cache).

    x: [B,k,D] — the draft tokens' embeddings; qpos: [B,k] each row's
    absolute position, for rope and for its causal horizon (a linear chain
    lengths[:, None] + arange(k) makes this bitwise
    :func:`mla_prefill_chunk`).  The rows are appended at lengths; the
    scheduler rewinds rejected ones with ``BlockPool.truncate``, never a
    pool rewrite.  Returns (out [B,k,D], cache)."""
    spec = spec or AttnSpec()
    qpos = qpos.to(torch.int32)
    return _mla_chunk(params, cfg, x, cache, table, lengths, qpos,
                      spec=spec, qpos=qpos)


def init_mla_cache(cfg, batch: int, max_len: int, dtype, *, device="cuda"):
    """Dense latent cache {"c": zeros [batch, max_len, latent]}."""
    return {"c": torch.zeros(batch, max_len, cfg.mla.latent_dim, dtype=dtype,
                             device=device)}


def mla_prefill_cache(params, cfg, x, positions):
    """Latent cache rows for a whole prompt."""
    return _latent(params, cfg, x, positions)


def init_mla_cache_paged(cfg, layout, dtype, kv_dtype: str = "fp", *,
                         device="cuda"):
    """Paged latent pool (block 0 = the reserved null block).  kv_dtype
    "int8" / "fp8": the pool holds codes (zero bits) and a parallel per-row
    (scale, zp) pool rides under "c_sz", initialised to scale 1 and zp 0 so
    the all-zero rows decode to exact zeros."""
    shape = (layout.num_blocks, layout.block_size, cfg.mla.latent_dim)
    qdt = paged_cache.quant_dtype(kv_dtype)
    if qdt is None:
        return {"c": torch.zeros(shape, dtype=dtype, device=device)}
    codes = torch.zeros(shape, dtype=torch.uint8, device=device).view(qdt)
    sz = torch.zeros(shape[:2] + (2,), dtype=torch.float32, device=device)
    sz[..., 0] = 1.0                                     # scale 1, zp 0
    return {"c": codes, "c_sz": sz}
