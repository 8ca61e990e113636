"""Attention layers of the GQA family — the port of
``repro/models/attention.py``: the full-sequence causal and sliding-window
(local) attention of the dense prefill, the attention module (projections,
qk-norm, rope), decode over the dense [B, S, K, hd] cache (a ring buffer of
``window`` rows for local attention) and over the paged {"k", "v"} pools,
and chunked paged prefill.

Decode runs the dense decode kernels of :mod:`repro_torch.core.etap` over
the cache in its grouped form (:func:`gqa_decode`): B·K rows of G = H/K
query columns (K5 / K6 + K2 for ``etap``, K7 / K8 + K2 for ``standard``).
The reference copies the cache into that form every layer and step when it
takes its kernel path; the CUDA kernels here read the [B, S, K, hd] cache
in place.  The paged layout gathers its pools to the dense layout first,
as the reference does (the GQA pool has a kv-head axis that the paged
kernels do not stride over), and chunked prefill is the reference's plain
masked product.  Scores and probabilities are fp32, as the reference's
``preferred_element_type=float32`` products make them.

The paged pools may hold int8 / fp8 codes (``--kv-dtype``), each kv head's
``hd``-vector of a row its own quantization granule with its own (scale,
zp) in the "k_sz" / "v_sz" pools [N, page, K, 2]: rows are quantized on
write; decode gathers codes and pairs and runs the quantized kernels K5q /
K6q (etap) or K7q / K8q (standard) with q in fp32, where the reference
gathers the rows dequantized to fp32 and runs K5-K8 on them; chunked
prefill dequantizes the gathered rows for its fp32 product, as the
reference does.

Local attention (RecurrentGemma) keeps its dense ring buffer: decode
writes slot ``pos % Smax`` of a cache of ``min(max_len, window)`` rows and
attends over ``min(pos + 1, Smax)`` of them, through the same decode
kernels as full attention.  A window never pages: the paged entries refuse
it, as the reference's do.

The dense prefill's causal attention (:func:`causal_attention`, from
``attention_train`` and ``core/mla.py:mla_train``) runs K9, the causal
prefill kernel (:mod:`repro_torch.kernels.flash_prefill`), on CUDA
operands: the reference names that kernel the accelerator route of its
masked product, which computes the upper triangle the kernel skips.  On
CPU operands it stays the reference's masked product.  Local attention
never takes K9.

Under tensor parallelism a rank's W_q, W_k, W_v hold its q and kv
heads' columns (G = H/K kept) and W_o their rows (:func:`local_heads`);
the dense cache keeps every kv head on every rank.

Draft verification (:func:`attention_verify_chunk`, the serve loop's
``--spec-tokens``) is the chunked prefill's masked product with an explicit
per-row horizon, over the gathered pools, with no kernel: the reference's
route.
"""
from __future__ import annotations

import torch

from repro_torch.core.attn_spec import AttnSpec
from repro_torch.core.etap import (decode_attention, gqa_grouped_view,
                                   seq_sharded_gqa_decode)
from repro_torch.kernels.flash_prefill import ops as prefill_ops
from repro_torch.launch.mesh import get_mesh
from repro_torch.models import layers
from repro_torch.runtime import paged_cache
from repro_torch.sharding.rules import seq_sharded

NEG_INF = -1e30


def _expand_kv(k, H: int):
    """[B,S,K,hd] -> [B,S,H,hd] by group broadcast (a view when K == H)."""
    B, S, K, hd = k.shape
    G = H // K
    if G == 1:
        return k
    return k[:, :, :, None, :].expand(B, S, K, G, hd).reshape(B, S, H, hd)


def causal_attention(q, k, v, *, scale: float, q_block: int = 512):
    """Causal attention over a whole sequence.  q [B,S,H,D]; k, v
    [B,S,K,D*] with H = K·G.  Returns [B,S,H,Dv] in v's dtype.  CUDA
    operands run K9 (``flash_prefill.ops.flash_prefill``: no scores in
    device memory, the blocks above the diagonal skipped; under grad,
    ``flash_prefill_grad``: the same launch with the reference's gradient
    as its backward); CPU operands the reference's route
    (:func:`masked_attention`), walked over ``q_block`` query rows, each block
    against the whole masked context (one block's fp32 scores are the
    peak).  Both refuse an S that is not a multiple of ``q_block`` (capped
    at S), as the reference does."""
    B, S, H, _ = q.shape
    q_block = min(q_block, S)
    if S % q_block:
        raise ValueError(f"S={S} not a multiple of q_block={q_block}")
    if q.device.type == "cuda":
        spec = AttnSpec(scale=scale)
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            return prefill_ops.flash_prefill_grad(q, k, v, spec=spec)
        return prefill_ops.flash_prefill(q, k, v, spec=spec)
    return masked_attention(q, k, v, scale=scale, q_block=q_block)


def masked_attention(q, k, v, *, scale: float, q_block: int = 512):
    """The reference's route of :func:`causal_attention` on any device: for
    each ``q_block``-row query block (S a multiple of it), the fp32 scores
    against the whole context under the causal mask (-1e30), softmax, and
    the product with V.  Autograd differentiates it as it stands."""
    B, S, H, _ = q.shape
    q_block = min(q_block, S)
    kf = _expand_kv(k, H).float().permute(0, 2, 3, 1).contiguous()  # [B,H,D,S]
    vf = _expand_kv(v, H).float().transpose(1, 2).contiguous()  # [B,H,S,Dv]
    kpos = torch.arange(S, device=q.device)
    out = torch.empty(B, S, H, v.shape[-1], dtype=v.dtype, device=q.device)
    for i in range(0, S, q_block):
        qi = q[:, i:i + q_block].float().transpose(1, 2)       # [B,H,qb,D]
        s = torch.matmul(qi, kf) * scale                       # [B,H,qb,S]
        qpos = i + torch.arange(q_block, device=q.device)
        s.masked_fill_(qpos[:, None] < kpos[None, :], NEG_INF)
        p = torch.softmax(s, dim=-1)
        del s
        o = torch.matmul(p, vf)                                # [B,H,qb,Dv]
        out[:, i:i + q_block] = o.transpose(1, 2).to(v.dtype)
    return out


def local_attention(q, k, v, *, window: int, scale: float):
    """Sliding-window causal attention, chunk = window: query chunk i
    attends key chunks i - 1 and i under the band mask (key p live for
    query t iff t - window < p <= t); chunk 0 has no previous chunk.  q
    [B,S,H,D]; k, v [B,S,K,D*] with H = K·G; S a multiple of
    min(window, S), as the reference asserts.  The G query heads of a kv
    head attend to its rows directly, in fp32.  Returns [B,S,H,Dv] in v's
    dtype."""
    B, S, H, D = q.shape
    K = k.shape[2]
    w = min(window, S)
    if S % w:
        raise ValueError(f"S={S} % window={w} != 0")
    dev = q.device
    qpos = torch.arange(w, device=dev)[:, None] + w       # within-pair coords
    kpos = torch.arange(2 * w, device=dev)[None, :]
    band = (qpos >= kpos) & (qpos - kpos < w)             # causal and window
    out = torch.empty(B, S, H, v.shape[-1], dtype=v.dtype, device=dev)
    for i in range(S // w):
        lo = max(0, (i - 1) * w)
        qi = q[:, i * w:(i + 1) * w].float().reshape(B, w, K, H // K, D)
        s = torch.einsum("bqkgd,bskd->bkgqs", qi,
                         k[:, lo:(i + 1) * w].float()) * scale
        valid = band if i else band[:, w:]                # no chunk before 0
        s = torch.where(valid, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskv->bqkgv", p, v[:, lo:(i + 1) * w].float())
        out[:, i * w:(i + 1) * w] = o.reshape(B, w, H, -1).to(v.dtype)
    return out


# ------------------------------------------------------------------- decode
def gqa_decode(q, k_cache, v_cache, length, *, spec: AttnSpec, k_sz=None,
               v_sz=None):
    """One-token decode against a [B,S,K,hd] cache: q [B,H,hd], length [B]
    → [B,H,Dv].  spec.mode picks ETAP (the paper) or the untransposed
    baseline, spec.kv_splits the split count (None = auto).  The cache
    decodes as its grouped form (row b·K + kh holds G = H/K query columns),
    read in place by the kernels (:func:`repro_torch.core.etap
    .gqa_grouped_view`).  ``k_sz`` / ``v_sz``: the (scale, zp) rows
    [B,S,K,2] of a code cache, read in place the same way; the output is
    then fp32."""
    K = k_cache.shape[2]
    qg, kg, vg, restore = gqa_grouped_view(q.contiguous(), k_cache, v_cache)
    return restore(decode_attention(qg, kg, vg, length.repeat_interleave(K),
                                    spec=spec, k_sz=k_sz, v_sz=v_sz))


# --------------------------------------------------------- attention module
def init_attention(gen, cfg, dtype, device):
    H, Kv, hd, D = (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
                    cfg.d_model)
    leaf = layers.leaf

    def dense(name, i, o):
        return leaf(name, layers.init_dense(gen, i, o, dtype, device))
    p = {"w_q": dense("w_q", D, H * hd), "w_k": dense("w_k", D, Kv * hd),
         "w_v": dense("w_v", D, Kv * hd), "w_o": dense("w_o", H * hd, D)}
    if cfg.qk_norm:
        p["q_norm"] = leaf("q_norm", torch.zeros(hd, dtype=dtype,
                                                 device=device))
        p["k_norm"] = leaf("k_norm", torch.zeros(hd, dtype=dtype,
                                                 device=device))
    return p


def local_heads(params, cfg) -> tuple[int, int]:
    """(query heads, kv heads) this rank's weights hold: all of them, or
    under tensor parallelism its pieces' (W_q's and W_k's columns over the
    head width)."""
    hd = cfg.resolved_head_dim
    return params["w_q"].shape[1] // hd, params["w_k"].shape[1] // hd


def _all_heads(t, whole: int):
    """``t`` [..., n, hd] of this rank's n heads → all ``whole`` heads."""
    return layers.gather_model(t, whole, dim=t.dim() - 2)


def _all_kv(k, v, whole: int):
    """:func:`_all_heads` of k and v in one collective."""
    if k.shape[-2] == whole:
        return k, v
    k, v = _all_heads(torch.stack((k, v)), whole)
    return k, v


def _project_qkv(params, cfg, x, positions):
    """x [..., S, D], positions [..., S] → q [..., S, H, hd], k and v
    [..., S, K, hd]: projections, qk-norm (when the config has it), then
    rope on q and k.  H and K are this rank's heads
    (:func:`local_heads`)."""
    hd = cfg.resolved_head_dim
    H, Kv = local_heads(params, cfg)
    cut = H != cfg.num_heads
    lead = x.shape[:-1]
    q, k, v = layers.tp_columns(
        x, (params["w_q"], params["w_k"], params["w_v"]), cut)
    q = q.reshape(*lead, H, hd)
    k = k.reshape(*lead, Kv, hd)
    v = v.reshape(*lead, Kv, hd)
    if cfg.qk_norm:     # whole scales applied to the rank's heads
        q = layers.rms_norm(q, layers.enter_model(params["q_norm"], cut),
                            cfg.norm_eps)
        k = layers.rms_norm(k, layers.enter_model(params["k_norm"], cut),
                            cfg.norm_eps)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _check_paged(cfg) -> None:
    """The paged pools hold full attention only: a local window keeps its
    dense ring buffer (the reference asserts the same)."""
    if cfg.attention_kind != "full":
        raise ValueError(
            f"{cfg.name}: paged cache supports full attention (local "
            f"windows stay dense), got {cfg.attention_kind}")


def attention_train(params, cfg, x, positions, *, return_cache: bool = False):
    """Full or local causal attention (per ``cfg.attention_kind``) over a
    whole sequence (the training and dense-prefill form).  x [B,S,D]; positions [B,S].  Returns out
    [B,S,D], and with ``return_cache`` also the cache rows {"k", "v":
    [B,S,K,hd]}.  Under tensor parallelism the rank's query heads attend
    over its kv heads (G kept), W_o's partial products are summed over
    `model`, and the cache rows are gathered to every kv head, as the
    cache holds them."""
    q, k, v = _project_qkv(params, cfg, x, positions)
    hd = cfg.resolved_head_dim
    scale = hd ** -0.5
    if cfg.attention_kind == "local":
        o = local_attention(q, k, v, window=cfg.window_size, scale=scale)
    else:
        o = causal_attention(q, k, v, scale=scale)
    out = layers.dense_row(o.reshape(*x.shape[:-1], -1), params["w_o"],
                           cfg.num_heads * hd)
    if return_cache:
        k, v = _all_kv(k, v, cfg.num_kv_heads)
        return out, {"k": k, "v": v}
    return out


def attention_decode(params, cfg, x, cache, pos: int, *,
                     spec: AttnSpec | None = None):
    """Decode over the dense cache.  x [B,D] one token; cache {"k", "v":
    [B,Smax,K,hd]}; pos the new token's position, shared by every row.  The
    new K/V rows are written in place at row ``pos`` (full attention) or
    ``pos % Smax`` (local attention's ring buffer), and attention runs over
    the first ``min(pos + 1, Smax)`` rows.  Under a mesh that
    sequence-shards a full-attention cache (``seq_shardable`` of the whole
    S, recorded under "seq_rows" beside this rank's slice) decode runs
    :func:`repro_torch.core.etap.seq_sharded_gqa_decode`.  The reference's
    condition is ``attention_kind == "full" and not cfg.use_kernels and
    seq_shardable(...)``; the port's config has no ``use_kernels`` (the
    reference's default is False), so the port's condition is
    ``attention_kind == "full"`` and the cache sharded.  A local ring never
    shards.  Under tensor parallelism the cache keeps every kv head on
    every rank: the new K/V rows are gathered over `model` and written
    whole, and the rank's query heads attend over its own kv heads of the
    cache in place (a view, no copy); in the sequence-sharded branch q is
    gathered over its heads and the rank keeps its heads of the output.
    W_o's partial products are summed over `model`.  Returns (out [B,D],
    the cache dict)."""
    spec = spec or AttnSpec()
    B = x.shape[0]
    H, Kv = cfg.num_heads, cfg.num_kv_heads
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(params, cfg, x[:, None, :], positions)
    Hl, Kl = q.shape[2], k.shape[2]
    k, v = _all_kv(k[:, 0], v[:, 0], Kv)                      # [B,K,hd]
    kc, vc = cache["k"], cache["v"]
    hd = cfg.resolved_head_dim
    scale = hd ** -0.5
    if seq_sharded(cache, "k", get_mesh()):
        if cfg.attention_kind != "full":
            raise ValueError("a local attention ring is never "
                             "sequence-sharded")
        o, kc, vc = seq_sharded_gqa_decode(
            _all_heads(q[:, 0], H), kc, vc, k, v, pos, scale=scale,
            block=spec.block, rescale=spec.rescale)
        h0 = layers.model_offset(Hl, H)
        o = o[:, h0:h0 + Hl]
        return (layers.dense_row(o.reshape(B, -1), params["w_o"], H * hd),
                {"k": kc, "v": vc, "seq_rows": cache["seq_rows"]})
    Smax = kc.shape[1]
    slot = pos % Smax if cfg.attention_kind == "local" else pos
    kc[:, slot] = k
    vc[:, slot] = v
    length = torch.full((B,), min(pos + 1, Smax), dtype=torch.int32,
                        device=x.device)
    k0 = layers.model_offset(Kl, Kv)
    o = gqa_decode(q[:, 0], kc[:, :, k0:k0 + Kl], vc[:, :, k0:k0 + Kl],
                   length, spec=spec.replace(scale=scale))
    return (layers.dense_row(o.reshape(B, -1), params["w_o"], H * hd),
            {"k": kc, "v": vc})


def _append_paged_kv(cache, table, lengths, k, v):
    """Append one row per sequence (k, v [B,K,hd]) or a chunk ([B,C,K,hd])
    into the paged {"k", "v"} pools through the table, in place; a code
    cache quantizes the rows on write, each kv head's hd-vector with its
    own (scale, zp) in "k_sz" / "v_sz".  Returns the cache dict."""
    chunked = k.dim() == 4
    if "k_sz" in cache:
        app = (paged_cache.append_chunk_quant if chunked
               else paged_cache.append_rows_quant)
        kc, k_sz = app(cache["k"], cache["k_sz"], table, lengths, k)
        vc, v_sz = app(cache["v"], cache["v_sz"], table, lengths, v)
        return {"k": kc, "v": vc, "k_sz": k_sz, "v_sz": v_sz}
    app = paged_cache.append_chunk if chunked else paged_cache.append_rows
    return {"k": app(cache["k"], table, lengths, k),
            "v": app(cache["v"], table, lengths, v)}


def _gather_paged_kv(cache, table):
    """Dense [B, nb·page, K, *] copies of the paged pools through the table
    (the reference's gather route: the GQA decode and chunked prefill
    attend over the gathered rows): {"k", "v"}, and for a code cache also
    the gathered (scale, zp) rows {"k_sz", "v_sz"} [B, S, K, 2]."""
    return {key: paged_cache.gather_blocks(pool, table)
            for key, pool in cache.items()}


def attention_decode_paged(params, cfg, x, cache, table, lengths, *,
                           spec: AttnSpec | None = None):
    """One-token decode against the paged cache: {"k", "v"} pools
    [num_blocks, page, K, hd] (and, for int8 / fp8 codes, their (scale, zp)
    pools "k_sz", "v_sz" [num_blocks, page, K, 2]), the shared block table
    [B,max_blocks] and per-sequence lengths [B] (row b's new token lands at
    lengths[b]).  The new rows are appended through the table, the pools
    gathered to the dense [B,S,K,*] layout, and :func:`gqa_decode` runs
    over them with the page as the split block, as in the reference.  Over
    codes q is taken in fp32 and the fp32 output is cast back to x's dtype
    before ``w_o``, as the reference does.  Returns (out [B,D], cache) —
    the pools are updated in place."""
    spec = spec or AttnSpec()
    _check_paged(cfg)
    B = x.shape[0]
    positions = lengths[:, None].to(torch.int32)
    q, k, v = _project_qkv(params, cfg, x[:, None, :], positions)
    cache = _append_paged_kv(cache, table, lengths, k[:, 0], v[:, 0])
    rows = _gather_paged_kv(cache, table)
    q = q[:, 0]
    if "k_sz" in rows:
        q = q.float()                  # match the dequantized fp32 rows
    o = gqa_decode(q, rows["k"], rows["v"], lengths + 1,
                   spec=spec.replace(scale=cfg.resolved_head_dim ** -0.5,
                                     block=cache["k"].shape[1]),
                   k_sz=rows.get("k_sz"), v_sz=rows.get("v_sz"))
    return layers.dense(o.reshape(B, -1).to(x.dtype), params["w_o"]), cache


def _attention_chunk(params, cfg, x, cache, table, lengths, positions,
                     n_cached: int = 0):
    """Append the chunk's K/V rows through the table (all but the first
    ``n_cached``, which the pools hold already), gather the pools, and
    run the masked chunk-against-context product: key position p is live
    for chunk row c iff p <= positions[b, c].  The G query heads of a kv
    head attend to its rows directly (no [B,S,H,hd] expansion).  A code
    cache's gathered rows are dequantized to fp32 first, as the reference
    does (its chunk route is a plain product, no kernel).  Returns
    (out [B,C,D], cache)."""
    B, C, _ = x.shape
    H, K = cfg.num_heads, cfg.num_kv_heads
    q, k, v = _project_qkv(params, cfg, x, positions)  # [B,C,H,hd],[B,C,K,hd]
    cache = _append_paged_kv(cache, table, lengths + n_cached,
                             k[:, n_cached:], v[:, n_cached:])
    rows = _gather_paged_kv(cache, table)                     # [B,S,K,*]
    kd, vd = rows["k"], rows["v"]
    if "k_sz" in rows:
        kd = paged_cache.dequantize_rows(kd, rows["k_sz"])
        vd = paged_cache.dequantize_rows(vd, rows["v_sz"])
    S = kd.shape[1]
    qg = q.float().reshape(B, C, K, H // K, -1)
    s = torch.einsum("bckgd,bskd->bkgcs", qg, kd.float()) * \
        cfg.resolved_head_dim ** -0.5
    kpos = torch.arange(S, device=x.device)
    valid = kpos[None, None, :] <= positions[:, :, None]       # [B,C,S]
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgcs,bskv->bckgv", p, vd.float()).to(v.dtype)
    return layers.dense(o.reshape(B, C, -1), params["w_o"]), cache


def attention_prefill_chunk(params, cfg, x, cache, table, lengths, *,
                            spec: AttnSpec | None = None, n_cached: int = 0):
    """Chunked prefill of C prompt tokens against the paged cache.  x
    [B,C,D] at positions lengths[b] + c; lengths [B] the chunk start; the
    first ``n_cached`` rows are in the pools already and are not appended.
    The spec is taken for parity with the MLA entry;
    this masked product has no knobs (the reference's chunk route is no
    kernel either).  Returns (out [B,C,D], cache)."""
    _check_paged(cfg)
    C = x.shape[1]
    positions = lengths[:, None].to(torch.int32) + torch.arange(
        C, dtype=torch.int32, device=x.device)[None, :]
    return _attention_chunk(params, cfg, x, cache, table, lengths, positions,
                            n_cached)


def attention_verify_chunk(params, cfg, x, cache, table, lengths, qpos, *,
                           spec: AttnSpec | None = None):
    """Draft verification over the paged cache: score k draft rows in one
    chunked-prefill-shaped pass.  x [B,k,D]; qpos [B,k] each row's absolute
    position, for rope and for its horizon (key position p is live for row
    c iff p <= qpos[b, c]); a linear chain lengths[:, None] + arange(k)
    makes this bitwise :func:`attention_prefill_chunk`.  The rows are
    appended at lengths; the scheduler rewinds rejected ones with
    ``BlockPool.truncate``.  The spec is taken for parity with the MLA
    entry.  Returns (out [B,k,D], cache)."""
    _check_paged(cfg)
    return _attention_chunk(params, cfg, x, cache, table, lengths,
                            qpos.to(torch.int32))


def init_attention_cache(cfg, batch: int, max_len: int, dtype, *,
                         device="cuda"):
    """Dense cache {"k", "v": zeros [batch, n, K, hd]}: n = max_len, or for
    local attention the ring buffer's min(max_len, window) rows."""
    n = min(max_len, cfg.window_size) if cfg.attention_kind == "local" \
        else max_len
    shape = (batch, n, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_attention_cache_paged(cfg, layout, dtype, kv_dtype: str = "fp", *,
                               device="cuda"):
    """Paged {"k", "v"} pools [num_blocks, page, K, hd] (block 0 = the
    reserved null block).  kv_dtype "int8" / "fp8": the pools hold codes
    (zero bits), and "k_sz" / "v_sz" [num_blocks, page, K, 2] hold each
    row's per-kv-head (scale, zp), initialised to scale 1 and zp 0 so the
    all-zero rows decode to exact zeros (the reference's layout)."""
    _check_paged(cfg)
    shape = (layout.num_blocks, layout.block_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    qdt = paged_cache.quant_dtype(kv_dtype)
    if qdt is None:
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    sz = torch.zeros(shape[:3] + (2,), dtype=torch.float32, device=device)
    sz[..., 0] = 1.0                                     # scale 1, zp 0
    codes = [torch.zeros(shape, dtype=torch.uint8, device=device).view(qdt)
             for _ in "kv"]
    return {"k": codes[0], "v": codes[1], "k_sz": sz, "v_sz": sz.clone()}
