"""The untransposed decode baseline (FlashMLA without ETAP): wrappers,
launch counters and plain versions.

The port of ``repro/kernels/flash_decode/flash_decode.py``.  The same
tiling as the ETAP kernels, with only the orientation of the products
changed — the comparison target of the paper's Figure-1 claim:

    S = Q·Kᵀ  [H, block]   (the thin head axis on the M side)
    m, ℓ : per-ROW stats   [H]
    Acc += P·V  [H, Dv]

One Hopper kernel (``kernels/csrc/flash_decode_wgmma.cu``: the heads on
wgmma's M, a TMA ring, warp-specialised; its header note says what bounds
it on the H100) runs all four:

  K7 :func:`flash_decode`           single-pass decode
     (replaces ``repro/kernels/flash_decode/flash_decode.py:83``)
  K8 :func:`flash_decode_partial`   split-KV phase 1, Acc [B,n,H,Dv]
     (replaces ``repro/kernels/flash_decode/flash_decode.py:168``)

Both at the MLA latent's widths (Dk 576, Dv 512) and at the GQA heads
(Dk = Dv = 128, 64 and 256: ``kernels/csrc/mma_tile.cuh:DenseWidths``),
whose cache [B, S, K, hd] they read in place as its grouped form [B·K, S,
hd] (:mod:`repro_torch.kernels.splitkv`).  Their quantized twins, at the
latent and the 128- and 64-wide heads (``QuantDenseWidths``):

  K7q :func:`flash_decode_quant`, K8q :func:`flash_decode_partial_quant`
     K7 and K8 over int8 / fp8 code rows with their (scale, zp) rows
     ``k_sz`` / ``v_sz``: the baseline over a quantized pool, whose codes
     and pairs the callers gather (the reference gathers them dequantized
     to fp32 and hands K7 / K8 the fp32 rows; the same two ``pallas_call``
     sites).  The codes enter the tensor cores as exact bf16 values and the
     affine is applied around the products in fp32 (the ETAP decode
     kernels' numerics, ``kernels/csrc/etap_decode.cuh``, "Over codes");
     q bf16 or fp32; the output is fp32, as the reference's.

CPU tensors run the ``*_plain`` versions, which walk ``block``-row blocks
of the cache (zero-padded to the split geometry) as the reference does;
CUDA tensors launch the kernel or raise.  Each wrapper's ``launches``
attribute counts its kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import softmax_state
from repro_torch.kernels.etap.schedule import dense_split_plan
from repro_torch.kernels.launch import (dense_partial, dense_single,
                                        device_of)
from repro_torch.kernels.splitkv import split_walks_plain

NEG_INF = softmax_state.NEG_INF


# ----------------------------------------------------------- plain versions
def _walk_plain(q, fetch, tiles, block, last, *, scale, dv, mode):
    """The untransposed online-softmax walk over KV ``tiles`` (``fetch(j)``
    returns block j's K and V rows) for q [B,H,Dk] with horizons last
    [B,1,1].  Returns the fp32 state (m [B,H], l [B,H], acc [B,H,dv])."""
    B, H, _ = q.shape
    qf = q.float()
    arange = torch.arange(block, device=q.device, dtype=torch.int32)
    state = softmax_state.init((B, H), (B, H, dv), device=q.device)
    for j in tiles:
        kj, vj = (x.float().contiguous() for x in fetch(j))
        sc = torch.einsum("bhd,bpd->bhp", qf, kj) * scale        # S = Q·Kᵀ
        live = (j * block + arange)[None, None, :] <= last
        sc = torch.where(live, sc, NEG_INF)
        state = softmax_state.update(
            state, sc, lambda p, vj=vj: torch.einsum("bhp,bpv->bhv", p, vj),
            axis=2, mode=mode, expand=lambda c: c[:, :, None])
    return state


def _splits_plain(q, k, v, length, plan, *, scale, mode, k_sz=None,
                  v_sz=None):
    """Per-split fp32 states (m [B,H], l [B,H], acc [B,H,Dv]) of the
    untransposed walk over ``plan.block``-row blocks of the cache,
    zero-padded to ``plan.padded_s`` rows (code rows dequantized block by
    block with their pairs ``k_sz`` / ``v_sz``)."""
    last = (length.to(torch.int32) - 1)[:, None, None]          # [B,1,1]
    return split_walks_plain(k, v, plan, lambda fetch, tiles: _walk_plain(
        q, fetch, tiles, plan.block, last, scale=scale, dv=v.shape[-1],
        mode=mode), k_sz=k_sz, v_sz=v_sz)


def flash_decode_plain(q, k, v, length, *, scale, block=512, rescale=None):
    """Plain K7. q [BG,H,Dk]; k [BG,S,Dk] and v [BG,S,Dv], or a GQA cache
    [B,S,K,D*] (BG = B·K); length [BG].  Returns [BG,H,Dv] in v's
    dtype."""
    (state,) = _splits_plain(q, k, v, length,
                             dense_split_plan(k.shape[1], block, 1),
                             scale=scale, mode=softmax_state.resolve(rescale))
    return softmax_state.finalize(
        state, expand=lambda l: l[:, :, None]).to(v.dtype)


def flash_decode_partial_plain(q, k, v, length, *, scale, plan,
                               rescale=None):
    """Plain K8: split s walks blocks [s·npb, (s+1)·npb) of the cache
    padded to ``plan.padded_s`` rows.  Returns fp32 (m [BG,n,H], l [BG,n,H],
    acc [BG,n,H,Dv])."""
    parts = _splits_plain(q, k, v, length, plan, scale=scale,
                          mode=softmax_state.resolve(rescale))
    return tuple(torch.stack(x, dim=1) for x in zip(*parts, strict=True))


def flash_decode_quant_plain(q, k, v, length, *, k_sz, v_sz, scale,
                            block=512, rescale=None):
    """Plain K7q: K7 over int8 / fp8 code rows with their (scale, zp) rows
    k_sz, v_sz; each fetched block is dequantized to fp32 and q taken in
    fp32, as the reference's K7 on its dequantized rows.  Returns [BG,H,Dv]
    fp32."""
    (state,) = _splits_plain(q, k, v, length,
                             dense_split_plan(k.shape[1], block, 1),
                             scale=scale, mode=softmax_state.resolve(rescale),
                             k_sz=k_sz, v_sz=v_sz)
    return softmax_state.finalize(state, expand=lambda l: l[:, :, None])


def flash_decode_partial_quant_plain(q, k, v, length, *, k_sz, v_sz, scale,
                                     plan, rescale=None):
    """Plain K8q: K8 over code rows with their pairs.  Returns fp32 (m, l,
    acc) as :func:`flash_decode_partial_plain`."""
    parts = _splits_plain(q, k, v, length, plan, scale=scale,
                          mode=softmax_state.resolve(rescale), k_sz=k_sz,
                          v_sz=v_sz)
    return tuple(torch.stack(x, dim=1) for x in zip(*parts, strict=True))


# ----------------------------------------------------------- CUDA launches
def flash_decode(q, k, v, length, *, scale, block=512, rescale=None):
    """K7: single-pass untransposed decode. q [BG,H,Dk]; k [BG,S,Dk];
    v [BG,S,Dv] (``k[..., :Dv]`` for the MLA latent: read in place), or a
    GQA cache k, v [B,S,K,hd] read in place as its grouped form (BG = B·K);
    length [BG].  The kernel walks 64-row tiles and reads rows past S as
    zero (no padded copy).  Returns [BG,H,Dv] in v's dtype."""
    if device_of(q, k, v, length).type == "cpu":
        return flash_decode_plain(q, k, v, length, scale=scale, block=block,
                                  rescale=rescale)
    return dense_single(flash_decode, "flash_decode", "flash_decode_widths",
                        q, k, v, length, scale=scale, rescale=rescale)


def flash_decode_partial(q, k, v, length, *, scale, plan, rescale=None):
    """K8: split-KV phase 1 of the baseline under ``plan``, with the split
    geometry of :func:`repro_torch.kernels.etap.etap.etap_partial_dense`.
    Returns fp32 (m [BG,n,H], l [BG,n,H], acc [BG,n,H,Dv]) for
    :func:`repro_torch.kernels.etap.combine.combine_splits_std`."""
    if device_of(q, k, v, length).type == "cpu":
        return flash_decode_partial_plain(q, k, v, length, scale=scale,
                                          plan=plan, rescale=rescale)
    return dense_partial(flash_decode_partial, "flash_decode_partial",
                         "flash_decode_widths", q, k, v, length, plan=plan,
                         transposed=False, scale=scale, rescale=rescale)


def flash_decode_quant(q, k, v, length, *, k_sz, v_sz, scale, block=512,
                       rescale=None):
    """K7q: single-pass untransposed decode over int8 / fp8 code rows.  q
    [BG,H,Dk] bf16 or fp32; k, v code rows as :func:`flash_decode` takes
    them (``k[..., :Dv]`` with ``v_sz = k_sz`` for the latent: read in
    place) and k_sz, v_sz their fp32 (scale, zp) rows [..., 2].  Returns
    [BG,H,Dv] fp32."""
    if device_of(q, k, v, length, k_sz, v_sz).type == "cpu":
        return flash_decode_quant_plain(q, k, v, length, k_sz=k_sz,
                                        v_sz=v_sz, scale=scale, block=block,
                                        rescale=rescale)
    return dense_single(flash_decode_quant, "flash_decode_quant",
                        "flash_decode_quant_widths", q, k, v, length,
                        scale=scale, rescale=rescale, k_sz=k_sz, v_sz=v_sz)


def flash_decode_partial_quant(q, k, v, length, *, k_sz, v_sz, scale, plan,
                               rescale=None):
    """K8q: split-KV phase 1 of the baseline over code rows under
    ``plan``.  Returns fp32 (m [BG,n,H], l [BG,n,H], acc [BG,n,H,Dv])."""
    if device_of(q, k, v, length, k_sz, v_sz).type == "cpu":
        return flash_decode_partial_quant_plain(q, k, v, length, k_sz=k_sz,
                                                v_sz=v_sz, scale=scale,
                                                plan=plan, rescale=rescale)
    return dense_partial(flash_decode_partial_quant,
                         "flash_decode_partial_quant",
                         "flash_decode_quant_widths", q, k, v, length,
                         plan=plan, transposed=False, scale=scale,
                         rescale=rescale, k_sz=k_sz, v_sz=v_sz)


flash_decode.launches = 0
flash_decode_partial.launches = 0
flash_decode_quant.launches = 0
flash_decode_partial_quant.launches = 0
