"""The untransposed decode baseline (FlashMLA without ETAP): wrappers,
launch counters and plain versions.

The port of ``repro/kernels/flash_decode/flash_decode.py``.  The same
tiling as the ETAP kernels, with only the orientation of the products
changed — the comparison target of the paper's Figure-1 claim:

    S = Q·Kᵀ  [H, block]   (the thin head axis on the M side)
    m, ℓ : per-ROW stats   [H]
    Acc += P·V  [H, Dv]

Two kernels, one CUDA body (``kernels/csrc/flash_decode.cu``, beside the
building blocks it shares with the ETAP kernels; its header note says what
bounds it on the H100):

  K7 :func:`flash_decode`           single-pass decode
     (replaces ``repro/kernels/flash_decode/flash_decode.py:83``)
  K8 :func:`flash_decode_partial`   split-KV phase 1, Acc [B,n,H,Dv]
     (replaces ``repro/kernels/flash_decode/flash_decode.py:168``)

Both at the MLA latent's widths (Dk 576, Dv 512) and at a 128-wide GQA
head (Dk = Dv = 128), whose cache [B, S, K, hd] they read in place as its
grouped form [B·K, S, hd] (:mod:`repro_torch.kernels.splitkv`).

CPU tensors run the ``*_plain`` versions, which walk ``block``-row blocks
of the cache (zero-padded to the split geometry) as the reference does;
CUDA tensors launch the kernel or raise.  Each wrapper's ``launches``
attribute counts its kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, softmax_state
from repro_torch.kernels.etap.schedule import dense_split_plan
from repro_torch.kernels.launch import (amla_flag, dense_operands,
                                        dense_split_tiles, device_of, ptr,
                                        stream)
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


def _splits_plain(q, k, v, length, plan, *, scale, mode):
    """Per-split fp32 states (m [B,H], l [B,H], acc [B,H,Dv]) of the
    untransposed walk over ``plan.block``-row blocks of the cache,
    zero-padded to ``plan.padded_s`` rows."""
    last = (length.to(torch.int32) - 1)[:, None, None]          # [B,1,1]
    return split_walks_plain(k, v, plan, lambda fetch, tiles: _walk_plain(
        q, fetch, tiles, plan.block, last, scale=scale, dv=v.shape[-1],
        mode=mode))


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


# ----------------------------------------------------------- CUDA launches
def flash_decode(q, k, v, length, *, scale, block=512, rescale=None):
    """K7: single-pass untransposed decode. q [BG,H,Dk]; k [BG,S,Dk];
    v [BG,S,Dv] (``k[..., :Dv]`` for the MLA latent: read in place), or a
    GQA cache k, v [B,S,K,hd] read in place as its grouped form (BG = B·K);
    length [BG].  The kernel walks 64-row tiles and reads rows past S as
    zero (no padded copy).  Returns [BG,H,Dv] in v's dtype."""
    dev = device_of(q, k, v, length)
    if dev.type == "cpu":
        return flash_decode_plain(q, k, v, length, scale=scale, block=block,
                                  rescale=rescale)
    lib, args, keep = dense_operands(q, k, v, length,
                                     widths="flash_decode_widths",
                                     what="flash_decode")
    B, H, _ = q.shape
    out = torch.empty(B, H, v.shape[-1], dtype=v.dtype, device=dev)
    flash_decode.launches += 1
    build.check(lib.flash_decode(
        *args, ptr(out), B, H, float(scale), amla_flag(rescale), stream(dev)),
        "flash_decode")
    del keep
    return out


def flash_decode_partial(q, k, v, length, *, scale, plan, rescale=None):
    """K8: split-KV phase 1 of the baseline under ``plan``, with the split
    geometry of :func:`repro_torch.kernels.etap.etap.etap_partial_dense`.
    Returns fp32 (m [BG,n,H], l [BG,n,H], acc [BG,n,H,Dv]) for
    :func:`repro_torch.kernels.etap.combine.combine_splits_std`."""
    dev = device_of(q, k, v, length)
    if dev.type == "cpu":
        return flash_decode_partial_plain(q, k, v, length, scale=scale,
                                          plan=plan, rescale=rescale)
    lib, args, keep = dense_operands(q, k, v, length,
                                     widths="flash_decode_widths",
                                     what="flash_decode_partial")
    tps = dense_split_tiles(k.shape[1], plan, what="flash_decode_partial")
    B, H, _ = q.shape
    n = plan.n_splits
    f32 = dict(dtype=torch.float32, device=dev)
    m = torch.empty(B, n, H, **f32)
    l = torch.empty(B, n, H, **f32)
    acc = torch.empty(B, n, H, v.shape[-1], **f32)
    flash_decode_partial.launches += 1
    build.check(lib.flash_decode_partial(
        *args, m.data_ptr(), l.data_ptr(), acc.data_ptr(), B, H, n, tps,
        float(scale), amla_flag(rescale), stream(dev)),
        "flash_decode_partial")
    del keep
    return m, l, acc


flash_decode.launches = 0
flash_decode_partial.launches = 0
