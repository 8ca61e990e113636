"""Direct oracle for ETAP decode attention — the port of
``repro/kernels/etap/ref.py``.  No blocking, no online softmax: the
mathematical definition, written in the transposed (ETAP) orientation:

    Sᵀ = K Qᵀ          [S, H]
    Pᵀ = softmax_cols(Sᵀ)
    Oᵀ = Vᵀ Pᵀ          [Dv, H]
    O  = (Oᵀ)ᵀ          [H, Dv]
"""
from __future__ import annotations

import torch

from repro_torch.kernels import softmax_state
from repro_torch.runtime.paged_cache import dequantize_rows


def etap_decode_ref(q, k, v, length=None, *, scale: float,
                    dtype=torch.float32):
    """q: [BG,H,Dk]; k: [BG,S,Dk]; v: [BG,S,Dv]; length: [BG] or None.
    Computes in ``dtype`` (float64 for an RMSE oracle), returns [BG,H,Dv]
    in v's dtype."""
    S = k.shape[1]
    qf, kf, vf = (a.to(dtype) for a in (q, k, v))
    sT = torch.einsum("bsd,bhd->bsh", kf, qf) * scale         # Sᵀ = K Qᵀ
    if length is not None:
        pos = torch.arange(S, device=k.device)
        live = (pos[None, :] < length.to(k.device)[:, None])[:, :, None]
        sT = torch.where(live, sT, torch.tensor(float("-inf"), dtype=dtype,
                                                device=k.device))
    pT = torch.softmax(sT, dim=1)                             # over S
    oT = torch.einsum("bsv,bsh->bvh", vf, pT)                 # Oᵀ = Vᵀ Pᵀ
    return oT.transpose(1, 2).to(v.dtype)


def etap_decode_state_ref(q, k, v, length=None, *, scale: float,
                          rescale: str | None = None):
    """Blockless degenerate of the softmax-state API: one ``init``, one
    ``update`` over the whole context, ``finalize``."""
    BG, H, _ = q.shape
    S = k.shape[1]
    Dv = v.shape[2]
    mode = softmax_state.resolve(rescale)
    sT = torch.einsum("bsd,bhd->bsh", k.float(), q.float()) * scale
    if length is not None:
        pos = torch.arange(S, device=k.device)
        live = (pos[None, :] < length.to(k.device)[:, None])[:, :, None]
        sT = torch.where(live, sT, softmax_state.NEG_INF)
    vf = v.float()
    state = softmax_state.init((BG, H), (BG, Dv, H), device=q.device)
    state = softmax_state.update(
        state, sT, lambda p: torch.einsum("bsv,bsh->bvh", vf, p),
        axis=1, mode=mode, expand=lambda c: c[:, None, :])
    oT = softmax_state.finalize(state, expand=lambda l: l[:, None, :])
    return oT.transpose(1, 2).to(v.dtype)


# ------------------------------------------------------ quantized twins
def dequantize(codes, sz):
    """Dequant of a quantized KV layout: codes [..., F] + per-row
    (scale, zp) [..., 2] -> fp32 rows, the runtime's one definition
    (:func:`repro_torch.runtime.paged_cache.dequantize_rows`)."""
    return dequantize_rows(codes, sz)


def etap_decode_quant_ref(q, k_codes, k_sz, v_codes, v_sz, length=None, *,
                          scale: float, dv: int = 0, dtype=torch.float32):
    """Oracle of the quantized decode kernels: dequantize densely, then the
    direct transposed softmax.  v_codes None -> MLA-fused (V = the first
    ``dv`` dequantized latent columns, the kernels' dequant-then-slice
    order).  Shapes as :func:`etap_decode_ref` with codes for K/V."""
    k = dequantize(k_codes, k_sz)
    v = dequantize(v_codes, v_sz) if v_codes is not None else k[..., :dv]
    return etap_decode_ref(q, k, v, length, scale=scale, dtype=dtype)
