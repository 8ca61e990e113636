"""Public wrappers for the untransposed baseline — the port of
``repro/kernels/flash_decode/ops.py``: single-pass and split-KV two-phase
entry points, with the ETAP path's scheduler and split geometry
(:mod:`repro_torch.kernels.splitkv`).  Entries take one
:class:`repro_torch.core.attn_spec.AttnSpec` through ``attn_entry`` (the
profiler's choke point); the kernels are called
through the modules' attributes, never bound here."""
from __future__ import annotations

from repro_torch.core.attn_spec import attn_entry
from repro_torch.kernels import splitkv
from repro_torch.kernels.etap import combine as combine_mod
from repro_torch.kernels.flash_decode import flash_decode as FD


@attn_entry(uses=("block", "rescale"))
def flash_decode(q, k, v, length=None, *, spec):
    """Baseline decode attention (K7). q [BG,H,Dk]; k [BG,S,Dk];
    v [BG,S,Dv]; length [BG] (None = all S).  Returns [BG,H,Dv]."""
    if length is None:
        length = splitkv.full_length(q, k.shape[1])
    return FD.flash_decode(q, k, v, length, scale=spec.scale,
                           block=spec.block, rescale=spec.rescale)


@attn_entry(uses=("block", "kv_splits", "rescale"))
def flash_decode_splitkv(q, k, v, length=None, *, spec, k_sz=None,
                         v_sz=None):
    """Two-phase split-KV baseline decode (the ETAP path's scheduler;
    spec.kv_splits None/0 → auto, 1 → single-pass K7, else K8 + the
    [n,H,Dv] combine K2).  ``k_sz`` / ``v_sz``: the (scale, zp) rows of
    int8 / fp8 code rows k, v — K7q / K8q run and the output is fp32."""
    quant = k_sz is not None
    return splitkv.decode_splitkv(
        q, k, v, length, spec=spec,
        single=FD.flash_decode_quant if quant else FD.flash_decode,
        partial=FD.flash_decode_partial_quant if quant
        else FD.flash_decode_partial,
        combine=combine_mod.combine_splits_std, k_sz=k_sz, v_sz=v_sz)
