"""Paged attention entry points — the port of the paged dispatchers of
``repro/core/etap.py`` for the MLA-fused fp case.

The reference routes to its Pallas kernels only when ``use_kernels`` is set
and otherwise runs XLA twins; the port has one route per entry: the kernel
wrappers in :mod:`repro_torch.kernels.etap.ops`, whose operands' device
picks the CUDA kernel or its plain version.  The separate-V pools, the
quantized layouts and the untransposed ``standard`` baseline are not ported
yet and raise ``NotImplementedError`` naming the ROADMAP item.
"""
from __future__ import annotations

from repro_torch.core.attn_spec import AttnSpec
from repro_torch.kernels.etap import ops as etap_ops


def _check(spec: AttnSpec, v_pool, k_sz, v_sz, *, decode: bool) -> None:
    if v_pool is not None:
        raise NotImplementedError(
            "separate-V paged pools are not ported yet: ROADMAP A1 (kernel "
            "bodies) and A5 (GQA path)")
    if k_sz is not None or v_sz is not None or spec.kv_dtype != "fp":
        raise NotImplementedError(
            "quantized KV pools are not ported yet: ROADMAP A1")
    if decode and spec.mode != "etap":
        raise NotImplementedError(
            "the untransposed 'standard' baseline is not ported yet: "
            "ROADMAP A4")


def decode_attention_paged(q, k_pool, v_pool, table, lengths, *,
                           spec: AttnSpec, dv: int = 0, k_sz=None,
                           v_sz=None):
    """Paged decode attention. q [B,H,Dk]; k_pool [N,page,Dk] the latent
    pool (v_pool None: V = its first ``dv`` columns); table [B,max_blocks];
    lengths [B].  spec.kv_splits None = auto split-KV.  Returns [B,H,dv]."""
    _check(spec, v_pool, k_sz, v_sz, decode=True)
    return etap_ops.etap_decode_mla_paged_splitkv(q, k_pool, dv, table,
                                                  lengths, spec=spec)


def prefill_attention_paged(q, k_pool, v_pool, table, start, *,
                            spec: AttnSpec, dv: int = 0, k_sz=None,
                            v_sz=None):
    """Chunked paged prefill attention. q [B,Cq,H,Dk]; start [B] tokens in
    the pool before the chunk, whose rows must already be appended.
    ``spec.mode`` is ignored, as in the reference: prefill always runs the
    transposed loop.  Returns [B,Cq,H,dv]."""
    _check(spec, v_pool, k_sz, v_sz, decode=False)
    return etap_ops.etap_prefill_mla_paged(q, k_pool, dv, table, start,
                                           spec=spec)


def verify_attention_paged(q, k_pool, v_pool, table, start, qpos, *,
                           spec: AttnSpec, dv: int = 0, k_sz=None,
                           v_sz=None):
    """Draft-verify attention: :func:`prefill_attention_paged` with the
    explicit per-row horizon qpos [B,Cq].  A linear qpos is bitwise the
    prefill entry."""
    _check(spec, v_pool, k_sz, v_sz, decode=False)
    return etap_ops.etap_verify_mla_paged(q, k_pool, dv, table, start, qpos,
                                          spec=spec)
