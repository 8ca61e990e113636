"""Public wrapper for the causal prefill kernel — the port of
``repro/kernels/flash_prefill/ops.py``: the :class:`repro_torch.core
.attn_spec.AttnSpec` entry, through ``attn_entry``.  ``bq`` / ``bkv`` stay explicit keywords, the
plain version's block sizes (the CUDA kernel tiles at 128 rows).  The kernel
is called through the module's attribute, never bound here."""
from __future__ import annotations

from repro_torch.core.attn_spec import attn_entry
from repro_torch.kernels.flash_prefill import flash_prefill as FP


@attn_entry(uses=("rescale",))
def flash_prefill(q, k, v, *, spec, bq: int = 256, bkv: int = 256):
    """Causal attention (K9). q [B,S,H,D]; k [B,S,K,D]; v [B,S,K,Dv] with
    H = K·G (head h reads kv head h // G; D may differ from Dv).  Returns
    [B,S,H,Dv] in v's dtype."""
    return FP.flash_prefill(q, k, v, scale=spec.scale, rescale=spec.rescale,
                            bq=bq, bkv=bkv)


@attn_entry(uses=("rescale",))
def flash_prefill_grad(q, k, v, *, spec, bq: int = 256, bkv: int = 256):
    """K9 with a gradient (training): the forward of :func:`flash_prefill`,
    the backward of the reference's masked product in plain PyTorch."""
    return FP.flash_prefill_grad(q, k, v, scale=spec.scale,
                                 rescale=spec.rescale, bq=bq, bkv=bkv)
