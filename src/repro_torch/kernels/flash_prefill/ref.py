"""Direct oracle for the causal prefill kernel — the port of
``repro/kernels/flash_prefill/ref.py``: the masked softmax written out, no
blocking and no online softmax."""
from __future__ import annotations

import torch


def causal_attention_ref(q, k, v, *, scale: float, dtype=torch.float32):
    """q: [B,S,H,D]; k, v: [B,S,K,D*] -> [B,S,H,Dv] (GQA by head grouping:
    query head h reads kv head h // (H/K)).  Computes in ``dtype``, returns
    v's dtype."""
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    qf = q.reshape(B, S, K, G, D).to(dtype)
    s = torch.einsum("bqkgd,bskd->bqkgs", qf, k.to(dtype)) * scale
    pos = torch.arange(S, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    s = torch.where(mask[None, :, None, None, :], s,
                    torch.tensor(float("-inf"), dtype=dtype, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqkgs,bskv->bqkgv", p, v.to(dtype))
    return o.reshape(B, S, H, v.shape[-1]).to(v.dtype)
