"""Full-sequence causal attention for the dense prefill — the port of
``repro/models/attention.py``'s ``causal_attention`` and ``_expand_kv``.

The reference computes this outside any Pallas kernel (XLA einsums and a
softmax, chunked over queries); the port does the same in plain PyTorch.
Scores and probabilities are fp32, as the reference's
``preferred_element_type=float32`` products make them.  The Pallas prefill
kernel of the reference (``kernels/flash_prefill``) is reached only from its
own ``ops.py`` and is not ported yet (ROADMAP A9).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _expand_kv(k, H: int):
    """[B,S,K,hd] -> [B,S,H,hd] by group broadcast (a view when K == H)."""
    B, S, K, hd = k.shape
    G = H // K
    if G == 1:
        return k
    return k[:, :, :, None, :].expand(B, S, K, G, hd).reshape(B, S, H, hd)


def causal_attention(q, k, v, *, scale: float, q_block: int = 512):
    """Blockwise causal attention, walked over ``q_block`` query rows (each
    block against the whole masked context, so one block's fp32 scores are
    the peak).  q [B,S,H,D]; k, v [B,S,K,D*] with H = K·G.  Returns
    [B,S,H,Dv] in v's dtype."""
    B, S, H, _ = q.shape
    q_block = min(q_block, S)
    if S % q_block:
        raise ValueError(f"S={S} not a multiple of q_block={q_block}")
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
