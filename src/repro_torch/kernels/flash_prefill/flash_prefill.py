"""K9: blockwise causal GQA attention for the dense prefill — the port of
``repro/kernels/flash_prefill/flash_prefill.py``.

:func:`flash_prefill` computes what ``flash_prefill_pallas`` computes
(``pallas_call`` at ``repro/kernels/flash_prefill/flash_prefill.py:78``):
for q [B,S,H,D], k [B,S,K,D] and v [B,S,K,Dv] with H = K·G, query head h
attends to kv head h // G under the causal mask, by an online softmax over
KV blocks that skips the blocks wholly above the diagonal (they read no
KV); scores and statistics are fp32 and the output takes v's dtype.  D and
Dv may differ (DeepSeek's MLA: 192 and 128).

CPU tensors run :func:`flash_prefill_plain`, which walks ``bq``-row query
blocks and ``bkv``-row KV blocks as the reference's grid does.  CUDA
tensors launch the kernel (``kernels/csrc/flash_prefill.cu``, whose header
says what bounds it on the H100) at the (D, Dv) pairs the library is built
for (``csrc/mma_tile.cuh:PrefillWidths``), or raise: there is no fallback.
The kernel reads q, k and v in place through their strides and handles any
S; its launches are counted on ``flash_prefill.launches``.

The reference kernel has no backward, and neither has this one: the
wrapper refuses inputs that require grad.  Training takes
:func:`flash_prefill_grad`, an autograd Function whose forward is the same
launch (same bits, same count) and whose backward,
:func:`flash_prefill_backward`, is the gradient of the reference's
training route (``repro/models/attention.py:causal_attention``: XLA's
masked product, one ``jax.checkpoint`` per 512-row query block) in plain
PyTorch: S and P recomputed a query block at a time in fp32 without TF32.
A hand-written backward kernel is a speed item on ROADMAP.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, softmax_state
from repro_torch.kernels.launch import (amla_flag, check_widths,
                                        dense_strides, dense_widths,
                                        device_of, ptr, refuse_grad, stream)
from repro_torch.models.layers import no_tf32

NEG_INF = softmax_state.NEG_INF


def _check_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_prefill: q, k, v must be [B,S,H,D], "
                         f"[B,S,K,D], [B,S,K,Dv], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    K = k.shape[2]
    if k.shape[:2] != (B, S) or k.shape[-1] != D or \
            v.shape[:3] != k.shape[:3] or H % K:
        raise ValueError(f"flash_prefill: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not agree "
                         "(H a multiple of K)")


def flash_prefill_plain(q, k, v, *, scale, rescale=None, bq: int = 256,
                        bkv: int = 256):
    """Plain K9: for each ``bq``-row query block, the online softmax
    (:mod:`repro_torch.kernels.softmax_state`, either mode) over the
    ``bkv``-row KV blocks whose first row precedes the block's last row;
    masked logits are -1e30.  Any S (the last blocks may be short).
    q [B,S,H,D]; k [B,S,K,D]; v [B,S,K,Dv].  Returns [B,S,H,Dv] in v's
    dtype."""
    _check_shapes(q, k, v)
    mode = softmax_state.resolve(rescale)
    B, S, H, D = q.shape
    K, Dv = k.shape[2], v.shape[-1]
    G = H // K
    bq, bkv = max(1, min(bq, S)), max(1, min(bkv, S))
    dev = q.device
    out = torch.empty(B, S, H, Dv, dtype=v.dtype, device=dev)
    for i0 in range(0, S, bq):
        i1 = min(i0 + bq, S)
        n = i1 - i0
        qi = q[:, i0:i1].float().reshape(B, n, K, G, D)
        qpos = torch.arange(i0, i1, device=dev)
        state = softmax_state.init((B, K, G, n), (B, K, G, n, Dv),
                                   device=dev)
        for j0 in range(0, i1, bkv):       # the causal block skip
            j1 = min(j0 + bkv, S)
            kj = k[:, j0:j1].float()
            vj = v[:, j0:j1].float()
            s = torch.einsum("bqkgd,bskd->bkgqs", qi, kj) * scale
            kpos = torch.arange(j0, j1, device=dev)
            s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
            state = softmax_state.update(
                state, s,
                lambda p, vj=vj: torch.einsum("bkgqs,bskv->bkgqv", p, vj),
                axis=4, mode=mode, expand=lambda c: c[..., None])
        o = softmax_state.finalize(state, expand=lambda l: l[..., None])
        out[:, i0:i1] = o.permute(0, 3, 1, 2, 4).reshape(B, n, H, Dv).to(
            v.dtype)
    return out


def flash_prefill(q, k, v, *, scale, rescale=None, bq: int = 256,
                  bkv: int = 256):
    """K9.  q [B,S,H,D]; k [B,S,K,D]; v [B,S,K,Dv] with H = K·G.  Returns
    [B,S,H,Dv] in v's dtype.  CPU tensors run :func:`flash_prefill_plain`
    (``bq`` / ``bkv`` are its block sizes); CUDA tensors launch the kernel,
    which tiles at 128 rows whatever ``bq`` / ``bkv`` say and takes bf16 q,
    k, v at the library's (D, Dv) pairs with unit column strides and other
    strides on 16 bytes, and raises otherwise.  Inputs that require grad
    are refused on either device (:func:`flash_prefill_grad` trains)."""
    refuse_grad(q, k, v, what="flash_prefill",
                item="train through flash_prefill_grad, K9's autograd "
                     "Function (ROADMAP A7)")
    if device_of(q, k, v).type == "cpu":
        return flash_prefill_plain(q, k, v, scale=scale, rescale=rescale,
                                   bq=bq, bkv=bkv)
    _check_shapes(q, k, v)
    what = "flash_prefill"
    lib = build.library()
    check_widths(q, k, v.shape[-1], dense_widths(lib, "flash_prefill_widths"),
                 what=what)
    if v.dtype != torch.bfloat16:
        raise NotImplementedError(f"{what}: the CUDA kernel takes bf16 v, "
                                  f"got {v.dtype}")
    B, S, H, _ = q.shape
    K, Dv = k.shape[2], v.shape[-1]
    qb, qh, qs = dense_strides(q, "q", what=what)
    kb, kh, ks = dense_strides(k, "k", what=what)
    vb, vh, vs = dense_strides(v, "v", what=what)
    out = torch.empty(B, S, H, Dv, dtype=v.dtype, device=q.device)
    if out.numel() == 0:
        return out
    flash_prefill.launches += 1
    build.check(lib.flash_prefill(
        ptr(q), qb, qs, qh, ptr(k), kb, ks, kh, ptr(v), vb, vs, vh, ptr(out),
        B, S, H, K, q.shape[-1], Dv, float(scale), amla_flag(rescale),
        stream(q.device)), what)
    return out


flash_prefill.launches = 0


def flash_prefill_backward(q, k, v, dout, *, scale, q_block: int = 512):
    """The gradient of causal attention, (dq, dk, dv) in q's, k's and v's
    dtypes, in plain PyTorch.  For each ``q_block``-row query block the
    scores against the keys up to its last row are recomputed in fp32
    (TF32 off), P = softmax(S), and dS = P ∘ (dP − rowsum(dO ∘ O)) with
    dP = dO Vᵀ and O = P V of the same block; the keys past the block's
    last row have P = 0 and so no gradient, as in the reference's masked
    product.  dK and dV sum over each kv head's G query heads.  One
    block's fp32 P and dP are the memory peak; the sums run in a fixed
    order, so the result is deterministic.  q [B,S,H,D]; k [B,S,K,D];
    v [B,S,K,Dv]; dout [B,S,H,Dv]."""
    _check_shapes(q, k, v)
    B, S, H, D = q.shape
    K, Dv = k.shape[2], v.shape[-1]
    G = H // K
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    kf = k.float().transpose(1, 2)                      # [B,K,S,D]
    vf = v.float().transpose(1, 2)                      # [B,K,S,Dv]
    dq = torch.empty(B, S, H, D, **f32)
    dk = torch.zeros(B, K, S, D, **f32)
    dv = torch.zeros(B, K, S, Dv, **f32)
    kpos = torch.arange(S, device=dev)

    def rows(x, i0, n, w):                  # [B,n,H,w] -> [B,K,G*n,w]
        return x[:, i0:i0 + n].float().reshape(B, n, K, G, w).permute(
            0, 2, 3, 1, 4).reshape(B, K, G * n, w)

    with no_tf32():
        for i0 in range(0, S, q_block):
            i1 = min(i0 + q_block, S)
            n = i1 - i0
            qi, doi = rows(q, i0, n, D), rows(dout, i0, n, Dv)
            kj, vj = kf[:, :, :i1], vf[:, :, :i1]
            s = torch.matmul(qi, kj.transpose(-1, -2)).mul_(scale)
            qpos = i0 + torch.arange(G * n, device=dev) % n
            s.masked_fill_(qpos[:, None] < kpos[None, :i1], NEG_INF)
            p = torch.softmax(s, dim=-1)
            del s
            delta = (doi * torch.matmul(p, vj)).sum(-1, keepdim=True)
            dv[:, :, :i1] += torch.matmul(p.transpose(-1, -2), doi)
            ds = torch.matmul(doi, vj.transpose(-1, -2)).sub_(delta).mul_(p)
            del p
            dq[:, i0:i1] = (torch.matmul(ds, kj) * scale).reshape(
                B, K, G, n, D).permute(0, 3, 1, 2, 4).reshape(B, n, H, D)
            dk[:, :, :i1] += torch.matmul(ds.transpose(-1, -2), qi) * scale
            del ds
    return (dq.to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


class _FlashPrefillFn(torch.autograd.Function):
    """K9 with a gradient: the forward is :func:`flash_prefill` (grad mode
    is off inside it), the backward :func:`flash_prefill_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, scale, rescale, bq, bkv):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return flash_prefill(q, k, v, scale=scale, rescale=rescale, bq=bq,
                             bkv=bkv)

    @staticmethod
    def backward(ctx, dout):
        flash_prefill_grad.backwards += 1
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_prefill_backward(q, k, v, dout, scale=ctx.scale)
        return dq, dk, dv, None, None, None, None


def flash_prefill_grad(q, k, v, *, scale, rescale=None, bq: int = 256,
                       bkv: int = 256):
    """K9 that autograd can differentiate: the output of
    :func:`flash_prefill` (the same launch and count on CUDA tensors, the
    plain version on CPU ones), its gradient from
    :func:`flash_prefill_backward`; the backwards run are counted on
    ``flash_prefill_grad.backwards``."""
    return _FlashPrefillFn.apply(q, k, v, scale, rescale, bq, bkv)


flash_prefill_grad.backwards = 0
