"""Plain oracle for the selective scan — the port of
``repro/kernels/selective_scan/ref.py``: the direct sequential recurrence,
one step at a time.

    h_t = dA_t ⊙ h_{t-1} + dBx_t          dA, dBx: [B, L, D, N]
    y_t = Σ_n C_{t,n} · h_{t,d,n}         C: [B, L, N] → y: [B, L, D]

The update is an eager multiply, then an eager add (two launches on the
card, never an FMA), so ``h_last`` is bitwise the CUDA kernel's.  The sum
over N is a halving tree — n + N/2 onto n, then n + N/4, ... — the order
of the kernel's warp shuffles, so ``y`` is bitwise the kernel's too (the
reference's einsum sums in another order: equal within fp32 rounding).
"""
from __future__ import annotations

import torch


def selective_scan_ref(dA, dBx, c, dtype=torch.float32, *,
                       return_state: bool = False):
    """dA, dBx: [B,L,D,N]; c: [B,L,N] -> y [B,L,D], computed in ``dtype``;
    with ``return_state`` also the state after the last step, [B,D,N]."""
    dA, dBx, c = (t.to(dtype) for t in (dA, dBx, c))
    B, L, D, N = dA.shape
    h = torch.zeros(B, D, N, dtype=dtype, device=dA.device)
    y = torch.empty(B, L, D, dtype=dtype, device=dA.device)
    for t in range(L):
        h = dA[:, t] * h + dBx[:, t]
        p = h * c[:, t, None, :]                          # [B,D,N]
        n = N
        while n > 1:
            n //= 2
            p = p[..., :n] + p[..., n:2 * n]
        y[:, t] = p[..., 0]
    return (y, h) if return_state else y
