"""The selective scan's entry point — the port of
``repro/kernels/selective_scan/ops.py``, with the reference's contract:
y [B,L,D] fp32 always, the final state only when ``L % chunk == 0``.

The reference pads L and D to its TPU blocks (zero dA/dBx rows past L, so
the state after the padding is 0, not the state at step L: hence the
contract).  Here no block is padded: the CUDA kernel scans L as it is and
takes a ragged D, so no copy of the 4 GB inputs is made at falcon's
widths, and ``chunk`` only decides whether the state is returned.
"""
from __future__ import annotations

from repro_torch.kernels.selective_scan import scan


def selective_scan(dA, dBx, c, *, chunk: int = 256):
    """dA, dBx: [B,L,D,N]; c: [B,L,N] -> (y [B,L,D] fp32, h [B,D,N] fp32
    or None when L is not a multiple of ``min(chunk, L)``).  CPU tensors
    run the plain version, CUDA tensors the kernel (K10)."""
    L = dA.shape[1]
    y, h = scan.selective_scan(dA, dBx, c)
    return y, (h if L % min(chunk, L) == 0 else None)
