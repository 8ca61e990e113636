"""K10: the Mamba-1 selective scan — the port of
``repro/kernels/selective_scan/scan.py``.

:func:`selective_scan` computes what ``selective_scan_pallas`` computes,
y [B,L,D] and the state after the last step h [B,D,N], both fp32, over
the whole of L and D: the CUDA kernel (``kernels/csrc/selective_scan.cu``,
whose header says what bounds it on the H100) takes any L and a ragged D,
so nothing is padded.  It replaces the Pallas kernel at
``repro/kernels/selective_scan/scan.py:64``.  CPU tensors take the plain
version, :func:`selective_scan_plain`; the kernel has no backward, so
CUDA inputs that require grad are refused (ROADMAP A7).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import device_of, refuse_grad, stream
from repro_torch.kernels.selective_scan.ref import selective_scan_ref


def selective_scan_plain(dA, dBx, c):
    """Plain K10: the sequential recurrence in fp32.  Returns (y, h)."""
    return selective_scan_ref(dA, dBx, c, return_state=True)


def selective_scan(dA, dBx, c):
    """K10.  dA, dBx: [B,L,D,N] fp32; c: [B,L,N] fp32.  Returns (y [B,L,D],
    h [B,D,N]) fp32.  CPU tensors take the plain version; CUDA tensors
    launch the kernel, which takes contiguous fp32 dA and dBx and N a power
    of two up to 32, and raises otherwise."""
    dev = device_of(dA, dBx, c)
    if dev.type == "cpu":
        return selective_scan_plain(dA, dBx, c)
    refuse_grad(dA, dBx, c, what="selective_scan",
                item="the K10 backward, which Falcon-Mamba training on the "
                     "card needs, is ROADMAP A7")
    B, L, D, N = dA.shape
    if tuple(dBx.shape) != (B, L, D, N) or tuple(c.shape) != (B, L, N):
        raise ValueError(f"selective_scan: dA {tuple(dA.shape)}, dBx "
                         f"{tuple(dBx.shape)}, c {tuple(c.shape)} do not "
                         "agree")
    if N not in (1, 2, 4, 8, 16, 32) or L < 1:
        raise NotImplementedError(
            f"selective_scan: the CUDA kernel takes N a power of two <= 32 "
            f"and L >= 1, got N {N}, L {L}")
    for name, t in (("dA", dA), ("dBx", dBx), ("c", c)):
        if t.dtype != torch.float32:
            raise NotImplementedError(
                f"selective_scan: the CUDA kernel takes fp32, {name} is "
                f"{t.dtype}")
    for name, t in (("dA", dA), ("dBx", dBx)):
        if not t.is_contiguous():
            raise NotImplementedError(
                f"selective_scan: {name} must be contiguous (a copy of it "
                "is the size of the scan's whole input)")
    c = c.contiguous()                 # a view of the projection: B*L*N
    y = torch.empty(B, L, D, dtype=torch.float32, device=dev)
    h = torch.empty(B, D, N, dtype=torch.float32, device=dev)
    selective_scan.launches += 1
    build.check(build.library().selective_scan(
        dA.data_ptr(), dBx.data_ptr(), c.data_ptr(), y.data_ptr(),
        h.data_ptr(), B, L, D, N, stream(dev)), "selective_scan")
    return y, h


selective_scan.launches = 0
