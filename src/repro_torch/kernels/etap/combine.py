"""Split-KV phase 2 (K2): merge per-split (m, ℓ, Accᵀ) into O.

The port of ``repro/kernels/etap/combine.py`` for the transposed (ETAP)
orientation.  The CUDA kernel (``csrc/combine.cu``) replaces the Pallas
kernel at ``repro/kernels/etap/combine.py:60``; its header note says what
bounds it on the H100.  The merge math is
:func:`repro_torch.kernels.softmax_state.merge_splits`; ``rescale`` must be
the mode the partials were produced in.  With one split the merge is bitwise
the single-pass epilogue.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import softmax_state
from repro_torch.kernels.etap import build


def combine_splits_plain(m, l, acc, *, out_dtype, rescale=None):
    """Plain K2. m, l [B,n,H]; acc [B,n,Dv,H] fp32.  Returns O [B,H,Dv]."""
    _, l_g, acc_g = softmax_state.merge_splits(
        m, l, acc, axis=1, mode=softmax_state.resolve(rescale),
        expand=lambda w: w[:, :, None, :])
    return (acc_g / l_g[:, None, :]).transpose(1, 2).to(out_dtype)


def combine_splits(m, l, acc, *, out_dtype, rescale=None):
    """K2: CPU tensors take the plain version; CUDA tensors launch the
    kernel (bf16 output)."""
    dev = m.device
    if dev.type == "cpu":
        return combine_splits_plain(m, l, acc, out_dtype=out_dtype,
                                    rescale=rescale)
    if dev.type != "cuda":
        raise NotImplementedError(f"no combine path for device {dev}")
    if out_dtype != torch.bfloat16:
        raise NotImplementedError(
            f"combine_splits: the CUDA kernel writes bf16, asked {out_dtype}")
    B, n, H = m.shape
    Dv = acc.shape[2]
    if Dv % 32 or acc.shape != (B, n, Dv, H):
        raise ValueError(f"combine_splits: acc {tuple(acc.shape)} does not "
                         f"match m {tuple(m.shape)} (Dv a multiple of 32)")
    lib = build.library()
    m, l, acc = (x.float().contiguous() for x in (m, l, acc))
    out = torch.empty(B, H, Dv, dtype=out_dtype, device=dev)
    combine_splits.launches += 1
    build.check(lib.etap_combine_splits(
        m.data_ptr(), l.data_ptr(), acc.data_ptr(), out.data_ptr(), B, n, H,
        Dv, int(softmax_state.resolve(rescale) == "amla"),
        torch.cuda.current_stream(dev).cuda_stream), "etap_combine_splits")
    return out


combine_splits.launches = 0
