"""Split-KV phase 2 (K2): merge per-split (m, ℓ, Acc) into O.

The port of ``repro/kernels/etap/combine.py`` in both of the reference's
orientations: :func:`combine_splits` takes the ETAP partials' transposed
Accᵀ [B,n,Dv,H] (K1, K6), :func:`combine_splits_std` the untransposed
baseline's Acc [B,n,H,Dv] (K8) — the reference's ``transposed=True`` and
``transposed=False``.  Their CUDA kernel (``kernels/csrc/combine.cu``,
one template over the orientation) replaces the Pallas kernel at
``repro/kernels/etap/combine.py:60``; its header note says what bounds it
on the H100.  The merge math is
:func:`repro_torch.kernels.softmax_state.merge_splits`; ``rescale`` must be
the mode the partials were produced in.  With one split the merge is bitwise
the single-pass epilogue; on the card each output is one thread's
in-order sum, so a row's bits depend neither on its batch nor on the
orientation.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import softmax_state
from repro_torch.kernels import build
from repro_torch.kernels.launch import (amla_flag, device_of, refuse_grad,
                                        stream)


def combine_splits_plain(m, l, acc, *, out_dtype, rescale=None):
    """Plain K2, transposed. m, l [B,n,H]; acc [B,n,Dv,H] fp32.  Returns
    O [B,H,Dv]."""
    _, l_g, acc_g = softmax_state.merge_splits(
        m, l, acc, axis=1, mode=softmax_state.resolve(rescale),
        expand=lambda w: w[:, :, None, :])
    return (acc_g / l_g[:, None, :]).transpose(1, 2).to(out_dtype)


def combine_splits_std_plain(m, l, acc, *, out_dtype, rescale=None):
    """Plain K2, [n,H,Dv] orientation. m, l [B,n,H]; acc [B,n,H,Dv] fp32.
    Returns O [B,H,Dv]."""
    _, l_g, acc_g = softmax_state.merge_splits(
        m, l, acc, axis=1, mode=softmax_state.resolve(rescale),
        expand=lambda w: w[..., None])
    return (acc_g / l_g[..., None]).to(out_dtype)


def _launch(wrapper, fn, m, l, acc, Dv, *, out_dtype, rescale, acc_shape,
            what, f32_out=False):
    """Launch ``fn``; ``f32_out``: the kernel also writes fp32 (it then
    takes the output type as an argument)."""
    dev = device_of(m, l, acc)
    if dev.type != "cuda":
        raise NotImplementedError(f"no combine path for device {dev}")
    dtypes = (torch.bfloat16, torch.float32) if f32_out else (torch.bfloat16,)
    if out_dtype not in dtypes:
        raise NotImplementedError(
            f"{what}: the CUDA kernel writes {dtypes}, asked {out_dtype}")
    B, n, H = m.shape
    if Dv % 32 or tuple(acc.shape) != acc_shape:
        raise ValueError(f"{what}: acc {tuple(acc.shape)} does not match "
                         f"m {tuple(m.shape)} (Dv a multiple of 32)")
    m, l, acc = (x.float().contiguous() for x in (m, l, acc))
    out = torch.empty(B, H, Dv, dtype=out_dtype, device=dev)
    wrapper.launches += 1
    f32 = (int(out_dtype == torch.float32),) if f32_out else ()
    build.check(fn(m.data_ptr(), l.data_ptr(), acc.data_ptr(), out.data_ptr(),
                   B, n, H, Dv, amla_flag(rescale), *f32, stream(dev)), what)
    return out


def combine_splits(m, l, acc, *, out_dtype, rescale=None):
    """K2, transposed: CPU tensors take the plain version; CUDA tensors
    launch the kernel (bf16 or fp32 output)."""
    if device_of(m, l, acc).type == "cpu":
        return combine_splits_plain(m, l, acc, out_dtype=out_dtype,
                                    rescale=rescale)
    refuse_grad(m, l, acc, what="etap_combine_splits")
    B, n, H = m.shape
    Dv = acc.shape[2]
    return _launch(combine_splits, build.library().etap_combine_splits,
                   m, l, acc, Dv, out_dtype=out_dtype, rescale=rescale,
                   acc_shape=(B, n, Dv, H), what="etap_combine_splits",
                   f32_out=True)


def combine_splits_std(m, l, acc, *, out_dtype, rescale=None):
    """K2, [n,H,Dv] orientation (the untransposed baseline's partials):
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16 or fp32 output)."""
    if device_of(m, l, acc).type == "cpu":
        return combine_splits_std_plain(m, l, acc, out_dtype=out_dtype,
                                        rescale=rescale)
    refuse_grad(m, l, acc, what="etap_combine_splits_rows")
    B, n, H = m.shape
    Dv = acc.shape[3]
    return _launch(combine_splits_std,
                   build.library().etap_combine_splits_rows, m, l, acc, Dv,
                   out_dtype=out_dtype, rescale=rescale,
                   acc_shape=(B, n, H, Dv), what="etap_combine_splits_rows",
                   f32_out=True)


combine_splits.launches = 0
combine_splits_std.launches = 0
