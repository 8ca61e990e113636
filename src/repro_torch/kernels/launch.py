"""Operand checks and launch plumbing shared by the CUDA kernel wrappers
(``etap``, ``combine`` and ``flash_decode`` modules): device dispatch,
pointers, the current stream, the widths each kernel library is built for,
and the dense KV operand layout the dense kernels take (row and kv-head
strides, no copies)."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, softmax_state


def device_of(*tensors) -> torch.device:
    """The one device of the operands (None entries skipped); CPU or CUDA."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t is not None and t.device != dev:
            raise ValueError(f"operands on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no kernel path for device {dev}")
    return dev


def ptr(t) -> int:
    if t.data_ptr() % 16:
        raise ValueError("CUDA kernel operands must be 16-byte aligned")
    return t.data_ptr()


def stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def i32(x):
    return x.to(torch.int32).contiguous()


def amla_flag(rescale) -> int:
    return int(softmax_state.resolve(rescale) == "amla")


_MAX_WIDTHS = 16


@functools.lru_cache(maxsize=None)
def dense_widths(lib, fn: str) -> frozenset:
    """The (Dk, Dv) pairs the library's ``fn`` (``etap_dense_widths`` for
    K5/K6, ``flash_decode_widths`` for K7/K8) says its kernels are built
    for."""
    buf = (ctypes.c_int * (2 * _MAX_WIDTHS))()
    n = getattr(lib, fn)(buf, _MAX_WIDTHS)
    return frozenset((buf[2 * i], buf[2 * i + 1])
                     for i in range(min(n, _MAX_WIDTHS)))


def check_widths(q, kv, dv, widths, *, what):
    """The kernels take bf16 q and KV at one of ``widths``, their (Dk, Dv)
    pairs (the paged ones DeepSeek's latent (576, 512) only)."""
    if q.dtype != torch.bfloat16 or kv.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"{what}: the CUDA kernel takes bf16 q and KV, got {q.dtype} "
            f"and {kv.dtype}")
    got = (q.shape[-1], dv)
    if got not in widths or kv.shape[-1] != got[0]:
        raise NotImplementedError(
            f"{what}: the CUDA kernel takes (Dk, Dv) in {sorted(widths)}, "
            f"got ({q.shape[-1]}/{kv.shape[-1]}, {dv})")


def _dense_strides(t, name, *, what):
    """(batch, kv-head, row) strides of a dense K or V operand: [BG, S, D],
    or a GQA cache [B, S, K, D] read in place as its grouped form (row
    bg = b·K + kh at b·stride(0) + kh·stride(2))."""
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]):
        raise NotImplementedError(
            f"{what}: {name} needs unit column stride and other strides "
            f"that are multiples of 8, got {t.stride()}")
    ptr(t)
    if t.dim() == 4:
        return t.stride(0), t.stride(2), t.stride(1)
    return t.stride(0), 0, t.stride(1)


def dense_operands(q, k, v, length, *, widths: str, what):
    """Check a dense decode's operands and return the library and the
    kernels' leading arguments (q, k, kb, ldk, v, vb, ldv, S, lengths, kvh,
    kh, vh, Dk, Dv) plus the contiguous q and lengths the launch must keep
    alive.  q [BG,H,Dk]; k [BG,S,Dk] and v [BG,S,Dv], or a GQA cache
    k [B,S,K,Dk], v [B,S,K,Dv] with BG = B·K (grouped in place, as
    :func:`repro_torch.kernels.splitkv.grouped` copies it); length [BG].
    ``widths`` names the library's width query (:func:`dense_widths`).  K
    and V are read in place through their strides; a V that is K's own
    first Dv columns (the MLA latent, ``v = k[..., :Dv]``) is passed as
    null and read from the K tile."""
    lib = build.library()
    if k.dim() not in (3, 4):
        raise ValueError(f"{what}: k must be [BG,S,D] or [B,S,K,D], got "
                         f"{tuple(k.shape)}")
    check_widths(q, k, v.shape[-1], dense_widths(lib, widths), what=what)
    if v.dtype != torch.bfloat16:
        raise NotImplementedError(f"{what}: V must be bf16, got {v.dtype}")
    kvh = k.shape[2] if k.dim() == 4 else 1
    BG, S = k.shape[0] * kvh, k.shape[1]
    if v.shape[:-1] != k.shape[:-1] or q.shape[0] != BG or \
            tuple(length.shape) != (BG,):
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, length {tuple(length.shape)} "
                         "do not agree")
    kb, kh, ldk = _dense_strides(k, "k", what=what)
    vb, vh, ldv = _dense_strides(v, "v", what=what)
    fused = v.data_ptr() == k.data_ptr() and (vb, vh, ldv) == (kb, kh, ldk)
    q, lengths = q.contiguous(), i32(length)
    args = [ptr(q), k.data_ptr(), kb, ldk, None if fused else v.data_ptr(),
            vb, ldv, S, lengths.data_ptr(), kvh, kh, vh, q.shape[-1],
            v.shape[-1]]
    return lib, args, (q, lengths)


def dense_split_tiles(S: int, plan, *, what) -> int:
    """64-row kernel tiles per split of a dense split-KV launch under
    ``plan`` (a :class:`repro_torch.kernels.etap.schedule.SplitPlan`): each
    split covers ``nb_per_split`` blocks of ``block`` rows, so more than one
    split needs split boundaries on 64-row tiles."""
    if plan.padded_s < S:
        raise ValueError(f"{what}: the split plan covers {plan.padded_s} of "
                         f"{S} rows")
    seg = plan.nb_per_split * plan.block
    if plan.n_splits > 1 and seg % 64:
        raise NotImplementedError(
            f"{what}: split boundaries every {seg} rows do not fall on the "
            "kernel's 64-row tiles")
    return -(-seg // 64)
