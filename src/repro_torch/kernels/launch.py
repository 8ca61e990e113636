"""Operand checks and launch plumbing shared by the CUDA kernel wrappers
(``etap``, ``combine`` and ``flash_decode`` modules): device dispatch,
pointers, the current stream, and the dense KV operand layout the dense
kernels take (row strides, no copies)."""
from __future__ import annotations

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


def check_widths(lib, q, kv, dv, *, what):
    """The kernels take bf16 at DeepSeek's latent widths (Dk 576, Dv 512)."""
    if q.dtype != torch.bfloat16 or kv.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"{what}: the CUDA kernel takes bf16 q and KV, got {q.dtype} "
            f"and {kv.dtype}")
    want = (lib.etap_dk(), lib.etap_dv())
    got = (q.shape[-1], dv)
    if got != want or kv.shape[-1] != want[0]:
        raise NotImplementedError(
            f"{what}: the CUDA kernel takes (Dk, Dv) = {want}, got "
            f"({q.shape[-1]}/{kv.shape[-1]}, {dv})")


def dense_operands(q, k, v, length, *, what):
    """Check a dense decode's operands (q [B,H,Dk], k [B,S,Dk], v [B,S,Dv],
    length [B]) and return the library and the kernels' leading arguments
    (q, k, kb, ldk, v, vb, ldv, S, lengths) plus the contiguous q and
    lengths the launch must keep alive.  K and V are read in place through
    their strides; a V that is K's own first Dv columns (the MLA latent,
    ``v = k[..., :Dv]``) is passed as null and read from the K tile."""
    lib = build.library()
    check_widths(lib, q, k, v.shape[-1], what=what)
    if v.dtype != torch.bfloat16:
        raise NotImplementedError(f"{what}: V must be bf16, got {v.dtype}")
    B, S, _ = k.shape
    if v.shape[:2] != (B, S) or q.shape[0] != B or length.shape != (B,):
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, length {tuple(length.shape)} "
                         "do not agree")
    for name, t in (("k", k), ("v", v)):
        if t.stride(2) != 1 or t.stride(1) % 8 or t.stride(0) % 8:
            raise NotImplementedError(
                f"{what}: {name} needs unit column stride and row and batch "
                f"strides that are multiples of 8, got {t.stride()}")
        ptr(t)
    fused = (v.data_ptr() == k.data_ptr()
             and v.stride()[:2] == k.stride()[:2])
    q, lengths = q.contiguous(), i32(length)
    args = [ptr(q), k.data_ptr(), k.stride(0), k.stride(1),
            None if fused else v.data_ptr(), v.stride(0), v.stride(1), S,
            lengths.data_ptr()]
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
