"""Operand checks and launch plumbing shared by the CUDA kernel wrappers
(``etap``, ``combine``, ``flash_decode``, ``flash_prefill`` and
``selective_scan`` modules): device dispatch, the refusal of operands that
require grad, pointers, the current stream, the widths each kernel
library is built for, and the dense KV operand layout the dense kernels
take (row and kv-head strides, no copies), for bf16 rows and for int8 /
e4m3 code rows with their fp32 (scale, zp) rows."""
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


def refuse_grad(*tensors, what: str,
                item: str = "training through it is ROADMAP A7") -> None:
    """Raise ``NotImplementedError`` when an operand of a CUDA launch
    requires grad under grad mode.  A kernel called through ``ctypes``
    writes tensors outside the autograd graph, so a gradient through it
    would be dropped without a word.  Every CUDA kernel wrapper calls this
    on its CUDA branch (K9's autograd Function launches under no_grad)."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise NotImplementedError(
            f"{what}: the CUDA kernel has no backward and an operand "
            f"requires grad; {item}")


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
    K5/K6, ``flash_decode_widths`` for K7/K8, ``flash_prefill_widths`` for
    K9, ``etap_paged_sepv_widths`` for K1/K3/K4 over separate K and V
    pools) says its kernels are built for."""
    buf = (ctypes.c_int * (2 * _MAX_WIDTHS))()
    n = getattr(lib, fn)(buf, _MAX_WIDTHS)
    return frozenset((buf[2 * i], buf[2 * i + 1])
                     for i in range(min(n, _MAX_WIDTHS)))


# The code types of a quantized operand, as the kernels number them.
CODES = {torch.int8: 0, torch.float8_e4m3fn: 1}


def check_widths(q, kv, dv, widths, *, what):
    """The kernels take q and KV at one of ``widths``, their (Dk, Dv)
    pairs (the fused paged ones DeepSeek's latent (576, 512) only): bf16 q
    and KV, or, over an int8 or e4m3 code operand ``kv``, bf16 or fp32
    q."""
    if kv.dtype in CODES:
        ok, want = q.dtype in (torch.bfloat16, torch.float32), \
            "bf16 or fp32 q over int8 or float8_e4m3fn codes"
    else:
        ok, want = q.dtype == kv.dtype == torch.bfloat16, "bf16 q and KV"
    if not ok:
        raise NotImplementedError(
            f"{what}: the CUDA kernel takes {want}, got {q.dtype} and "
            f"{kv.dtype}")
    got = (q.shape[-1], dv)
    if got not in widths or kv.shape[-1] != got[0]:
        raise NotImplementedError(
            f"{what}: the CUDA kernel takes (Dk, Dv) in {sorted(widths)}, "
            f"got ({q.shape[-1]}/{kv.shape[-1]}, {dv})")


def _strides(t):
    """(batch, kv-head, row) strides of a dense operand: [BG, S, D], or a
    GQA cache [B, S, K, D] read in place as its grouped form (row
    bg = b·K + kh at b·stride(0) + kh·stride(2))."""
    if t.dim() == 4:
        return t.stride(0), t.stride(2), t.stride(1)
    return t.stride(0), 0, t.stride(1)


def dense_strides(t, name, *, what):
    """The strides of a dense Q, K or V operand (bf16 rows or 1-byte
    codes), which the kernels read in 16-byte pieces: unit column stride,
    other strides and the base on 16 bytes."""
    if t.stride(-1) != 1 or any(s * t.element_size() % 16
                                for s in t.stride()[:-1]):
        raise NotImplementedError(
            f"{what}: {name} needs unit column stride and other strides of "
            f"a multiple of 16 bytes, got {t.stride()} of {t.dtype}")
    ptr(t)
    return _strides(t)


def _pair_strides(t, rows, name, *, what):
    """The strides (in floats) of the fp32 (scale, zp) rows of a code
    operand ``rows``: [..., 2] beside its codes, each pair one 8-byte load
    (so the pair's stride is 1 and the others even, the base on 8
    bytes)."""
    if t.dtype != torch.float32 or tuple(t.shape) != (*rows.shape[:-1], 2):
        raise NotImplementedError(
            f"{what}: {name} must be fp32 {(*rows.shape[:-1], 2)} beside "
            f"its codes, got {t.dtype} {tuple(t.shape)}")
    if t.stride(-1) != 1 or any(s % 2 for s in t.stride()[:-1]) or \
            t.data_ptr() % 8:
        raise NotImplementedError(
            f"{what}: {name} needs 8-byte (scale, zp) rows (unit last "
            f"stride, even others, an 8-byte base), got {t.stride()}")
    return _strides(t)


def dense_operands(q, k, v, length, *, widths: str, what, k_sz=None,
                   v_sz=None):
    """Check a dense decode's operands and return the library and the
    kernels' leading arguments (q, k, kb, ldk, v, vb, ldv, S, lengths, kvh,
    kh, vh, Dk, Dv, and for code rows the pairs' kz, zb, zh, ldz, vz, vzb,
    vzh, ldvz, code type and whether q is fp32) plus the contiguous q and
    lengths the launch must keep alive.  q [BG,H,Dk]; k [BG,S,Dk] and v
    [BG,S,Dv], or a GQA cache k [B,S,K,Dk], v [B,S,K,Dv] with BG = B·K
    (grouped in place, as :func:`repro_torch.kernels.splitkv.grouped`
    copies it); length [BG]; ``k_sz`` / ``v_sz`` the (scale, zp) rows of
    int8 / e4m3 code operands k / v ([..., 2] beside their codes).
    ``widths`` names the library's width query (:func:`dense_widths`).  K
    and V are read in place through their strides; a V that is K's own
    first Dv columns (the MLA latent, ``v = k[..., :Dv]``, with K's pairs)
    is passed as null and read from the K tile."""
    lib = build.library()
    if k.dim() not in (3, 4):
        raise ValueError(f"{what}: k must be [BG,S,D] or [B,S,K,D], got "
                         f"{tuple(k.shape)}")
    check_widths(q, k, v.shape[-1], dense_widths(lib, widths), what=what)
    quant = k.dtype in CODES
    if v.dtype != k.dtype or quant != (k_sz is not None) or \
            quant != (v_sz is not None):
        raise NotImplementedError(
            f"{what}: V must be K's type ({k.dtype}, got {v.dtype}), with "
            "(scale, zp) rows beside code operands only")
    kvh = k.shape[2] if k.dim() == 4 else 1
    BG, S = k.shape[0] * kvh, k.shape[1]
    if v.shape[:-1] != k.shape[:-1] or q.shape[0] != BG or \
            tuple(length.shape) != (BG,):
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, length {tuple(length.shape)} "
                         "do not agree")
    kb, kh, ldk = dense_strides(k, "k", what=what)
    vb, vh, ldv = dense_strides(v, "v", what=what)
    fused = v.data_ptr() == k.data_ptr() and (vb, vh, ldv) == (kb, kh, ldk)
    q, lengths = q.contiguous(), i32(length)
    args = [ptr(q), k.data_ptr(), kb, ldk, None if fused else v.data_ptr(),
            vb, ldv, S, lengths.data_ptr(), kvh, kh, vh, q.shape[-1],
            v.shape[-1]]
    if quant:
        zb, zh, ldz = _pair_strides(k_sz, k, "k_sz", what=what)
        vzb, vzh, ldvz = _pair_strides(v_sz, v, "v_sz", what=what)
        if fused and (v_sz.data_ptr(), vzb, vzh, ldvz) != \
                (k_sz.data_ptr(), zb, zh, ldz):
            raise NotImplementedError(
                f"{what}: V read from K's rows takes K's (scale, zp) rows")
        args += [k_sz.data_ptr(), zb, zh, ldz,
                 None if fused else v_sz.data_ptr(), vzb, vzh, ldvz,
                 CODES[k.dtype], int(q.dtype == torch.float32)]
    return lib, args, (q, lengths)


def dense_single(wrapper, what: str, widths: str, q, k, v, length, *,
                 scale, rescale, k_sz=None, v_sz=None):
    """Launch the single-pass dense kernel ``what`` (the library's entry
    point: K5, K7, or over code rows K5q, K7q) on operands
    :func:`dense_operands` checks, counting it on ``wrapper.launches``.
    Returns O [BG,H,Dv] in v's dtype, fp32 over codes."""
    refuse_grad(q, k, v, k_sz, v_sz, what=what)
    lib, args, keep = dense_operands(q, k, v, length, widths=widths,
                                     what=what, k_sz=k_sz, v_sz=v_sz)
    B, H, _ = q.shape
    dtype = v.dtype if k_sz is None else torch.float32
    out = torch.empty(B, H, v.shape[-1], dtype=dtype, device=q.device)
    wrapper.launches += 1
    build.check(getattr(lib, what)(*args, ptr(out), B, H, float(scale),
                                   amla_flag(rescale), stream(q.device)),
                what)
    del keep
    return out


def dense_partial(wrapper, what: str, widths: str, q, k, v, length, *,
                  plan, transposed: bool, scale, rescale, k_sz=None,
                  v_sz=None):
    """Launch the dense split-KV phase-1 kernel ``what`` (K6, K8, or over
    code rows K6q, K8q) under ``plan``, counting it on
    ``wrapper.launches``.  Returns fp32 (m [BG,n,H], l [BG,n,H], acc
    [BG,n,Dv,H] when ``transposed`` (ETAP), else [BG,n,H,Dv])."""
    refuse_grad(q, k, v, k_sz, v_sz, what=what)
    lib, args, keep = dense_operands(q, k, v, length, widths=widths,
                                     what=what, k_sz=k_sz, v_sz=v_sz)
    tps = dense_split_tiles(k.shape[1], plan, what=what)
    B, H, _ = q.shape
    n, Dv = plan.n_splits, v.shape[-1]
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.empty(B, n, H, **f32)
    l = torch.empty(B, n, H, **f32)
    acc = torch.empty((B, n, Dv, H) if transposed else (B, n, H, Dv), **f32)
    wrapper.launches += 1
    build.check(getattr(lib, what)(
        *args, m.data_ptr(), l.data_ptr(), acc.data_ptr(), B, H, n, tps,
        float(scale), amla_flag(rescale), stream(q.device)), what)
    del keep
    return m, l, acc


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
