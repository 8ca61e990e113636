"""Paged MLA-fused ETAP kernels: wrappers, launch counters and plain versions.

The port of ``repro/kernels/etap/etap.py`` for the paged MLA-fused fp path.
Three kernels, all one CUDA body (``csrc/etap.cu``, whose header note says
what bounds each on the H100 and how the design answers it):

  K3 :func:`etap_decode_mla_paged`   single-pass paged decode
     (replaces ``repro/kernels/etap/etap.py:237``, ``_paged_call``)
  K1 :func:`etap_paged_partial`      split-KV phase 1
     (replaces ``repro/kernels/etap/etap.py:713``)
  K4 :func:`etap_prefill_mla_paged` / :func:`etap_verify_mla_paged`
     chunked paged prefill and draft verify
     (replaces ``repro/kernels/etap/etap.py:430``, ``_prefill_call``)

Each wrapper dispatches on the device of its operands: CPU tensors run the
``*_plain`` version, CUDA tensors launch the kernel (or raise on a shape or
dtype the kernel does not take).  There is no fallback.  The plain versions
walk the pool page by page through the block table with
:func:`repro_torch.kernels.softmax_state.update`, the recurrence the kernel
runs.  Each wrapper's ``launches`` attribute counts its kernel launches.

Column convention: a query tile is [B, C, Dk] with C columns; column c is
live for key position kpos iff ``kpos <= horizon[b, c]`` — decode uses
``lengths - 1``, prefill ``start + c // H``, verify the explicit ``qpos``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import softmax_state
from repro_torch.kernels.etap import build

NEG_INF = softmax_state.NEG_INF


# ----------------------------------------------------------- plain versions
def _walk_plain(q, pool, table, horizon, pages, *, scale, dv, mode):
    """Online-softmax walk of ``pages`` (table columns) for query columns
    q [B, C, Dk] with per-column horizons [B, C].  Returns the fp32 state
    (m [B,C], l [B,C], accT [B,dv,C])."""
    B, C, _ = q.shape
    page = pool.shape[1]
    qf = q.float()
    arange = torch.arange(page, device=q.device, dtype=torch.int32)
    state = softmax_state.init((B, C), (B, dv, C), device=q.device)
    for j in pages:
        blk = pool[table[:, j].long()].float()                 # [B,page,Dk]
        sT = torch.einsum("bpd,bcd->bpc", blk, qf) * scale     # Sᵀ = K·Qᵀ
        kpos = j * page + arange
        live = kpos[None, :, None] <= horizon[:, None, :]
        sT = torch.where(live, sT, NEG_INF)
        v = blk[..., :dv]
        state = softmax_state.update(
            state, sT, lambda p, v=v: torch.einsum("bpv,bpc->bvc", v, p),
            axis=1, mode=mode, expand=lambda c: c[:, None, :])
    return state


def _finalize(state, dtype):
    """O = (Accᵀ / ℓ)ᵀ in the output dtype: [B, C, dv]."""
    oT = softmax_state.finalize(state, expand=lambda l: l[:, None, :])
    return oT.transpose(1, 2).to(dtype)


def _decode_horizon(lengths, H):
    return (lengths.to(torch.int32) - 1)[:, None].expand(-1, H)


def _chunk_horizon(start, qpos, Cq, H, device):
    if qpos is not None:
        return qpos.to(torch.int32).repeat_interleave(H, dim=1)  # [B, Cq*H]
    col = torch.arange(Cq * H, device=device, dtype=torch.int32) // H
    return start.to(torch.int32)[:, None] + col[None, :]


def etap_decode_mla_paged_plain(q, kv_pool, dv, table, lengths, *, scale,
                                rescale=None):
    """Plain K3. q [B,H,Dk]; pool [N,page,Dk]; table [B,nb]; lengths [B].
    Returns [B,H,dv] in the pool dtype."""
    mode = softmax_state.resolve(rescale)
    H = q.shape[1]
    state = _walk_plain(q, kv_pool, table, _decode_horizon(lengths, H),
                        range(table.shape[1]), scale=scale, dv=dv, mode=mode)
    return _finalize(state, kv_pool.dtype)


def etap_paged_partial_plain(q, kv_pool, dv, table, lengths, *, scale,
                             n_splits, rescale=None):
    """Plain K1.  The table width must be a multiple of ``n_splits``; split
    s walks columns [s·npb, (s+1)·npb).  Returns fp32 (m [B,n,H],
    l [B,n,H], accT [B,n,dv,H])."""
    mode = softmax_state.resolve(rescale)
    nb = table.shape[1]
    if nb % n_splits:
        raise ValueError(f"table width {nb} not a multiple of {n_splits}")
    npb = nb // n_splits
    horizon = _decode_horizon(lengths, q.shape[1])
    parts = [_walk_plain(q, kv_pool, table, horizon,
                         range(s * npb, (s + 1) * npb), scale=scale, dv=dv,
                         mode=mode) for s in range(n_splits)]
    return tuple(torch.stack(x, dim=1) for x in zip(*parts, strict=True))


def etap_prefill_mla_paged_plain(q, kv_pool, dv, table, start, *, scale,
                                 rescale=None, qpos=None):
    """Plain K4. q [B,Cq,H,Dk]; start [B] rows in the pool before the chunk
    (whose rows are already appended); qpos [B,Cq] explicit per-row
    horizons (verify) or None (prefill).  Returns [B,Cq,H,dv]."""
    mode = softmax_state.resolve(rescale)
    B, Cq, H, Dk = q.shape
    horizon = _chunk_horizon(start, qpos, Cq, H, q.device)
    state = _walk_plain(q.reshape(B, Cq * H, Dk), kv_pool, table, horizon,
                        range(table.shape[1]), scale=scale, dv=dv, mode=mode)
    return _finalize(state, kv_pool.dtype).reshape(B, Cq, H, dv)


# ----------------------------------------------------------- CUDA launches
def _device_of(*tensors) -> torch.device:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t is not None and t.device != dev:
            raise ValueError(f"operands on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no ETAP path for device {dev}")
    return dev


def _ptr(t) -> int:
    if t.data_ptr() % 16:
        raise ValueError("CUDA ETAP operands must be 16-byte aligned")
    return t.data_ptr()


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_cuda(q, kv_pool, dv, *, what):
    lib = build.library()
    if q.dtype != torch.bfloat16 or kv_pool.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"{what}: the CUDA kernel takes bf16 q and pool, got {q.dtype} "
            f"and {kv_pool.dtype}")
    want = (lib.etap_dk(), lib.etap_dv(), lib.etap_page())
    got = (q.shape[-1], dv, kv_pool.shape[1])
    if got != want or kv_pool.shape[2] != want[0]:
        raise NotImplementedError(
            f"{what}: the CUDA kernel takes (Dk, Dv, page) = {want}, got "
            f"{got} (DeepSeek's latent width at the serve default page)")
    return lib


def _i32(x):
    return x.to(torch.int32).contiguous()


def _amla(rescale) -> int:
    return int(softmax_state.resolve(rescale) == "amla")


def etap_decode_mla_paged(q, kv_pool, dv, table, lengths, *, scale,
                          rescale=None):
    """K3: single-pass paged MLA-fused ETAP decode. q [B,H,Dk]; pool
    [N,page,Dk]; table [B,nb] (null block 0 in padded entries); lengths [B].
    Returns [B,H,dv] in the pool dtype."""
    dev = _device_of(q, kv_pool, table, lengths)
    if dev.type == "cpu":
        return etap_decode_mla_paged_plain(q, kv_pool, dv, table, lengths,
                                           scale=scale, rescale=rescale)
    lib = _check_cuda(q, kv_pool, dv, what="etap_decode_mla_paged")
    B, H, _ = q.shape
    q, pool, table, lengths = (q.contiguous(), kv_pool.contiguous(),
                               _i32(table), _i32(lengths))
    out = torch.empty(B, H, dv, dtype=kv_pool.dtype, device=dev)
    etap_decode_mla_paged.launches += 1
    build.check(lib.etap_decode_mla_paged(
        _ptr(q), _ptr(pool), table.data_ptr(), lengths.data_ptr(), _ptr(out),
        B, H, table.shape[1], float(scale), _amla(rescale), _stream(dev)),
        "etap_decode_mla_paged")
    return out


def etap_paged_partial(q, kv_pool, dv, table, lengths, *, scale, n_splits,
                       rescale=None):
    """K1: split-KV phase 1 over the paged latent pool.  The table width
    must be a multiple of ``n_splits`` (``ops._pad_table`` pads it with
    null blocks).  Returns fp32 (m [B,n,H], l [B,n,H], accT [B,n,dv,H])."""
    dev = _device_of(q, kv_pool, table, lengths)
    if dev.type == "cpu":
        return etap_paged_partial_plain(q, kv_pool, dv, table, lengths,
                                        scale=scale, n_splits=n_splits,
                                        rescale=rescale)
    lib = _check_cuda(q, kv_pool, dv, what="etap_paged_partial")
    B, H, _ = q.shape
    nb = table.shape[1]
    if nb % n_splits:
        raise ValueError(f"table width {nb} not a multiple of {n_splits}")
    q, pool, table, lengths = (q.contiguous(), kv_pool.contiguous(),
                               _i32(table), _i32(lengths))
    f32 = dict(dtype=torch.float32, device=dev)
    m = torch.empty(B, n_splits, H, **f32)
    l = torch.empty(B, n_splits, H, **f32)
    acc = torch.empty(B, n_splits, dv, H, **f32)
    etap_paged_partial.launches += 1
    build.check(lib.etap_paged_partial(
        _ptr(q), _ptr(pool), table.data_ptr(), lengths.data_ptr(),
        m.data_ptr(), l.data_ptr(), acc.data_ptr(), B, H, nb, n_splits,
        float(scale), _amla(rescale), _stream(dev)), "etap_paged_partial")
    return m, l, acc


def _prefill(q, kv_pool, dv, table, start, qpos, *, scale, rescale, what):
    dev = _device_of(q, kv_pool, table, start, qpos)
    if dev.type == "cpu":
        return etap_prefill_mla_paged_plain(q, kv_pool, dv, table, start,
                                            scale=scale, rescale=rescale,
                                            qpos=qpos)
    lib = _check_cuda(q, kv_pool, dv, what=what)
    B, Cq, H, Dk = q.shape
    C = Cq * H
    q = q.reshape(B, C, Dk).contiguous()
    pool, table, start = kv_pool.contiguous(), _i32(table), _i32(start)
    cols = _chunk_horizon(start, qpos, Cq, H, dev).contiguous() \
        if qpos is not None else None
    out = torch.empty(B, C, dv, dtype=kv_pool.dtype, device=dev)
    etap_prefill_mla_paged.launches += 1
    build.check(lib.etap_prefill_mla_paged(
        _ptr(q), _ptr(pool), table.data_ptr(), start.data_ptr(),
        cols.data_ptr() if cols is not None else None, _ptr(out),
        B, C, H, table.shape[1], float(scale), _amla(rescale), _stream(dev)),
        what)
    return out.reshape(B, Cq, H, dv)


def etap_prefill_mla_paged(q, kv_pool, dv, table, start, *, scale,
                           rescale=None):
    """K4: chunked paged MLA-fused prefill. q [B,Cq,H,Dk]; start [B] tokens
    in the pool before the chunk (the chunk's own rows already appended).
    Causal: row c attends to positions <= start + c.  Returns
    [B,Cq,H,dv]."""
    return _prefill(q, kv_pool, dv, table, start, None, scale=scale,
                    rescale=rescale, what="etap_prefill_mla_paged")


def etap_verify_mla_paged(q, kv_pool, dv, table, start, qpos, *, scale,
                          rescale=None):
    """K4 with an explicit per-row horizon: row c attends to positions
    <= qpos[b, c].  A linear qpos (start + arange(Cq)) is bitwise
    :func:`etap_prefill_mla_paged`.  Counts as a K4 launch."""
    return _prefill(q, kv_pool, dv, table, start, qpos, scale=scale,
                    rescale=rescale, what="etap_verify_mla_paged")


etap_decode_mla_paged.launches = 0
etap_paged_partial.launches = 0
etap_prefill_mla_paged.launches = 0
