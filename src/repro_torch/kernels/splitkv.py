"""Split-KV decode over the dense cache, shared by both orientations: the
ETAP entries (``kernels/etap/ops.py``: K5, K6 + K2 transposed) and the
untransposed baseline's (``kernels/flash_decode/ops.py``: K7, K8 + K2
[n,H,Dv]).  The split plan is worked out once, here, and handed to the
kernel wrappers; the plain versions of both orientations share the
zero-padded block walk of :func:`split_walks_plain`.

K and V are [BG, S, D], or a GQA cache [B, S, K, D] that stands for its
grouped form [B·K, S, D] (row bg = b·K + kh, the reference's
``gqa_to_grouped`` order): the CUDA kernels read it in place through its
kv-head stride, the plain versions copy it with :func:`grouped`.  Either
may hold int8 / e4m3 codes with their (scale, zp) rows ``k_sz`` / ``v_sz``
([..., 2] beside them): the quantized kernels K5q-K8q read the codes, the
plain versions dequantize each fetched block to fp32 (``codes*scale +
zp``), the rows the reference's K5-K8 are handed, and the output is fp32
(the reference's K5-K8 write V's type, fp32 after its dequantization)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.etap.schedule import (SplitPlan, dense_split_plan,
                                               num_cores, plan_splits)
from repro_torch.runtime.paged_cache import dequantize_rows, raw


def grouped(x):
    """A GQA cache [B, S, K, D] as its grouped rows [B·K, S, D] (row
    b·K + kh is kv head kh of batch row b; a copy, bitwise, fp8 codes
    through their bytes); [BG, S, D] as it is."""
    if x.dim() == 3:
        return x
    B, S, K, D = x.shape
    return raw(x).transpose(1, 2).reshape(B * K, S, D).view(x.dtype)


def full_length(q, S: int):
    """The default ``length``: every row holds all S positions."""
    return torch.full((q.shape[0],), S, dtype=torch.int32, device=q.device)


def split_plan(q, k, v, *, spec) -> SplitPlan:
    """The plan of a dense split-KV decode: ``spec.kv_splits`` None/0 → the
    scheduler, sized to q's device; the split count is effective (no split
    holds only padding)."""
    BG, H, _ = q.shape
    S = k.shape[1]
    n_splits = int(spec.kv_splits or 0)
    if not n_splits:
        n_splits = plan_splits(BG, S, H, v.shape[-1], block=spec.block,
                               num_cores=num_cores(q.device)).n_splits
    return dense_split_plan(S, spec.block, n_splits)


def decode_splitkv(q, k, v, length, *, spec, single, partial, combine,
                   k_sz=None, v_sz=None):
    """Two-phase split-KV decode of one orientation: ``single`` (the
    single-pass kernel) when the plan has one split, else ``partial`` (its
    phase 1) and ``combine`` (K2 in the matching orientation).  q [BG,H,Dk];
    k [BG,S,Dk] and v [BG,S,Dv], or a GQA cache [B,S,K,D*] (BG = B·K);
    length [BG] or None (all S); ``k_sz`` / ``v_sz``: the (scale, zp) rows
    of code operands, handed to the (quantized) wrappers.  Returns
    [BG,H,Dv] in v's dtype, fp32 over codes."""
    if length is None:
        length = full_length(q, k.shape[1])
    plan = split_plan(q, k, v, spec=spec)
    kw = dict(scale=spec.scale, rescale=spec.rescale)
    if k_sz is not None:
        kw.update(k_sz=k_sz, v_sz=v_sz)
    if plan.n_splits <= 1:
        return single(q, k, v, length, block=spec.block, **kw)
    m, l, acc = partial(q, k, v, length, plan=plan, **kw)
    out_dtype = v.dtype if k_sz is None else torch.float32
    return combine(m, l, acc, out_dtype=out_dtype, rescale=spec.rescale)


def _pad_rows(x, pad):
    """x [BG, S, D] with ``pad`` zero rows appended (codes through their
    bytes: a zero byte is code 0)."""
    return F.pad(raw(x), (0, 0, 0, pad)).view(x.dtype) if pad else x


def split_walks_plain(k, v, plan: SplitPlan, walk, k_sz=None, v_sz=None):
    """The plain versions' walk: k and v (a GQA cache grouped first)
    zero-padded to ``plan.padded_s`` rows (the reference's padding), then
    ``walk(fetch, tiles)`` once per split, where ``fetch(j)`` returns block
    j's K [BG,block,Dk] and V [BG,block,Dv] rows and split s walks blocks
    [s·npb, (s+1)·npb).  Code operands come with their (scale, zp) rows
    ``k_sz`` / ``v_sz``, padded with zero pairs, and each fetched block is
    dequantized to fp32 (padding rows to 0, the reference's zero padding of
    its fp32 rows).  Returns the list of the walks' results."""
    k, v = grouped(k), grouped(v)
    pad = plan.padded_s - k.shape[1]
    if pad < 0:
        raise ValueError(f"the split plan covers {plan.padded_s} of "
                         f"{k.shape[1]} rows")
    k, v = _pad_rows(k, pad), _pad_rows(v, pad)
    if k_sz is not None:
        k_sz, v_sz = (_pad_rows(grouped(z), pad) for z in (k_sz, v_sz))
    block, npb = plan.block, plan.nb_per_split

    def fetch(j):
        rows = slice(j * block, (j + 1) * block)
        if k_sz is None:
            return k[:, rows], v[:, rows]
        return (dequantize_rows(k[:, rows], k_sz[:, rows]),
                dequantize_rows(v[:, rows], v_sz[:, rows]))
    return [walk(fetch, range(s * npb, (s + 1) * npb))
            for s in range(plan.n_splits)]
