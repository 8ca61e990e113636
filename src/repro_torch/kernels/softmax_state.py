"""The online-softmax state API — the port of ``repro/kernels/softmax_state.py``.

Every online-softmax loop of the port (the plain versions of the ETAP
kernels and the split combine) carries its state as one fp32 triple
``(m, l, acc)`` and advances/merges it only through this module.  The CUDA
kernels under ``kernels/csrc`` run the same recurrence, written out in
C++; their plain PyTorch versions call these functions, so the CPU tests hold
the recurrence against the JAX definition directly.

Two rescale modes:

``mul``  — the textbook FlashAttention recurrence: ``m`` is the running
  score max (natural-log domain), ``corr = exp(m_old - m_new)``.

``amla`` (default) — deferred power-of-two rescaling.  ``m`` is an
  integer-valued fp32 bias ``ceil(log2 e · max score)``, probabilities are
  ``exp2(score·log2e − m)`` and ``corr = 2^(m_old − m_new)`` is an exact
  power of two, so the accumulator rescale adds no rounding.

Stats produced in one mode must be merged in the same mode.
"""
from __future__ import annotations

import os

import torch

NEG_INF = -1e30
LOG2E = 1.4426950408889634  # log2(e)

MODES = ("mul", "amla")

_DEFAULT_MODE = [os.environ.get("REPRO_RESCALE", "amla")]


def _check(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(f"rescale mode {mode!r} not in {MODES}")
    return mode


def default_mode() -> str:
    """The process-wide rescale mode (env ``REPRO_RESCALE``, default amla)."""
    return _check(_DEFAULT_MODE[0])


def set_default_mode(mode: str) -> None:
    """Set the process-wide mode (the serve ``--rescale`` flag)."""
    _DEFAULT_MODE[0] = _check(mode)


def resolve(mode: str | None = None) -> str:
    """None → the process default; anything else is validated and passed
    through.  Every public entry point resolves exactly once, at the top."""
    return default_mode() if mode is None else _check(mode)


def _identity(x):
    return x


def _exp(mode: str):
    return torch.exp2 if mode == "amla" else torch.exp


def _max(x, axis, keep):
    return torch.amax(x, dim=axis, keepdim=keep)


# ------------------------------------------------------------------ state
def init(stats_shape, acc_shape, *, device="cuda", dtype=torch.float32):
    """Fresh ``(m, l, acc)`` — fp32 by contract."""
    return (torch.full(stats_shape, NEG_INF, dtype=dtype, device=device),
            torch.zeros(stats_shape, dtype=dtype, device=device),
            torch.zeros(acc_shape, dtype=dtype, device=device))


def update(state, s, pv, *, axis: int, mode: str, expand=_identity):
    """One online-softmax block update.

    ``s``: fp32 score block, already scaled and masked (``NEG_INF``).
    ``pv``: the caller's probability-value contraction ``p -> ΔAcc``; ``p``
    is fp32 with ``s``'s shape.  ``axis``: the KV (reduction) axis of ``s``.
    ``expand`` broadcasts a stats-shaped array against ``acc``.  Stats keep
    ``s``'s rank iff the incoming ``m`` does."""
    m, l, acc = state
    keep = s.dim() == m.dim()
    if mode == "amla":
        s = s * LOG2E                       # log2 domain
        block_m = torch.ceil(_max(s, axis, keep))
    else:
        block_m = _max(s, axis, keep)
    exp_fn = _exp(mode)
    m_new = torch.maximum(m, block_m)
    p = exp_fn(s - (m_new if keep else m_new.unsqueeze(axis)))
    corr = exp_fn(m - m_new)                # amla: exact power of two
    l_new = l * corr + torch.sum(p, dim=axis, keepdim=keep)
    acc_new = acc * expand(corr) + pv(p)
    return m_new, l_new, acc_new


def finalize(state, *, expand=_identity):
    """Epilogue: ``acc / l`` (the running bias cancels in both modes).
    Orientation transposes and the output cast stay with the caller."""
    _, l, acc = state
    return acc / expand(l)


# ------------------------------------------------------------------ merge
def merge_splits(m, l, acc, *, axis: int, mode: str, expand=_identity):
    """Merge per-split stats along ``axis`` in the stat domain:

        m* = max_s m_s        w_s = expΔ(m_s − m*)     (amla: exact 2^Δ)
        l* = Σ_s w_s l_s      acc* = Σ_s w_s acc_s

    A fully-masked split (``m = NEG_INF, l = 0``) gets weight exactly 0.
    With a single split the weights are 1 and the merge is bitwise the
    identity.  Upcasts to fp32 on entry; returns ``(m, l, acc)`` with
    ``axis`` reduced."""
    m = m.float()
    l = l.float()
    acc = acc.float()
    m_g = torch.amax(m, dim=axis, keepdim=True)
    w = _exp(mode)(m - m_g)
    l_g = torch.sum(l * w, dim=axis)
    acc_g = torch.sum(acc * expand(w), dim=axis)
    return m_g.squeeze(axis), l_g, acc_g


def merge(a, b, *, mode: str, expand=_identity):
    """Pairwise stat-domain merge of two states (same math as
    :func:`merge_splits` over a 2-long axis).  Upcasts on entry."""
    ma, la, acca = (x.float() for x in a)
    mb, lb, accb = (x.float() for x in b)
    exp_fn = _exp(mode)
    m = torch.maximum(ma, mb)
    wa = exp_fn(ma - m)
    wb = exp_fn(mb - m)
    return (m, la * wa + lb * wb, acca * expand(wa) + accb * expand(wb))


def _pow2(d):
    """2^d for integer-valued fp32 d <= 0 (or NEG_INF differences), exact,
    built from the exponent as ``csrc/softmax_state.cuh:stat_weight``
    builds it: d below -200 gives 0, subnormal results are kept."""
    e = torch.clamp(d, min=-200.0).to(torch.int32)
    normal = (e + 127) << 23
    sub = torch.bitwise_left_shift(torch.ones_like(e),
                                   torch.clamp(e + 149, min=0))
    bits = torch.where(e >= -126, normal,
                       torch.where(e >= -149, sub, torch.zeros_like(e)))
    return bits.view(torch.float32)


def merge_weights(m, m_global, *, mode: str):
    """Per-shard combine weight ``w = expΔ(m − m*)`` for the cross-rank
    (all-reduce MAX, then SUM) combine — the distributed twin of
    :func:`merge_splits`, where the Σ is an all-reduce the caller owns.
    fp32 on entry, like every merge.  In amla mode both stats are
    integer-valued (or NEG_INF), and 2^Δ is built from the exponent
    (:func:`_pow2`), exact; a shard whose slice holds no position (m =
    NEG_INF) gets weight 0 in both modes."""
    d = m.float() - m_global.float()
    if _check(mode) == "amla":
        return _pow2(d)
    return torch.exp(d)
