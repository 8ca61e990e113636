"""Split-KV scheduler for two-phase ETAP decode — the port of
``repro/kernels/etap/schedule.py``.

Decode launches one work item per (batch row, split); at small batch × long
context one split per row leaves most of the machine idle, so the context is
cut until the grid fills it — but never so far that a split owns too few KV
blocks, or that the per-split (m, ℓ, Accᵀ) stat traffic stops being small
next to the one mandatory read of the KV cache.

The machine size is the one difference from the reference: for a CUDA tensor
it is the card's SM count (132 on an H100 SXM); for a CPU tensor it stays
``DEFAULT_CORES = 8``, so CPU runs schedule exactly as the JAX package does.
"""
from __future__ import annotations

import dataclasses

import torch

DEFAULT_CORES = 8          # the reference's figure; used for CPU tensors
WAVE_FACTOR = 2            # aim for this many work items per core
MIN_BLOCKS_PER_SPLIT = 2   # a split must own >= this many KV blocks
STATS_TRAFFIC_BUDGET = 8   # stat bytes must stay under kv_bytes / this


def num_cores(device) -> int:
    """Parallel units the decode grid should fill on ``device``."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return DEFAULT_CORES


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """Chosen split-KV launch geometry."""
    n_splits: int
    block: int
    nb_per_split: int          # KV blocks each split walks (after padding)

    @property
    def padded_s(self) -> int:
        return self.n_splits * self.nb_per_split * self.block


def _floor_pow2(n: int) -> int:
    return 1 << (max(n, 1).bit_length() - 1)


def split_geometry(S: int, block: int, n_splits: int):
    """Launch geometry for cutting an S-long dense context into at most
    ``n_splits`` segments: (block, n_splits, nb_per_split, padded_s).
    ``block`` is clamped to S; the split count is EFFECTIVE (no split may
    own only padding), and callers pad S to ``padded_s`` and launch with
    the returned count."""
    S = max(int(S), 1)
    block = max(1, min(block, S))
    nb = -(-S // block)
    n_splits = max(1, min(int(n_splits), nb))
    npb = -(-nb // n_splits)
    n_splits = -(-nb // npb)       # drop splits starting past the last block
    return block, n_splits, npb, n_splits * npb * block


def dense_split_plan(S: int, block: int, n_splits: int) -> SplitPlan:
    """:func:`split_geometry` as the plan the dense kernels take."""
    block, n_splits, npb, _ = split_geometry(S, block, n_splits)
    return SplitPlan(n_splits=n_splits, block=block, nb_per_split=npb)


def paged_split_geometry(nb: int, n_splits: int):
    """Split geometry over a paged cache: splits land on page boundaries.
    Returns (n_splits, nb_per_split, padded_nb) with n_splits EFFECTIVE (no
    split may own only padding); callers pad the block table to
    ``padded_nb`` columns with null blocks and launch with that count."""
    nb = max(int(nb), 1)
    n_splits = max(1, min(int(n_splits), nb))
    npb = -(-nb // n_splits)
    n_splits = -(-nb // npb)       # drop splits starting past the last block
    return n_splits, npb, n_splits * npb


def plan_splits(BG: int, S: int, H: int, Dv: int, *, block: int = 512,
                num_cores: int = DEFAULT_CORES,
                kv_itemsize: int = 2) -> SplitPlan:
    """Pick (n_splits, block) for a decode of shape (BG, S, H, Dv).

    occupancy: want BG * n_splits >= WAVE_FACTOR * num_cores
    granularity: each split keeps >= MIN_BLOCKS_PER_SPLIT KV blocks
    traffic: n_splits * stat_bytes <= kv_bytes / STATS_TRAFFIC_BUDGET
    """
    S = max(int(S), 1)
    block = max(1, min(block, S))
    nb = -(-S // block)
    want = -(-WAVE_FACTOR * num_cores // max(int(BG), 1))
    cap_blocks = max(1, nb // MIN_BLOCKS_PER_SPLIT)
    # per-split phase-2 payload: fp32 (m, ℓ) [2·H] + Accᵀ [Dv·H]
    stat_bytes = 4 * H * (Dv + 2)
    kv_bytes = 2 * S * Dv * kv_itemsize        # K + V streams (≈; MLA: one)
    cap_traffic = max(1, kv_bytes // (STATS_TRAFFIC_BUDGET * stat_bytes))
    n = _floor_pow2(min(want, cap_blocks, int(cap_traffic)))
    npb = -(-nb // n)
    return SplitPlan(n_splits=n, block=block, nb_per_split=npb)


def plan_splits_paged(B: int, nb: int, page: int, H: int, Dv: int, *,
                      num_cores: int = DEFAULT_CORES,
                      kv_itemsize: int = 2) -> SplitPlan:
    """Block-granular split plan for a paged decode: :func:`plan_splits`
    with the KV block pinned to the page size."""
    plan = plan_splits(B, max(int(nb), 1) * page, H, Dv, block=page,
                       num_cores=num_cores, kv_itemsize=kv_itemsize)
    n_eff, npb, _ = paged_split_geometry(nb, plan.n_splits)
    return SplitPlan(n_splits=n_eff, block=page, nb_per_split=npb)
