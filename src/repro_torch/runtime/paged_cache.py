"""Paged KV-cache subsystem: block-pool allocator + block-table tensor ops.

The port of ``repro/runtime/paged_cache.py`` for the fp layout.  The serving
cache is a pool of fixed-size KV blocks (pages) shared by all sequences:

    pool        [num_blocks, block_size, *feat]   (per layer; on the device)
    block_table [B, max_blocks]  int32            (shared across layers)
    lengths     [B]              int32            (tokens written per slot)

Sequence ``b``'s token at logical position ``t`` lives at
``pool[block_table[b, t // block_size], t % block_size]``.  Block 0 is the
reserved null block; every padded or released table entry points at it.

:class:`BlockPool` (the host-side allocator) is the reference's class
unchanged apart from :meth:`BlockPool.device_views`.  The device ops differ
from the reference in one way: they write into the pool IN PLACE (the
reference's arrays are immutable and it donates them through jit instead)
and return the same tensor, so a pool is never copied per step.

Quantized layouts: the pool may hold int8 or fp8 (e4m3) codes with one
fp32 (scale, zero-point) pair per written row in a parallel ``sz`` pool
[num_blocks, block_size, 2] that pages with the code pool.  The row is the
quantization granule, so a write never re-quantizes earlier rows and the
same rows always quantize to the same bits (the prefix cache relies on
it).  :func:`quantize_rows` follows the reference's operations one for one
(same op order, round half to even, the clamp before the e4m3 cast, scale
1 on degenerate rows), so its codes and pairs are the reference's bit for
bit.  fp8 pools are written and copied through their uint8 view
(:func:`raw`), which is bitwise and needs no fp8 indexing kernels.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

NULL_BLOCK = 0

# Quantized KV layouts.  "fp" keeps the config dtype; "int8" is an
# asymmetric per-row affine; "fp8" is e4m3 (torch.float8_e4m3fn), symmetric:
# the zero-point is pinned to 0 and only the scale is live.
KV_LAYOUTS = ("fp", "int8", "fp8")
F8_MAX = 448.0                    # e4m3fn finite max (no inf encoding)
INT8_MAX = 127.0


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Static geometry of a paged cache."""
    block_size: int            # tokens per KV block (page)
    num_blocks: int            # pool size, INCLUDING the reserved null block
    max_blocks: int            # block-table width (max logical blocks/seq)

    def __post_init__(self):
        assert self.block_size >= 1 and self.max_blocks >= 1
        assert self.num_blocks >= 2, "need at least null block + one real block"

    @property
    def max_len(self) -> int:
        return self.max_blocks * self.block_size

    def blocks_for(self, n_tokens: int) -> int:
        return max(1, -(-int(n_tokens) // self.block_size))


def layout_for(batch_slots: int, max_len: int, block_size: int = 64,
               spare_blocks: int = 0) -> PagedLayout:
    """A layout that can hold `batch_slots` full-length sequences (+spares)."""
    max_blocks = max(1, -(-int(max_len) // block_size))
    return PagedLayout(block_size=block_size,
                       num_blocks=1 + batch_slots * max_blocks + spare_blocks,
                       max_blocks=max_blocks)


@dataclasses.dataclass
class SwapRecord:
    """Accounting for one preempted sequence resident in the host tier:
    one host block id per WRITTEN logical block, the rows they carry and
    the original reserved budget.  Holds no device references."""
    key: object
    host_ids: list
    n_tokens: int
    budget: int


class BlockPool:
    """Host-side free-list allocator over `layout.num_blocks` KV blocks,
    owning the block table and per-slot lengths for `batch_slots` slots.
    ``host_blocks`` > 0 adds the host swap tier.  Every non-null block
    carries a refcount (one per slot mapping it, one for the prefix-cache
    trie); a block is free iff its refcount is zero."""

    def __init__(self, layout: PagedLayout, batch_slots: int,
                 host_blocks: int = 0, *, metrics=None):
        self.layout = layout
        self.batch_slots = batch_slots
        self.metrics = metrics
        self._free = deque(range(1, layout.num_blocks))      # 0 = null block
        self.table = np.zeros((batch_slots, layout.max_blocks), np.int32)
        self.lengths = np.zeros((batch_slots,), np.int32)
        self.active = np.zeros((batch_slots,), bool)
        self.ref = np.zeros((layout.num_blocks,), np.int32)
        self._chain: list[list[int]] = [[] for _ in range(batch_slots)]
        self._nshared = np.zeros((batch_slots,), np.int32)
        self._budget = np.zeros((batch_slots,), np.int32)    # reserved tokens
        self.host_blocks = int(host_blocks)
        self._host_free = deque(range(self.host_blocks))
        self.swapped: dict = {}                  # key -> SwapRecord

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def host_free(self) -> int:
        return len(self._host_free)

    def free_slots(self) -> list[int]:
        return [b for b in range(self.batch_slots) if not self.active[b]]

    def free_ids(self) -> set[int]:
        """Snapshot of the free-list block ids."""
        return set(self._free)

    def budget(self, slot: int) -> int:
        """Reserved token budget of `slot` (0 when torn down)."""
        return int(self._budget[slot])

    def can_admit(self, max_total_len: int, n_shared: int = 0) -> bool:
        """A free batch slot AND enough free blocks to reserve the request's
        whole token budget; ``n_shared`` counts FULL prefix blocks mapped
        from the prefix cache (no free-list draw)."""
        if max_total_len > self.layout.max_len:
            return False
        need = self.layout.blocks_for(max_total_len) - int(n_shared)
        return bool(self.free_slots()) and need <= self.num_free

    def admit(self, prompt_len: int, max_total_len: int) -> int | None:
        """Reserve a slot + blocks for `max_total_len` tokens; returns the
        slot id, or None (admission refusal)."""
        got = self.admit_shared(prompt_len, max_total_len, ())
        return None if got is None else got[0]

    def admit_shared(self, prompt_len: int, max_total_len: int,
                     shared_ids) -> tuple | None:
        """Admission with a cached prefix: map `shared_ids` (the chain
        holding the first `prompt_len` tokens) by refcount bump, allocate
        fresh blocks for the rest of the budget.  A prefix ending mid-block
        returns the (src, dst) copy-on-write pair for the caller to copy
        before any chunk is appended.  Returns (slot, cow) or None."""
        assert 0 <= prompt_len <= max_total_len and max_total_len >= 1
        shared_ids = [int(b) for b in shared_ids]
        n_full = prompt_len // self.layout.block_size
        if shared_ids:
            assert prompt_len >= 1
            assert len(shared_ids) == self.layout.blocks_for(prompt_len), \
                "shared chain must cover exactly the prompt_len prefix"
        else:
            n_full = 0                       # nothing to map without a chain
        if not self.can_admit(max_total_len, n_shared=n_full):
            return None
        slot = self.free_slots()[0]
        need = self.layout.blocks_for(max_total_len)
        reused = shared_ids[:n_full]
        fresh = [self._free.popleft() for _ in range(need - n_full)]
        cow = []
        if len(shared_ids) > n_full:         # prefix ends mid-block: COW
            cow.append((shared_ids[n_full], fresh[0]))
        for bid in reused:
            assert self.ref[bid] > 0, "shared block must be live (trie/slot)"
            self.ref[bid] += 1
        for bid in fresh:
            assert self.ref[bid] == 0
            self.ref[bid] = 1
        chain = reused + fresh
        self._chain[slot] = chain
        self._nshared[slot] = len(reused)
        self.table[slot] = NULL_BLOCK
        self.table[slot, :len(chain)] = chain
        self.lengths[slot] = prompt_len
        self._budget[slot] = max_total_len
        self.active[slot] = True
        return slot, cow

    def block_ids(self, slot: int) -> np.ndarray:
        """Physical block chain of `slot` in logical order."""
        return np.asarray(self._chain[slot], np.int32)

    def ref_block(self, bid: int) -> None:
        """Take an external (prefix-trie) reference on a live block."""
        assert bid != NULL_BLOCK and self.ref[bid] > 0
        self.ref[bid] += 1

    def unref_block(self, bid: int) -> bool:
        """Drop one reference; the block returns to the free list when the
        count hits zero.  Returns True iff the block was freed."""
        assert bid != NULL_BLOCK and self.ref[bid] > 0
        self.ref[bid] -= 1
        if self.ref[bid] == 0:
            self._free.append(bid)
            return True
        return False

    def _assert_writable(self, slot: int, lo_tok: int, hi_tok: int) -> None:
        """Writes may only touch exclusively-owned blocks (refcount 1)."""
        bs = self.layout.block_size
        for bid in self._chain[slot][lo_tok // bs:hi_tok // bs + 1]:
            assert self.ref[bid] == 1, \
                f"COW violation: write into shared block {bid} " \
                f"(refcount {int(self.ref[bid])})"

    def append(self, slot: int) -> None:
        """Account one generated token for `slot` (the device-side write is
        :func:`append_rows`).  Never allocates."""
        assert self.active[slot]
        assert self.lengths[slot] < self._budget[slot], \
            f"slot {slot} exceeded its reserved budget"
        self._assert_writable(slot, int(self.lengths[slot]),
                              int(self.lengths[slot]))
        self.lengths[slot] += 1

    def extend(self, slot: int, n: int) -> None:
        """Account `n` prompt tokens appended to `slot` in one prefill chunk
        (the device-side write is :func:`append_chunk`).  Never allocates."""
        assert self.active[slot] and n >= 0
        assert self.lengths[slot] + n <= self._budget[slot], \
            f"slot {slot} chunk of {n} exceeds its reserved budget"
        if n:
            self._assert_writable(slot, int(self.lengths[slot]),
                                  int(self.lengths[slot]) + n - 1)
        self.lengths[slot] += n

    def truncate(self, slot: int, n_tokens: int, *,
                 free_blocks: bool = True) -> int:
        """Invariant-safe rollback of `slot` to `n_tokens`: tail blocks are
        dropped through :meth:`unref_block` and their table columns nulled;
        ``free_blocks=False`` rewinds only the length.  Returns the number
        of blocks freed."""
        assert self.active[slot]
        n_tokens = int(n_tokens)
        assert 0 <= n_tokens <= int(self.lengths[slot]), \
            f"truncate to {n_tokens} past written length " \
            f"{int(self.lengths[slot])}"
        if not free_blocks:
            self.lengths[slot] = n_tokens
            return 0
        keep = self.layout.blocks_for(n_tokens) if n_tokens else 0
        chain = self._chain[slot]
        assert keep <= len(chain)
        freed = 0
        for bid in reversed(chain[keep:]):
            freed += bool(self.unref_block(bid))
        self._chain[slot] = chain[:keep]
        self.table[slot, keep:] = NULL_BLOCK
        self.lengths[slot] = n_tokens
        self._nshared[slot] = min(int(self._nshared[slot]), keep)
        self._budget[slot] = keep * self.layout.block_size
        return freed

    def release(self, slot: int) -> None:
        """Drop one reference per chain block and null the slot's row."""
        assert self.active[slot]
        assert (self.table[slot, len(self._chain[slot]):]
                == NULL_BLOCK).all(), "stale ids beyond the slot's chain"
        self.truncate(slot, 0)
        self._nshared[slot] = 0
        self._budget[slot] = 0
        self.active[slot] = False

    # ------------------------------------------------------ host swap tier
    def can_swap_out(self, slot: int) -> bool:
        """Whether the host tier can absorb `slot`'s written blocks."""
        n = int(self.lengths[slot])
        nb = self.layout.blocks_for(n) if n else 0
        return nb <= self.host_free

    def swap_out(self, slot: int, key) -> SwapRecord | None:
        """Evacuate `slot` to the host tier (the caller copied the written
        blocks off the device first), then release it.  None when the host
        tier is full."""
        assert self.active[slot]
        assert key not in self.swapped, f"key {key!r} already swapped"
        n_tokens = int(self.lengths[slot])
        nb = self.layout.blocks_for(n_tokens) if n_tokens else 0
        if nb > self.host_free:
            return None
        host_ids = [self._host_free.popleft() for _ in range(nb)]
        rec = SwapRecord(key=key, host_ids=host_ids, n_tokens=n_tokens,
                         budget=int(self._budget[slot]))
        self.swapped[key] = rec
        self.release(slot)
        if self.metrics is not None and nb:
            self.metrics.inc("pool/swap_out_blocks", nb)
        return rec

    def swap_in(self, key, shared_ids=(), matched: int = 0):
        """Restore a swapped sequence into a fresh slot with its original
        budget.  Returns ``(slot, cow, record)`` or None (refusal)."""
        rec = self.swapped[key]
        matched = int(matched)
        got = self.admit_shared(matched, rec.budget, shared_ids)
        if got is None:
            return None
        slot, cow = got
        n_eff = max(matched, rec.n_tokens)
        if n_eff > matched:
            self.extend(slot, n_eff - matched)
        if self.metrics is not None and rec.host_ids:
            self.metrics.inc("pool/swap_in_blocks", len(rec.host_ids))
        self.swap_free(key)
        return slot, cow, rec

    def swap_free(self, key) -> SwapRecord:
        """Drop a swap record and return its host ids to the tier."""
        rec = self.swapped.pop(key)
        self._host_free.extend(rec.host_ids)
        return rec

    def observe(self, metrics=None) -> None:
        """Publish pool occupancy gauges into a MetricsRegistry."""
        m = metrics if metrics is not None else self.metrics
        if m is None:
            return
        m.gauge("pool/free_blocks").set(self.num_free)
        m.gauge("pool/used_blocks").set(
            self.layout.num_blocks - 1 - self.num_free)
        m.gauge("pool/active_slots").set(int(self.active.sum()))
        m.gauge("pool/shared_blocks").set(int((self.ref > 1).sum()))
        m.gauge("pool/host_free_blocks").set(self.host_free)
        m.gauge("pool/swapped_seqs").set(len(self.swapped))

    def check_conservation(self) -> None:
        """Refcount conservation: free ⟺ refcount 0, free + referenced
        blocks partition the pool, active chains are live, and the host
        tier's ids are partitioned.  Raises AssertionError on a violation."""
        assert (self.ref >= 0).all()
        assert int(self.ref[NULL_BLOCK]) == 0
        free = list(self._free)
        assert len(set(free)) == len(free), "duplicate ids on the free list"
        assert NULL_BLOCK not in free
        for bid in free:
            assert self.ref[bid] == 0, f"freed block {bid} still referenced"
        n_live = int((self.ref[1:] > 0).sum())
        assert len(free) + n_live == self.layout.num_blocks - 1
        for b in range(self.batch_slots):
            if self.active[b]:
                assert all(self.ref[bid] >= 1 for bid in self._chain[b])
                assert self._nshared[b] <= len(self._chain[b])
            else:
                assert not self._chain[b]
                assert (self.table[b] == NULL_BLOCK).all()
        hf = list(self._host_free)
        assert len(set(hf)) == len(hf), "duplicate ids on the host free list"
        used = [h for r in self.swapped.values() for h in r.host_ids]
        assert len(set(used)) == len(used), "host block in two swap records"
        assert not set(hf) & set(used)
        assert len(hf) + len(used) == self.host_blocks
        for r in self.swapped.values():
            nb = self.layout.blocks_for(r.n_tokens) if r.n_tokens else 0
            assert len(r.host_ids) == nb and r.n_tokens <= r.budget

    def audit(self) -> None:
        """The ``--paranoia`` sweep: :meth:`check_conservation` plus the
        full-row table audit of every slot."""
        self.check_conservation()
        for b in range(self.batch_slots):
            chain = self._chain[b]
            assert (self.table[b, len(chain):] == NULL_BLOCK).all(), \
                f"slot {b}: stale ids beyond its chain"
            assert (self.table[b, :len(chain)]
                    == np.asarray(chain, np.int32)).all(), \
                f"slot {b}: table row disagrees with its chain"
            assert int(self.lengths[b]) <= int(self._budget[b])
            if self._budget[b]:
                assert self.layout.blocks_for(int(self._budget[b])) \
                    <= len(chain), f"slot {b}: budget outruns its chain"

    def device_views(self, device="cuda"):
        """(block_table [B, max_blocks], lengths [B]) as int32 tensors on
        ``device`` — owned COPIES, never views of the allocator's arrays,
        so a later host-side append/release cannot change what an in-flight
        step reads."""
        return (torch.tensor(self.table, dtype=torch.int32, device=device),
                torch.tensor(self.lengths, dtype=torch.int32, device=device))


# --------------------------------------------------------- device-side ops
def append_rows(pool, table, lengths, rows):
    """Write one new token row per sequence at its current length, in place.

    pool: [N, bs, *F]; table: [B, max_blocks] int32; lengths: [B] int32;
    rows: [B, *F].  Inactive slots (all-null table, length 0) land in the
    null block — masked on read.  Returns ``pool``."""
    bs = pool.shape[1]
    lengths = lengths.long()
    pid = torch.gather(table.long(), 1, (lengths // bs)[:, None])[:, 0]
    pool[pid, lengths % bs] = rows.to(pool.dtype)
    return pool


def append_chunk(pool, table, lengths, rows):
    """Write a C-token chunk per sequence starting at its current length, in
    place (chunk token c of sequence b lands at position lengths[b] + c).
    rows: [B, C, *F].  Returns ``pool``."""
    bs = pool.shape[1]
    C = rows.shape[1]
    pos = lengths.long()[:, None] + torch.arange(C, device=pool.device)
    pid = torch.gather(table.long(), 1, pos // bs)                  # [B,C]
    pool[pid, pos % bs] = rows.to(pool.dtype)
    return pool


def copy_block(pool, src: int, dst: int):
    """Copy-on-write device copy of physical block `src` into `dst`, in
    place.  Returns ``pool``."""
    raw(pool)[dst] = raw(pool)[src]
    return pool


def gather_blocks(pool, table):
    """Dense [B, max_blocks * bs, *F] copy of the paged rows (an oracle
    path: the kernels index the pool through the table)."""
    B, nb = table.shape
    bs = pool.shape[1]
    rows = raw(pool)[table.long()].reshape(B, nb * bs, *pool.shape[2:])
    return rows.view(pool.dtype)


# ------------------------------------------------------------ quantization
def quant_dtype(kv_dtype: str):
    """Pool storage dtype of a KV layout ("fp" -> None: the caller keeps
    the config dtype)."""
    if kv_dtype == "fp":
        return None
    if kv_dtype == "int8":
        return torch.int8
    if kv_dtype == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(f"kv_dtype must be one of {KV_LAYOUTS}, got {kv_dtype!r}")


def kv_dtype_of(pool) -> str:
    """Inverse of :func:`quant_dtype`: classify a pool by its dtype."""
    if pool.dtype == torch.int8:
        return "int8"
    if pool.dtype == torch.float8_e4m3fn:
        return "fp8"
    return "fp"


def raw(t):
    """The bits of an fp8 tensor as uint8 (a view); other tensors as they
    are.  Writes, copies and gathers of fp8 pools go through it."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def quantize_rows(rows, kv_dtype: str):
    """Quantize fp rows [..., F] to (codes [..., F] in :func:`quant_dtype`,
    sz [..., 2] fp32) with one affine pair per row, ``sz[..., 0]`` the
    scale and ``sz[..., 1]`` the zero-point:

        int8:  zp = (max+min)/2, scale = (max-min)/254,
               codes = round((x - zp)/scale) in [-127, 127]
        fp8:   zp = 0, scale = amax/448, codes = e4m3(x/scale)

    Degenerate rows (max == min) take scale 1, so all-zero and constant
    rows round-trip exactly.  A pure function of the row values."""
    dt = quant_dtype(kv_dtype)
    if dt is None:
        raise ValueError("quantize_rows on a 'fp' layout: nothing to do")
    x = rows.to(torch.float32)
    hi = torch.amax(x, dim=-1, keepdim=True)
    lo = torch.amin(x, dim=-1, keepdim=True)
    one = torch.ones_like(hi)

    def per_row(c):
        # a tensor divisor: CUDA turns division by a Python number into a
        # product with its reciprocal, which is not the reference's bits
        return torch.full_like(hi, c)
    if kv_dtype == "int8":
        zp = (hi + lo) * 0.5
        rng = hi - lo
        scale = torch.where(rng > 0, rng / per_row(2.0 * INT8_MAX), one)
        codes = torch.round((x - zp) / scale)             # half to even
        codes = torch.clamp(codes, -INT8_MAX, INT8_MAX).to(dt)
    else:
        amax = torch.maximum(hi.abs(), lo.abs())
        zp = torch.zeros_like(hi)
        scale = torch.where(amax > 0, amax / per_row(F8_MAX), one)
        # clamp BEFORE the cast: e4m3fn has no inf, overflow would be nan
        codes = torch.clamp(x / scale, -F8_MAX, F8_MAX).to(dt)
    return codes, torch.cat([scale, zp], dim=-1)


def dequantize_rows(codes, sz):
    """Inverse of :func:`quantize_rows`: ``codes*scale + zp`` in fp32."""
    return codes.to(torch.float32) * sz[..., 0:1] + sz[..., 1:2]


def quantize_pool(pool, kv_dtype: str):
    """Quantize a whole fp pool [N, bs, F] into (codes, sz [N, bs, 2])."""
    return quantize_rows(pool, kv_dtype)


def row_bytes(feat: int, kv_dtype: str, fp_dtype=torch.bfloat16,
              granules: int = 1) -> int:
    """KV bytes per written token row: ``feat`` features in the layout's
    code dtype plus, for a quantized layout, ``granules`` fp32 (scale, zp)
    pairs."""
    if kv_dtype == "fp":
        return feat * torch.empty((), dtype=fp_dtype).element_size()
    return feat + granules * 8            # 1-byte codes + fp32 (scale, zp)


def layout_for_bytes(budget_bytes: int, bytes_per_row: int, max_len: int,
                     block_size: int = 64, spare_blocks: int = 0):
    """Size a (layout, batch_slots) pair to a pool byte budget: as many
    blocks as the budget buys at ``bytes_per_row``, and as many full-length
    batch slots as those blocks back (``spare_blocks`` held out).  At the
    fp row size this is :func:`layout_for`; at int8 the same budget admits
    about twice the sequences."""
    max_blocks = max(1, -(-int(max_len) // block_size))
    block_bytes = block_size * int(bytes_per_row)
    num_blocks = max(2, 1 + int(budget_bytes) // block_bytes)
    usable = max(1, num_blocks - 1 - max(0, int(spare_blocks)))
    batch_slots = max(1, usable // max_blocks)
    return (PagedLayout(block_size=block_size, num_blocks=num_blocks,
                        max_blocks=max_blocks), batch_slots)


def append_rows_quant(pool, sz_pool, table, lengths, rows):
    """Quantized :func:`append_rows`: quantize the new fp rows in the
    pool's layout and write codes and (scale, zp) at the same coordinates,
    in place.  Returns (pool, sz_pool)."""
    codes, sz = quantize_rows(rows, kv_dtype_of(pool))
    append_rows(raw(pool), table, lengths, raw(codes))
    append_rows(sz_pool, table, lengths, sz)
    return pool, sz_pool


def append_chunk_quant(pool, sz_pool, table, lengths, rows):
    """Quantized :func:`append_chunk` (rows: [B, C, F]), in place.
    Returns (pool, sz_pool)."""
    codes, sz = quantize_rows(rows, kv_dtype_of(pool))
    append_chunk(raw(pool), table, lengths, raw(codes))
    append_chunk(sz_pool, table, lengths, sz)
    return pool, sz_pool


# ------------------------------------------------- packing and stacked trees
def dense_to_paged(dense, lengths, layout: PagedLayout):
    """Pack a dense [B, S, *F] cache into (pool, BlockPool) — the test and
    benchmark helper and the dense→paged migration path.  Allocation order
    follows slot order, so tables are NOT identity maps of logical order
    across sequences (which is exactly what the kernels must be robust
    to).  The pool [num_blocks, block_size, *F] lies on ``dense``'s device
    in its dtype; rows past a sequence's length, and every block no
    sequence holds, are zero."""
    B = dense.shape[0]
    feat = tuple(dense.shape[2:])
    pool = torch.zeros((layout.num_blocks, layout.block_size) + feat,
                       dtype=dense.dtype, device=dense.device)
    bp = BlockPool(layout, B)
    bs = layout.block_size
    for b in range(B):
        n = int(lengths[b])
        slot = bp.admit(n, n)
        assert slot == b, "fresh pool admits in slot order"
        ids = torch.as_tensor(bp.block_ids(b), dtype=torch.long,
                              device=dense.device)
        pos = torch.arange(n, device=dense.device)
        raw(pool)[ids[pos // bs], pos % bs] = raw(dense[b, :n])
    return pool, bp


def tree_append_rows(cache, table, lengths, rows):
    """:func:`append_rows` over matching (pool, rows) dicts whose tensors
    carry a leading stacked-layer axis [n, ...]: layer i's rows [B, *F]
    land in layer i's pool [N, bs, *F] at each sequence's length, in place
    (a quantized layout's codes and (scale, zp) rows alike, as given).
    Returns ``cache``."""
    for key, pool in cache.items():
        for i in range(pool.shape[0]):
            append_rows(raw(pool[i]), table, lengths,
                        raw(rows[key][i].to(pool.dtype)))
    return cache
