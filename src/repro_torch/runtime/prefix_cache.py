"""Radix-tree prefix cache: refcounted KV-block sharing across requests.

Serving traffic shares long prompt prefixes — system prompts, few-shot
templates, multi-turn history — and the cheapest prefill is the one that is
skipped.  This module maps shared prefixes to chains of physical KV blocks
in the :class:`~repro_torch.runtime.paged_cache.BlockPool` through a
BLOCK-GRANULAR radix tree over prompt token ids: each node covers exactly
one ``block_size``-token block, its edge is labeled by that block's token
tuple, and walking a new prompt block-by-block yields the longest cached
block-aligned prefix.  Admission (launch/serve.py) maps the matched chain
into the new request's block table with a refcount bump per block
(:meth:`BlockPool.admit_shared`) and starts chunked prefill at the match
offset — zero prefill tokens are spent on the shared prefix, and MLA's
compressed latent cache (a single 576-wide stream per token) makes the
retained blocks nearly free in memory.

Lifecycle (DESIGN.md §10):
  · ``insert`` is called when a request finishes PREFILL (not release): the
    prompt's full blocks enter the trie, each taking one pool reference, so
    concurrent and queued requests can share them while the donor is still
    decoding.  Insert under an existing token path DEDUPES: the first
    cached physical block wins, the duplicate stays owned by its slot and
    is freed on release.
  · ``release`` (BlockPool) drops the slot's references; trie-cached prompt
    blocks survive at refcount >= 1 as an LRU-evictable cached set, decode
    tail blocks fall to zero and return to the free list.
  · Under pressure the free list reclaims from LRU LEAVES (``evict_lru``):
    only leaves are evictable (never dangles a cached child chain), and
    only trie-exclusive blocks (pool refcount == 1) are taken — evicting a
    block a live slot still maps would free nothing and is skipped, so
    eviction can never free a live block by construction.

The trie stores host-side ids only; KV bytes always live in the pool.
"""
from __future__ import annotations

import itertools
from collections import OrderedDict

import numpy as np


class _Node:
    """One cached KV block: edge label `key` (the block's token tuple) from
    `parent`, the physical pool block `block_id`, children keyed by their
    own token tuples."""
    __slots__ = ("key", "block_id", "parent", "children", "uid")

    def __init__(self, key, block_id, parent, uid):
        self.key = key
        self.block_id = block_id
        self.parent = parent
        self.children = {}
        self.uid = uid


class PrefixCache:
    """Block-granular radix tree over prompt token ids -> physical block
    chains, with LRU leaf eviction.  One instance per BlockPool; the pool
    owns the refcounts, the trie owns the recency order."""

    def __init__(self, block_size: int):
        assert block_size >= 1
        self.block_size = block_size
        self._root = _Node(None, None, None, -1)
        self._lru: OrderedDict[int, _Node] = OrderedDict()  # LRU -> MRU
        self._uid = itertools.count()
        # persistent pins (block id -> pin count): chains a PREEMPTED
        # request will re-match at restore (DESIGN.md §12).  Pinning is
        # BEST-EFFORT pressure steering, not protection: pinned blocks are
        # evicted last (second pass of evict_lru), never exempted — a
        # recompute-restore whose pinned prefix was reclaimed anyway just
        # re-prefills it, so reclaimable() stays an exact supply.
        self._pinned: dict[int, int] = {}
        self.lookups = 0
        self.hits = 0
        self.matched_tokens = 0
        self.inserted_blocks = 0
        self.evictions = 0
        self.pinned_evictions = 0

    def __len__(self) -> int:
        """Cached blocks (= trie nodes)."""
        return len(self._lru)

    def _keys(self, tokens) -> list[tuple]:
        toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
        bs = self.block_size
        return [tuple(toks[i * bs:(i + 1) * bs])
                for i in range(len(toks) // bs)]

    def match(self, tokens, record: bool = True):
        """Longest cached block-aligned prefix of `tokens`.

        Returns ``(chain, matched_len)``: the physical block ids holding
        the first ``matched_len`` tokens (all visited nodes are touched to
        MRU).  Capped so at least ONE prompt token is always left to
        prefill — the last position's logits must be computed fresh to seed
        the first decode token, so a fully-cached block-aligned prompt
        recomputes its final block.

        ``record=False`` leaves the hit/lookup counters alone: a scheduler
        that re-matches a still-queued request every step (the match can
        GROW while it waits — donors finish prefill, tries fill) would
        otherwise count one request N times and inflate the hit rate; it
        calls :meth:`record` once, on successful admission."""
        if record:
            self.lookups += 1
        n_tok = int(np.asarray(tokens).size)
        node, chain = self._root, []
        for key in self._keys(tokens):
            child = node.children.get(key)
            if child is None:
                break
            self._lru.move_to_end(child.uid)
            chain.append(child.block_id)
            node = child
        while chain and len(chain) * self.block_size >= n_tok:
            chain.pop()
        matched = len(chain) * self.block_size
        if record and chain:
            self.hits += 1
            self.matched_tokens += matched
        return chain, matched

    def record(self, matched: int) -> None:
        """Count one lookup (and its hit, if any) — the deferred-stats
        companion of ``match(record=False)``, called once per ADMITTED
        request so refusal retries don't inflate the hit rate."""
        self.lookups += 1
        if matched:
            self.hits += 1
            self.matched_tokens += matched

    def insert(self, tokens, chain, pool) -> int:
        """Cache the full-block prefix of `tokens`, whose physical blocks
        are `chain` (the slot's logical block chain, shared + fresh — only
        the first ``len(tokens) // block_size`` entries are used; a partial
        tail block is never cached).  Every NEWLY inserted block takes one
        pool reference (:meth:`BlockPool.ref_block`); a block already
        cached under the same token path is deduped — the existing physical
        block is kept and the caller's duplicate stays owned by its slot
        alone.  Returns the number of blocks newly inserted."""
        node, new = self._root, 0
        for key, bid in zip(self._keys(tokens), chain, strict=False):
            child = node.children.get(key)
            if child is None:
                child = _Node(key, int(bid), node, next(self._uid))
                node.children[key] = child
                pool.ref_block(int(bid))
                new += 1
            self._lru[child.uid] = child
            self._lru.move_to_end(child.uid)
            node = child
        self.inserted_blocks += new
        return new

    def pin_chain(self, chain) -> None:
        """Take a best-effort pin on every block of `chain`: pinned blocks
        are passed over by :meth:`evict_lru`'s first pass, so a preempted
        request's cached prompt survives routine pressure and its restore
        stays a refcount bump instead of a re-prefill.  Pins nest (a block
        two preempted requests depend on needs two unpins) and do NOT
        protect absolutely — under exhaustive pressure the second pass
        reclaims pinned blocks too."""
        for bid in chain:
            bid = int(bid)
            self._pinned[bid] = self._pinned.get(bid, 0) + 1

    def unpin_chain(self, chain) -> None:
        """Drop one pin per block of `chain` (restore-complete, or the
        request was cancelled).  Unpinning a block evicted meanwhile is a
        no-op — the pin was best-effort and the eviction already counted."""
        for bid in chain:
            bid = int(bid)
            n = self._pinned.get(bid, 0)
            if n <= 1:
                self._pinned.pop(bid, None)
            else:
                self._pinned[bid] = n - 1

    def evict_lru(self, pool, protect=frozenset()):
        """Evict the least-recently-used evictable LEAF and drop its pool
        reference; returns the freed physical block id, or None when
        nothing is evictable.  A node is evictable iff it has no children
        (so no cached chain dangles), the trie holds the block's ONLY
        reference (pool refcount == 1 — evicting a slot-shared block frees
        no memory and could strand a mapper's future re-match), and its
        block is not in `protect` (a chain the caller matched but has not
        yet mapped).  Evicting a leaf exposes its parent for the next
        round, so repeated calls peel cached chains back to front.
        Two passes: unpinned leaves first; PINNED blocks (chains preempted
        requests will re-match, :meth:`pin_chain`) go only when nothing
        else is left, so pins steer pressure without shrinking the
        reclaimable supply."""
        for take_pinned in (False, True):
            for uid, node in self._lru.items():
                if node.children or node.block_id in protect:
                    continue
                if (node.block_id in self._pinned) != take_pinned:
                    continue
                if int(pool.ref[node.block_id]) != 1:
                    continue
                del node.parent.children[node.key]
                del self._lru[uid]
                freed = pool.unref_block(node.block_id)
                assert freed, "trie held the only reference, block must free"
                self.evictions += 1
                if take_pinned:
                    self.pinned_evictions += 1
                return node.block_id
        return None

    def reclaimable(self, pool, protect=frozenset()) -> int:
        """Blocks repeated :meth:`evict_lru` calls could actually free:
        cached blocks whose ONLY reference is the trie and that are not
        protected.  Slot references are taken on root-anchored prefixes,
        so trie-exclusive nodes are downward-closed — every one of them is
        reachable by peeling leaves, making this an exact supply, not a
        bound.  The scheduler checks it BEFORE evicting: an admission that
        eviction cannot satisfy must refuse without trading away cache
        state other requests would have hit."""
        return sum(1 for n in self._lru.values()
                   if int(pool.ref[n.block_id]) == 1
                   and n.block_id not in protect)

    def cached_block_ids(self) -> set[int]:
        """Snapshot of every physical block id the trie holds a reference
        on — the public inspection surface for conservation tests; recency
        order is untouched (unlike :meth:`match`)."""
        return {n.block_id for n in self._lru.values()}

    def peek_chain(self, tokens) -> list[int]:
        """Physical block ids cached for the full-block prefix of
        ``tokens`` — a side-effect-free :meth:`match`: no LRU touch, no
        counter motion, and no last-token cap (the full cached chain)."""
        node, chain = self._root, []
        for key in self._keys(tokens):
            child = node.children.get(key)
            if child is None:
                break
            chain.append(child.block_id)
            node = child
        return chain

    def stats(self) -> dict:
        """Counters for serve-loop observability (DESIGN.md §10)."""
        return {"lookups": self.lookups, "hits": self.hits,
                "hit_rate": self.hits / max(1, self.lookups),
                "matched_tokens": self.matched_tokens,
                "inserted_blocks": self.inserted_blocks,
                "evictions": self.evictions,
                "pinned_evictions": self.pinned_evictions,
                "pinned_blocks": len(self._pinned),
                "cached_blocks": len(self._lru)}
