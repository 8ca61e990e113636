"""SLO-aware multi-tenant scheduler: admission, preemption, restore.

The serve loop (launch/serve.py) was FCFS admit-or-refuse: under burst
load it parked refused requests and could never reclaim capacity from
running sequences (ROADMAP item 4).  This module turns refusal-under-
pressure into degrade-under-pressure on top of the paged substrate:

  · Requests carry a PRIORITY CLASS (0 = most important) and move through
    WAITING -> RUNNING -> DONE, with PREEMPTED as the pressure detour.
  · Admission is head-of-line strict over a candidate order of
    (priority, PREEMPTED-before-WAITING, arrival, id): one refusal stops
    the admission round — a lower-priority request must never slip past a
    refused higher-priority one just because it is smaller.
  · A refused candidate backs off exponentially (``next_try`` ticks) and
    retries — never a permanent refusal.  When everything is backing off
    and nothing runs, an IDLE KICK clears the backoffs (progress
    guarantee: an empty machine never sits idle on a non-empty queue).
  · When a candidate cannot be placed, the scheduler PREEMPTS strictly-
    lower-priority victims (victim order: lowest priority class first,
    then shortest progress — cheapest to redo — then highest slot).  The
    strictness is the livelock guard: equals never preempt each other, so
    a preempted request re-admitted later cannot bounce its own usurper.

Two evacuation modes (DESIGN.md §12), both restoring BITWISE-identical
greedy outputs:

  swap       The victim's written device blocks are copied to host RAM
             (``BlockPool.swap_out`` host-tier accounting; a KVOps
             adapter moves the bytes), restore copies them back into a
             fresh admission (``swap_in``).  Bitwise trivially: the same
             bits come back.
  recompute  The victim's blocks are dropped (``release``); restore
             re-prefills the prompt — the prefix-cache trie usually still
             holds the prompt blocks (they are PINNED while the victim is
             out, steering LRU eviction away) — and then TEACHER-FORCES
             the already-delivered tokens back through the decode kernel
             (``Request.replay``).  Prefill and decode kernels are not
             bitwise-interchangeable, so generated tokens must replay
             through the same decode path that first produced them; the
             prompt re-prefill is bitwise by the global-chunk-grid
             invariant (§10).  Replayed tokens are not delivered twice.

SLO controls are WALL-CLOCK driven but bitwise-safe — they only reorder
work and resize the per-step prefill share, never a request's token
sequence:

  · ``slo_ttft_ms``: a request past its time-to-first-token budget gets
    effective priority -1 (ahead of every class, still preemption-inert).
  · ``slo_itl_ms``: when the recent delivered inter-token latency runs
    over budget, :meth:`Scheduler.prefill_quota` shrinks the prefill
    share of the step token budget (chunked-prefill interference is the
    knob) — chunk SHAPES never change, only how many run per step.

The scheduler is DEVICE-FREE: numpy + BlockPool + PrefixCache.  Device
bytes move through the three :class:`KVOps` closures serve.py provides
(read_blocks / write_blocks / copy_block over the donated cache pytree).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from collections.abc import Callable

import numpy as np

from repro_torch.runtime import telemetry

WAITING = "WAITING"
RUNNING = "RUNNING"
PREEMPTED = "PREEMPTED"
DONE = "DONE"


@dataclasses.dataclass
class KVOps:
    """Device-side byte movers the scheduler stays agnostic of.

    read_blocks(ids) -> opaque host rows for physical blocks `ids`;
    write_blocks(ids, rows, start) writes host rows for LOGICAL blocks
    [start, start + len(ids)) back into physical blocks `ids`;
    copy_block(src, dst) is the eager-COW duplicate.  serve.py binds them
    to models.model.{read,write}_paged_blocks / copy_paged_block over the
    live cache; pool-only tests bind plain dict stores."""
    read_blocks: Callable
    write_blocks: Callable
    copy_block: Callable


def null_kv_ops() -> KVOps:
    """KVOps for pool-accounting tests with no device state."""
    return KVOps(read_blocks=lambda ids: None,
                 write_blocks=lambda ids, rows, start: None,
                 copy_block=lambda src, dst: None)


@dataclasses.dataclass
class SchedulerConfig:
    preemption: str = "recompute"        # "swap" | "recompute"
    slo_ttft_ms: float = 0.0             # 0 = off
    slo_itl_ms: float = 0.0              # 0 = off
    backoff_base: int = 1                # ticks; doubles per failed attempt
    backoff_cap: int = 1                 # cap=1 == retry-every-tick (the
    #                                      pre-scheduler serve behavior;
    #                                      --retry-backoff raises it)

    def __post_init__(self):
        assert self.preemption in ("swap", "recompute")
        assert self.backoff_base >= 1 and self.backoff_cap >= 1


@dataclasses.dataclass
class Request:
    """One serving request through the WAITING/RUNNING/PREEMPTED/DONE
    lifecycle.  ``out`` is the delivered-token transcript — under greedy
    decoding it is the bitwise ground truth a restore must extend, and
    the teacher-forcing source for recompute replay."""
    id: int
    prompt: np.ndarray
    gen: int
    priority: int = 0
    arrival: int = 0                     # tick the request becomes visible
    state: str = WAITING
    slot: int | None = None
    pf_pos: int = 0                      # prompt tokens resident in KV
    decoding: bool = False               # prompt fully prefilled
    cur: int = -1                        # next token to feed the decoder
    remaining: int = 0                   # delivery budget left
    out: list = dataclasses.field(default_factory=list)
    replay: deque = dataclasses.field(default_factory=deque)
    matched: int = 0                     # trie match at last placement
    attempts: int = 0                    # refused placements since placed
    next_try: int = 0                    # earliest retry tick
    preemptions: int = 0
    pinned: list | None = None        # trie chain pinned while out
    admit_seq: int = -1                  # FCFS order among cold slots
    t_arrival: float = 0.0               # wall clock, for SLO accounting
    t_first: float | None = None
    t_last: float | None = None
    ttft_ms: float | None = None

    @property
    def plen(self) -> int:
        return int(np.asarray(self.prompt).size)

    @property
    def total(self) -> int:
        return self.plen + int(self.gen)


_COUNTER_NAMES = ("admissions", "refusals", "idle_kicks", "preempts_swap",
                  "preempts_recompute", "restores_swap",
                  "restores_recompute", "failures", "slo_boosts")


class Scheduler:
    """Priority/SLO admission + preemption policy over one BlockPool.

    Owns the request queue and the slot->request map; the serve loop owns
    the device work (prefill chunks, decode steps) and calls back in:
    ``add`` on arrival, ``admit`` once per tick, ``deliver`` per generated
    token, ``finish`` at budget exhaustion, ``fail_running`` on injected
    worker failures, ``cancel`` to drop a request in any state."""

    def __init__(self, pool, prefix, kv: KVOps | None = None,
                 cfg: SchedulerConfig | None = None, *,
                 metrics: telemetry.MetricsRegistry | None = None,
                 tracer=None):
        self.pool = pool
        self.prefix = prefix
        self.kv = kv if kv is not None else null_kv_ops()
        self.cfg = cfg if cfg is not None else SchedulerConfig()
        if self.cfg.preemption == "swap":
            assert pool.host_blocks > 0, \
                "swap preemption needs a host tier (--host-blocks)"
        self.queue: list[Request] = []       # WAITING + PREEMPTED
        self.by_slot: dict[int, Request] = {}
        self.done: dict[int, Request] = {}
        self._host_rows: dict[int, object] = {}   # req id -> swapped bytes
        self._itl_recent: deque = deque(maxlen=64)
        self.refused_ids: set = set()
        self.n_admitted = 0
        self.prefill_tokens_saved = 0
        # all stats live in a MetricsRegistry (a private one when the
        # caller didn't wire telemetry in — the counters/class_stats APIs
        # then behave exactly as before).  `tracer`, when given, gets one
        # lifecycle instant per request state transition.
        self.metrics = metrics if metrics is not None \
            else telemetry.MetricsRegistry()
        self.tracer = tracer
        self._c = {n: self.metrics.counter(f"sched/{n}")
                   for n in _COUNTER_NAMES}
        self._classes: set[int] = set()

    @property
    def counters(self) -> dict:
        """Counter name -> value (the pre-registry dict shape; tests and
        the serve summary read this)."""
        return {n: c.value for n, c in self._c.items()}

    # -------------------------------------------------------- telemetry
    def _instant(self, name: str, r: Request, args: dict | None = None
                 ) -> None:
        """One lifecycle instant on the request's trace thread
        (tid 1000+id; tid 0 is the engine timeline)."""
        if self.tracer is not None:
            self.tracer.instant(name, tid=1000 + r.id, args=args)

    def _class_hist(self, r: Request, kind: str) -> telemetry.Histogram:
        self._classes.add(r.priority)
        return self.metrics.histogram(
            f"sched/class{r.priority}/{kind}_ms")

    # ------------------------------------------------------------ lifecycle
    def add(self, req: Request, now: float = 0.0) -> None:
        assert req.state == WAITING
        req.t_arrival = now
        req.remaining = int(req.gen)
        self.queue.append(req)
        self._instant("enqueued", req,
                      {"priority": req.priority, "plen": req.plen,
                       "gen": int(req.gen)})

    def running(self) -> list:
        """RUNNING requests in slot order (the per-step iteration order)."""
        return [self.by_slot[s] for s in sorted(self.by_slot)]

    def deliver(self, r: Request, token: int, now: float) -> None:
        """Account one DELIVERED token (never called for replayed ones):
        transcript, budget, and the wall-clock TTFT/ITL samples the class
        stats and the ITL controller read."""
        r.out.append(int(token))
        r.remaining -= 1
        if r.t_first is None:
            r.t_first = now
            r.ttft_ms = (now - r.t_arrival) * 1e3
            self._class_hist(r, "ttft").record(r.ttft_ms)
        else:
            itl = (now - r.t_last) * 1e3
            self._class_hist(r, "itl").record(itl)
            self._itl_recent.append(itl)
        r.t_last = now

    def finish(self, r: Request) -> None:
        assert r.state == RUNNING and r.remaining == 0 and not r.replay
        self.pool.release(r.slot)
        del self.by_slot[r.slot]
        r.slot, r.decoding, r.state = None, False, DONE
        self.done[r.id] = r
        self._classes.add(r.priority)
        self.metrics.inc(f"sched/class{r.priority}/done")
        self._instant("finished", r, {"tokens": len(r.out)})

    def cancel(self, r: Request) -> None:
        """Drop a request in any live state.  The PREEMPTED-with-swap case
        is the double-unref edge: the victim's device
        references were already dropped at swap_out — its trie-cached
        prompt blocks belong to the trie alone — so cancelling frees HOST
        ids only (``swap_free``) and must not touch device refcounts."""
        if r.state == RUNNING:
            self.pool.release(r.slot)
            del self.by_slot[r.slot]
        elif r.state == PREEMPTED:
            if r.id in self.pool.swapped:
                self.pool.swap_free(r.id)
                self._host_rows.pop(r.id, None)
            self._unpin(r)
            self.queue.remove(r)
        elif r.state == WAITING:
            self.queue.remove(r)
        r.slot, r.decoding, r.state = None, False, DONE

    # ------------------------------------------------------------ admission
    def admit(self, tick: int, now: float = 0.0) -> None:
        """One admission round: place candidates in strict head-of-line
        order, preempting strictly-lower-priority victims when placement
        refuses; stop at the first candidate that cannot be placed even
        after preemption (it backs off)."""
        while True:
            r = self._next_candidate(tick, now)
            if r is None:
                return
            placed = self._try_place(r, now)
            while not placed and self._preempt_for(r, tick):
                placed = self._try_place(r, now)
            if not placed:
                self._refuse(r, tick)
                return

    def _eff_priority(self, r: Request, now: float) -> int:
        """Priority used for ORDERING (not preemption rights): a request
        past its TTFT budget jumps every class.  Preemption compares raw
        classes only — an SLO boost must not let equals evict each other
        (that thrash is the livelock the strictness guard exists for)."""
        if (self.cfg.slo_ttft_ms and r.t_first is None
                and (now - r.t_arrival) * 1e3 > self.cfg.slo_ttft_ms):
            return -1
        return r.priority

    def _next_candidate(self, tick: int, now: float) -> Request | None:
        elig = [r for r in self.queue
                if r.arrival <= tick and r.next_try <= tick]
        if not elig:
            arrived = [r for r in self.queue if r.arrival <= tick]
            if arrived and not self.by_slot:
                # idle kick: every arrived request is backing off and
                # nothing runs — clear the backoffs rather than idle
                for r in arrived:
                    r.next_try = tick
                self._c["idle_kicks"].inc()
                elig = arrived
            else:
                return None
        best = min(elig, key=lambda r: (self._eff_priority(r, now),
                                        0 if r.state == PREEMPTED else 1,
                                        r.arrival, r.id))
        if self._eff_priority(best, now) < best.priority:
            self._c["slo_boosts"].inc()
        return best

    def _evict_to_fit(self, total: int, chain, matched: int) -> None:
        """The evict-only-if-it-helps guard from the pre-scheduler serve
        loop: reclaim LRU trie-only leaves exactly when block shortage is
        the refusal cause AND the reclaimable supply can close the gap."""
        layout = self.pool.layout
        n_full = matched // layout.block_size
        protect = frozenset(chain)
        need = layout.blocks_for(total) - n_full
        if (total <= layout.max_len and need > self.pool.num_free
                and self.pool.num_free
                + self.prefix.reclaimable(self.pool, protect) >= need):
            while not self.pool.can_admit(total, n_shared=n_full):
                if self.prefix.evict_lru(self.pool, protect=protect) is None:
                    break

    def _try_place(self, r: Request, now: float) -> bool:
        if r.id in self.pool.swapped:
            return self._try_restore_swap(r, now)
        prompt = np.asarray(r.prompt)
        total = r.total
        chain, matched = [], 0
        if self.prefix is not None and self.pool.free_slots():
            chain, matched = self.prefix.match(prompt, record=False)
            self._evict_to_fit(total, chain, matched)
        if chain:
            got = self.pool.admit_shared(matched, total, chain)
            if got is None:
                return False
            slot, cow = got
            for src, dst in cow:
                self.kv.copy_block(src, dst)
        else:
            slot = self.pool.admit(0, total)
            if slot is None:
                return False
        restored = r.state == PREEMPTED
        self._place(r, slot, matched, now)
        # recompute restore: the prompt re-prefills from the trie match
        # (bitwise by the chunk-grid invariant), then the already-delivered
        # tokens TEACHER-FORCE through the decode kernel without being
        # delivered again — decode rows must come from the decode path
        r.pf_pos = matched
        r.decoding = False
        r.replay = deque(r.out)
        r.cur = -1 if not restored else r.cur   # re-seeded at prompt end
        if restored:
            self._c["restores_recompute"].inc()
            self._instant("restored", r, {"mode": "recompute",
                                          "matched": matched})
        else:
            self._c["admissions"].inc()
            self._instant("admitted", r, {"slot": slot, "matched": matched})
            if self.prefix is not None:
                self.prefix.record(matched)     # one lookup per admission
        return True

    def _try_restore_swap(self, r: Request, now: float) -> bool:
        rec = self.pool.swapped[r.id]
        prompt = np.asarray(r.prompt)
        chain, matched = [], 0
        if self.prefix is not None and self.pool.free_slots():
            # a trie match shrinks the host write-back; the match may have
            # GROWN past the swapped prefill position while the victim was
            # out (donors finished) — swap_in accounts the max
            chain, matched = self.prefix.match(prompt, record=False)
            self._evict_to_fit(rec.budget, chain, matched)
        got = self.pool.swap_in(r.id, chain, matched)
        if got is None:
            return False
        slot, cow, rec = got
        for src, dst in cow:
            self.kv.copy_block(src, dst)
        f = matched // self.pool.layout.block_size
        nb = self.pool.layout.blocks_for(rec.n_tokens) if rec.n_tokens else 0
        rows = self._host_rows.pop(r.id, None)
        ids = self.pool.block_ids(slot)[f:nb]
        if len(ids):
            self.kv.write_blocks(ids, rows, f)
        self._place(r, slot, matched, now)
        if r.decoding:
            # resume exactly where the victim stopped: all plen+|out| rows
            # are back, cur was saved — no replay needed, bitwise trivially
            r.pf_pos = r.plen
        else:
            r.pf_pos = max(matched, rec.n_tokens)   # mid-prefill victim
        self._c["restores_swap"].inc()
        self._instant("restored", r, {"mode": "swap", "matched": matched})
        return True

    def _place(self, r: Request, slot: int, matched: int, now: float) -> None:
        self._unpin(r)
        self.queue.remove(r)
        r.slot = slot
        r.state = RUNNING
        r.matched = matched
        r.attempts = 0
        r.remaining = int(r.gen) - len(r.out)
        r.admit_seq = self.n_admitted
        self.n_admitted += 1
        self.prefill_tokens_saved += matched
        self.by_slot[slot] = r

    def _refuse(self, r: Request, tick: int) -> None:
        if not self.pool.active.any():
            # nothing running, nothing preemptible: a request the EMPTY
            # pool refuses can never fit (same terminal condition the
            # pre-scheduler loop raised on)
            total = (self.pool.swapped[r.id].budget
                     if r.id in self.pool.swapped else r.total)
            raise RuntimeError(
                f"request {r.id} ({total} tokens) can never fit the pool "
                f"({self.pool.layout.num_blocks - 1} blocks)")
        r.attempts += 1
        r.next_try = tick + min(
            self.cfg.backoff_base << min(r.attempts - 1, 5),
            self.cfg.backoff_cap)
        self.refused_ids.add(r.id)
        self._c["refusals"].inc()
        self._instant("refused", r, {"attempts": r.attempts,
                                     "next_try": r.next_try})

    # ----------------------------------------------------------- preemption
    def _preempt_for(self, r: Request, tick: int) -> bool:
        victims = [v for v in self.by_slot.values()
                   if v.priority > r.priority]
        if not victims:
            return False
        v = min(victims, key=lambda v: (-v.priority,
                                        int(self.pool.lengths[v.slot]),
                                        -v.slot))
        self.preempt(v, tick)
        return True

    def preempt(self, v: Request, tick: int,
                mode: str | None = None) -> str:
        """Evacuate RUNNING request `v`.  Tries the configured mode; swap
        falls back to recompute when the host tier cannot absorb the
        victim (graceful degradation, never a refusal).  Returns the mode
        actually used."""
        assert v.state == RUNNING
        mode = mode or self.cfg.preemption
        slot = v.slot
        used = "recompute"
        if mode == "swap" and self.pool.host_blocks:
            n = int(self.pool.lengths[slot])
            nb = self.pool.layout.blocks_for(n) if n else 0
            if nb <= self.pool.host_free:
                ids = self.pool.block_ids(slot)[:nb]
                rows = self.kv.read_blocks(ids) if nb else None
                rec = self.pool.swap_out(slot, v.id)
                assert rec is not None
                if rows is not None:
                    self._host_rows[v.id] = rows
                used = "swap"
        if used == "recompute":
            if self.prefix is not None:
                # steer LRU eviction away from the prompt chain the
                # restore will re-match (best-effort, DESIGN.md §12)
                chain, _ = self.prefix.match(np.asarray(v.prompt),
                                             record=False)
                if chain:
                    self.prefix.pin_chain(chain)
                    v.pinned = list(chain)
            self.pool.release(slot)
        self._c[f"preempts_{used}"].inc()
        self._classes.add(v.priority)
        self.metrics.inc(f"sched/class{v.priority}/preemptions")
        self._instant("preempted", v, {"mode": used})
        v.preemptions += 1
        v.state = PREEMPTED
        v.slot = None
        v.next_try = tick           # eligible immediately; sorts first
        del self.by_slot[slot]
        self.queue.append(v)
        return used

    def fail_running(self, slot: int, tick: int) -> Request:
        """Injected worker failure on `slot` (satellite: fault_tolerance
        wiring): the device state is deemed LOST, so the victim is always
        requeued through the recompute path — restore re-prefills and
        replays, bitwise-identical to the unfailed run."""
        v = self.by_slot[slot]
        self.preempt(v, tick, mode="recompute")
        self._c["failures"].inc()
        self._instant("failed", v, {"slot": slot, "tick": tick})
        return v

    def _unpin(self, r: Request) -> None:
        if r.pinned:
            self.prefix.unpin_chain(r.pinned)
            r.pinned = None

    # ------------------------------------------------------------------ SLO
    def prefill_quota(self, base_tokens: int) -> int:
        """Per-step prefill token allowance under the ITL SLO.  Chunked-
        prefill interference is the knob: over-budget recent delivered ITL
        shrinks the prefill share proportionally (floor one token — the
        progress guarantee).  Chunk SHAPES and the global chunk grid are
        untouched, so outputs stay bitwise; only how many chunks run per
        step changes."""
        if not self.cfg.slo_itl_ms or len(self._itl_recent) < 8:
            return base_tokens
        p50 = float(np.median(np.asarray(self._itl_recent)))
        if p50 <= self.cfg.slo_itl_ms:
            return base_tokens
        return max(1, int(base_tokens * max(0.25, self.cfg.slo_itl_ms / p50)))

    # ------------------------------------------------------------ reporting
    def class_stats(self) -> dict:
        """Per-priority-class latency tails:
        {class: {n, preemptions, ttft_p50_ms, ttft_p99_ms, itl_p50_ms,
        itl_p99_ms}} — the BENCH_serve.json payload.

        Read straight from the registry's per-class histograms — the same
        instruments ``--metrics-out`` exports (sched/class{c}/ttft_ms,
        .../itl_ms), so the summary's tails and the archived snapshot can
        never disagree.  Resolution is the histogram contract: exact
        nearest-rank percentile of values quantized within ~1%
        (tests/test_telemetry.py pins it against exact percentiles)."""
        out = {}
        for cls in sorted(self._classes):
            ttft = self.metrics.histogram(f"sched/class{cls}/ttft_ms")
            itl = self.metrics.histogram(f"sched/class{cls}/itl_ms")
            out[cls] = {
                "n": self.metrics.counter(f"sched/class{cls}/done").value,
                "preemptions": self.metrics.counter(
                    f"sched/class{cls}/preemptions").value,
                "ttft_p50_ms": ttft.percentile(50),
                "ttft_p99_ms": ttft.percentile(99),
                "itl_p50_ms": itl.percentile(50),
                "itl_p99_ms": itl.percentile(99),
            }
        return out

    def stats(self) -> dict:
        out = dict(self.counters)
        out["preemptions"] = (out["preempts_swap"]
                              + out["preempts_recompute"])
        out["queued"] = len(self.queue)
        out["running"] = len(self.by_slot)
        out["done"] = len(self.done)
        return out
