"""Serving driver — the port of ``repro/launch/serve.py``.  Two cache
layouts:

  paged (default, :func:`run_paged`) — continuous batching over the paged
      KV cache (the MLA latent pool, or a GQA model's {"k", "v"} pools).
      Ragged requests are admitted into free batch slots when the
      allocator can reserve their whole token budget; their prompts run
      as chunked paged prefill interleaved with the decode batch under a
      per-step token budget; decode steps run the whole ragged batch
      through the paged decode kernels (a GQA model: the dense ones over
      the gathered pools); and finished sequences release
      their blocks so queued requests join mid-stream.  The scheduler
      (priorities, preemption by swap or recompute, SLOs, prefix cache) is
      the reference's, copied.

  dense (:func:`run_dense`) — the fixed-batch path: one full-sequence
      prefill of B prompts, then ``--gen`` decode steps in which every
      sequence runs every step, over a [B, prompt + gen, latent] cache (or
      [B, prompt + gen, K, hd] K and V caches for a GQA model).

``--mode etap`` (default) runs the paper's transposed decode kernels;
``--mode standard`` the untransposed baseline, on either layout.

``--arch`` picks the model: DeepSeek-R1 (MLA and MoE, the default; on
one card cut its depth with ``--layers``: 3 is its dense layers, 5 adds
its first two MoE layers of 256 experts), a full-attention GQA model
(``qwen3_8b``, ``granite_20b`` and ``llava_next_34b`` at head_dim 128;
``smollm_360m``, ``stablelm_1_6b`` and ``musicgen_large`` at 64; the MoE
models ``dbrx_132b`` and ``llama4_maverick_400b`` at 128),
RecurrentGemma-9B (RG-LRU and local attention at head_dim 256, dense
layout only), or Falcon-Mamba-7B.  A MoE layer routes a decode step's B
tokens as one group and each prompt chunk's rows as groups, dropless
(``models/moe.py``), on both layouts; the dense layout's single-shot
prefill routes with capacity, as the reference's does.  A GQA model
decodes through the dense kernels K5-K8 over its cache's grouped rows (the
paged layout gathers its pools first, as the reference does); on the card
they are built at head_dim 64, 128 and 256
(``kernels/csrc/mma_tile.cuh``).  MusicGen's and
LLaVA-NeXT's frontends project precomputed embeddings; serving runs in
token space, as the reference's does.

``--kv-dtype int8|fp8`` stores the paged pools as codes with per-row
(scale, zp) pairs (per kv head for a GQA model), the pool sized to the fp
pool's bytes, so it holds about twice the slots: DeepSeek's ETAP decode
reads the latent code pool in place (K3q / K1q), its ``--mode standard``
and a GQA model (either mode) gather codes and pairs for the quantized
dense kernels K5q-K8q; chunked prefill runs K4q (DeepSeek) or the plain
product on the dequantized rows (GQA).  The dense layout takes the flag and
ignores it, as the reference's ``run_dense`` does.

``--spec-tokens k`` turns on speculative decoding on the paged layout: a
host-side drafter (``--spec-draft ngram``, the longest-suffix match over
the committed stream, or ``head``, an embedding-similarity chain) proposes
k-1 tokens for every decoding slot with k or more tokens left, one
``model.verify_step`` scores [cur, d_1, .., d_{k-1}] for those slots in
one launch a layer (DeepSeek: K4, or K4q over codes; a GQA model: the
reference's masked product), and greedy acceptance keeps the delivered
streams those of one-at-a-time greedy decode; the other decoding slots take
the one-token step.

``--arch falcon_mamba_7b`` serves Falcon-Mamba-7B on the dense layout (its
prefill runs the selective-scan kernel in every layer); its state is per
sequence, so the paged layout raises the reference's ``ValueError``, and
``--mode`` / ``--kv-dtype`` are accepted and not read, as in the reference.
``--arch recurrentgemma_9b`` is the same: the dense layout (its local
attention decodes over a ring of ``window`` rows, in either ``--mode``),
and the reference's ``ValueError`` on the paged one.

    PYTHONPATH=src python -m repro_torch.launch.serve --batch 8 \\
        --requests 16 --prompt 512 --gen 32 --layers 3
    PYTHONPATH=src python -m repro_torch.launch.serve --cache-layout dense \\
        --mode standard --batch 4 --prompt 4096 --gen 32 --layers 3
    PYTHONPATH=src python -m repro_torch.launch.serve --batch 8 \\
        --requests 16 --prompt 512 --gen 32 --layers 5
    PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx_132b \\
        --layers 4 --batch 8 --requests 4 --prompt 512 --gen 16 --kv-splits 1
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon_mamba_7b \\
        --cache-layout dense --batch 8 --prompt 512 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_8b \\
        --batch 8 --requests 16 --prompt 512 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_8b \\
        --reduced --device cpu --batch 2 --prompt 24 --gen 6
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_360m \\
        --batch 8 --requests 16 --prompt 512 --gen 32 --kv-dtype int8
    PYTHONPATH=src python -m repro_torch.launch.serve --batch 8 \\
        --requests 16 --prompt 512 --gen 32 --layers 3 --spec-tokens 4
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --layers 1 \\
        --device cpu --batch 2 --prompt 24 --gen 8 --spec-tokens 4 \\
        --spec-draft head
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma_9b --cache-layout dense --batch 1 \\
        --prompt 4096 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --layers 1 \\
        --device cpu --batch 2 --prompt 24 --gen 8 --requests 4 \\
        --page-size 8 --prefill-chunk 8 --fault-rate 0.2 \\
        --trace-out t.json --metrics-out m.json --profile-kernels 1

Fault drills and telemetry export, as the reference's: ``--fault-rate r``
fails the decode worker every round(1/r) ticks and requeues its victim
through the recompute path (the outputs stay those of the run without);
every stat lands in one metrics registry, rendered into the ``[serve]``
lines (``launch/obs.py``) and written by ``--metrics-out`` (also on the
dense layout); ``--trace-out`` writes the request lifecycle and the
prefill / decode / verify spans as Chrome trace-event JSON, in a ring of
``--trace-buffer`` events; ``--profile-kernels N`` times every N-th
attention entry launch between two device syncs and sets it against the
card's HBM rate (``launch/roofline.py``).  On the card the profile is
wall time a launch, so a small decode entry's row shows its wrapper's
host time too.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from collections import deque

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.core.attn_spec import AttnSpec
from repro_torch.kernels import softmax_state
from repro_torch.launch import obs
from repro_torch.models import model
from repro_torch.runtime import scheduler, spec_decode, telemetry
from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                 HeartbeatRegistry,
                                                 WorkerFailure)
from repro_torch.runtime.paged_cache import (BlockPool, layout_for,
                                             layout_for_bytes)
from repro_torch.runtime.prefix_cache import PrefixCache


def _make_requests(args, vocab: int):
    """Ragged request stream: prompt/gen lengths drawn from a few buckets
    around --prompt/--gen, with the reference's numpy streams, so a seed
    yields the reference's requests token for token.  ``--shared-prefix N``
    starts every prompt with the same N tokens; ``--priority-classes`` and
    ``--arrival-rate`` draw from separate streams.  Prompts are int32
    numpy arrays (host data)."""
    rng = np.random.default_rng(args.seed + 1)
    p_buckets = sorted({max(1, args.prompt // 2), max(1, 3 * args.prompt // 4),
                        args.prompt})
    g_buckets = sorted({max(1, args.gen // 2), args.gen})
    shared = None
    if args.shared_prefix:
        shared = rng.integers(0, vocab, size=(args.shared_prefix,))
    n = args.requests
    prios = [0] * n
    if args.priority_classes > 1:
        prng = np.random.default_rng(args.seed + 2)
        prios = prng.integers(0, args.priority_classes, size=n).tolist()
    arrivals = [0] * n
    if args.arrival_rate > 0:
        arng = np.random.default_rng(args.seed + 3)
        if args.trace == "burst":
            bsz = max(1, args.burst_size)
            gap = max(1, round(bsz / args.arrival_rate))
            arrivals = [(i // bsz) * gap for i in range(n)]
        else:
            gaps = arng.exponential(1.0 / args.arrival_rate, size=n)
            arrivals = np.floor(np.cumsum(gaps)).astype(int).tolist()
    reqs = []
    for i in range(n):
        plen = int(rng.choice(p_buckets))
        glen = int(rng.choice(g_buckets))
        if shared is None:
            toks = rng.integers(0, vocab, size=(plen,))
        else:
            plen = max(plen, args.shared_prefix + 1)
            tail = rng.integers(0, vocab, size=(plen - args.shared_prefix,))
            toks = np.concatenate([shared, tail])
        reqs.append({"id": i, "prompt": np.asarray(toks, np.int32),
                     "gen": glen, "priority": int(prios[i]),
                     "arrival": int(arrivals[i])})
    return reqs


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_dense(args, cfg, *, params=None, tokens=None, device="cuda") -> dict:
    """Fixed-batch serving over the dense cache (the reference's
    ``run_dense``): prefill B prompts of ``--prompt`` tokens, then
    ``--gen`` greedy decode steps for every sequence.  The reference jits
    the steps into one ``lax.scan``; the port loops in Python, one
    :func:`model.decode_step` per token.

    ``params`` hands in weights (None: the port's seeded init); ``tokens``
    [B, prompt] the prompts (None: drawn from ``--seed`` with numpy; the
    reference draws them with ``jax.random``, so a test hands its prompts
    in).  ``--metrics-out`` writes the run's registry snapshot.  Returns the
    generated tokens [B, gen] (each step's input token, as the reference's
    scan emits them), the timings and the snapshot."""
    reg = telemetry.MetricsRegistry()
    if params is None:
        params = model.init(cfg, seed=args.seed, device=device)
    B, S = args.batch, args.prompt
    if tokens is None:
        tokens = np.random.default_rng(args.seed + 1).integers(
            0, cfg.vocab_size, size=(B, S))
    tokens = torch.as_tensor(np.array(tokens, np.int32), dtype=torch.int32,
                             device=device)
    max_len = S + args.gen
    spec = AttnSpec(mode=args.mode, kv_splits=args.kv_splits)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache, pos = model.prefill(params, cfg, tokens, max_len)
    cur = torch.argmax(logits, dim=-1).to(torch.int32)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    t0 = time.perf_counter()
    gen = []
    for i in range(args.gen):
        gen.append(cur)
        logits, cache = model.decode_step(params, cfg, cache, cur, pos + i,
                                          spec=spec, cache_layout="dense")
        cur = torch.argmax(logits, dim=-1).to(torch.int32)
    gen = torch.stack(gen, dim=1).cpu()                       # syncs
    t_decode = time.perf_counter() - t0
    tokens_served = int(gen.numel())
    reg.counter("serve/decode_tokens").inc(tokens_served)
    reg.counter("serve/decode_steps").inc(int(args.gen))
    snap = reg.snapshot()
    if args.metrics_out:
        obs.write_metrics(args.metrics_out, snap,
                          config=f"serve:{args.arch}:dense", device=device)
    for line in obs.summarize_dense(snap, {
            "arch": args.arch, "device": obs.device_name(device),
            "mode": args.mode, "rescale": softmax_state.default_mode(),
            "batch": B, "prompt": S, "gen": args.gen,
            "t_prefill": t_prefill, "t_decode": t_decode,
            "metrics_path": args.metrics_out,
            "sample": gen[0][:16].tolist()}):
        obs.emit(line)
    return {"tokens": gen.numpy(), "t_prefill": t_prefill,
            "t_decode": t_decode, "tokens_served": tokens_served,
            "steps": args.gen, "metrics": snap}


def paged_layout(args, cfg):
    """The paged pool's layout and batch slots for ``args``: ``--batch``
    slots of ``--prompt + --gen`` rows over bf16 rows; over int8 / fp8 rows
    the pool keeps the bf16 layout's bytes and the cheaper rows buy more
    blocks, and with them more batch slots (about 2x at int8).  Returns
    ``(layout, batch_slots)``."""
    max_total = args.prompt + args.gen
    layout = layout_for(args.batch, max_total, block_size=args.page_size,
                        spare_blocks=args.spare_blocks)
    if args.kv_dtype == "fp":
        return layout, args.batch
    budget_bytes = ((layout.num_blocks - 1) * layout.block_size
                    * model.paged_row_bytes(cfg, "fp"))
    return layout_for_bytes(budget_bytes,
                            model.paged_row_bytes(cfg, args.kv_dtype),
                            max_total, block_size=args.page_size,
                            spare_blocks=args.spare_blocks)


def run_paged(args, cfg, *, params=None, device="cuda") -> dict:
    """Continuous-batching serve loop (the reference's ``run_paged``).

    Per tick: (0) arrivals join the scheduler queue (``--paranoia N`` runs
    the pool audit; a missed heartbeat counts a worker restart); (1) the
    scheduler admits, restores and preempts; (2) prefill chunks of
    ``--prefill-chunk`` tokens run from cold slots while they fit the
    step's token budget, the first chunk after a cache hit or restore
    ending on the global chunk grid so every later chunk has the uncached
    run's shape, and itself run from the grid point with the rows the pool
    holds recomputed, not written (``prefill_chunk(n_cached=...)``), so it
    has that shape too; (3) one paged decode step runs over the decoding
    slots (the other slots' table rows masked to the null block), then
    finished sequences retire.

    ``--fault-rate r`` injects a decode-worker failure every round(1/r)
    ticks (``FailureInjector.from_rate``) at a tick with decoding slots:
    the step is skipped, the highest decoding slot is requeued through the
    recompute path (``Scheduler.fail_running``), and the heartbeat the tick
    does not beat shows as one worker restart on the next.  A restored
    victim re-prefills its prompt and teacher-forces its delivered tokens,
    and the loop asserts that the kernels re-derive each of them exactly.

    Telemetry: one ``MetricsRegistry`` for the run (``--metrics-out``
    writes its snapshot); ``--trace-out`` records the request lifecycle
    (scheduler instants) and ``prefill_chunk`` / ``decode_step`` /
    ``verify_step`` spans, each closed after the device sync that reading
    its tokens forces, into a ring of ``--trace-buffer`` events;
    ``--profile-kernels N`` times every N-th attention entry launch
    (``core/attn_spec.attn_entry``), installed after the warm-up.  None of
    them changes the served tokens.

    With ``--spec-tokens k`` every decoding slot that is not replaying a
    restore and has k or more tokens left is a spec slot: the drafter
    proposes k-1 tokens from its committed stream, and one
    :func:`model.verify_step` over the spec slots (the others masked)
    scores [cur, d_1, .., d_{k-1}]; the slot's budget is extended by k,
    :func:`spec_decode.accept_greedy` keeps the longest matching draft
    prefix, and the rejected tail is rewound in place
    (``BlockPool.truncate(..., free_blocks=False)``).  The one-token step
    runs over the other decoding slots only.

    ``params`` hands in weights (e.g. converted from the reference's with
    :func:`repro_torch.models.convert.params_from_jax`); None draws them
    from the port's own seeded init.  Returns the outputs per request id
    and the run's counters, timings, metrics snapshot and kernel report."""
    model.check_pageable(cfg)            # before any weights are made
    reg = telemetry.MetricsRegistry()
    tracer = (telemetry.Tracer(capacity=args.trace_buffer)
              if args.trace_out else None)
    if params is None:
        params = model.init(cfg, seed=args.seed, device=device)
    layout, B = paged_layout(args, cfg)
    host_blocks = args.host_blocks
    if args.preemption == "swap" and host_blocks == 0:
        host_blocks = layout.num_blocks - 1   # host tier mirrors the pool
    bp = BlockPool(layout, B, host_blocks=host_blocks, metrics=reg)
    prefix = PrefixCache(layout.block_size) if args.prefix_cache else None
    holder = {"cache": model.init_paged_cache(cfg, layout,
                                              kv_dtype=args.kv_dtype,
                                              device=device)}
    pending = deque(sorted(_make_requests(args, cfg.vocab_size),
                           key=lambda r: (r["arrival"], r["id"])))
    n_requests = len(pending)
    chunk = max(1, args.prefill_chunk)
    budget = args.token_budget if args.token_budget > 0 else B + chunk

    def _kv_read(ids):
        return model.read_paged_blocks(holder["cache"], ids)

    def _kv_write(ids, rows, start):
        sel = {k: r[:, start:start + len(ids)] for k, r in rows.items()}
        holder["cache"] = model.write_paged_blocks(holder["cache"], ids, sel)

    def _kv_copy(src, dst):
        holder["cache"] = model.copy_paged_block(holder["cache"], src, dst)

    sched = scheduler.Scheduler(
        bp, prefix,
        scheduler.KVOps(_kv_read, _kv_write, _kv_copy),
        scheduler.SchedulerConfig(
            preemption=args.preemption, slo_ttft_ms=args.slo_ttft,
            slo_itl_ms=args.slo_itl,
            backoff_cap=max(1, args.retry_backoff)),
        metrics=reg, tracer=tracer)
    injector = (FailureInjector.from_rate(args.fault_rate, metrics=reg)
                if args.fault_rate > 0 else None)
    tick = 0
    # heartbeats on the tick clock (the lambda reads ``tick`` when called):
    # a beat every tick is alive (gap 1 <= 1.5); the beat a failure tick
    # skips (gap 2) trips dead()
    hb = HeartbeatRegistry(timeout_s=1.5, clock=lambda: float(tick),
                           metrics=reg)
    worker = "decode-worker-0"
    spec = AttnSpec(mode=args.mode, kv_splits=args.kv_splits,
                    kv_dtype=args.kv_dtype)

    def step_fn(cache, toks, table, lengths):
        return model.decode_step(params, cfg, cache, toks, spec=spec,
                                 cache_layout="paged", block_table=table,
                                 lengths=lengths)

    def prefill_fn(cache, toks, table, lengths, n_cached):
        return model.prefill_chunk(params, cfg, cache, toks, table, lengths,
                                   spec=spec, n_cached=n_cached)

    def verify_fn(cache, toks, table, lengths):
        return model.verify_step(params, cfg, cache, toks, table, lengths,
                                 spec=spec)

    def masked(slots):
        """The table and lengths with every slot outside ``slots`` on the
        null block, so that a launch's rows for it land there."""
        table_m = bp.table.copy()
        lens_m = bp.lengths.copy()
        for b in range(B):
            if b not in slots:
                table_m[b] = 0
                lens_m[b] = 0
        return (torch.tensor(table_m, device=device),
                torch.tensor(lens_m, device=device))

    # warm-up outside the timed region (on the card this builds the kernels):
    # all slots inactive, so the dummy rows land in the null block
    table0, lengths0 = bp.device_views(device)
    logits0, holder["cache"] = step_fn(
        holder["cache"], torch.zeros(B, dtype=torch.int32, device=device),
        table0, lengths0)
    k_max = args.spec_tokens
    drafter, t_drafter = None, 0.0
    if k_max > 0:
        t_drafter = time.perf_counter()
        drafter = spec_decode.make_drafter(args.spec_draft, params,
                                           metrics=reg)
        t_drafter = time.perf_counter() - t_drafter
        logits0, holder["cache"] = verify_fn(
            holder["cache"],
            torch.zeros(B, k_max, dtype=torch.int32, device=device),
            table0, lengths0)
    _sync(device)
    del logits0

    c_tokens = reg.counter("serve/decode_tokens")
    c_steps = reg.counter("serve/decode_steps")
    c_spec_steps = reg.counter("serve/spec_verify_steps")
    c_spec_prop = reg.counter("serve/spec_proposed")
    c_spec_acc = reg.counter("serve/spec_accepted")
    c_chunks = reg.counter("serve/prefill_chunks")
    c_inter = reg.counter("serve/interleaved_steps")
    c_pf = reg.counter("serve/prefill_tokens")
    c_replay = reg.counter("serve/replayed_tokens")
    c_restarts = reg.counter("serve/worker_restarts")
    c_ticks = reg.counter("serve/ticks")
    g_queued = reg.gauge("sched/queued")
    g_running = reg.gauge("sched/running")
    t_prefill = 0.0

    # the profiler goes in after the warm-up, so no warm-up launch is
    # recorded, and comes out in the finally, so no run leaks it
    prof = None
    if args.profile_kernels:
        prof = telemetry.KernelProfiler(args.profile_kernels)
        telemetry.set_profiler(prof)
    t0 = time.perf_counter()
    try:
        while pending or sched.queue or sched.by_slot:
            now = time.perf_counter()
            # ---- (0) arrivals + paranoia sweep + heartbeat bookkeeping
            while pending and pending[0]["arrival"] <= tick:
                req = pending.popleft()
                sched.add(scheduler.Request(
                    id=req["id"], prompt=req["prompt"], gen=req["gen"],
                    priority=req["priority"], arrival=req["arrival"]), now)
            if args.paranoia and tick % args.paranoia == 0:
                bp.audit()
            if hb.dead():                 # missed beat = failure tick
                c_restarts.inc()          # ...the worker comes back below
                if tracer is not None:
                    tracer.instant("worker_restart", args={"tick": tick})

            # ---- (1) admission / restore / preemption (scheduler policy)
            sched.admit(tick, now)
            running = sched.running()
            dec = [r for r in running if r.decoding]
            # speculation takes slots with k_max or more deliveries left
            # (start + k_max then stays inside the slot's reserved budget)
            # that are not teacher-forcing a restore replay; the rest take
            # the one-token step
            spec_dec = [r for r in dec
                        if k_max > 0 and not r.replay and r.remaining >= k_max]
            spec_slots = {r.slot for r in spec_dec}
            # decode tokens this step (each spec slot runs k_max verify rows)
            spent = len(dec) + max(0, k_max - 1) * len(spec_dec)
            budget_eff = spent + sched.prefill_quota(max(0, budget - spent))

            # ---- (2) prefill chunks from cold slots under the budget
            pf_tokens = 0
            cold = sorted((r for r in running if not r.decoding),
                          key=lambda r: r.admit_seq)
            for r in cold:
                b = r.slot
                plen = r.plen
                c = min(chunk - r.pf_pos % chunk, plen - r.pf_pos)
                if spent + c > budget_eff and spent > 0:
                    break                     # budget spent — defer chunk
                # after a prefix-cache hit or a restore at a position off
                # the chunk grid, the chunk runs from the grid point with
                # the rows the pool holds recomputed, not written: every
                # row then comes from the chunk the uncached run gives it
                # (on the card a GEMM's row bits depend on its row count)
                n_cached = r.pf_pos % chunk
                tp = time.perf_counter()
                ts = tracer.now_us() if tracer is not None else 0.0
                toks_c = torch.as_tensor(
                    r.prompt[None, r.pf_pos - n_cached:r.pf_pos + c],
                    device=device)
                trow = torch.tensor(bp.table[b:b + 1], device=device)
                lrow = torch.tensor(bp.lengths[b:b + 1] - n_cached,
                                    device=device)
                logits, holder["cache"] = prefill_fn(holder["cache"], toks_c,
                                                     trow, lrow, n_cached)
                seed_tok = int(torch.argmax(logits[0, -1]))   # syncs
                t_prefill += time.perf_counter() - tp
                if tracer is not None:
                    tracer.complete("prefill_chunk", ts,
                                    args={"req": r.id, "tokens": c,
                                          "pf_pos": r.pf_pos})
                bp.extend(b, c)
                r.pf_pos += c
                spent += c
                pf_tokens += c
                c_pf.inc(c)
                c_chunks.inc()
                if r.pf_pos == plen:          # prompt done -> start decoding
                    if r.replay:
                        assert seed_tok == r.replay[0], \
                            f"request {r.id}: restore diverged at prefill " \
                            f"(got {seed_tok}, delivered {r.replay[0]})"
                    else:
                        r.cur = seed_tok
                    r.decoding = True
                    if prefix is not None:
                        prefix.insert(np.asarray(r.prompt), bp.block_ids(b),
                                      bp)

            # ---- fault drill: a failed decode worker's step never
            # lands; its victim is requeued through the recompute path and
            # the tick skips its heartbeat
            if dec and injector is not None:
                try:
                    injector.check(tick)
                except WorkerFailure:
                    victim = max(dec, key=lambda r: r.slot)
                    sched.fail_running(victim.slot, tick)
                    tick += 1
                    continue
            # ---- (3) one ragged decode step over the plain decoding slots
            plain = [r for r in dec if r.slot not in spec_slots]
            if plain:
                cur_arr = np.zeros((B,), np.int32)
                for r in plain:
                    cur_arr[r.slot] = r.replay[0] if r.replay else r.cur
                ts = tracer.now_us() if tracer is not None else 0.0
                logits, holder["cache"] = step_fn(
                    holder["cache"], torch.tensor(cur_arr, device=device),
                    *masked({r.slot for r in plain}))
                nxt = torch.argmax(logits, dim=-1).cpu().numpy()
                if tracer is not None:
                    tracer.complete("decode_step", ts,
                                    args={"slots": len(plain)})
                c_steps.inc()
                if pf_tokens:
                    c_inter.inc()
                now = time.perf_counter()
                for r in plain:
                    b = r.slot
                    if r.replay:
                        # teacher-forced replay of a restored recompute victim:
                        # the decode path must re-derive the next token exactly
                        fed = r.replay.popleft()
                        bp.append(b)
                        expect = r.replay[0] if r.replay else r.cur
                        assert int(nxt[b]) == int(expect), \
                            f"request {r.id}: replay diverged after token " \
                            f"{fed} (got {int(nxt[b])}, expected " \
                            f"{int(expect)})"
                        c_replay.inc()
                    else:
                        sched.deliver(r, r.cur, now)
                        c_tokens.inc()
                        bp.append(b)
                        r.cur = int(nxt[b])
                        if r.remaining == 0:
                            sched.finish(r)

            # ---- (3') one verify launch over the spec slots: draft k-1 tokens
            # a slot from its committed stream, score [cur, d_1, .., d_{k-1}],
            # keep the longest draft prefix the model's argmax chain agrees
            # with
            if spec_dec:
                tok_arr = np.zeros((B, k_max), np.int32)
                drafts = {}
                for r in spec_dec:
                    history = np.concatenate([np.asarray(r.prompt, np.int64),
                                              np.asarray(r.out + [r.cur],
                                                         np.int64)])
                    drafts[r.slot] = (list(drafter(history, k_max - 1))
                                      if k_max > 1 else [])
                    tok_arr[r.slot] = [r.cur] + drafts[r.slot]
                ts = tracer.now_us() if tracer is not None else 0.0
                logits, holder["cache"] = verify_fn(
                    holder["cache"], torch.tensor(tok_arr, device=device),
                    *masked(spec_slots))
                preds = torch.argmax(logits, dim=-1).cpu().numpy()   # [B, k]
                if tracer is not None:
                    tracer.complete("verify_step", ts,
                                    args={"slots": len(spec_dec),
                                          "k": k_max})
                c_steps.inc()
                c_spec_steps.inc()
                if pf_tokens:
                    c_inter.inc()
                now = time.perf_counter()
                for r in spec_dec:
                    b = r.slot
                    start = int(bp.lengths[b])
                    # the verify pass appended k_max rows; commit them, then
                    # rewind the rejected tail in place (the slot keeps its
                    # reservation; the stale rows past its length are never
                    # read before the next launch overwrites them)
                    bp.extend(b, k_max)
                    accepted, nxt_tok = spec_decode.accept_greedy(drafts[b],
                                                                  preds[b])
                    bp.truncate(b, start + 1 + accepted, free_blocks=False)
                    for t in [r.cur] + drafts[b][:accepted]:
                        sched.deliver(r, int(t), now)
                        c_tokens.inc()
                    c_spec_prop.inc(len(drafts[b]))
                    c_spec_acc.inc(accepted)
                    r.cur = int(nxt_tok)
                    if r.remaining == 0:
                        sched.finish(r)
            c_ticks.inc()
            bp.observe(reg)
            g_queued.set(len(sched.queue))
            g_running.set(len(sched.by_slot))
            hb.beat(worker)
            tick += 1
    finally:
        if prof is not None:
            telemetry.set_profiler(None)
    _sync(device)
    t_total = time.perf_counter() - t0
    t_decode = t_total - t_prefill

    outputs = {rid: r.out for rid, r in sorted(sched.done.items())}
    pstats = prefix.stats() if prefix is not None else None
    sstats = sched.stats()
    classes = sched.class_stats()
    tokens_served = c_tokens.value
    snap = reg.snapshot()
    krep = (obs.kernel_report(prof)
            if prof is not None and prof.records else None)
    trace_stats = (obs.write_trace(tracer, args.trace_out)
                   if tracer is not None else None)
    if args.metrics_out:
        obs.write_metrics(args.metrics_out, snap,
                          config=f"serve:{args.arch}:paged:{args.kv_dtype}",
                          device=device)
    first = outputs[0][:16] if outputs.get(0) else []
    for line in obs.summarize_paged(snap, {
            "arch": args.arch, "device": obs.device_name(device),
            "mode": args.mode, "batch_slots": B, "n_requests": n_requests,
            "page_size": layout.block_size,
            "pool_blocks": layout.num_blocks - 1,
            "host_blocks": host_blocks, "chunk": chunk, "budget": budget,
            "kv_dtype": args.kv_dtype,
            "rescale": softmax_state.default_mode(),
            "prefix": pstats, "preemption": args.preemption,
            "spec_tokens": k_max, "spec_draft": args.spec_draft,
            "t_prefill": t_prefill, "t_decode": t_decode,
            "refusals": len(sched.refused_ids),
            "prefill_tokens_saved": sched.prefill_tokens_saved,
            "sched": sstats, "classes": classes,
            "kernel_report": krep,
            "profile_sampled": prof.sampled if prof is not None else 0,
            "profile_every": args.profile_kernels,
            "trace_stats": trace_stats, "metrics_path": args.metrics_out,
            "sample": first}):
        obs.emit(line)
    spec_stats = None
    if k_max > 0:
        spec_stats = {"k": k_max, "draft": args.spec_draft,
                      "steps": c_spec_steps.value,
                      "proposed": c_spec_prop.value,
                      "accepted": c_spec_acc.value,
                      "acceptance_rate":
                          c_spec_acc.value / max(c_spec_prop.value, 1)}
    return {"outputs": outputs, "tokens_served": tokens_served,
            "batch_slots": B, "kv_dtype": args.kv_dtype,
            "pool_blocks": layout.num_blocks - 1,
            "host_blocks": host_blocks, "steps": c_steps.value,
            "refusals": len(sched.refused_ids),
            "prefill_chunks": c_chunks.value,
            "interleaved_steps": c_inter.value,
            "prefill_tokens": c_pf.value, "decode_tokens": tokens_served,
            "prefill_tokens_saved": sched.prefill_tokens_saved,
            "replayed_tokens": c_replay.value,
            "worker_restarts": c_restarts.value, "prefix": pstats,
            "sched": sstats, "classes": classes,
            "spec": spec_stats, "t_drafter": t_drafter,
            "metrics": snap, "kernel_report": krep,
            "t_prefill": t_prefill, "t_decode": t_decode, "t_total": t_total}


def config_for(args):
    """The model config the flags select: ``--reduced`` shrinks it,
    ``--layers N`` cuts its depth and nothing else."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    return cfg


def run(args) -> dict:
    softmax_state.set_default_mode(args.rescale)
    cfg = config_for(args)
    if args.cache_layout == "dense":
        return run_dense(args, cfg, device=args.device)
    return run_paged(args, cfg, device=args.device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek_r1_671b", choices=ARCH_IDS)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (the CPU runs the "
                         "kernels' plain versions)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to its first N layers (0 = all); "
                         "DeepSeek-R1's first 3 are its dense layers, the "
                         "rest MoE")
    ap.add_argument("--batch", type=int, default=4, help="batch slots")
    ap.add_argument("--prompt", type=int, default=64,
                    help="max prompt length (requests draw ragged lengths)")
    ap.add_argument("--gen", type=int, default=32,
                    help="max tokens to generate per request")
    ap.add_argument("--mode", default="etap", choices=["etap", "standard"])
    ap.add_argument("--cache-layout", default="paged",
                    choices=["dense", "paged"])
    ap.add_argument("--requests", type=int, default=8,
                    help="ragged request count")
    ap.add_argument("--page-size", type=int, default=64,
                    help="tokens per KV block (FlashMLA uses 64)")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="prompt tokens per paged prefill chunk")
    ap.add_argument("--token-budget", type=int, default=0,
                    help="per-step token budget shared by the decode batch "
                         "and prefill chunks (0 = batch + prefill-chunk)")
    ap.add_argument("--spare-blocks", type=int, default=0,
                    help="extra pool blocks beyond batch*max_blocks")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="radix-tree prefix cache (--no-prefix-cache "
                         "disables)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="tokens of a common prompt prefix shared by every "
                         "request (0 = independent prompts)")
    ap.add_argument("--priority-classes", type=int, default=1,
                    help="priority classes drawn per request (0 = most "
                         "important)")
    ap.add_argument("--slo-ttft", type=float, default=0.0,
                    help="time-to-first-token budget in ms (0 = off)")
    ap.add_argument("--slo-itl", type=float, default=0.0,
                    help="inter-token latency budget in ms (0 = off)")
    ap.add_argument("--preemption", default="recompute",
                    choices=["swap", "recompute"],
                    help="victim evacuation mode")
    ap.add_argument("--host-blocks", type=int, default=0,
                    help="host swap tier size in blocks (0 with --preemption "
                         "swap mirrors the device pool)")
    ap.add_argument("--retry-backoff", type=int, default=1,
                    help="max backoff in ticks between admission retries")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="injected decode-worker failures per tick (a "
                         "periodic schedule, FailureInjector.from_rate; "
                         "victims requeue through the recompute path and "
                         "the outputs stay those of the run without; 0 = "
                         "off)")
    ap.add_argument("--paranoia", type=int, default=0,
                    help="run the BlockPool audit every N ticks (0 = off)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="request arrivals per scheduler tick (0 = all at "
                         "tick 0)")
    ap.add_argument("--trace", default="uniform",
                    choices=["uniform", "burst"],
                    help="arrival trace shape under --arrival-rate")
    ap.add_argument("--burst-size", type=int, default=4,
                    help="requests per burst for --trace burst")
    ap.add_argument("--spec-tokens", type=int, default=0,
                    help="speculative decode window k: draft k-1 tokens per "
                         "eligible decode slot and score all k in one "
                         "verify pass; greedy acceptance keeps the outputs "
                         "those of one-at-a-time decode (0 = off; paged "
                         "layout only)")
    ap.add_argument("--spec-draft", default="ngram",
                    choices=list(spec_decode.DRAFT_KINDS),
                    help="draft proposer for --spec-tokens: ngram = "
                         "longest-suffix match over the committed stream; "
                         "head = embedding-similarity chain (not with "
                         "--kv-dtype fp8)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the request-lifecycle and engine-span trace "
                         "as Chrome trace-event JSON (ui.perfetto.dev or "
                         "chrome://tracing; paged layout only)")
    ap.add_argument("--trace-buffer", type=int, default=65536,
                    help="trace ring-buffer capacity in events: overflow "
                         "drops the oldest events (counted in the export)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the run's metrics-registry snapshot as "
                         "schema-versioned JSON (git sha, torch version and "
                         "device name beside it)")
    ap.add_argument("--profile-kernels", type=int, default=0, metavar="N",
                    help="time every N-th attention entry launch between "
                         "two device syncs, tagged with its spec and "
                         "argument geometry and set against the card's HBM "
                         "rate in the summary (0 = off; paged layout only)")
    ap.add_argument("--kv-splits", type=int, default=None,
                    help="split-KV count for decode attention "
                         "(default: auto-scheduled)")
    ap.add_argument("--kv-dtype", default=os.environ.get("REPRO_KV_DTYPE",
                                                         "fp"),
                    choices=["fp", "int8", "fp8"])
    ap.add_argument("--rescale", default=os.environ.get("REPRO_RESCALE",
                                                        "amla"),
                    choices=list(softmax_state.MODES),
                    help="online-softmax rescaling mode")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)
    if args.spec_tokens < 0:
        ap.error("--spec-tokens must be >= 0")
    if args.spec_tokens > 0 and args.cache_layout == "dense":
        ap.error("--spec-tokens requires --cache-layout paged: the dense "
                 "loop has no block pool to rewind rejected drafts in")
    if args.spec_tokens > 0 and args.spec_draft == "head" \
            and args.kv_dtype == "fp8":
        ap.error("--spec-draft head is not supported with --kv-dtype fp8; "
                 "use --spec-draft ngram")
    if args.trace_buffer < 1:
        ap.error("--trace-buffer must be >= 1")
    if args.profile_kernels < 0:
        ap.error("--profile-kernels must be >= 0")
    if not 0.0 <= args.fault_rate <= 1.0:
        ap.error("--fault-rate must be in [0, 1]")
    if args.cache_layout == "dense" and (args.trace_out
                                         or args.profile_kernels):
        ap.error("--trace-out/--profile-kernels require --cache-layout "
                 "paged: the dense loop has no per-request lifecycle or "
                 "per-launch entries to record")
    if args.layers < 0:
        ap.error("--layers must be >= 0")
    if args.shared_prefix >= args.prompt:
        ap.error("--shared-prefix must leave room for a per-request tail "
                 "(< --prompt)")
    return args


if __name__ == "__main__":
    run(parse_args())
