"""Serve-loop observability front end — the port of ``repro/launch/obs.py``.

``runtime/telemetry.py`` owns the primitives (registry / tracer /
profiler); this module owns everything user-facing:

  emit()           the one print site of the serve loop's reporting: every
                   line a serve run shows is rendered from a registry
                   snapshot first, so no stat appears in the summary
                   without also being in ``--metrics-out``.

  summarize_*()    render the ``[serve]`` summary lines from ONE registry
                   snapshot + a context dict of run facts (flags, timings,
                   sample tokens).  The snapshot is the source of truth;
                   the text is a view.  The port's first line also names
                   the device the run served on.

  write_metrics()  ``--metrics-out``: the full snapshot as schema-versioned
                   JSON with a provenance block (git sha, torch version,
                   the device's name).

  write_trace()    ``--trace-out``: Chrome trace-event JSON.  Open in
                   https://ui.perfetto.dev (drag the file in) or
                   chrome://tracing.  Thread 0 is the engine timeline
                   (prefill/decode/verify spans); thread 1000+id is
                   request id's lifecycle instants.

  kernel_report()  joins ``--profile-kernels`` launch timings against the
                   card's HBM rate (``launch/roofline.py``): per-entry
                   achieved GB/s and achieved-vs-roofline fraction
                   (memory-floor time / measured wall time).  A launch's
                   time is its wall time between two device syncs, so a
                   small decode entry's row shows the wrapper's host time
                   as much as the kernel's.
"""
from __future__ import annotations

import json
import subprocess

import torch

from repro_torch.launch import roofline
from repro_torch.runtime.telemetry import OBS_SCHEMA_VERSION

_DTYPE_BYTES = {
    "float64": 8, "int64": 8, "uint64": 8,
    "float32": 4, "int32": 4, "uint32": 4,
    "bfloat16": 2, "float16": 2, "int16": 2, "uint16": 2,
    "int8": 1, "uint8": 1, "bool": 1,
    "float8_e4m3fn": 1, "float8_e5m2": 1,
}


def emit(line: str) -> None:
    """Print one serve-summary line."""
    print(line)


def device_name(device) -> str:
    """The card's name for a CUDA device, ``"cpu"`` otherwise."""
    device = torch.device(device)
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def obs_meta(config: str, device) -> dict:
    """Provenance block for exported artifacts, with the telemetry schema
    version and the name of the device the run served on."""
    try:
        sha = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True,
                             timeout=10).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        sha = "unknown"
    return {"schema_version": OBS_SCHEMA_VERSION, "config": config,
            "git_sha": sha, "torch_version": torch.__version__,
            "device": device_name(device)}


def write_metrics(path: str, snapshot: dict, config: str, device) -> dict:
    """Write the registry snapshot as schema-versioned JSON, with the name
    of ``device``, the run's, in its provenance block."""
    doc = {"meta": obs_meta(config, device), "metrics": snapshot}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    return doc


def write_trace(tracer, path: str) -> dict:
    """Export the ring buffer as Chrome trace-event JSON; returns the
    tracer's export stats (events written / recorded / dropped)."""
    return tracer.export(path)


def _geometry_bytes(geometry: tuple) -> int:
    """HBM traffic floor for one launch: every argument tensor read once.
    (Outputs and intermediate traffic are not modeled — this is a FLOOR,
    so the reported roofline fraction is an upper bound on achievement.)"""
    total = 0
    for entry in geometry:
        shape, dtype = entry[-2], entry[-1]
        n = 1
        for d in shape:
            n *= int(d)
        total += n * _DTYPE_BYTES.get(dtype, 2)
    return total


def kernel_report(prof) -> list:
    """Per-(entry, spec, geometry) profile rows joined against the
    roofline memory floor, slowest first."""
    rows = []
    for (name, tag, geometry), (count, total_s) in prof.records.items():
        mean_s = total_s / max(count, 1)
        byts = _geometry_bytes(geometry)
        floor_s = byts / roofline.HBM_BW
        rows.append({
            "entry": name, "spec": tag, "launches": count,
            "mean_us": mean_s * 1e6, "total_ms": total_s * 1e3,
            "arg_bytes": byts,
            "achieved_gbps": byts / max(mean_s, 1e-12) / 1e9,
            "roofline_fraction": floor_s / max(mean_s, 1e-12),
        })
    rows.sort(key=lambda r: -r["total_ms"])
    return rows


def kernel_report_lines(rows, sampled: int, sample_every: int) -> list:
    lines = [f"[serve] kernel profile: {sampled} sampled launches "
             f"(every {sample_every}); achieved vs HBM-roofline floor "
             f"({roofline.HBM_BW / 1e9:.0f} GB/s):"]
    for r in rows:
        lines.append(
            f"[serve]   {r['entry']}: {r['launches']}x "
            f"{r['mean_us']:.0f}us/launch, {r['achieved_gbps']:.3g} GB/s, "
            f"{r['roofline_fraction']:.3g} of roofline ({r['spec']})")
    return lines


def _c(snap: dict, name: str) -> int:
    return int(snap["counters"].get(name, 0))


def summarize_paged(snap: dict, ctx: dict) -> list:
    """The ``[serve]`` summary for the paged loop, rendered from the
    registry snapshot.  ``ctx`` carries run facts that are configuration
    or wall-clock, not metrics: flags, timings, sample tokens, the
    per-class stats dict, the device's name, and the optional kernel
    report."""
    tokens_served = _c(snap, "serve/decode_tokens")
    steps = _c(snap, "serve/decode_steps")
    prefill_tokens = _c(snap, "serve/prefill_tokens")
    prefill_chunks = _c(snap, "serve/prefill_chunks")
    interleaved = _c(snap, "serve/interleaved_steps")
    t_prefill, t_decode = ctx["t_prefill"], ctx["t_decode"]
    lines = [
        (f"[serve] arch={ctx['arch']} device={ctx['device']} layout=paged "
         f"mode={ctx['mode']} "
         f"B={ctx['batch_slots']} requests={ctx['n_requests']} "
         f"page={ctx['page_size']} blocks={ctx['pool_blocks']} "
         f"host_blocks={ctx['host_blocks']} chunk={ctx['chunk']} "
         f"budget={ctx['budget']} kv_dtype={ctx['kv_dtype']} "
         f"rescale={ctx['rescale']} prefix_cache="
         f"{'on' if ctx['prefix'] is not None else 'off'} "
         f"preemption={ctx['preemption']} spec_tokens={ctx['spec_tokens']}"),
        (f"[serve] {tokens_served} tokens in {steps} decode steps "
         f"({tokens_served / max(steps, 1):.2f} tokens/step occupancy); "
         f"{prefill_chunks} prefill chunks, {interleaved} steps "
         f"interleaved prefill+decode; prefill {t_prefill*1e3:.1f}ms; "
         f"decode {t_decode*1e3:.1f}ms "
         f"({tokens_served/max(t_decode, 1e-9):.1f} tok/s); "
         f"requests refused at least once: {ctx['refusals']}"),
    ]
    pstats = ctx["prefix"]
    lines.append(
        f"[serve] token split: {prefill_tokens} prefill + {tokens_served} "
        f"decode run, {ctx['prefill_tokens_saved']} prefill skipped"
        + (f"; prefix cache: {pstats['hits']}/{pstats['lookups']} hits "
           f"({pstats['hit_rate']:.0%}), {pstats['cached_blocks']} blocks "
           f"cached, {pstats['evictions']} evicted" if pstats else ""))
    sstats = ctx["sched"]
    if sstats["preemptions"] or sstats["failures"] or sstats["refusals"]:
        lines.append(
            f"[serve] pressure: {sstats['preemptions']} preemptions "
            f"({sstats['preempts_swap']} swap / "
            f"{sstats['preempts_recompute']} recompute), "
            f"{sstats['restores_swap']}+{sstats['restores_recompute']} "
            f"restores, {_c(snap, 'serve/replayed_tokens')} tokens "
            f"replayed, {sstats['refusals']} transient refusals, "
            f"{sstats['failures']} injected failures "
            f"({_c(snap, 'serve/worker_restarts')} worker restarts)")
        for cls, st in ctx["classes"].items():
            lines.append(
                f"[serve]   class {cls}: n={st['n']} "
                f"preempt={st['preemptions']} "
                f"ttft p50/p99 {st['ttft_p50_ms']:.1f}/"
                f"{st['ttft_p99_ms']:.1f}ms itl p50/p99 "
                f"{st['itl_p50_ms']:.2f}/{st['itl_p99_ms']:.2f}ms")
    if ctx["spec_tokens"] > 0:
        proposed = _c(snap, "serve/spec_proposed")
        accepted = _c(snap, "serve/spec_accepted")
        lines.append(
            f"[serve] speculation: k={ctx['spec_tokens']} "
            f"draft={ctx['spec_draft']}; "
            f"{_c(snap, 'serve/spec_verify_steps')} verify launches, "
            f"{accepted}/{proposed} drafts accepted "
            f"({accepted / max(proposed, 1):.0%})")
    if ctx.get("kernel_report"):
        lines.extend(kernel_report_lines(ctx["kernel_report"],
                                         ctx["profile_sampled"],
                                         ctx["profile_every"]))
    stats = ctx.get("trace_stats")
    if stats:
        lines.append(
            f"[serve] trace: {stats['events']} events -> "
            f"{stats['path']} ({stats['dropped']} dropped of "
            f"{stats['recorded']} recorded)")
    if ctx.get("metrics_path"):
        lines.append(f"[serve] metrics snapshot -> {ctx['metrics_path']}")
    lines.append("[serve] sample generation (request 0): "
                 f"{ctx['sample']}")
    return lines


def summarize_dense(snap: dict, ctx: dict) -> list:
    tokens_served = _c(snap, "serve/decode_tokens")
    t_prefill, t_decode = ctx["t_prefill"], ctx["t_decode"]
    lines = [
        (f"[serve] arch={ctx['arch']} device={ctx['device']} layout=dense "
         f"mode={ctx['mode']} "
         f"rescale={ctx['rescale']} B={ctx['batch']} "
         f"prompt={ctx['prompt']} gen={ctx['gen']}"),
        (f"[serve] prefill {t_prefill*1e3:.1f}ms; decode "
         f"{t_decode/ctx['gen']*1e3:.2f}ms/token "
         f"({tokens_served/t_decode:.1f} tok/s, {tokens_served} tokens)"),
    ]
    if ctx.get("metrics_path"):
        lines.append(f"[serve] metrics snapshot -> {ctx['metrics_path']}")
    lines.append(f"[serve] sample generation (seq 0): {ctx['sample']}")
    return lines
