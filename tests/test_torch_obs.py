"""The port's telemetry export, kernel profiler, roofline and paged helpers
against the JAX package.

``launch/obs.py``: the ``[serve]`` summaries give the reference's lines for
the same snapshot and context (the port's first line adds the device), the
kernel report the reference's bytes, launches and mean times with the
roofline fraction scaled by the two HBM rates (819e9 / 3.35e12), and the
metrics file the port's provenance (torch version, device).
``core/attn_spec.attn_entry``: the profiler's sampling pattern, a profiled
entry's output bitwise the unprofiled one's, and the reference's
(entry, tag, geometry) records for the same call.  ``launch/roofline.py``:
the reference's parameter and FLOP counts for every arch, and its split-KV
byte and occupancy terms at the same core count.  The serve loop with
``--trace-out`` / ``--metrics-out`` against the same run without them and
JAX's, on converted weights; ``--profile-kernels 1`` against the
reference's profiled run.  ``runtime/paged_cache.py``: ``dense_to_paged``
and ``tree_append_rows`` bitwise the reference's.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import SHAPES as JSHAPES
from repro.core.attn_spec import AttnSpec as JSpec
from repro.kernels.etap import ops as jetap_ops
from repro.kernels.flash_decode import ops as jfd_ops
from repro.launch import obs as jobs
from repro.launch import roofline as jroofline
from repro.launch import serve as jserve
from repro.models import model as jmodel
from repro.runtime import paged_cache as jpc
from repro.runtime import telemetry as jtelemetry
from repro_torch.configs import ARCH_IDS, ShapeCell, get_config, reduced
from repro_torch.core.attn_spec import AttnSpec
from repro_torch.kernels.etap import ops as etap_ops
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.launch import obs, roofline, serve
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import paged_cache as pc
from repro_torch.runtime import telemetry

SCALE = 24 ** -0.5


# ------------------------------------------------------------- profiler
@pytest.mark.parametrize("every", [1, 2, 3, 5])
def test_profiler_sampling_pattern(every):
    got, want = telemetry.KernelProfiler(every), \
        jtelemetry.KernelProfiler(every)
    assert [got.want() for _ in range(17)] == [want.want() for _ in range(17)]


def _paged_inputs(seed=0, B=3, H=4, dk=40, dv=32, page=8, nb=4, Cq=None):
    """The same paged MLA inputs as numpy: q [B,H,dk] (or [B,Cq,H,dk]), a
    pool of B * nb + 1 pages, a shuffled table, ragged lengths."""
    rng = np.random.default_rng(seed)
    N = B * nb + 1
    pool = rng.normal(size=(N, page, dk)).astype(np.float32)
    table = (1 + rng.permutation(B * nb)).reshape(B, nb).astype(np.int32)
    lengths = rng.integers(Cq or 1, nb * page - (Cq or 0) + 1,
                           size=B).astype(np.int32)
    shape = (B, H, dk) if Cq is None else (B, Cq, H, dk)
    q = rng.normal(size=shape).astype(np.float32)
    return q, pool, dv, table, lengths


def _both(args):
    """(jax args, torch args) of the same numpy values; ints stay ints."""
    return ([jnp.asarray(a) if isinstance(a, np.ndarray) else a
             for a in args],
            [torch.as_tensor(a) if isinstance(a, np.ndarray) else a
             for a in args])


def _records(install, profiler_mod, fn, args, spec):
    prev = profiler_mod.set_profiler(install)
    try:
        out = fn(*args, spec=spec)
    finally:
        profiler_mod.set_profiler(prev)
    return out, install.records


@pytest.mark.parametrize("case", [
    "decode-auto", "decode-1-split", "decode-2-splits", "prefill", "verify",
    "baseline-dense", "etap-dense", "decode-sepv-1-split"])
def test_profiler_records_match_reference(case):
    """One profiled call of each public entry the serve paths reach: the
    port records the reference's (entry name, spec tag, argument geometry),
    one launch a call — an entry called inside another (a split entry's
    single-pass branch) is part of the outer launch, as the reference's
    inner entries are traced into its jit — and its output is bitwise the
    unprofiled call's."""
    splits = {"decode-1-split": 1, "decode-2-splits": 2,
              "decode-sepv-1-split": 1}.get(case)
    jspec = JSpec(scale=SCALE, kv_splits=splits, block=16)
    spec = AttnSpec(scale=SCALE, kv_splits=splits, block=16)
    if case.startswith("decode-sepv"):
        q, pool, dv, table, lengths = _paged_inputs()
        args = (q, pool, pool[..., :dv], table, lengths)
        jfn, fn = (jetap_ops.etap_decode_paged_splitkv,
                   etap_ops.etap_decode_paged_splitkv)
    elif case.startswith("decode"):
        args = _paged_inputs()
        jfn, fn = (jetap_ops.etap_decode_mla_paged_splitkv,
                   etap_ops.etap_decode_mla_paged_splitkv)
    elif case in ("prefill", "verify"):
        q, pool, dv, table, lengths = _paged_inputs(Cq=4)
        start = lengths - 4
        args = (q, pool, dv, table, start)
        jfn, fn = (jetap_ops.etap_prefill_mla_paged,
                   etap_ops.etap_prefill_mla_paged)
        if case == "verify":
            qpos = (start[:, None] + np.array([0, 1, 1, 2])).astype(np.int32)
            args = args + (qpos,)
            jfn, fn = (jetap_ops.etap_verify_mla_paged,
                       etap_ops.etap_verify_mla_paged)
    else:
        rng = np.random.default_rng(1)
        k = rng.normal(size=(3, 40, 24)).astype(np.float32)
        args = (rng.normal(size=(3, 4, 24)).astype(np.float32), k,
                k[..., :16].copy(), np.array([40, 17, 3], np.int32))
        jfn, fn = ((jfd_ops.flash_decode_splitkv, fd_ops.flash_decode_splitkv)
                   if case == "baseline-dense" else
                   (jetap_ops.etap_decode, etap_ops.etap_decode))
    jargs, targs = _both(args)
    _, want = _records(jtelemetry.KernelProfiler(1), jtelemetry, jfn, jargs,
                       jspec)
    got_out, got = _records(telemetry.KernelProfiler(1), telemetry, fn,
                            targs, spec)
    assert list(got) == list(want)
    assert [v[0] for v in got.values()] == [1]
    assert torch.equal(got_out, fn(*targs, spec=spec))
    assert telemetry.profiler() is None


def test_profiler_samples_every_nth_top_level_call():
    """Every N-th top-level call is recorded; the count of calls asked is
    the number of top-level calls (inner entries never ask)."""
    q, pool, dv, table, lengths = _paged_inputs()
    args = [torch.as_tensor(a) if isinstance(a, np.ndarray) else a
            for a in (q, pool, pool[..., :dv], table, lengths)]
    prof = telemetry.KernelProfiler(3)
    prev = telemetry.set_profiler(prof)
    try:
        for _ in range(7):
            etap_ops.etap_decode_paged_splitkv(
                *args, spec=AttnSpec(scale=SCALE, kv_splits=1))
    finally:
        telemetry.set_profiler(prev)
    assert prof.sampled == 3 and prof._tick == 7
    assert [k[0] for k in prof.records] == ["etap_decode_paged_splitkv"]


# ------------------------------------------------------ kernel report
GEOMETRIES = [
    (((8, 128, 576), "bfloat16"), ((1161, 64, 576), "bfloat16"),
     ((8, 68), "int32"), ((8,), "int32")),
    (((1, 32, 128, 576), "bfloat16"), ((1161, 64, 576), "float8_e4m3fn"),
     ((1, 68), "int32"), ((1,), "int32"),
     ("kv_sz", (1161, 64, 2), "float32")),
    (((4, 16, 576), "float32"), ((100, 64, 576), "int8"), ((4, 9), "int32"),
     ((4,), "int32"), ("kv_sz", (100, 64, 2), "float32")),
]


def _report_pair():
    got, want = telemetry.KernelProfiler(1), jtelemetry.KernelProfiler(1)
    for i, geo in enumerate(GEOMETRIES):
        for p in (got, want):
            for n in range(i + 2):
                p.record(f"entry{i}", "mode=etap rescale=amla kv=fp "
                         "splits=None", geo, 1e-4 * (i + 1) + 1e-6 * n)
    return got, want


def test_kernel_report_matches_reference():
    """The same records: equal argument bytes (torch's dtype names),
    launches and mean times; the roofline fraction scaled by the two HBM
    rates (the reference's 819 GB/s against the H100's 3.35 TB/s)."""
    mine, ref = _report_pair()
    got, want = obs.kernel_report(mine), jobs.kernel_report(ref)
    assert [r["entry"] for r in got] == [r["entry"] for r in want]
    for g, w in zip(got, want, strict=True):
        for key in ("arg_bytes", "launches", "mean_us", "total_ms",
                    "achieved_gbps", "spec"):
            assert g[key] == w[key], key
        assert g["roofline_fraction"] == pytest.approx(
            w["roofline_fraction"] * 819e9 / 3.35e12, rel=1e-12)
    by_entry = {r["entry"]: r["arg_bytes"] for r in got}
    assert by_entry["entry1"] == 32 * 128 * 576 * 2 + 1161 * 64 * 576 \
        + (68 + 1) * 4 + 1161 * 64 * 2 * 4


def test_kernel_report_lines_match_reference():
    """The profile lines: the reference's rendering of the port's rows,
    with the H100's rate in the header."""
    rows = obs.kernel_report(_report_pair()[0])
    got = obs.kernel_report_lines(rows, 9, 1)
    want = jobs.kernel_report_lines(rows, 9, 1)
    assert got[1:] == want[1:]
    assert got[0] == want[0].replace("(819 GB/s)", "(3350 GB/s)")


# ------------------------------------------------------------ summaries
def _snapshot():
    reg = telemetry.MetricsRegistry()
    for name, n in (("serve/decode_tokens", 37), ("serve/decode_steps", 21),
                    ("serve/prefill_tokens", 90),
                    ("serve/prefill_chunks", 12),
                    ("serve/interleaved_steps", 5),
                    ("serve/replayed_tokens", 4),
                    ("serve/worker_restarts", 2),
                    ("serve/spec_verify_steps", 6),
                    ("serve/spec_proposed", 6), ("serve/spec_accepted", 1)):
        reg.counter(name).inc(n)
    for v in (1.5, 2.0, 40.0):
        reg.histogram("sched/class0/ttft_ms").record(v)
    return reg.snapshot()


def _paged_ctx(**kw):
    ctx = {"arch": "deepseek_r1_671b", "device": "cpu", "mode": "etap",
           "batch_slots": 2, "n_requests": 6, "page_size": 8,
           "pool_blocks": 12, "host_blocks": 0, "chunk": 8, "budget": 10,
           "kv_dtype": "int8", "rescale": "amla",
           "prefix": {"hits": 2, "lookups": 6, "hit_rate": 1 / 3,
                      "cached_blocks": 5, "evictions": 1},
           "preemption": "recompute", "spec_tokens": 2,
           "spec_draft": "ngram", "t_prefill": 0.25, "t_decode": 1.5,
           "refusals": 3, "prefill_tokens_saved": 16,
           "sched": {"preemptions": 2, "preempts_swap": 0,
                     "preempts_recompute": 2, "restores_swap": 0,
                     "restores_recompute": 2, "refusals": 3,
                     "failures": 2},
           "classes": {0: {"n": 6, "preemptions": 2, "ttft_p50_ms": 2.0,
                           "ttft_p99_ms": 40.0, "itl_p50_ms": 1.25,
                           "itl_p99_ms": 3.5}},
           "kernel_report": None, "profile_sampled": 0, "profile_every": 0,
           "trace_stats": {"events": 80, "recorded": 90, "dropped": 10,
                           "path": "t.json"},
           "metrics_path": "m.json", "sample": [1, 2, 3]}
    ctx.update(kw)
    return ctx


def _with_device(line, device="cpu"):
    return line.replace(" layout=", f" device={device} layout=", 1)


@pytest.mark.parametrize("kw", [
    {}, {"prefix": None, "spec_tokens": 0, "trace_stats": None,
         "metrics_path": None},
    {"sched": {"preemptions": 0, "preempts_swap": 0,
               "preempts_recompute": 0, "restores_swap": 0,
               "restores_recompute": 0, "refusals": 0, "failures": 0}}],
    ids=["all", "bare", "calm"])
def test_summarize_paged_matches_reference(kw):
    snap, ctx = _snapshot(), _paged_ctx(**kw)
    got = obs.summarize_paged(snap, ctx)
    want = jobs.summarize_paged(snap, ctx)
    assert got == [_with_device(want[0])] + want[1:]


def test_summarize_paged_kernel_profile_lines():
    rows = obs.kernel_report(_report_pair()[0])
    ctx = _paged_ctx(kernel_report=rows, profile_sampled=9, profile_every=1)
    got = obs.summarize_paged(_snapshot(), ctx)
    assert obs.kernel_report_lines(rows, 9, 1) == \
        [x for x in got if "kernel profile" in x or x.startswith(
            "[serve]   entry")]


@pytest.mark.parametrize("metrics_path", [None, "m.json"])
def test_summarize_dense_matches_reference(metrics_path):
    snap = _snapshot()
    ctx = {"arch": "qwen3_8b", "device": "NVIDIA H100 80GB HBM3",
           "mode": "standard", "rescale": "mul", "batch": 4, "prompt": 64,
           "gen": 8, "t_prefill": 0.5, "t_decode": 2.0,
           "metrics_path": metrics_path, "sample": [4, 5]}
    got = obs.summarize_dense(snap, ctx)
    want = jobs.summarize_dense(snap, ctx)
    assert got == [_with_device(want[0], ctx["device"])] + want[1:]


def test_metrics_file_provenance(tmp_path):
    """--metrics-out's document: the snapshot, and a provenance block with
    the schema version, the torch version and the device, no jax."""
    path = str(tmp_path / "m.json")
    doc = obs.write_metrics(path, _snapshot(), "serve:x:paged:fp", "cpu")
    assert json.load(open(path)) == doc
    meta = doc["meta"]
    assert meta["schema_version"] == telemetry.OBS_SCHEMA_VERSION
    assert meta["torch_version"] == torch.__version__
    assert meta["device"] == "cpu" and "jax_version" not in meta
    assert meta["config"] == "serve:x:paged:fp" and meta["git_sha"]
    assert obs.device_name("cpu") == "cpu"


# ------------------------------------------------------------- roofline
def test_roofline_constants_are_the_h100s():
    assert roofline.PEAK_FLOPS == 989e12 and roofline.HBM_BW == 3.35e12


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_flop_counts_equal_reference(arch):
    assert ARCH_IDS == JARCH_IDS
    for red in (False, True):
        cfg, jcfg = get_config(arch), jget_config(arch)
        if red:
            cfg, jcfg = reduced(cfg), jreduced(jcfg)
        n = roofline.active_params(cfg)
        assert n == jroofline.active_params(jcfg)
        assert roofline.total_params(cfg) == jroofline.total_params(jcfg)
        for cell in JSHAPES.values():
            mine = ShapeCell(cell.name, cell.seq_len, cell.global_batch,
                             cell.kind)
            assert mine.is_decode == cell.is_decode
            assert roofline.model_flops(cfg, mine, n) == \
                jroofline.model_flops(jcfg, cell, n)


@pytest.mark.parametrize("BG,S,H,dk,dv,n,fused", [
    (1, 65536, 16, 576, 512, 4, True), (16, 65536, 16, 576, 512, 8, True),
    (8, 4096, 128, 576, 512, 4, True), (32, 4096, 8, 128, 128, 2, False),
    (2, 1000, 4, 64, 64, 16, False)])
def test_splitkv_terms_equal_reference(BG, S, H, dk, dv, n, fused):
    """Bytes and occupancy equal the reference's at its core count; the
    times are the same bytes and operations over the H100's rates."""
    got = roofline.splitkv_roofline(BG, S, H, dk, dv, n, mla_fused=fused)
    want = jroofline.splitkv_roofline(BG, S, H, dk, dv, n, mla_fused=fused)
    for key in ("kv_bytes", "stat_bytes", "occupancy", "overhead"):
        assert got[key] == want[key], key
    for key in ("t_partial_mem", "t_combine"):
        assert got[key] * roofline.HBM_BW == pytest.approx(
            want[key] * jroofline.HBM_BW, rel=1e-12)
    assert got["t_partial_compute"] * roofline.PEAK_FLOPS == pytest.approx(
        want["t_partial_compute"] * jroofline.PEAK_FLOPS, rel=1e-12)
    h100 = roofline.splitkv_roofline(BG, S, H, dk, dv, n, mla_fused=fused,
                                     num_cores=132)
    assert h100["occupancy"] == min(1.0, BG * n / 132)


# ------------------------------------------------------ serve against JAX
@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jreduced(jget_config("deepseek_r1_671b")),
                               moe=None)
    cfg = dataclasses.replace(reduced(get_config("deepseek_r1_671b")),
                              moe=None)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, params_from_jax(tree, device="cpu")


def _port(cfg, params, flags):
    return serve.run_paged(serve.parse_args(flags + ["--device", "cpu"]), cfg,
                           params=params, device="cpu")


BURST = ["--reduced", "--batch", "2", "--prompt", "24", "--gen", "8",
         "--requests", "6", "--page-size", "8", "--prefill-chunk", "8",
         "--cache-layout", "paged", "--priority-classes", "3",
         "--arrival-rate", "0.25", "--trace", "burst", "--burst-size", "3",
         "--retry-backoff", "4", "--preemption", "recompute",
         "--spec-tokens", "2", "--seed", "0"]


def test_serve_trace_and_metrics_bitwise_and_equal_jax(setup, tmp_path):
    """The reference telemetry test's burst (speculation, three classes,
    recompute preemption): with --trace-out / --metrics-out the outputs
    equal the run without them and JAX's; the trace holds the engine spans
    and the lifecycle instants; the metrics file holds the returned
    snapshot, whose class histograms are what class_stats reads."""
    jcfg, cfg, params = setup
    want = jserve.run_paged(jserve.parse_args(BURST), jcfg)
    plain = _port(cfg, params, BURST)
    tpath, mpath = str(tmp_path / "t.json"), str(tmp_path / "m.json")
    inst = _port(cfg, params, BURST + ["--trace-out", tpath, "--metrics-out",
                                       mpath])
    assert inst["outputs"] == plain["outputs"] == want["outputs"]
    assert inst["tokens_served"] == plain["tokens_served"]
    evs = json.load(open(tpath))["traceEvents"]
    for e in evs:
        assert {"name", "ph", "ts", "pid", "tid"} <= set(e), e
    assert [e["ts"] for e in evs] == sorted(e["ts"] for e in evs)
    names = {e["name"] for e in evs}
    assert inst["sched"]["preempts_recompute"] > 0
    need = {"enqueued", "admitted", "finished", "prefill_chunk",
            "decode_step", "verify_step", "preempted", "restored"}
    assert need <= names, need - names
    met = json.load(open(mpath))
    assert met["meta"]["schema_version"] == telemetry.OBS_SCHEMA_VERSION
    snap = inst["metrics"]
    assert met["metrics"] == snap
    assert snap["counters"]["serve/decode_tokens"] == inst["decode_tokens"]
    for cls, cstats in inst["classes"].items():
        hd = snap["histograms"][f"sched/class{cls}/ttft_ms"]
        assert cstats["ttft_p50_ms"] == hd["p50"]
        assert cstats["ttft_p99_ms"] == hd["p99"]
        assert cstats["n"] == snap["counters"][f"sched/class{cls}/done"]
    for key in ("serve/decode_tokens", "serve/decode_steps",
                "serve/prefill_chunks", "serve/ticks",
                "serve/spec_verify_steps", "sched/preemptions"):
        assert snap["counters"].get(key) == \
            want["metrics"]["counters"].get(key), key


def test_serve_bitwise_int8_prefix_with_exports(setup, tmp_path):
    """The reference's int8 + prefix-cache leg: telemetry on == off ==
    JAX's outputs, and the exports hold the spans and the token count."""
    jcfg, cfg, params = setup
    base = ["--reduced", "--batch", "2", "--prompt", "16", "--gen", "8",
            "--requests", "3", "--page-size", "8", "--prefill-chunk", "8",
            "--cache-layout", "paged", "--kv-dtype", "int8",
            "--shared-prefix", "2", "--seed", "0"]
    want = jserve.run_paged(jserve.parse_args(base), jcfg)
    plain = _port(cfg, params, base)
    tpath, mpath = str(tmp_path / "t.json"), str(tmp_path / "m.json")
    inst = _port(cfg, params, base + ["--trace-out", tpath, "--metrics-out",
                                      mpath, "--trace-buffer", "8"])
    assert inst["outputs"] == plain["outputs"] == want["outputs"]
    doc = json.load(open(tpath))
    assert len(doc["traceEvents"]) == 9        # the ring's 8 + metadata
    assert doc["otherData"]["dropped"] > 0
    assert json.load(open(mpath))["metrics"]["counters"][
        "serve/decode_tokens"] == inst["decode_tokens"]


def _entry_launches(rep):
    out = {}
    for r in rep:
        out[(r["entry"], r["spec"])] = \
            out.get((r["entry"], r["spec"]), 0) + r["launches"]
    return out


PROFILED = ["--reduced", "--batch", "2", "--prompt", "16", "--gen", "4",
            "--requests", "2", "--page-size", "8", "--prefill-chunk", "8",
            "--profile-kernels", "1"]


@pytest.mark.parametrize("extra", [
    [], ["--mode", "standard", "--kv-splits", "2"],
    ["--kv-dtype", "int8", "--spec-tokens", "2"]],
    ids=["etap", "standard-2-splits", "int8-spec"])
def test_profiled_entries_equal_reference(setup, extra):
    """--profile-kernels 1: the same entries, tags and launch counts as the
    reference's profiled run at the same flags, the outputs of the run
    without the profiler, and no profiler left installed."""
    jcfg, cfg, params = setup
    want = jserve.run_paged(jserve.parse_args(PROFILED + extra), jcfg)
    got = _port(cfg, params, PROFILED + extra)
    plain = _port(cfg, params, PROFILED[:-2] + extra)
    assert got["outputs"] == plain["outputs"]
    assert _entry_launches(got["kernel_report"]) == \
        _entry_launches(want["kernel_report"])
    assert telemetry.profiler() is None


# ----------------------------------------------------------- paged helpers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_to_paged_equals_reference(dtype):
    """Ragged lengths (a full row, a one-token row, a row ending mid-page,
    an empty-page boundary): the pool and the allocator's tables and
    lengths are the reference's, bitwise."""
    rng = np.random.default_rng(0)
    B, S, F = 4, 37, 6
    dense = rng.normal(size=(B, S, F)).astype(np.float32)
    lengths = np.array([37, 1, 20, 16], np.int32)
    layout = pc.layout_for(B, S, 8)
    jlayout = jpc.layout_for(B, S, 8)
    jpool, jbp = jpc.dense_to_paged(jnp.asarray(dense, dtype), lengths,
                                    jlayout)
    pool, bp = pc.dense_to_paged(
        torch.as_tensor(dense).to(getattr(torch, dtype)), lengths, layout)
    assert pool.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(pool.float().numpy(),
                                  np.asarray(jpool, np.float32))
    np.testing.assert_array_equal(bp.table, jbp.table)
    np.testing.assert_array_equal(bp.lengths, jbp.lengths)
    rows = pc.gather_blocks(pool, torch.as_tensor(bp.table))
    for b, n in enumerate(lengths):
        assert torch.equal(rows[b, :n], torch.as_tensor(dense[b, :n]).to(
            pool.dtype))


def test_tree_append_rows_equals_reference():
    """A 2-layer stacked cache dict (a latent pool and its (scale, zp)
    pool, leading layer axis): one row per sequence lands where the
    reference's vmapped append puts it, in every layer."""
    rng = np.random.default_rng(1)
    layout = pc.layout_for(3, 24, 8)
    N, bs = layout.num_blocks, layout.block_size
    cache = {"c": rng.normal(size=(2, N, bs, 12)).astype(np.float32),
             "c_sz": rng.normal(size=(2, N, bs, 2)).astype(np.float32)}
    rows = {"c": rng.normal(size=(2, 3, 12)).astype(np.float32),
            "c_sz": rng.normal(size=(2, 3, 2)).astype(np.float32)}
    table = (1 + rng.permutation(N - 1)[:3 * layout.max_blocks]).reshape(
        3, layout.max_blocks).astype(np.int32)
    lengths = np.array([0, 9, 23], np.int32)
    want = jpc.tree_append_rows({k: jnp.asarray(v) for k, v in cache.items()},
                                jnp.asarray(table), jnp.asarray(lengths),
                                {k: jnp.asarray(v) for k, v in rows.items()})
    got_cache = {k: torch.as_tensor(v.copy()) for k, v in cache.items()}
    got = pc.tree_append_rows(got_cache, torch.as_tensor(table),
                              torch.as_tensor(lengths),
                              {k: torch.as_tensor(v) for k, v in rows.items()})
    assert got is got_cache
    for k in cache:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
