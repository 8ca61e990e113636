#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Phases, each of which fails the run when it fails:

  1. build   the ETAP kernels from ``src/repro_torch/kernels/etap/csrc``
             (one nvcc per source, started together) and print ptxas'
             register / shared-memory lines;
  2. kernels each kernel against its plain PyTorch version on the card, at
             DeepSeek-R1's bf16 widths (Dk 576, Dv 512, page 64, ~4K ragged
             context, H = 128 and 16, both rescale modes, prefill Cq = 32
             with and without a tree-shaped qpos); partial(n=1) + combine
             must equal single-pass bitwise; then each kernel's time (CUDA
             events), its plain version's time and its bound;
  3. serve   ``run_paged`` on DeepSeek-R1 at full width cut to its 3 dense
             layers (bf16, random weights from a seed), short context: the
             scheduler picks one split, so K3 and K4 run;
  4. serve   the same model at long context: the table is wide enough that
             the split scheduler picks n >= 2, so K1 and K2 run;
  5. decode  one full-width decode step through the kernels and through the
             plain versions, on the same weights and cache: logits agree;
             then the step's wall time and device time by kernel.

The launch counters are zeroed just before phase 3 and read after phase 4;
each of K1-K4 must have launched on those serve paths.  The line before the
last is the ``kernels`` JSON; the last line is the device JSON.

    python3 chip_smoke.py            # everything (one card)
    python3 chip_smoke.py --quick    # phases 1-2 at one iteration each
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor cores
DK, DV, PAGE = 576, 512, 64
SCALE = 192 ** -0.5            # DeepSeek's qk_head_dim ** -0.5
# Tolerance of a bf16 kernel output against its plain version (bf16 in, fp32
# accumulation on both sides): the two sum in different orders, so a value
# may round to the neighbouring bf16 number — one ulp is at most 2^-7 of the
# value; 1e-3 absolute covers outputs near zero, where the fp32 values
# before rounding differ by cancellation.
BF16_RTOL, BF16_ATOL = 2 ** -7, 1e-3
# fp32 partial stats (K1), compared after finalizing each split (acc / l):
# fp32 scores summed in another order, probabilities carried as bf16 hi+lo.
F32_TOL = 1e-4
# Logits of one full-width decode step, kernel path against plain path:
# attention outputs may differ by one bf16 ulp, which three bf16 layers
# carry into the logits; allow 2% of the largest logit.
LOGIT_RTOL = 2e-2

REPLACES = {
    "etap_paged_partial": "src/repro/kernels/etap/etap.py:713",
    "combine_splits": "src/repro/kernels/etap/combine.py:60",
    "etap_decode_mla_paged": "src/repro/kernels/etap/etap.py:237",
    "etap_prefill_mla_paged": "src/repro/kernels/etap/etap.py:430",
}
SOURCES = {
    "etap_paged_partial": "src/repro_torch/kernels/etap/csrc/etap.cu",
    "combine_splits": "src/repro_torch/kernels/etap/csrc/combine.cu",
    "etap_decode_mla_paged": "src/repro_torch/kernels/etap/csrc/etap.cu",
    "etap_prefill_mla_paged": "src/repro_torch/kernels/etap/csrc/etap.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / BF16_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def bf16_close(out, ref, what: str) -> float:
    """Max |out - ref| in fp32; raises beyond the bf16 tolerance."""
    import torch
    o, r = out.float(), ref.float()
    d = (o - r).abs()
    ok = bool((d <= BF16_RTOL * r.abs() + BF16_ATOL).all()) and \
        bool(torch.isfinite(o).all())
    err = float(d.max())
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version (max abs err {err:.3e})")
    return err


def finalized_close(state, ref, what: str) -> float:
    """K1 stats: compare acc / l per split (NaN where l = 0 on both)."""
    import torch
    m, l, acc = state
    rm, rl, racc = ref
    o = acc / l[:, :, None, :]
    r = racc / rl[:, :, None, :]
    nan_o, nan_r = torch.isnan(o), torch.isnan(r)
    if not torch.equal(nan_o, nan_r):
        raise AssertionError(f"{what}: empty splits differ")
    d = (o - r).abs()[~nan_r]
    err = float(d.max()) if d.numel() else 0.0
    if not torch.allclose(o[~nan_r], r[~nan_r], rtol=F32_TOL, atol=F32_TOL):
        raise AssertionError(f"{what}: partial stats disagree "
                             f"(max abs err {err:.3e})")
    return err


# ------------------------------------------------------------- phase 2
def make_pool(B, nb, lengths, gen, device):
    """A random bf16 latent pool with a shuffled block table: [N, 64, 576]
    holding B rows of nb pages (plus the null block 0, left random too)."""
    import torch
    N = 1 + B * nb
    pool = torch.randn(N, PAGE, DK, generator=gen, device=device).to(
        torch.bfloat16)
    perm = torch.randperm(N - 1, generator=gen, device=device) + 1
    table = perm.reshape(B, nb).to(torch.int32)
    for b in range(B):                   # unused tail entries -> null block
        used = -(-int(lengths[b]) // PAGE)
        table[b, used:] = 0
    return pool, table


def phase_kernels(quick: bool, report: dict) -> None:
    import torch
    from repro_torch.kernels.etap import combine as C
    from repro_torch.kernels.etap import etap as K
    from repro_torch.kernels.etap import ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    ctx = 4096
    nb = ctx // PAGE
    errs = {k: 0.0 for k in REPLACES}

    for H in (128, 16):
        B = 8
        lengths = torch.tensor([ctx, 1, 4033, 64, 65, 2500, 3999, 1234],
                               dtype=torch.int32, device=dev)[:B]
        pool, table = make_pool(B, nb, lengths.tolist(), gen, dev)
        q = torch.randn(B, H, DK, generator=gen, device=dev).to(torch.bfloat16)
        for mode in ("amla", "mul"):
            tag = f"H={H} {mode}"
            out = K.etap_decode_mla_paged(q, pool, DV, table, lengths,
                                          scale=SCALE, rescale=mode)
            ref = K.etap_decode_mla_paged_plain(q, pool, DV, table, lengths,
                                                scale=SCALE, rescale=mode)
            e = bf16_close(out, ref, f"K3 decode {tag}")
            errs["etap_decode_mla_paged"] = max(errs["etap_decode_mla_paged"],
                                                e)
            n = 4
            st = K.etap_paged_partial(q, pool, DV, table, lengths,
                                      scale=SCALE, n_splits=n, rescale=mode)
            st_ref = K.etap_paged_partial_plain(q, pool, DV, table, lengths,
                                                scale=SCALE, n_splits=n,
                                                rescale=mode)
            e = finalized_close(st, st_ref, f"K1 partial {tag}")
            errs["etap_paged_partial"] = max(errs["etap_paged_partial"], e)
            o2 = C.combine_splits(*st, out_dtype=torch.bfloat16, rescale=mode)
            r2 = C.combine_splits_plain(*st, out_dtype=torch.bfloat16,
                                        rescale=mode)
            errs["combine_splits"] = max(
                errs["combine_splits"], bf16_close(o2, r2, f"K2 {tag}"))
            bf16_close(o2, ref, f"K1+K2 vs plain K3 {tag}")
            st1 = K.etap_paged_partial(q, pool, DV, table, lengths,
                                       scale=SCALE, n_splits=1, rescale=mode)
            o1 = C.combine_splits(*st1, out_dtype=torch.bfloat16,
                                  rescale=mode)
            if not torch.equal(o1.view(torch.int16), out.view(torch.int16)):
                raise AssertionError(f"partial(n=1)+combine != single-pass "
                                     f"({tag})")
            log(f"[kernels] decode {tag}: K3 ok, K1 ok, K2 ok, "
                f"n=1 bitwise ok")

        # chunked prefill / verify at Cq = 32 on a ~4K context
        Cq = 32
        start = torch.tensor([ctx - Cq, 1000], dtype=torch.int32, device=dev)
        Bp = 2
        poolp, tablep = make_pool(Bp, nb, (start + Cq).tolist(), gen, dev)
        qp = torch.randn(Bp, Cq, H, DK, generator=gen, device=dev).to(
            torch.bfloat16)
        depth = torch.tensor([0] + [1 + (c - 1) // 3 for c in range(1, Cq)],
                             dtype=torch.int32, device=dev)
        tree = start[:, None] + depth[None, :]             # siblings share
        linear = start[:, None] + torch.arange(Cq, dtype=torch.int32,
                                               device=dev)[None, :]
        for mode in ("amla", "mul"):
            tag = f"H={H} Cq={Cq} {mode}"
            out = K.etap_prefill_mla_paged(qp, poolp, DV, tablep, start,
                                           scale=SCALE, rescale=mode)
            ref = K.etap_prefill_mla_paged_plain(qp, poolp, DV, tablep, start,
                                                 scale=SCALE, rescale=mode)
            e = bf16_close(out, ref, f"K4 prefill {tag}")
            outv = K.etap_verify_mla_paged(qp, poolp, DV, tablep, start, tree,
                                           scale=SCALE, rescale=mode)
            refv = K.etap_prefill_mla_paged_plain(qp, poolp, DV, tablep, start,
                                                  scale=SCALE, rescale=mode,
                                                  qpos=tree)
            e = max(e, bf16_close(outv, refv, f"K4 verify(tree) {tag}"))
            errs["etap_prefill_mla_paged"] = max(
                errs["etap_prefill_mla_paged"], e)
            lin = K.etap_verify_mla_paged(qp, poolp, DV, tablep, start, linear,
                                          scale=SCALE, rescale=mode)
            if not torch.equal(lin.view(torch.int16), out.view(torch.int16)):
                raise AssertionError(f"verify(linear) != prefill ({tag})")
            log(f"[kernels] prefill {tag}: K4 ok, tree verify ok, "
                f"linear verify bitwise ok")

    # ---- timing at the main path's widths: H = 128, ~4K ragged context
    iters, piters = (1, 1) if quick else (20, 3)
    H, B = 128, 8
    lengths = torch.tensor([4096, 3900, 4033, 3500, 4000, 2500, 3999, 3210],
                           dtype=torch.int32, device=dev)
    pool, table = make_pool(B, nb, lengths.tolist(), gen, dev)
    q = torch.randn(B, H, DK, generator=gen, device=dev).to(torch.bfloat16)
    keys = int(lengths.sum())
    q_bytes, row_bytes = B * H * DK * 2, DK * 2
    attn_flops = 2 * keys * H * (DK + DV)
    n = ops.paged_split_geometry(nb, 4)[0]

    def sdpa_decode():
        """Yardstick: one SDPA call over the dense gather of the same rows
        (the gather is done outside the timing)."""
        kd = pool[table.long()].reshape(B, nb * PAGE, DK)
        mask = (torch.arange(nb * PAGE, device=dev)[None, :]
                < lengths[:, None])[:, None, None, :]
        qd, kk = q[:, :, None, :], kd[:, None]
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            qd, kk, kk[..., :DV], attn_mask=mask, scale=SCALE,
            enable_gqa=True)

    timing = {}
    out_b = B * H * DV * 2
    t = cuda_time_ms(lambda: K.etap_decode_mla_paged(
        q, pool, DV, table, lengths, scale=SCALE), iters)
    tp = cuda_time_ms(lambda: K.etap_decode_mla_paged_plain(
        q, pool, DV, table, lengths, scale=SCALE), piters, warmup=1)
    tl = cuda_time_ms(sdpa_decode(), iters)
    timing["etap_decode_mla_paged"] = (
        t, tp, *bound_ms(q_bytes + keys * row_bytes + out_b, attn_flops), tl,
        f"B={B} H={H} ctx<=4096 ragged")
    stats_b = B * n * H * (DV + 2) * 4
    t = cuda_time_ms(lambda: K.etap_paged_partial(
        q, pool, DV, table, lengths, scale=SCALE, n_splits=n), iters)
    tp = cuda_time_ms(lambda: K.etap_paged_partial_plain(
        q, pool, DV, table, lengths, scale=SCALE, n_splits=n), piters,
        warmup=1)
    timing["etap_paged_partial"] = (
        t, tp, *bound_ms(q_bytes + keys * row_bytes + stats_b, attn_flops),
        None, f"B={B} H={H} n_splits={n}")
    st = K.etap_paged_partial(q, pool, DV, table, lengths, scale=SCALE,
                              n_splits=n)
    t = cuda_time_ms(lambda: C.combine_splits(*st, out_dtype=torch.bfloat16),
                     iters)
    tp = cuda_time_ms(lambda: C.combine_splits_plain(
        *st, out_dtype=torch.bfloat16), piters, warmup=1)
    timing["combine_splits"] = (t, tp, *bound_ms(stats_b + out_b,
                                                 B * n * H * DV * 2),
                                None, f"B={B} H={H} n_splits={n}")
    Cq, Bp = 32, 1
    start = torch.tensor([4096 - Cq], dtype=torch.int32, device=dev)
    poolp, tablep = make_pool(Bp, nb, [4096], gen, dev)
    qp = torch.randn(Bp, Cq, H, DK, generator=gen, device=dev).to(
        torch.bfloat16)
    keys_p = sum(int(start[0]) + c + 1 for c in range(Cq)) * H
    pf_bytes = (Bp * Cq * H * DK * 2 + 4096 * row_bytes
                + Bp * Cq * H * DV * 2)

    def sdpa_prefill():
        kd = poolp[tablep.long()].reshape(Bp, nb * PAGE, DK)
        kpos = torch.arange(nb * PAGE, device=dev)
        qpos = start[:, None] + torch.arange(Cq, device=dev)[None, :]
        mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None]
        qd = qp.transpose(1, 2)                            # [B, H, Cq, DK]
        kk = kd[:, None]
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            qd, kk, kk[..., :DV], attn_mask=mask, scale=SCALE,
            enable_gqa=True)

    t = cuda_time_ms(lambda: K.etap_prefill_mla_paged(
        qp, poolp, DV, tablep, start, scale=SCALE), iters)
    tp = cuda_time_ms(lambda: K.etap_prefill_mla_paged_plain(
        qp, poolp, DV, tablep, start, scale=SCALE), piters, warmup=1)
    tl = cuda_time_ms(sdpa_prefill(), iters)
    timing["etap_prefill_mla_paged"] = (
        t, tp, *bound_ms(pf_bytes, 2 * keys_p * (DK + DV)), tl,
        f"B={Bp} Cq={Cq} H={H} start={int(start[0])}")
    for name, (t, tp, tb, by, tl, shape) in timing.items():
        lib = "null" if tl is None else f"{tl:.4f}"
        log(f"[timing] {name} ({shape}): {t:.4f} ms, plain {tp:.4f} ms, "
            f"bound {tb:.4f} ms ({by}), library {lib} ms")
        report[name] = {"max_abs_err": errs[name], "ms": t, "plain_ms": tp,
                        "bound_ms": tb, "bound_by": by, "library_ms": tl}


# ------------------------------------------------------- phases 3 - 5
def full_config(layers: int = 3):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("deepseek_r1_671b"),
                               num_layers=layers)


def counters():
    from repro_torch.kernels.etap import combine as C
    from repro_torch.kernels.etap import etap as K
    return {"etap_paged_partial": K.etap_paged_partial,
            "combine_splits": C.combine_splits,
            "etap_decode_mla_paged": K.etap_decode_mla_paged,
            "etap_prefill_mla_paged": K.etap_prefill_mla_paged}


def phase_serve(name: str, flags: list, params) -> dict:
    import torch
    from repro_torch.launch import serve
    args = serve.parse_args(flags + ["--layers", "3"])
    cfg = serve.config_for(args)
    before = {k: fn.launches for k, fn in counters().items()}
    res = serve.run_paged(args, cfg, params=params, device="cuda")
    launched = {k: fn.launches - before[k] for k, fn in counters().items()}
    n_req = args.requests
    if len(res["outputs"]) != n_req:
        raise AssertionError(f"{name}: {len(res['outputs'])} of {n_req} "
                             "requests finished")
    for rid, toks in res["outputs"].items():
        if not toks or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"{name}: request {rid} tokens {toks}")
    tps = res["tokens_served"] / res["t_total"]
    log(f"[{name}] {' '.join(flags)}: {res['tokens_served']} tokens, "
        f"{tps:.1f} tok/s, t_prefill {res['t_prefill']:.3f} s, "
        f"t_decode {res['t_decode']:.3f} s, launches {launched}, "
        f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return launched


@contextlib.contextmanager
def plain_attention():
    """Route the model's attention through the plain versions (on CUDA
    tensors) for the kernel-vs-plain comparison of phase 5."""
    from repro_torch.kernels.etap import combine as C
    from repro_torch.kernels.etap import etap as K
    saved = (K.etap_decode_mla_paged, K.etap_paged_partial, C.combine_splits)
    K.etap_decode_mla_paged = K.etap_decode_mla_paged_plain
    K.etap_paged_partial = K.etap_paged_partial_plain
    C.combine_splits = C.combine_splits_plain
    try:
        yield
    finally:
        K.etap_decode_mla_paged, K.etap_paged_partial, C.combine_splits = saved


def profile_decode_step(params, cfg, cache, toks, table, lengths) -> None:
    """Where one full-width decode step spends its time: wall time (host
    clock, synchronised), device time by kernel (torch.profiler), the
    device's busy share of the wall time, and the step's byte bound (its
    weights, the fp32 unembedding table and the live latent rows, read
    once)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model

    def step():
        model.decode_step(params, cfg, cache, toks, block_table=table,
                          lengths=lengths)
        torch.cuda.synchronize()

    step()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = sorted(walls)[len(walls) // 2]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3   # ms
    layer_bytes = sum(t.numel() * t.element_size() for lp in params["layers"]
                      for t in _leaves(lp))
    rows = int((lengths + 1).sum()) * DK * 2 * cfg.num_layers
    need = layer_bytes + params["embed_f32"].numel() * 4 + rows
    log(f"[decode-step] wall {wall:.3f} ms (median of 5), device busy "
        f"{busy:.3f} ms ({100 * busy / wall:.1f}% of wall), byte bound "
        f"{need / HBM_BYTES_PER_S * 1e3:.3f} ms, "
        f"{sum(e.count for e in kernels)} kernel launches "
        f"({len(kernels)} kernel names)")
    groups = {"etap": 0.0, "gemm": 0.0, "other": 0.0}
    for e in kernels:
        name = e.key.lower()
        key = ("etap" if "etap_paged" in name or "combine_kernel" in name
               else "gemm" if any(x in name for x in ("gemm", "xmma",
                                                       "cutlass", "nvjet"))
               else "other")
        groups[key] += e.self_device_time_total / 1e3
    log("[decode-step] device ms by group: " + ", ".join(
        f"{k} {v:.3f}" for k, v in groups.items()))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[decode-step]   {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<4d} {e.key[:90]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def phase_decode_step(params) -> None:
    import torch
    from repro_torch.models import model
    from repro_torch.runtime.paged_cache import BlockPool, layout_for
    cfg = full_config()
    dev = torch.device("cuda")
    B, ctx = 8, 2048
    layout = layout_for(B, ctx, block_size=PAGE)
    bp = BlockPool(layout, B)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    cache = model.init_paged_cache(cfg, layout, device=dev)
    for layer in cache:                  # latent rows of a realistic scale
        layer["c"].copy_(torch.randn(layer["c"].shape, generator=gen,
                                     device=dev).to(torch.bfloat16))
    lens = [2047, 1500, 1, 700, 2000, 64, 1999, 1024]
    for n in lens:
        slot = bp.admit(0, ctx)
        bp.extend(slot, n)
    table, lengths = bp.device_views(dev)
    toks = torch.randint(0, cfg.vocab_size, (B,), generator=gen, device=dev)

    def step():
        c = [{k: v.clone() for k, v in layer.items()} for layer in cache]
        return model.decode_step(params, cfg, c, toks, block_table=table,
                                 lengths=lengths)[0]

    lk = step()
    with plain_attention():
        lp = step()
    profile_decode_step(params, cfg, cache, toks, table, lengths)
    d = float((lk - lp).abs().max())
    scale = float(lp.abs().max())
    agree = int((lk.argmax(-1) == lp.argmax(-1)).sum())
    log(f"[decode-step] full width, B={B} ctx<={ctx}: max |dlogit| {d:.4e} "
        f"(max |logit| {scale:.3f}), greedy agreement {agree}/{B}")
    if not torch.isfinite(lk).all() or d > LOGIT_RTOL * scale:
        raise AssertionError("decode step: kernel path disagrees with the "
                             "plain path")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="phases 1-2 only, one timing iteration")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from repro_torch.kernels.etap import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(gpu_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    lib_path, nvlog = build.build()
    build.library()
    for line in nvlog.splitlines():
        if line.startswith("==") or any(
                x in line for x in ("Compiling entry", "registers", "spill")):
            log(f"[build] {line.strip()}")
    log(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s")

    report: dict = {}
    phase_kernels(args.quick, report)
    if args.quick:
        log(json.dumps({"kernels": [dict(name=k, **v)
                                    for k, v in report.items()]}))
        return 0

    from repro_torch.models import model
    cfg = full_config()
    t0 = time.perf_counter()
    params = model.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[init] DeepSeek-R1 full width, {cfg.num_layers} dense layers: "
        f"{model.param_count(params) / 1e9:.3f} B params bf16 in "
        f"{time.perf_counter() - t0:.1f} s")

    for fn in counters().values():
        fn.launches = 0
    short = phase_serve("serve-short", [
        "--batch", "8", "--requests", "16", "--prompt", "512", "--gen", "32"],
        params)
    long = phase_serve("serve-long", [
        "--batch", "4", "--requests", "4", "--prompt", "4096",
        "--gen", "32", "--prefill-chunk", "256"], params)
    launches = {k: fn.launches for k, fn in counters().items()}
    log(f"[launches] serve paths: {launches}")
    if short["etap_decode_mla_paged"] == 0 or \
            short["etap_prefill_mla_paged"] == 0:
        raise AssertionError("short serve did not run K3 and K4")
    if long["etap_paged_partial"] == 0 or long["combine_splits"] == 0:
        raise AssertionError("long serve did not run the split path K1+K2")
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f"{k} never launched on the serve paths")

    phase_decode_step(params)

    kernels = [dict(name=k, route="cuda", source=SOURCES[k],
                    replaces=REPLACES[k], launches=launches[k], **report[k])
               for k in REPLACES]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
