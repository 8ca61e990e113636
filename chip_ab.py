#!/usr/bin/env python3
"""Time the latent-width (Dk 576, Dv 512) decode kernels and K4, or with
``--prefill`` DeepSeek-R1's dense and paged prefills, of several checkouts
of this repository on one GPU, in turns, so that a change can be held
against its parent on one card in one call.

Each checkout runs in its own process (it builds its own kernels from its
own sources). By default it times K3, K1 (n = 4), K5, K6, K7 and K8, and
K3q and K1q (n = 4) over int8 and e4m3 pools, at chip_smoke.py's timing
shapes (B 8, H 128, ragged context up to 4096, bf16 q) with CUDA events
over 200 launches each; then K4 over bf16 pools (B 1, H 128, a 4096-row
latent pool): fused at Cq 32 from start 4064, at Cq 32 from 256
(serve-short's chunk shape: a 512-token prompt in 32-token chunks walks at
most 8 pages) and at serve-long's Cq 256 from 3840, with V in its own pool
at Cq 256, and over Granite-20B's separate (128, 128) pools at B 2 x Cq
128 x H 48 from starts 1920 and 0, over 50 launches each; then K4q at the
same latent shapes over int8 and e4m3 pools (bf16 q; with V in its own
pool at Cq 256 over int8) and over Granite's separate code pools (fp32 q),
over 50 launches each; then K3 over Granite's separate bf16 pools (B 8 x
48 heads, ragged lengths) beside one SDPA call on the gathered rows, and
K1 there under its auto plan, over 200 launches each; then K5 and K6 at a
128-, 64- and 256-wide GQA head at chip_smoke.GQA_TIMED's shapes
(qwen-dense / qwen-long, stablelm-dense / smol-long, rgemma-short /
rgemma-long) with the baseline K7 / K8 at the same shapes, over 200
launches each, the host time of one K5 [128] call (µs), and the paper's
geometry (B 16, H 16, context 65,536) through the paged entry's K1 + K2
and, over the same rows dense, the baseline entry's K8 + K2, over 20. Then K5q and K6q over the quantized GQA serve phases' code rows
with fp32 q (chip_smoke.quant_dense_cases: qwen-short's int8 rows and
qwen-long's fp8 rows at 128, smol-short's and smol-long's at 64), and the
baseline over codes, K7q and K8q, at the quantized serve phases' shapes
(serve-short-std-int8's latent, B 15 x H 128, bf16 q; serve-long-std-fp8's,
B 7, 4 splits; qwen-short-std-fp8 / qwen-long-std-int8 at 128 and
smol-short / smol-long at 64, fp32 q), over 200 launches each; then K2 in
both orientations (``K2`` ETAP's [B, n, Dv, H], ``K2std`` the baseline's
[B, n, H, Dv], bf16 out) at Dv 512 (serve-long-std's B 7 x 4 splits x H
128), 128 (qwen-long's 8 grouped rows x 22 splits x G 4), 64 (smol-long's 5
x 22 x G 3), 256 (rgemma-long's 1 x 2 x G 16) and 512 at the paper's
geometry (``512p``: B 16 x 16 splits x H 16), device time only, and the
host time of one K2 call at Dv 128 (``host-us-K2[128]``). A
launch that the wrapper's host time outpaces reads as that host time under
CUDA events, so the decode kernels (bf16 and over codes) also get a
``-dev`` column: their kernels' device time under torch.profiler. Each
checkout also hands back a digest of the outputs of the bf16 decode
kernels (K3, K1, K5, K6 at the timing shapes), of the ETAP decode kernels
over codes (K3q, K1q, K5q, K6q at their timing shapes), of the baseline
over bf16 rows (K7 / K8 at the latent's timing shapes and at qwen-dense /
qwen-long) and over codes (K7q / K8q at a 128-wide head), and of K2's in
both orientations at each of its shapes (both rescale modes, bf16 and fp32
out, a masked split), and the run says whether they are bitwise equal
across the checkouts. With ``--prefill`` it runs ``model.prefill`` on DeepSeek-R1
at full width cut to its 3 dense layers (random bf16 weights, seed 0) at
dense-short's B 8 x 512 and dense-long's B 4 x 4096 prompts: the median
wall of 5 synchronised runs (ms) and the peak device memory of those runs
(GiB, weights included); then its paged chunked prefill
(``model.prefill_chunk`` over a one-slot block pool, K4 in every layer):
one 4096-token prompt in 256-token chunks (serve-long's) and one 512-token
prompt in 32-token chunks (serve-short's), the median wall of 5
synchronised runs (``--paged`` adds the same prompts over an fp8 pool,
serve-long-fp8's, and an int8 pool, serve-short-int8's: K4q in every
layer); then K9 alone at each width, at chip_smoke.PREFILL_TIMED's shapes
(dense-long MLA, qwen-dense G 4, stablelm-dense G 1; random bf16 q, k, v),
with CUDA events over 50 launches. With ``--paged`` it runs only the paged
chunked prefills, so that many alternating pairs fit one call. With
``--serve`` it serves chip_smoke.py's serve-short and dense-short phases
on that 3-layer model through the checkout's own ``run_paged`` and
``run_dense`` (tok/s as the serve phases count it). The medians per
checkout close the output, with the quartiles where a checkout ran 4
times or more.

    git archive <parent> | tar -x -C .proof/parent     # .proof/: gitignored
    python3 chip_ab.py .proof/parent . . .proof/parent .proof/parent .
    python3 chip_ab.py --prefill .proof/parent . . .proof/parent
    python3 chip_ab.py --paged .proof/parent . . .proof/parent ...
    python3 chip_ab.py --serve .proof/parent . . .proof/parent ...
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys

KERNELS = ("K3", "K1", "K5", "K6", "K7", "K8", "K3q-int8", "K1q-int8",
           "K3q-fp8", "K1q-fp8", "K4-Cq32", "K4-Cq32-s256", "K4-Cq256",
           "K4sep-Cq256", "K4sep[128]-Cq128", "K4q-int8-Cq32",
           "K4q-int8-Cq32-s256", "K4q-int8-Cq256", "K4q-fp8-Cq32",
           "K4q-fp8-Cq32-s256", "K4q-fp8-Cq256", "K4qsep-int8-Cq256",
           "K4qsep[128]-int8-Cq128", "K4qsep[128]-fp8-Cq128", "K3sep[128]",
           "SDPA-K3sep[128]", "K1sep[128]", "K5[128]", "K6[128]", "K5[64]",
           "K6[64]", "K5[256]", "K6[256]", "paper-K1+K2", "host-us-K5[128]",
           "K3-dev", "K1-dev", "K5-dev", "K6-dev", "K3sep[128]-dev",
           "SDPA-K3sep[128]-dev", "K1sep[128]-dev", "K5[128]-dev",
           "K6[128]-dev", "K5[64]-dev", "K6[64]-dev", "K5[256]-dev",
           "K6[256]-dev", "paper-K1+K2-dev", "K3q-int8-dev", "K1q-int8-dev",
           "K3q-fp8-dev", "K1q-fp8-dev", "K5q[128]-int8", "K6q[128]-fp8",
           "K5q[64]-int8", "K6q[64]-fp8", "K5q[128]-int8-dev",
           "K6q[128]-fp8-dev", "K5q[64]-int8-dev", "K6q[64]-fp8-dev",
           "K7[128]", "K8[128]", "K7[128]-dev", "K8[128]-dev", "K7-dev",
           "K8-dev", "K7[64]", "K8[64]", "K7[64]-dev", "K8[64]-dev",
           "K7[256]", "K8[256]", "K7[256]-dev", "K8[256]-dev", "paper-K8+K2",
           "paper-K8+K2-dev", "K7q[576]-int8", "K8q[576]-fp8", "K7q[128]-fp8",
           "K8q[128]-int8", "K7q[64]-fp8", "K8q[64]-int8",
           "K7q[576]-int8-dev", "K8q[576]-fp8-dev", "K7q[128]-fp8-dev",
           "K8q[128]-int8-dev", "K7q[64]-fp8-dev", "K8q[64]-int8-dev",
           "K2[512]-dev", "K2std[512]-dev", "K2[128]-dev", "K2std[128]-dev",
           "K2[64]-dev", "K2std[64]-dev", "K2[256]-dev", "K2std[256]-dev",
           "K2[512p]-dev", "K2std[512p]-dev", "host-us-K2[128]")
# the kernels whose outputs are held bitwise from one checkout to the next
# (the bf16 decode kernels, the ETAP decode kernels over codes, the
# baseline over bf16 rows at the latent and at 128, and the baseline over
# codes), each a digest of its output
BITS = ("K3", "K1", "K5", "K6", "K7", "K8", "K3q-int8", "K1q-int8",
        "K3q-fp8", "K1q-fp8", "K7[128]", "K8[128]", "K7q[128]-int8",
        "K8q[128]-fp8")
PREFILL = ("short-ms", "short-GiB", "long-ms", "long-GiB", "paged-long-ms",
           "paged-short-ms", "K9[192,128]-ms", "K9[128,128]-ms",
           "K9[64,64]-ms")
PAGED = ("paged-long-ms", "paged-short-ms", "paged-long-fp8-ms",
         "paged-short-int8-ms")
SERVE = ("serve-short-tok/s", "dense-short-tok/s")


def time_one(root: str) -> dict:
    sys.path[:0] = [root + "/src", root]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.etap import etap as K
    from repro_torch.kernels.etap.schedule import dense_split_plan
    from repro_torch.kernels.flash_decode import flash_decode as FD
    from repro_torch.runtime.paged_cache import gather_blocks
    build.library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    B, H, ctx, S = 8, 128, 4096, cs.SCALE
    lengths = torch.tensor([4096, 3900, 4033, 3500, 4000, 2500, 3999, 3210],
                           dtype=torch.int32, device=dev)
    k = torch.randn(B, ctx, cs.DK, generator=gen, device=dev).to(
        torch.bfloat16)
    v = k[..., :cs.DV]
    q = torch.randn(B, H, cs.DK, generator=gen, device=dev).to(torch.bfloat16)
    pool, table = cs.dense_as_paged(k, gen)
    plan = dense_split_plan(ctx, 512, 4)
    quant = {kvd: cs.make_quant_pool(B, ctx // cs.PAGE, lengths.tolist(), kvd,
                                     gen, dev) for kvd in ("int8", "fp8")}
    fns = {
        "K3": lambda: K.etap_decode_mla_paged(q, pool, cs.DV, table, lengths,
                                              scale=S),
        "K1": lambda: K.etap_paged_partial(q, pool, cs.DV, table, lengths,
                                           scale=S, n_splits=4),
        "K5": lambda: K.etap_decode_dense(q, k, v, lengths, scale=S,
                                          block=512),
        "K6": lambda: K.etap_partial_dense(q, k, v, lengths, scale=S,
                                           plan=plan),
        "K7": lambda: FD.flash_decode(q, k, v, lengths, scale=S, block=512),
        "K8": lambda: FD.flash_decode_partial(q, k, v, lengths, scale=S,
                                              plan=plan),
    }
    for kvd, (codes, sz, qtable) in quant.items():
        fns[f"K3q-{kvd}"] = lambda c=codes, z=sz, t=qtable: \
            K.etap_decode_mla_paged_quant(q, c, z, cs.DV, t, lengths, scale=S)
        fns[f"K1q-{kvd}"] = lambda c=codes, z=sz, t=qtable: \
            K.etap_paged_partial_quant(q, c, z, cs.DV, t, lengths, scale=S,
                                       n_splits=4)
    out = {n: cs.cuda_time_ms(f, 200, warmup=5) for n, f in fns.items()}
    out.update({f"{n}-dev": device_ms(fns[n]) for n in (
        "K3", "K1", "K5", "K6", "K7", "K8", "K3q-int8", "K1q-int8",
        "K3q-fp8", "K1q-fp8")})
    out["bits"] = bits_of(cs, FD, gen, dev, {n: fns[n] for n in BITS
                                             if n in fns})
    del k, v, pool, table, quant
    # K4 over bf16 pools: the latent's 4096-row pool, and Granite's pools
    pool, table = cs.make_pool(1, 64, [4096], gen, dev)
    vpool = pool[..., :cs.DV].contiguous()
    k4 = {}
    for name, Cq, s0 in (("K4-Cq32", 32, 4064), ("K4-Cq32-s256", 32, 256),
                         ("K4-Cq256", 256, 3840)):
        qp = torch.randn(1, Cq, H, cs.DK, generator=gen, device=dev).to(
            torch.bfloat16)
        st = torch.tensor([s0], dtype=torch.int32, device=dev)
        k4[name] = lambda qp=qp, st=st: K.etap_prefill_mla_paged(
            qp, pool, cs.DV, table, st, scale=S)
        if Cq == 256:
            k4["K4sep-Cq256"] = lambda qp=qp, st=st: K.etap_prefill_paged(
                qp, pool, vpool, table, st, scale=S)
    gq3, gargs, gtable, glens, _ = cs.granite_case("fp", cs.GRANITE_LENGTHS,
                                                   gen, dev)
    gq = torch.randn(2, cs.GRANITE_CQ, cs.GRANITE_H, 128, generator=gen,
                     device=dev).to(torch.bfloat16)
    gst = torch.tensor(cs.GRANITE_STARTS, dtype=torch.int32, device=dev)
    k4["K4sep[128]-Cq128"] = lambda: K.etap_prefill_paged(
        gq, *gargs, gtable[:2], gst, scale=128 ** -0.5)
    # K4q over int8 / e4m3 pools (bf16 q) at K4's latent shapes, and over
    # Granite's separate code pools (fp32 q, as the GQA paths cast it)
    for kvd in ("int8", "fp8"):
        codes, sz, ctable = cs.make_quant_pool(1, 64, [4096], kvd, gen, dev)
        for name, Cq, s0 in (("Cq32", 32, 4064), ("Cq32-s256", 32, 256),
                             ("Cq256", 256, 3840)):
            qp = torch.randn(1, Cq, H, cs.DK, generator=gen, device=dev).to(
                torch.bfloat16)
            st = torch.tensor([s0], dtype=torch.int32, device=dev)
            k4[f"K4q-{kvd}-{name}"] = lambda qp=qp, st=st, c=codes, z=sz, \
                t=ctable: K.etap_prefill_mla_paged_quant(qp, c, z, cs.DV, t,
                                                         st, scale=S)
            if kvd == "int8" and Cq == 256:
                vc, vs = cs.latent_v(codes, sz)
                k4["K4qsep-int8-Cq256"] = lambda qp=qp, st=st, c=codes, \
                    z=sz, t=ctable, vc=vc, vs=vs: K.etap_prefill_paged_quant(
                        qp, c, z, vc, vs, t, st, scale=S)
        _, qargs, qtable, _, _ = cs.granite_case(kvd, cs.GRANITE_LENGTHS,
                                                 gen, dev)
        gqf = torch.randn(2, cs.GRANITE_CQ, cs.GRANITE_H, 128, generator=gen,
                          device=dev)
        k4[f"K4qsep[128]-{kvd}-Cq128"] = lambda a=qargs, t=qtable, q=gqf: \
            K.etap_prefill_paged_quant(q, *a, t[:2], gst, scale=128 ** -0.5)
    out.update({n: cs.cuda_time_ms(f, 50, warmup=3) for n, f in k4.items()})
    # K3 over Granite's separate pools (B 8 x 48 heads) and its SDPA
    # yardstick on the gathered rows (gathered before the timing)
    kd, vd = (gather_blocks(x, gtable) for x in gargs)
    mask = (torch.arange(kd.shape[1], device=dev)[None, :]
            < glens[:, None])[:, None, None, :]
    qd = gq3[:, :, None, :]
    out["K3sep[128]"] = cs.cuda_time_ms(lambda: K.etap_decode_paged(
        gq3, *gargs, gtable, glens, scale=128 ** -0.5), 200, warmup=5)
    sdpa = (lambda: torch.nn.functional.scaled_dot_product_attention(
        qd, kd[:, None], vd[:, None], attn_mask=mask, scale=128 ** -0.5,
        enable_gqa=True))
    out["SDPA-K3sep[128]"] = cs.cuda_time_ms(sdpa, 200, warmup=5)
    out["K3sep[128]-dev"] = device_ms(lambda: K.etap_decode_paged(
        gq3, *gargs, gtable, glens, scale=128 ** -0.5))
    out["SDPA-K3sep[128]-dev"] = device_ms(sdpa)
    gqa = gqa_times(cs, K, gen, dev, gq3, gargs, gtable, glens)
    out["bits"].update(gqa.pop("bits"))
    out.update(gqa)
    qd = quant_dense_times(cs, K, dev)
    out["bits"].update(qd.pop("bits"))
    out.update(qd)
    k2 = combine_times(dev, gen)
    out["bits"].update(k2.pop("bits"))
    out.update(k2)
    return out


def device_ms(fn, iters: int = 50) -> float:
    """The device time of one call of ``fn`` (ms): its kernels' durations
    summed over ``iters`` calls under torch.profiler, over ``iters``.  A
    launch that the wrappers' host time (tens of µs a call) outpaces reads
    as that host time in cuda_time_ms; this reads the kernel alone.  The
    profiler now and then hands back no device events: such a window is
    taken again, up to twice."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    us = 0.0
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.name.startswith(("Memset", "Memcpy")))
        if us:
            break
    return us / iters / 1e3


def host_us(fn, calls: int = 200) -> float:
    """The host time of one call of ``fn`` (µs): the mean of ``calls``
    unsynchronised calls after 5 to warm up."""
    import time

    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def gqa_times(cs, K, gen, dev, gq3, gargs, gtable, glens) -> dict:
    """K5 and K6 at chip_smoke.GQA_TIMED's shapes (each width's single
    pass and split shape, the split one under its auto plan), K7 and K8,
    the baseline, beside them, and K1 over Granite's separate pools under
    its auto plan, over 200 launches each, with their device times; the
    paper's geometry (B 16, H 16, context 65,536: K1 + K2 through the
    paged entry's auto plan, and K8 + K2 over the same rows dense through
    the baseline's entry and its auto plan) over 20; the host time a K5
    [128] launch takes (the wrapper's call, µs, the mean of 200
    unsynchronised calls); and, under "bits", the digests of K7 / K8
    [128]'s outputs."""
    import torch
    from repro_torch.core.attn_spec import AttnSpec
    from repro_torch.kernels import splitkv
    from repro_torch.kernels.etap import ops
    from repro_torch.kernels.flash_decode import flash_decode as FD
    by_tag = {c[0]: c for c in cs.gqa_cases(gen, dev)}
    fns = {}
    for hd, (single, split) in cs.GQA_TIMED.items():
        _, _, q, k, v, lens, blk = by_tag[single]
        fns[f"K5[{hd}]"] = lambda q=q, k=k, v=v, lens=lens, blk=blk, s=hd ** \
            -0.5: K.etap_decode_dense(q, k, v, lens, block=blk, scale=s)
        _, _, q, k, v, lens, blk = by_tag[split]
        plan = splitkv.split_plan(q, k, v, spec=AttnSpec(block=blk))
        fns[f"K6[{hd}]"] = lambda q=q, k=k, v=v, lens=lens, plan=plan, \
            s=hd ** -0.5: K.etap_partial_dense(q, k, v, lens, plan=plan,
                                               scale=s)
        # the baseline at the same shapes
        fns[f"K8[{hd}]"] = lambda q=q, k=k, v=v, lens=lens, plan=plan, \
            s=hd ** -0.5: FD.flash_decode_partial(q, k, v, lens, plan=plan,
                                                  scale=s)
        _, _, q, k, v, lens, blk = by_tag[single]
        fns[f"K7[{hd}]"] = lambda q=q, k=k, v=v, lens=lens, blk=blk, \
            s=hd ** -0.5: FD.flash_decode(q, k, v, lens, block=blk, scale=s)
    spec = AttnSpec(scale=128 ** -0.5)
    n = ops._paged_n_splits(gq3, gtable, cs.PAGE, 128, spec)
    gpad = ops._pad_table(gtable, ops.paged_split_geometry(
        gtable.shape[1], n)[2])
    fns["K1sep[128]"] = lambda: K.etap_paged_partial_sepv(
        gq3, *gargs, gpad, glens, n_splits=n, scale=128 ** -0.5)
    out = {name: cs.cuda_time_ms(f, 200, warmup=5) for name, f in fns.items()}
    out.update({f"{name}-dev": device_ms(f) for name, f in fns.items()})
    out["bits"] = {n: digest(fns[n]()) for n in ("K7[128]", "K8[128]")}
    out["host-us-K5[128]"] = host_us(fns["K5[128]"])
    del by_tag, fns
    Bp, Hp, ctx = cs.PAPER
    pool, table = cs.make_pool(Bp, ctx // cs.PAGE, [ctx] * Bp, gen, dev)
    lens = torch.full((Bp,), ctx, dtype=torch.int32, device=dev)
    q = torch.randn(Bp, Hp, cs.DK, generator=gen, device=dev).to(
        torch.bfloat16)
    spec = AttnSpec(scale=cs.SCALE)
    out["paper-K1+K2"] = cs.cuda_time_ms(
        lambda: ops.etap_decode_mla_paged_splitkv(q, pool, cs.DV, table,
                                                  lens, spec=spec), 20,
        warmup=2)
    out["paper-K1+K2-dev"] = device_ms(
        lambda: ops.etap_decode_mla_paged_splitkv(q, pool, cs.DV, table,
                                                  lens, spec=spec), 10)
    del pool
    torch.cuda.empty_cache()
    # the baseline there: the same geometry over dense rows, K8 + K2 under
    # the baseline entry's auto plan
    from repro_torch.kernels.flash_decode import ops as fd_ops
    k = torch.randn(Bp, ctx, cs.DK, generator=gen, device=dev).to(
        torch.bfloat16)

    def paper_std():
        return fd_ops.flash_decode_splitkv(q, k, k[..., :cs.DV], lens,
                                           spec=spec)
    out["paper-K8+K2"] = cs.cuda_time_ms(paper_std, 20, warmup=2)
    out["paper-K8+K2-dev"] = device_ms(paper_std, 10)
    del k
    torch.cuda.empty_cache()
    return out


def quant_dense_times(cs, K, dev) -> dict:
    """K5q / K6q (ETAP) and K7q / K8q (the baseline) over the quantized
    serve phases' code rows and serve lengths (chip_smoke.quant_dense_cases;
    the split ones under the phase's plan), over 200 launches each, and
    their device times: K5q / K6q with fp32 q at qwen-short int8 and
    qwen-long fp8 (128), smol-short int8 and smol-long fp8 (64); K7q / K8q
    at serve-short-std int8 and serve-long-std fp8 (the latent, bf16 q),
    qwen-short fp8 and qwen-long int8 (128), smol-short fp8 and smol-long
    int8 (64).  Under "bits", the digests of K5q / K6q's outputs."""
    import numpy as np
    import torch
    from repro_torch.kernels.etap.schedule import dense_split_plan
    from repro_torch.kernels.flash_decode import flash_decode as FD
    cases = {c[0]: c for c in cs.quant_dense_cases()}
    out, fns = {}, {}
    for name, tag, kvd in (("K5q[128]-int8", "qwen-short", "int8"),
                           ("K6q[128]-fp8", "qwen-long", "fp8"),
                           ("K5q[64]-int8", "smol-short", "int8"),
                           ("K6q[64]-fp8", "smol-long", "fp8"),
                           ("K7q[576]-int8", "serve-short-std", "int8"),
                           ("K8q[576]-fp8", "serve-long-std", "fp8"),
                           ("K7q[128]-fp8", "qwen-short", "fp8"),
                           ("K8q[128]-int8", "qwen-long", "int8"),
                           ("K7q[64]-fp8", "smol-short", "fp8"),
                           ("K8q[64]-int8", "smol-long", "int8")):
        _, B, S, Kv, G, Dk, Dv, fused, qdt, n, _, serve = cases[tag]
        q, _, _, kc, ks, vc, vs = cs.quant_dense_inputs(
            B, S, Kv, G, Dk, Dv, fused, qdt, kvd, np.random.default_rng(11))
        lengths = torch.tensor(serve, dtype=torch.int32,
                               device=dev).repeat_interleave(Kv)
        kw = dict(k_sz=ks, v_sz=vs, scale=Dk ** -0.5)
        single, split = ((K.etap_decode_dense_quant,
                          K.etap_partial_dense_quant)
                         if name.startswith(("K5q", "K6q")) else
                         (FD.flash_decode_quant,
                          FD.flash_decode_partial_quant))
        if n == 1:
            def f(q=q, kc=kc, vc=vc, lengths=lengths, kw=kw, fn=single):
                return fn(q, kc, vc, lengths, **kw)
        else:
            def f(q=q, kc=kc, vc=vc, lengths=lengths, kw=kw, fn=split,
                  plan=dense_split_plan(S, cs.PAGE, n)):
                return fn(q, kc, vc, lengths, plan=plan, **kw)
        fns[name] = f
        out[name] = cs.cuda_time_ms(f, 200, warmup=5)
        out[name + "-dev"] = device_ms(f)
    out["bits"] = {n: digest(f()) for n, f in fns.items()
                   if n.startswith(("K5q", "K6q"))}
    return out


# K2's shapes: (column tag, Dv, B, n, H): the split shapes the serve
# phases give it and the paper's geometry
K2_SHAPES = (("512", 512, 7, 4, 128), ("128", 128, 8, 22, 4),
             ("64", 64, 5, 22, 3), ("256", 256, 1, 2, 16),
             ("512p", 512, 16, 16, 16))


def k2_stats(B, n, H, Dv, mode, g, dev):
    """Split stats for K2's digests (m, l [B, n, H], Acc [B, n, H, Dv]):
    integer-valued m in amla mode, split 0 far below the others (weights
    around 2^-140 or e^-95: subnormal, or 0), split n // 2 fully masked
    (m = -1e30, l = 0, a finite garbage Acc)."""
    import torch
    m = torch.randn(B, n, H, generator=g, device=dev) * 4
    if mode == "amla":
        m = m.round()
    m[:, 0] -= 140 if mode == "amla" else 95
    l = torch.rand(B, n, H, generator=g, device=dev) + 1
    acc = torch.randn(B, n, H, Dv, generator=g, device=dev)
    if n > 1:
        m[:, n // 2], l[:, n // 2] = -1e30, 0.0
        acc[:, n // 2] *= 1e3
    return m, l, acc


def combine_times(dev, gen) -> dict:
    """K2's device time in both orientations (``K2``: ETAP's acc [B, n, Dv,
    H]; ``K2std``: the baseline's [B, n, H, Dv]; bf16 out) at K2_SHAPES:
    Dv 512 at serve-long-std's B 7 x 4 splits x H 128, 128 at qwen-long's 8
    grouped rows x 22 splits x G 4, 64 at smol-long's 5 x 22 x G 3, 256 at
    rgemma-long's 1 x 2 x G 16 and the paper's geometry ``512p`` (B 16 x 16
    splits x H 16), over random finite stats; the host time of one K2 call
    at Dv 128 (µs, the mean of 200 unsynchronised calls); and, under
    "bits", a digest of each orientation's outputs at each shape in both
    rescale modes with bf16 and fp32 out (k2_stats, a generator of its
    own)."""
    import torch
    from repro_torch.kernels.etap import combine as C
    out, bits = {}, {}
    g = torch.Generator(device=dev)
    g.manual_seed(27)
    for tag, Dv, B, n, H in K2_SHAPES:
        def rand(*shape):
            return torch.randn(*shape, generator=gen, device=dev)
        m = rand(B, n, H)
        l = rand(B, n, H).abs() + 1
        for name, fn, acc in (
                ("K2", C.combine_splits, rand(B, n, Dv, H)),
                ("K2std", C.combine_splits_std, rand(B, n, H, Dv))):
            def call(fn=fn, acc=acc, m=m, l=l):
                return fn(m, l, acc, out_dtype=torch.bfloat16)
            out[f"{name}[{tag}]-dev"] = device_ms(call)
            if (tag, name) == ("128", "K2"):
                out["host-us-K2[128]"] = host_us(call)
        outs = {"K2": [], "K2std": []}
        for mode in ("amla", "mul"):
            m, l, acc = k2_stats(B, n, H, Dv, mode, g, dev)
            acc_t = acc.transpose(2, 3).contiguous()
            for dt in (torch.bfloat16, torch.float32):
                kw = dict(out_dtype=dt, rescale=mode)
                outs["K2"].append(C.combine_splits(m, l, acc_t, **kw))
                outs["K2std"].append(C.combine_splits_std(m, l, acc, **kw))
        for name, o in outs.items():
            bits[f"{name}[{tag}]"] = digest(tuple(o))
    out["bits"] = bits
    return out


def digest(x) -> str:
    """A digest of the bits of a tensor or a tuple of tensors."""
    import hashlib

    import torch
    h = hashlib.sha256()
    for t in x if isinstance(x, tuple) else (x,):
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def bits_of(cs, FD, gen, dev, fns: dict) -> dict:
    """A digest of each output of ``fns`` (the bf16 latent decode kernels,
    ETAP's and the baseline's, at time_one's inputs) and of K7q / K8q at a 128-wide GQA head (B 16
    rows of G 4 heads over int8 / e4m3 code rows, fp32 q), so that
    checkouts can be held bitwise against each other."""
    import torch
    from repro_torch.kernels.etap.schedule import dense_split_plan
    from repro_torch.runtime import paged_cache

    out = {n: digest(f()) for n, f in fns.items()}
    BG, S, hd = 16, 1024, 128
    q = torch.randn(BG, 4, hd, generator=gen, device=dev)
    lengths = torch.randint(1, S + 1, (BG,), generator=gen, device=dev,
                            dtype=torch.int32)
    for kvd, name in (("int8", "K7q[128]-int8"), ("fp8", "K8q[128]-fp8")):
        kc, ks = paged_cache.quantize_rows(torch.randn(
            BG, S, hd, generator=gen, device=dev), kvd)
        vc, vs = paged_cache.quantize_rows(torch.randn(
            BG, S, hd, generator=gen, device=dev), kvd)
        kw = dict(k_sz=ks, v_sz=vs, scale=hd ** -0.5)
        out[name] = digest(
            FD.flash_decode_quant(q, kc, vc, lengths, **kw)
            if name.startswith("K7q") else FD.flash_decode_partial_quant(
                q, kc, vc, lengths, plan=dense_split_plan(S, 512, 2), **kw))
    return out


def paged_prefill_ms(model, cfg, params, S: int, chunk: int, gen,
                     kv_dtype: str = "fp") -> float:
    """The median wall (ms) of 5 synchronised chunked prefills of one
    S-token prompt in ``chunk``-token chunks over a one-slot paged cache
    (bf16, or int8 / fp8 codes), each chunk one ``model.prefill_chunk``
    (its rows appended, quantized over codes, then K4 or K4q)."""
    import time

    import torch
    from repro_torch.runtime.paged_cache import BlockPool, layout_for
    layout = layout_for(1, S + 32, block_size=64)
    bp = BlockPool(layout, 1)
    slot = bp.admit(S, S + 32)
    cache = model.init_paged_cache(cfg, layout, kv_dtype, device="cuda")
    table = torch.tensor(bp.table[slot:slot + 1], dtype=torch.int32,
                         device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                         device="cuda", dtype=torch.int32)
    starts = [torch.tensor([c0], dtype=torch.int32, device="cuda")
              for c0 in range(0, S, chunk)]

    def run():
        for i, st in enumerate(starts):
            model.prefill_chunk(params, cfg, cache,
                                toks[:, i * chunk:(i + 1) * chunk], table, st)
        torch.cuda.synchronize()

    run()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        run()
        walls.append((time.perf_counter() - t0) * 1e3)
    del cache
    return statistics.median(walls)


def deepseek(root: str):
    """root's DeepSeek-R1 (3 dense layers, random bf16 weights, seed 0):
    (model module, cfg, params, a CUDA generator)."""
    sys.path[:0] = [root + "/src", root]
    import torch

    import chip_smoke as cs
    from repro_torch.models import model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cs.full_config()
    params = model.init(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    return model, cfg, params, gen


def paged_prefills(model, cfg, params, gen, quant: bool = False) -> dict:
    """serve-long's and serve-short's paged chunked prefills (ms), and with
    ``quant`` those of serve-long-fp8 and serve-short-int8 (the same
    prompts over fp8 / int8 pools)."""
    runs = [("paged-long", 4096, 256, "fp"), ("paged-short", 512, 32, "fp")]
    if quant:
        runs += [("paged-long-fp8", 4096, 256, "fp8"),
                 ("paged-short-int8", 512, 32, "int8")]
    return {f"{tag}-ms": paged_prefill_ms(model, cfg, params, S, chunk, gen,
                                          kvd)
            for tag, S, chunk, kvd in runs}


def paged_one(root: str) -> dict:
    return paged_prefills(*deepseek(root), quant=True)


def prefill_one(root: str) -> dict:
    import time

    model, cfg, params, gen = deepseek(root)
    import torch

    import chip_smoke as cs
    out = {}
    for tag, B, S in (("short", 8, 512), ("long", 4, 4096)):
        toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                             device="cuda", dtype=torch.int32)

        def run(toks=toks, S=S):
            model.prefill(params, cfg, toks, S + 32)
            torch.cuda.synchronize()

        run()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            run()
            walls.append((time.perf_counter() - t0) * 1e3)
        out[f"{tag}-ms"] = statistics.median(walls)
        out[f"{tag}-GiB"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out.update(paged_prefills(model, cfg, params, gen))
    from repro_torch.kernels.flash_prefill import flash_prefill as FP
    for (d, dv), tag in cs.PREFILL_TIMED.items():
        B, S, H, K = next(c[2:] for c in cs.PREFILL_CASES if c[0] == tag)
        q, k, v = (torch.randn(B, S, n, w, generator=gen, device="cuda").to(
            torch.bfloat16) for n, w in ((H, d), (K, d), (K, dv)))
        out[f"K9[{d},{dv}]-ms"] = cs.cuda_time_ms(
            lambda q=q, k=k, v=v, s=d ** -0.5: FP.flash_prefill(q, k, v,
                                                                scale=s),
            50, warmup=3)
        del q, k, v
    return out


def serve_one(root: str) -> dict:
    """serve-short's and dense-short's tok/s on root's 3-layer DeepSeek-R1,
    through root's serve loops."""
    model, cfg, params, _ = deepseek(root)
    import chip_smoke as cs
    from repro_torch.launch import serve
    out = {}
    for tag, flags in (("serve-short", cs.SHORT),
                       ("dense-short", cs.DENSE + ["--batch", "8",
                                                   "--prompt", "512"])):
        args = serve.parse_args(flags + ["--layers", str(cfg.num_layers)])
        if args.cache_layout == "dense":
            res = serve.run_dense(args, cfg, params=params, device="cuda")
            t = res["t_prefill"] + res["t_decode"]
        else:
            res = serve.run_paged(args, cfg, params=params, device="cuda")
            t = res["t_total"]
        out[f"{tag}-tok/s"] = res["tokens_served"] / t
    return out


ONE = {"--one": time_one, "--one-prefill": prefill_one,
       "--one-paged": paged_one, "--one-serve": serve_one}
MODES = {"--prefill": ("--one-prefill", PREFILL),
         "--paged": ("--one-paged", PAGED),
         "--serve": ("--one-serve", SERVE)}


def spread(xs: list) -> str:
    """The median, with the quartiles where there are 4 values or more."""
    if len(xs) < 4:
        return f"{statistics.median(xs):.4f}"
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    return f"{q2:.4f} [{q1:.4f}, {q3:.4f}]"


def main(argv: list) -> int:
    if argv[:1] and argv[0] in ONE:
        print(json.dumps(ONE[argv[0]](argv[1])), flush=True)
        return 0
    one, names = "--one", KERNELS
    if argv[:1] and argv[0] in MODES:
        (one, names), argv = MODES[argv[0]], argv[1:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    runs: dict = {}
    bits: dict = {}
    for root in argv:
        out = subprocess.run([sys.executable, __file__, one, root],
                             capture_output=True, text=True)
        if out.returncode:
            print(out.stderr[-4000:], file=sys.stderr)
            out.check_returncode()
        ms = json.loads(out.stdout.strip().splitlines()[-1])
        runs.setdefault(root, []).append(ms)
        for n, d in ms.get("bits", {}).items():
            bits.setdefault(n, set()).add(d)
        print(root, " ".join(f"{n} {ms[n]:.4f}" for n in names),
              flush=True)
    for root, rs in runs.items():
        print(f"median of {len(rs)} {root}: " + " ".join(
            f"{n} {spread([r[n] for r in rs])}" for n in names))
    if bits:
        print("outputs across the checkouts: " + ", ".join(
            f"{n} {'bitwise equal' if len(d) == 1 else 'DIFFER'}"
            for n, d in bits.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
