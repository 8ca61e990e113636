#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Phases, each of which fails the run when it fails:

  1. build   the port's kernels from ``src/repro_torch/kernels/csrc``
             (one nvcc per source, started together) and print each
             source's compile time and ptxas' register / shared-memory
             lines;
  2. kernels each kernel against its plain PyTorch version on the card, at
             DeepSeek-R1's bf16 widths (Dk 576, Dv 512, ~4K ragged context,
             H = 128 and 16, both rescale modes): the paged ETAP kernels
             K1-K4 (page 64, prefill Cq = 32 with and without a
             tree-shaped qpos), the dense ETAP kernels K5/K6, the
             untransposed baseline K7/K8 (also at the decode kernels'
             edges, DECODE_EDGES: baseline_edge_checks, with a row alone
             bitwise its rows of a 60-row batch, and its [attrs] lines)
             and both orientations of the
             combine K2, also at the serve phases' own dense shapes and
             split plans (S 544; S 4128 in 3 splits; 65 gathered pages in
             blocks of 64); the bitwise contracts (split(n=1) + combine ==
             single pass for both orientations, dense == paged over the
             same rows, fused V == separate V at the same stride); the
             quantized bodies K3q, K1q (n = 4) and K4q over int8 and fp8
             (e4m3) pools with bf16 q, their bitwise contracts (split(n=1)
             + combine == K3q, linear verify == prefill), quantize_rows on
             the card bitwise the CPU's, and the reference's RMSE gates
             (int8 <= 6.12e-4, fp8 <= 2.22e-3 against an fp64 oracle) with
             fp32 q; K1 + K2, K3 and K4 and, per code type, K1q + K2, K3q
             and K4q at the shapes serve-long gives them (4 or 7 slots, 3
             of them idle; a 65-column table padded to 68, 4 splits of 17;
             256-token prefill chunks at start 0 and 3840), with the auto
             split plan and the bitwise contracts there; then each kernel's
             time (CUDA events), its plain
             version's time, its bound and one PyTorch library call's time
             where there is one, and ETAP beside the baseline at the same
             shapes; then K10, the selective scan, against its plain
             version (h_last and y bitwise) at the reference test's shapes
             (N 4, 8, 16; ragged D 48, ragged L 100) and at falcon's widths
             (D 8192, N 16: B 2 x L 256 and a ragged L 200, with ops'
             chunk contract) and at the shapes the main path gives it,
             mamba-short's and mamba-long's prefill (B 8 x L 512, B 1 x
             L 8192), with its time and its plain version's there; and
             K5-K8 at a 128-wide GQA head (Dk = Dv = 128) and K2 at Dv 128
             in both orientations, at the Qwen3-8B phases' shapes and split
             plans (the [B, S, K, 128] cache read in place) and at an MQA
             shape (G = 48), with the bitwise contracts there (split(n=1) +
             K2 == single pass; in place == on gqa_to_grouped's copy),
             their times, bounds and SDPA's (enable_gqa); and the
             quantized dense kernels K5q-K8q over int8 and e4m3 code rows
             (K5q / K6q at (128, 128), K7q / K8q at (128, 128) and at the
             latent with fused V) at the quantized serve phases' shapes and
             split plans, in both rescale modes, with fp32 q for GQA and
             bf16 q for DeepSeek (and the other q type once): each against
             its plain version, K2 in both orientations with fp32 output,
             split(n=1) + K2 == single pass bitwise, the RMSE against the
             fp64 oracle on the unquantized rows with the phases' lengths
             (the reference's gate where the reference's own route meets
             it, else within 1% of that route), the reference's RMSE test
             at its geometry for K7q and K8q + K2, and their times; and
             K9, the causal prefill, at (D, Dv) = (192, 128), (128, 128)
             and (64, 64) against its plain version in both rescale modes,
             at the dense serve phases' prefill shapes (DeepSeek B 4 x
             4096 and B 8 x 512 at H 128, Qwen3 G 4, LLaVA G 7, StableLM G
             1), a SmolLM (G 3) and an MQA (G 48) shape, a ragged S 200
             and an S of 576 (a multiple of 64, not of the kernel's 128-row
             tiles) at each width, fewer work items than SMs (B 1 x 256, H
             4) and a long GQA case (B 2 x 4096, G 4: many items a CTA of
             the persistent grid), rows [:T] bitwise a call on the first T
             rows, no local memory (spills) in any width's [attrs], with
             each width's time, achieved TFLOP/s, its plain version's
             time, its bound and SDPA's (is_causal, enable_gqa); and the
             paged bodies over separate K and V pools
             (phase_sepv_kernels: K3, K1 + K2 and K4, and K3q, K1q, K4q
             over int8 / fp8 pools each with its own
             (scale, zp) pool, at (576, 512) and (128, 128)): the latent
             with V = pool[..., :512] as its own pool at serve-long's and
             serve-short's decode shapes and 256-token chunks, bitwise the
             fused kernels there; Granite-20B's MQA pools (48 heads over
             one kv head of 128, a shuffled 32-column table, ragged
             lengths) with the auto plan and one split and K4 at Cq 128,
             paged == dense bitwise at block-aligned lengths (K3 == K5, K1
             == K6), the code pools' RMSE against the fp64 oracle; each
             instance's registers, time, plain time, bound and SDPA time,
             the fused kernels beside at the latent, the paper's geometry
             (B 16, H 16, context 65,536) fused against separate V
             through K1 + K2, and this slice's path: core.etap's paged
             entries with a v_pool in both modes over fp, int8 and fp8
             pools at both widths, their launches counted; and K4 over
             bf16 pools (etap_prefill.cu: fused and separate-V latent,
             Granite's (128, 128)) at the edges of its tiling
             (K4_EDGES: 144 columns, 4 query rows a unit, start 0 and a
             horizon mid-page, an idle row on the null block, each with
             fewer units than SMs, so units of 32 columns; 132 units of
             64; a horizon past a 3-page table) in both modes, a tree
             verify, linear verify == prefill and separate V == fused
             bitwise, an [attrs] line per instance and unit width (local
             memory fails the run), and its time at Cq 32 and serve-long's
             Cq 256 (start 3840) with its TFLOP/s, plain time, bound and
             SDPA's; and K4q, the same kernel over int8 / e4m3 pools, at
             K4Q_EDGES (K4's edges) over both code types with bf16 q
             (both unit widths must run) and fp32 q (units of 32), fused,
             separate-V latent and Granite, both modes, linear verify ==
             prefill and separate V == fused bitwise, whether a column's
             bits depend on the unit width (logged), its RMSE with fp32 q
             against the fp64 oracle (the reference's geometry: the gate;
             a 16-row chunk and Granite's chunks: within 1% of the
             reference's route where that route misses the gate), its
             [attrs] lines, and its time at Cq 256 from 3840 beside K4's
             in turns; and the bf16 decode kernels (etap_decode.cuh: K3 /
             K1 paged, fused and over separate pools, K5 / K6 dense at
             every width) at DECODE_EDGES (G 1, 3, 4, 7, 16, 32, 48 and H
             16, 128; length 1, a horizon mid-page, an idle row on the
             null block, splits with no live position, fewer and many
             more units than SMs, a dense S not a multiple of 64) in both
             modes against their plain versions, with split(n=1) + K2 ==
             single pass, separate V == fused, dense == paged and in
             place == gqa_to_grouped's copy bitwise, every unit width
             run, an [attrs] line per instance and unit width (local
             memory fails the run) and [unit width] lines (logged); and
             their quantized twins on the same kernel (K3q / K1q over the
             latent code pool, fused and with V a pool of its own, and
             over Granite's code pools, K5q / K6q over GQA code caches
             at 128 and 64) at DECODE_EDGES over int8 and e4m3 codes with
             bf16 and fp32 q in both modes (quant_decode_edge_checks):
             against their plain versions, the same bitwise contracts,
             fp32 q's RMSE against the fp64 oracle (the reference's gate,
             or 1% of the reference's route where that misses it), every
             unit width run, [attrs] and [unit width] lines; and the
             baseline over codes on K7 / K8's kernel (K7q / K8q,
             flash_decode_wgmma.cu: the latent fused and with V code rows
             of its own, GQA code caches at 128 and 64) at DECODE_EDGES
             over int8 and e4m3 codes with bf16 and fp32 q in both modes
             (baseline_quant_edge_checks): against their plain versions,
             K8q(n=1) + K2 == K7q, own V == fused, in place == the grouped
             copy and a row alone == in the batch bitwise, fp32 q's RMSE
             against the fp64 oracle, an [attrs] line per instance, code
             and q type (local memory fails the run); and K2, the split
             merge (combine.cu: one kernel templated over the
             orientation), at its edges (combine_edge_checks: every n in
             COMBINE_EDGE_N x H in COMBINE_EDGE_H x Dv in
             COMBINE_EDGE_DV over 7 rows, both orientations and rescale
             modes, bf16 and fp32 out, a fully masked split, a row masked
             but one split, subnormal weights) against its plain
             versions, with transposed == [n,H,Dv], a row alone == in
             the batch and n = 1 == acc / l bitwise, and an [attrs] line
             per instance (local memory fails the run); and K4 / K4q at
             the spec serve phases' verify shapes (phase_spec_verify,
             SPEC_VERIFY_CASES: Cq 4 x H 128; B 8 bf16, 15 int8, 7 e4m3
             slots at starts ragged over 480-600, two rows idle on the
             null block; B 4 bf16 and 7 e4m3 slots at starts ragged over
             4096-4160, one and two rows idle): linear and tree
             verify against their plain versions in both modes, linear
             verify == prefill and a row alone == in its batch bitwise,
             over codes fp32 q too and its RMSE against the fp64 oracle,
             and each one's time, device time, plain time, bound and SDPA's
             (sdpa_chunk's horizon mask);
  3. serve   ``run_paged`` on DeepSeek-R1 at full width cut to its 3 dense
             layers (bf16, random weights from a seed), short and long
             context, in both attention modes and over int8 and fp8 pools
             (etap; the fp8 short and int8 long phases with a few requests
             and tokens), and in the standard mode over int8 (short) and
             fp8 (long) pools, cut the same way: short runs one split (K3 /
             K7 / K3q / K7q), long picks n >= 2 (K1 + K2, K8 + K2 [n,H,Dv],
             K1q + K2, K8q + K2 [n,H,Dv]); K4 or K4q runs every prefill;
             then the telemetry and fault-drill twins of three of them:
             serve-short-obs (serve-short with --trace-out, --metrics-out
             and --profile-kernels 1: outputs and every wrapper's launch
             count bitwise serve-short's, the trace parsed with its
             prefill / decode spans and lifecycle instants, the metrics
             file's snapshot equal to the returned one, the kernel report's
             launches 3 a decode step and 3 a prefill chunk, its [serve]
             kernel profile lines printed) and serve-short-fault,
             serve-long-fault (replays through K1 + K2) and
             serve-short-int8-fault (restores re-quantize rows), each at
             --fault-rate 0.02: faults injected, every one a scheduler
             failure and a worker restart, tokens replayed (the serve
             loop asserts the kernels re-derive each delivered token),
             one heartbeat a tick, every request finished with its
             drill-free twin's outputs (FAULT_PHASES); and a chunk
             resumed at 1984 of a 2048-token prompt from its grid point
             (prefill_chunk's n_cached) bitwise the uncached chunk in
             every layer, with the 64-row chunk's gap and layer 0's GEMMs'
             row-count dependence logged (phase_resume_chunk);
             then the spec phases (SPEC_PHASES, --spec-tokens 4):
             serve-short-spec, serve-long-std-spec, and, cut,
             serve-short-int8-spec-head (the head drafter; the seconds its
             table took) and serve-long-fp8-spec, each verifying through K4
             / K4q once a layer a verify step (counted on the
             etap_verify_mla_paged wrappers) with K3, K8 + K2, K3q or K1q +
             K2 for the slots with fewer than 4 tokens left, printing k,
             verify steps, drafts proposed and accepted and the acceptance
             rate, beside its spec-off run (an earlier phase, or one made
             beside it); then the head drafter's table at the full
             vocabulary, built on the card, against an fp64 argmax on
             4096 of its rows, the last (padded) block's among them
             (head_table_check);
  4. serve   ``run_dense`` on the same model: B 8 x 512 (K5), B 4 x 4096
             (K6 + K2), and B 4 x 4096 in the standard mode (K8 + K2
             [n,H,Dv]), each prefill launching K9 once a layer;
  5. decode  one full-width decode step over the paged cache, the same
             step over an int8 pool, and in the standard mode over an fp8
             pool (K7q), the split-KV step of serve-long-int8 (int8, 7
             slots over 65 pages, 4 splits) in both modes (K1q, K8q), and
             over the dense
             cache one in each mode with one split and with two, each
             through the kernels and through the plain versions on the
             same weights and cache: logits agree, greedy tokens agree;
             then one paged step under torch.profiler: its wall time,
             the device's busy and idle share of it, device time by kernel;
             then verify steps (phase_verify_steps: k 4, B 8, ctx <=
             2047) over bf16, int8 and fp8 pools through K4 / K4q and
             through the plain versions (check_step's gate; over bf16 with
             a floor from the kernels' P precision), linear verify_step ==
             prefill_chunk bitwise (logits, every pool: codes and pairs),
             and verify at k 1 against the decode step, both through the
             kernels, per pool and mode, whose largest logit difference
             rules the spec phases' streams: each equals its spec-off
             run's, or parts first where the spec-off decode step (replayed
             alone: replay_logits) has a top-two logit gap below it; then
             dense-long's B 4 x 4096 prefill through K9 and through
             its plain version (check_step's floor-based gate on the last
             position's logits), and one such prefill under torch.profiler
             (wall, busy, K9's share);
 5b. moe     DeepSeek-R1 at full width cut to 5 layers, its 3 dense layers
             and its first 2 MoE layers (256 experts of 3 x 7168 x 2048,
             top-8, a shared expert; the 3-layer model's parameters freed
             first): the MoE unit check (phase_moe_unit: moe_ffn on the
             card at MOE_UNIT_CASES, decode's one group of 8 tokens, a
             prompt chunk's 8 x 32 with a skewed router so that pairs are
             dropped, and the capacity rule at 2 x 512: routes against an
             fp64 top-k, slots bitwise numpy's, the output against the
             reference test's per-token loop, the aux losses);
             serve-short-moe, serve-long-moe and dense-short-moe (the
             3-layer phases' flags at 5 layers: K3 / K1 + K2 / K5, K4 or
             K9); a paged decode step kernel vs plain
             (phase_moe_decode_step: per layer on teacher-forced inputs,
             and the whole step under the routing rule, route_flips: a
             token whose experts differ between the paths must be one
             where the router is undecided), then the step under
             torch.profiler and the MoE share of its device time; then
             DBRX-132B at full width cut to 4 of its 40 layers (GQA, G =
             6, every layer MoE: 16 experts, top-4), dbrx-short (paged,
             B 8 x 512: K5 [128] over the gathered pools);
  6. serve   ``run_dense`` on Falcon-Mamba-7B at full width and all 64
             layers (bf16, random weights from a seed; DBRX's
             parameters freed first): mamba-short (B 8 x 512, 32 tokens)
             and mamba-long (B 1 x 6144, left-padded to 8192: two scan
             chunks; 16 tokens), each prefill launching K10 once a layer;
  7. prefill falcon's prefill at full width through K10 and through the
             plain scan on the same weights, at B 2 x 128 and at
             mamba-short's B 8 x 512 (all 64 layers) and mamba-long's
             B 1 x 6144 (left-padded to 8192; its first 8 layers): the
             last-position logits agree (LOGIT_RTOL, greedy on decided
             rows), and so do 4 decode steps from each cache; then one
             B 8 x 512 prefill under torch.profiler: its wall time, the
             device's busy and idle share of it, and device time in K10,
             in the GEMMs and in the elementwise passes;
  8. serve   Qwen3-8B at full width and all 36 layers (bf16, random
             weights from a seed; Falcon's parameters freed first):
             qwen-short and qwen-short-std (paged, B 8 x 512, 8 requests
             since the sharded train step's phase joined the script, 16
             before; one split: K5 / K7), qwen-long and qwen-long-std (paged, B 1 x 4096:
             K6 / K8 + K2), qwen-dense (B 8 x 512: K5 on the dense cache),
             and over int8 / fp8 pools sized to the fp pool's bytes:
             qwen-short-int8 (15 slots: K5q), qwen-long-fp8 (K6q + K2),
             and, cut to a few requests and tokens, qwen-short-std-fp8
             (K7q) and qwen-long-std-int8 (K8q + K2 [n,H,Dv]); then
             qwen-short-spec (4 requests of 16 tokens, --spec-tokens 4: the
             GQA verify is the reference's masked product, no kernel; K5
             for the other slots) beside its spec-off run, its streams
             ruled by Qwen's verify-vs-decode difference as DeepSeek's are;
  9. decode  full-width Qwen3-8B decode steps through the kernels, the
             plain versions and two perturbed plain paths, the reordered
             plain versions and one-ulp noise (check_step's floor): paged
             over fp, int8 and fp8 pools and dense, each in both modes
             with one split and the auto plan's (K5-K8, K5q-K8q), then one
             paged step under torch.profiler; then the per-layer check on
             teacher-forced inputs: each of the 36 layers fed its
             plain-path input, its
             attention output (before w_o) through the kernels held to the
             plain path's at the per-kernel tolerance, over fp, int8 and
             fp8 pools with one split (K5, K5q) and three (K6 / K6q + K2);
             then qwen-dense's B 8 x 512 prefill through K9 and through its
             plain version (as DeepSeek's), and the per-layer check of the
             prefill: each layer's causal attention through K9 on the
             plain path's q, k, v, held to the plain output at the
             per-kernel tolerance;
 10. widths  the last dense-decode widths, each model at full width, the
             one before freed first: SmolLM-360M (32 layers, G = 3,
             head_dim 64), paged, smol-short / smol-short-std (B 8 x 512,
             one split: K5 / K7 [64]), smol-long / smol-long-std (B 1 x
             4096: K6 / K8 + K2 [64], 22 splits), smol-short-int8 (K5q
             [64]), smol-long-fp8 (K6q + K2) and, cut, smol-short-std-fp8
             (K7q) and smol-long-std-int8 (K8q + K2), then its decode steps
             (as Qwen's, paged) and the per-layer check (fp and int8
             pools, 1 and 3 splits); StableLM-1.6B (24 layers, MHA, G = 1),
             dense, stablelm-dense / -std (B 8 x 512: K5 / K7 [64]), its decode
             steps (B 8 x 2080: one split and the auto plan's two) and the
             per-layer check; MusicGen-large's decoder (48 layers, MHA),
             musicgen-short (paged, B 8 x 512: K6 + K2 [64]);
             RecurrentGemma-9B (38 layers: 26 RG-LRU, 12 local attention,
             16 heads over one kv head, head_dim 256), dense,
             rgemma-short (B 8 x 512, one split: K5 [256]), rgemma-long /
             -std (B 1 x 4096 over the 2048-row ring, every decode step
             writing a wrapped slot: K6 / K8 + K2 [256]), its prefill on
             the kernel and plain paths (bitwise: it runs no kernel), its
             decode steps and per-layer check on the wrapped ring; and
             LLaVA-NeXT-34B at full width cut to 8 of its 60 layers,
             llava-dense (B 4 x 512: K5 [128] at G = 7).  Phase 2 holds
             the twelve new instances (K5-K8 at (64, 64) and (256, 256),
             K5q-K8q at (64, 64) over int8 and fp8) and K2 at Dv 64 and
             256 to their plain versions at these phases' shapes, prints
             each instance's registers and shared memory, and times ETAP
             beside the baseline at G = 1, 3, 7 and 16.

After DeepSeek's 3-layer phases come the two card checks owed under
ROADMAP section C and training:

  C1         the prefix cache on against ``--no-prefix-cache`` on the
             paged layout, bf16 and int8 pools, every prompt starting with
             the same 200 tokens (hits of 192 tokens, off the 256-token
             chunk grid; the ragged prompts end off it too):
             outputs bitwise equal, hits > 0, prefill tokens on + saved ==
             off;
  row bits   C2's repair: layer 0's decode products, the absorptions and
             the unembedding keep a row's bits at every row count up to
             ``layers.ROW_TILE`` (a bare product's are logged);
  C2         the reference's contended trace (three priority classes,
             bursts of 3 arrivals, batch 2) with ``--preemption swap`` and
             with ``recompute``: both preempt, and their outputs, and those
             of the unpreempted run at batch 2, equal bitwise those of the
             reference's calm run at batch 8;
  train-deepseek  DeepSeek-R1 at full width cut to its 3 dense layers,
             trained by ``launch.steps.make_train_step`` (AdamW, bf16
             moments, remat) on ``make_batch``'s B 2 x S 2048 batches for 6
             steps: every loss and grad norm finite, K9 launched on the
             steps (its autograd Function: the forward is the serve path's
             launch); before that, the Function's dQ / dK / dV on layer 0's
             q, k, v of the first batch against autograd through the plain
             route (``models.attention.masked_attention``) within
             ``K9_GRAD_RTOL`` of each gradient's largest value, its output
             bitwise the wrapper's, and the backward timed beside that
             route's and SDPA's; each step's wall time, tok/s and peak
             memory, a profiled step's device-busy share, and the share of
             a step the fp32 unembedding (with the cross-entropy) takes,
             timed alone on the step's shapes;
  train-smollm  SmolLM-360M at full width and depth through
             ``launch.train.run`` (B 8 x S 512): the restart drill of the
             reference's tests/test_runtime.py (cut to 8 steps with a
             checkpoint every 4; again with a failure injected at step 6,
             then ``--restart``), the state restored at step 4 bitwise the state
             saved there, the final losses within rtol 1e-5 (whether they
             are bitwise is logged), K9 launched on the steps.

Then sequence-sharded decode (ROADMAP A10a), ``phase_seq_sharded``:

  reference  DeepSeek-R1 at full width cut to its 3 dense layers (B 4 x
             prompt 8192, 16 greedy steps over S 8208) and Qwen3-8B cut to
             4 of 36 layers (B 2 x 8192, 8 steps over S 8200), seed-0
             weights, in this process with the card to itself:
             ``model.prefill`` (K9), ``decode_step`` on the dense layout
             (K6 + K2); its tokens, logits, prefill cache and written rows
             kept on the host, and the floor (step 0 at the auto plan
             against one split, K5); DeepSeek also a B 4 x 512 prompt and
             4 greedy steps (``greedy_reference``); the card then freed;
  ranks      4 processes (``launch.mesh.spawn``, a wall limit; the group
             through a FileStore, a collective timeout): gloo with every
             rank on cuda:0 on a one-card machine (the ranks share the
             card: the sharded step's wall is no multi-GPU speedup), nccl
             with a card a rank where there are 4; on each of the meshes
             (1, 4) and (2, 2) every rank draws its pieces of the seed-0
             weights (``model.init`` under the mesh; over each data row
             the pieces' digests sum to the reference's), runs K6 on its
             slice against the plain version (an empty slice among them:
             stats (NEG_INF, 0, 0), merge weight 0), then
             ``make_serve_step`` under ``use_mesh`` over ``shard_cache``
             of the reference's cache, teacher-forced: each step's
             gathered logits within check_step's gate of the reference's
             (floor its floor), the layer-0 row the owner writes within
             LAYER0_ROW_RTOL of the reference's (from the rank's column
             pieces of W_dkv, W_k, W_v; whether bitwise is logged); a
             free-running greedy run equal to the reference's or parting
             first where its top-two gap is below the teacher-forced
             difference; K6 launched on every rank; the unsharded branch
             under (2, 2) (the B 4 x 512 prompt prefilled under the mesh:
             K9, K5) within the gate of its reference.  ``[seq-sharded]``
             lines give the launches by rank, the bytes a step
             all-reduces, and the step's wall ms sharded beside
             unsharded.

Last, tensor-parallel serving (ROADMAP A10b.1),
``phase_tensor_parallel``:

  reference  whole seed-0 weights in this process with the card to
             itself: DeepSeek-R1 at full width, 3 dense layers, B 16 x
             prompt 512 and 16 greedy steps (tp-short), and B 16 x 8192
             (prefilled 4 rows at a time) and 16 greedy steps over S
             8208 (tp-long); Qwen3-8B at full width cut to 6 of 36
             layers, B 8 x 512 and 8 steps; each with its floor (step 0 at the auto plan
             against one split); the card then freed;
  ranks      8 processes, gloo with every rank on cuda:0 on a one-card
             machine (nccl with a card a rank where there are 8); on the
             meshes (1, 8) and (2, 4) each rank draws only its pieces of
             the weights as ``param_specs(profile="serve")`` places them
             (``model.init`` under the mesh; the pieces' digests sum to
             the reference's), their bytes counted and allocated;
             tp-short: the prompt through ``make_prefill_step`` under the
             mesh (K9 on the rank's 16 / 32 heads, Qwen's 4 / 8 with G
             4), then ``make_serve_step`` teacher-forced with the
             reference's tokens (K5, or K6 + K2, on the rank's heads):
             the prefill's and each step's gathered logits within
             check_step's gate of the reference's; tp-long (DeepSeek on
             (1, 8)): ``shard_cache`` of the reference's cache (1026 rows
             a rank), q gathered over its heads for K6 on the slice; each
             leg also free-running (the streams equal to the reference's
             are reported, not gated).  ``[tp]`` lines give the launches
             by rank with the q shapes the attention entries received,
             the bytes each collective returned a step a rank, the step's
             wall beside the reference's, and the weight bytes a rank.

Then expert parallelism over `data` in serving (ROADMAP A10b.3),
``phase_expert_parallel``:

  reference  DeepSeek-R1 at full width cut to 4 layers (its 3 dense
             layers and its first MoE layer: 256 experts, top-8, F 2048,
             the shared expert), whole seed-0 weights in this process
             with the card to itself: B 16 x prompt 256 and 16 greedy
             steps (``greedy_reference``, dense layout), the MoE layer's
             routes recorded, its floor as tp-short's; the card then
             freed;
  ranks      8 processes on the (2, 4) mesh (gloo with every rank on
             cuda:0 on a one-card machine): each draws only its pieces
             of the weights as ``param_specs(profile="serve")`` places
             them (``model.init`` under the mesh: 128 of the 256 experts
             with 512 of each one's 2048 F columns, drawn 16 experts at
             a time, and 32 of the 128 heads; the pieces' digests,
             each leaf's summed over the ranks over its replicas, sum to
             the reference's); tp-short's legs on the prompt
             (``make_prefill_step`` under the mesh: the MoE layer's
             experts' slots exchanged by two all-to-alls over `data`;
             then ``make_serve_step`` teacher-forced and free-running:
             the step's group of 16 tokens gathered over `data`, routed
             whole on every rank, its combine reduce-scattered), gated as
             there, the free-running rows equal the reference's or
             parting where its top-two gap is below the teacher-forced
             difference; the MoE layer's routes (the prefill's on the
             rank's groups, each teacher-forced step's) equal the
             reference's but at an undecided router (route_flips' rule); K9
             and K5 launched on every rank with q at 32 heads.
             ``[expert-parallel]`` lines give the launches by rank, the
             bytes each collective moved a rank by op in the prefill and
             a step, the weight bytes a rank (counted, allocated) against
             the whole, and the step's wall beside the whole-weight one.

Then the sharded train step (ROADMAP A10b.2), ``phase_sharded_train``:

  reference  DeepSeek-R1 at full width, 3 dense layers, seed 0, AdamW
             with bf16 moments, in this process with the card to itself:
             one ``make_train_step`` step on B 2 x S 2048 (the
             train-deepseek batch), its gradients (the tree the step
             clips) and updated params saved to a host file; then the
             same step at ``n_micro`` 2, and at ``n_micro`` 1 with each
             row product computed as the 4 `model` ranks compute it
             (``split_rows``: 4 K pieces' products summed in fp32), both
             from the same state: two orders of summation the reference
             allows, the second its sharded step's; the larger of their
             distances from the first step is the floor (per leaf of the
             gradients and of the update p' - p0, and of nll and the grad
             norm); the card then freed;
  ranks      8 processes on the (2, 4) mesh (gloo with every rank on
             cuda:0 on a one-card machine): each builds its pieces of the
             params and AdamW state as ``param_specs(profile="train")``
             and ``opt_state_specs`` place them (``train.build_state``
             under the mesh: no whole tree on the device), runs the same
             step on its row (K9 on its 32 heads, forward and remat; the
             `data` pieces gathered a block at a time), and compares its
             pieces with the reference's: each leaf's gradient and its
             update p' - p0 within max(1%, 2 x its floor) relative L2 over
             the whole leaf, nll and the grad norm within max(0.1%, 2 x
             their floors).
             ``[sharded-train]`` lines give K9's launches by rank and its
             q shapes, the param and state bytes a rank (counted,
             allocated) against the whole, the bytes each collective
             moved by phase (forward, remat, backward), the peak memory
             and the step's wall beside the whole step's (the ranks share
             one card through the host: no multi-GPU speedup).

Each phase's seconds are printed as ``[time]`` lines.

The launch counters are zeroed just before each serve phase and read just
after it; each of K1-K8, both K2 orientations, each quantized body on each
code type and K10 must have launched on a serve path, and K5-K8 and both
K2 orientations at 128 (the ``[128]`` entries) on a Qwen, DBRX or LLaVA
phase,
at 64 and 256 (``[64]``, ``[256]``) on a main-path call of a 64- or
256-wide model (a serve phase or a decode-step check).  Each
quantized dense kernel (K5q-K8q, ``[width,code]`` entries) must launch on a
serve phase, and each of its (width, code type) pairs on a main-path call
(a serve phase or a full-width decode-step check, whose kernel path's
launches are counted as well).  K9 (``flash_prefill[D,Dv]`` entries) must
launch once a full-attention layer of every dense serve phase's prefill,
and never on the paged layout; its widths are credited from the serve
phases, [192,128] on dense-short / -long, [128,128] on qwen-dense and
llava-dense, [64,64] on stablelm-dense.  The separate-V paged kernels
(``<wrapper>[Dk,Dv]`` and ``<wrapper>_quant[Dk,Dv,code]`` entries) are
counted on their own path, the paged attention entries with a v_pool
(phase 2's sepv_entry_path), zeroed just before each (width, code type)
group and read just after; no serve loop reaches them.  A verify launch
of K4 / K4q counts on ``etap_verify_mla_paged`` (``_quant[code]``) and on
K4's own entry; the spec phases must launch it (its entries' times are
phase 2's first case of each pool type).  The line before the last is
the ``kernels`` JSON; the last line is the device JSON.

    python3 chip_smoke.py            # everything (one card)
    python3 chip_smoke.py --quick    # phases 1-2 (K10, K9 too), one iteration
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch import roofline  # noqa: E402

HBM_BYTES_PER_S = roofline.HBM_BW     # H100 SXM HBM3 (the data sheet's)
BF16_FLOP_PER_S = roofline.PEAK_FLOPS  # H100 SXM dense bf16 tensor cores
FP32_FLOP_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
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
# carry into the logits; allow 2% of the largest logit.  The falcon
# prefill check uses it too, though there the two paths agree bitwise (K10
# gives the plain scan's bits).
LOGIT_RTOL = 2e-2

# kernel wrapper -> (the TPU kernel it replaces, its CUDA source)
_CSRC = "src/repro_torch/kernels/csrc/"
KERNELS = {
    "etap_paged_partial": ("src/repro/kernels/etap/etap.py:713",
                           _CSRC + "etap_decode.cu"),
    "combine_splits": ("src/repro/kernels/etap/combine.py:60",
                       _CSRC + "combine.cu"),
    "etap_decode_mla_paged": ("src/repro/kernels/etap/etap.py:237",
                              _CSRC + "etap_decode.cu"),
    "etap_prefill_mla_paged": ("src/repro/kernels/etap/etap.py:430",
                               _CSRC + "etap_prefill.cu"),
    # K4's verify launches (explicit per-row horizons), at the spec serve
    # phases' shape; each is also one of K4's own launches
    "etap_verify_mla_paged": ("src/repro/kernels/etap/etap.py:430",
                              _CSRC + "etap_prefill.cu"),
    "etap_decode_dense": ("src/repro/kernels/etap/etap.py:154",
                          _CSRC + "etap.cu"),
    "etap_partial_dense": ("src/repro/kernels/etap/etap.py:603",
                           _CSRC + "etap.cu"),
    "flash_decode": ("src/repro/kernels/flash_decode/flash_decode.py:83",
                     _CSRC + "flash_decode_wgmma.cu"),
    "flash_decode_partial": (
        "src/repro/kernels/flash_decode/flash_decode.py:168",
        _CSRC + "flash_decode_wgmma.cu"),
    "combine_splits_std": ("src/repro/kernels/etap/combine.py:60",
                           _CSRC + "combine.cu"),
    "selective_scan": ("src/repro/kernels/selective_scan/scan.py:64",
                       _CSRC + "selective_scan.cu"),
}


# quantized bodies, one entry per code type: entry -> (the TPU kernel it
# replaces, its CUDA source, the wrapper, the pool's kv_dtype)
QUANT_KERNELS = {
    f"{wrapper}[{kvd}]": (tpu, _CSRC + src, wrapper, kvd)
    for kvd in ("int8", "fp8")
    for wrapper, tpu, src in (
        ("etap_decode_mla_paged_quant",
         "src/repro/kernels/etap/etap.py:237", "etap_quant.cu"),
        ("etap_paged_partial_quant", "src/repro/kernels/etap/etap.py:713",
         "etap_quant.cu"),
        ("etap_prefill_mla_paged_quant",
         "src/repro/kernels/etap/etap.py:430", "etap_prefill.cu"),
        ("etap_verify_mla_paged_quant",
         "src/repro/kernels/etap/etap.py:430", "etap_prefill.cu"))}
# RMSE gates of the quantized decode against the fp64 oracle on the
# unquantized rows (the reference's tests/test_softmax_state.py:258-280)
QUANT_RMSE = {"int8": 6.12e-4, "fp8": 2.22e-3}
# fp32-q outputs of the quantized bodies against their plain versions: the
# CPU tests' fp32 tolerance (q as hi + lo bf16, p as hi + lo, sums in
# another order)
F32_Q_TOL = 1e-5


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


def finalized_close(state, ref, what: str, transposed: bool = True) -> float:
    """Split stats: compare acc / l per split (NaN where l = 0 on both);
    acc is [B,n,Dv,H] (transposed) or [B,n,H,Dv]."""
    import torch
    _, l, acc = state
    _, rl, racc = ref
    ex = (lambda x: x[:, :, None, :]) if transposed else \
        (lambda x: x[..., None])
    o = acc / ex(l)
    r = racc / ex(rl)
    nan_o, nan_r = torch.isnan(o), torch.isnan(r)
    if not torch.equal(nan_o, nan_r):
        raise AssertionError(f"{what}: empty splits differ")
    d = (o - r).abs()[~nan_r]
    err = float(d.max()) if d.numel() else 0.0
    if not torch.allclose(o[~nan_r], r[~nan_r], rtol=F32_TOL, atol=F32_TOL):
        raise AssertionError(f"{what}: partial stats disagree "
                             f"(max abs err {err:.3e})")
    return err


def bitwise(a, b, what: str) -> None:
    """Raise unless a and b hold the same bits (of any dtype: fp8 codes
    through their bytes)."""
    import torch
    from repro_torch.runtime.paged_cache import raw

    def bits(x):
        return raw(x).contiguous().view(torch.uint8)
    if a.dtype != b.dtype or a.shape != b.shape or \
            not torch.equal(bits(a), bits(b)):
        raise AssertionError(f"{what}: not bitwise equal")


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


def paged_main_path(kvd: str, gen, dev) -> dict:
    """K1 + K2, K3 and K4 (``kvd`` "fp") or K1q + K2, K3q and K4q ("int8",
    "fp8") at H = 128 in both modes, at the shapes serve-long gives them,
    against their plain versions.  Decode: the pool's batch slots (4 in fp,
    7 quantized: three idle slots with all-null table rows and one live
    row, as an idle serve step leaves them) over a 65-column table (4128
    rows), which ops pads to 68 columns: 4 splits of 17, the last with
    three null columns; the auto plan's output is bitwise the n = 4 one,
    and split(n=1) + K2 is bitwise the single pass.  Prefill: 256-token
    chunks at start 0 and 3840, with linear verify == prefill bitwise.
    Returns {wrapper: max abs err}."""
    import torch
    from repro_torch.core.attn_spec import AttnSpec
    from repro_torch.kernels.etap import combine as C
    from repro_torch.kernels.etap import etap as K
    from repro_torch.kernels.etap import ops
    H, nb, Cq = 128, 65, 256
    quant = kvd != "fp"
    sfx, kq = ("_quant", "q") if quant else ("", "")
    errs: dict = {}

    def note(name, err):
        errs[name] = max(errs.get(name, 0.0), err)

    def pool_of(B, lengths):              # (pool, extra args, kv_sz, table)
        if quant:
            codes, sz, table = make_quant_pool(B, nb, lengths, kvd, gen, dev)
            return codes, (sz,), sz, table
        pool, table = make_pool(B, nb, lengths, gen, dev)
        return pool, (), None, table

    lengths = [4128, 4097, 1089, 65] + ([1, 1, 1] if quant else [])
    B = len(lengths)
    pool, extra, sz, table = pool_of(B, lengths)
    table[4:] = 0                         # idle slots read the null block
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = torch.randn(B, H, DK, generator=gen, device=dev).to(torch.bfloat16)
    n, npb, padded = ops.paged_split_geometry(nb, 4)
    tpad = ops._pad_table(table, padded)
    for mode in ("amla", "mul"):
        tag = f"{kvd} B={B} {mode}"
        kw = dict(scale=SCALE, rescale=mode)
        bf16 = dict(out_dtype=torch.bfloat16, rescale=mode)
        spec = AttnSpec(scale=SCALE, rescale=mode)
        st = ops._paged_partial(q, pool, DV, table, lens, n_splits=n,
                                kv_sz=sz, **kw)
        st_ref = getattr(K, f"etap_paged_partial{sfx}_plain")(
            q, pool, *extra, DV, tpad, lens, n_splits=n, **kw)
        note(f"etap_paged_partial{sfx}",
             finalized_close(st, st_ref, f"K1{kq} {tag}"))
        o2 = C.combine_splits(*st, **bf16)
        note("combine_splits", bf16_close(
            o2, C.combine_splits_plain(*st, **bf16), f"K2 {tag}"))
        out = getattr(K, f"etap_decode_mla_paged{sfx}")(
            q, pool, *extra, DV, table, lens, **kw)
        ref = getattr(K, f"etap_decode_mla_paged{sfx}_plain")(
            q, pool, *extra, DV, table, lens, **kw)
        note(f"etap_decode_mla_paged{sfx}",
             bf16_close(out, ref, f"K3{kq} {tag}"))
        bf16_close(o2, ref, f"K1{kq}+K2 vs plain K3{kq} {tag}")
        auto = ops.plan_splits_paged(B, nb, PAGE, H, DV,
                                     num_cores=ops.num_cores(dev)).n_splits
        if ops.paged_split_geometry(nb, auto)[0] != n:
            raise AssertionError(f"{tag}: the auto plan picks {auto} "
                                 f"splits, not the serve path's {n}")
        bitwise(ops.etap_decode_mla_paged_splitkv(
            q, pool, DV, table, lens, spec=spec, kv_sz=sz), o2,
            f"auto plan vs n={n} {tag}")
        st1 = ops._paged_partial(q, pool, DV, table, lens, n_splits=1,
                                 kv_sz=sz, **kw)
        bitwise(C.combine_splits(*st1, **bf16), out,
                f"K1{kq}(n=1)+K2 vs K3{kq} {tag}")
        log(f"[kernels] main path serve-long {tag}: table {nb} -> {padded} "
            f"columns, {n} splits of {npb}: K1{kq} ok, K2 ok, K3{kq} ok; "
            f"bitwise: auto plan == n={n}, K1{kq}(n=1)+K2 == K3{kq}")

    pool, extra, sz, table = pool_of(1, [4128])
    qp = torch.randn(1, Cq, H, DK, generator=gen, device=dev).to(
        torch.bfloat16)
    for s0 in (0, 3840):
        start = torch.tensor([s0], dtype=torch.int32, device=dev)
        linear = start[:, None] + torch.arange(Cq, dtype=torch.int32,
                                               device=dev)[None, :]
        for mode in ("amla", "mul"):
            tag = f"{kvd} Cq={Cq} start={s0} {mode}"
            spec = AttnSpec(scale=SCALE, rescale=mode)
            out = ops.etap_prefill_mla_paged(qp, pool, DV, table, start,
                                             spec=spec, kv_sz=sz)
            ref = getattr(K, f"etap_prefill_mla_paged{sfx}_plain")(
                qp, pool, *extra, DV, table, start, scale=SCALE,
                rescale=mode)
            note(f"etap_prefill_mla_paged{sfx}",
                 bf16_close(out, ref, f"K4{kq} {tag}"))
            bitwise(ops.etap_verify_mla_paged(qp, pool, DV, table, start,
                                              linear, spec=spec, kv_sz=sz),
                    out, f"K4{kq} verify(linear) vs prefill {tag}")
            log(f"[kernels] main path serve-long prefill {tag}: K4{kq} ok, "
                f"linear verify bitwise ok")
    return errs


# ---------------------------------- phase 2: the bf16 decode kernels' edges
# The bf16 decode kernels (etap_decode.cuh, wgmma and TMA): K3 / K1 paged
# (etap_decode.cu: the fused latent, and separate K and V pools at the
# latent and at Granite's 128) and K5 / K6 dense (etap.cu: the latent,
# fused or with V rows of its own, and GQA caches read in place at 128, 64
# and 256), at the edges of their tiling.  Each entry: (what, lengths per
# batch row, table pages / dense S, split counts, idle rows); rows of
# length 1 on an all-null table row are serve's idle slots.
DECODE_EDGES = (
    # length 1, a horizon mid-page, one on a page's last row, an idle row
    # on the null block, two pages and a bit; one split, and three of two
    # pages (splits past a row's length: no live position); few units
    ("edges", [1, 100, 64, 1, 130, 257], 6, (1, 3), (3,)),
    # many more units than SMs: 60 rows x 5 splits (units of 64 at H 128
    # and G 48; their single pass takes units of 64 or 32)
    ("many units", None, 10, (5,), ()),
)
# the columns a row: the latent's heads, the GQA groups' G (with the kv
# heads of a cache row that give each; 32 makes units of 32 columns run)
DECODE_LATENT_H = (16, 128)
DECODE_GQA = ((1, 4), (3, 2), (4, 2), (7, 2), (16, 1), (32, 1), (48, 1))
# dense S: not a multiple of 64 (edges 300 in 5 tiles, many units 600)
DECODE_DENSE_S = {"edges": 300, "many units": 600}


def decode_unit_cap(dk: int, quant: bool, fp32_q: bool) -> int:
    """The widest unit an instance takes (etap_decode.cuh's unit_cap): 64
    columns, 32 where Dk >= 256 and over codes, 16 over codes with fp32 q
    where Dk >= 256."""
    return 16 if quant and fp32_q and dk >= 256 else \
        32 if quant or dk >= 256 else 64


def decode_unit_cols(dk: int, rows: int, C: int, quant: bool = False,
                     fp32_q: bool = False) -> int:
    """The unit width the decode kernels take on this card for ``rows`` =
    B n_splits row splits of C columns at Dk = ``dk`` (etap_decode.cuh's
    decode_unit_cols, asked from the library; over codes, ``quant``, at
    most the instance's decode_unit_cap)."""
    from repro_torch.kernels import build
    cols = build.library().etap_decode_unit_cols(dk, rows, C)
    if cols <= 0:
        raise RuntimeError(f"etap_decode_unit_cols: cudaError {-cols}")
    return min(cols, decode_unit_cap(dk, quant, fp32_q))


def decode_edge_lengths(what, gen, dev, cap=None):
    """DECODE_EDGES' lengths for ``what`` (ragged random ones for the many
    units' 60 rows, up to ``cap`` rows or 10 pages)."""
    import torch
    lens, nb = next((e[1], e[2]) for e in DECODE_EDGES if e[0] == what)
    if lens is None:
        top = cap or nb * PAGE
        lens = [int(x) for x in torch.randint(
            1, top + 1, (60,), generator=gen, device=dev)]
        lens[0] = top
    return lens


def check_decode_pair(single, partial, plain_single, plain_partial, n_list,
                      tag, errs, key, *, mode, fused_out=None,
                      fused_st=None):
    """The single pass against its plain version at the bf16 tolerance;
    the partial under each split count of ``n_list`` after finalizing
    (finalized_close), split(n=1) + K2 == the single pass bitwise, and,
    with ``fused_out`` / ``fused_st``, the outputs bitwise those of the
    kernel they must equal (separate V == fused, dense == paged).  Returns
    the single pass's output and the partials by split count."""
    import torch
    from repro_torch.kernels.etap import combine as C
    out = single()
    errs[key[0]] = max(errs.get(key[0], 0.0),
                       bf16_close(out, plain_single(), f"{tag} single"))
    sts = {}
    for n in sorted(set(n_list) | {1}):
        st = partial(n)
        sts[n] = st
        if n > 1:
            errs[key[1]] = max(errs.get(key[1], 0.0), finalized_close(
                st, plain_partial(n), f"{tag} partial n={n}"))
    bitwise(C.combine_splits(*sts[1], out_dtype=torch.bfloat16,
                             rescale=mode), out,
            f"{tag}: partial(n=1)+K2 vs single pass")
    if fused_out is not None:
        bitwise(out, fused_out, f"{tag}: single pass")
        for n, st in sts.items():
            for a, b in zip(st, fused_st[n], strict=True):
                bitwise(a, b, f"{tag}: partial n={n}")
    return out, sts


def decode_edge_checks(gen, dev) -> dict:
    """Every bf16 decode instance at DECODE_EDGES in both rescale modes
    against its plain version: the paged latent (H 16 and 128), fused, with
    V = pool[..., :512] as its own pool (bitwise the fused kernels) and as
    dense rows (the pool's pages gathered: fused and with V rows of its
    own, bitwise the paged kernels); Granite's separate (128, 128) pools
    and GQA caches [B, S, K, hd] at 128, 64 and 256 with G = 1, 3, 4, 7,
    16, 32 and 48 (dense S not a multiple of 64; in place bitwise the
    kernel on gqa_to_grouped's copy; at 128 the paged pools bitwise the
    dense rows gathered from them).  Each case logs its unit width; every
    instance must run each unit width it is built at (16 and 32 columns,
    and 64 where Dk < 256).  Returns {wrapper: max abs err}."""
    import torch
    from repro_torch.core.etap import gqa_to_grouped
    from repro_torch.kernels.etap import etap as K
    from repro_torch.kernels.etap.schedule import dense_split_plan
    from repro_torch.runtime.paged_cache import gather_blocks
    errs: dict = {}
    widths: dict = {}

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    def table_of(B, nb, lens, idle):
        t = (torch.randperm(B * nb, generator=gen, device=dev) + 1
             ).reshape(B, nb).to(torch.int32)
        for b, n in enumerate(lens):
            t[b, -(-n // PAGE):] = 0
        for b in idle:
            t[b] = 0
        return t

    def ran(insts, dk, rows, n_list, C, tag):
        """The unit widths of the single pass and each split count."""
        got = {n: decode_unit_cols(dk, rows * n, C) for n in (1, *n_list)}
        for inst in insts:
            widths.setdefault(inst, set()).update(got.values())
        return tag + ", units of " + ", ".join(
            f"{c} (n={n})" for n, c in got.items())

    paged_keys = ("etap_decode_mla_paged", "etap_paged_partial")
    sepv_keys = ("etap_decode_paged", "etap_paged_partial_sepv")
    dense_keys = ("etap_decode_dense", "etap_partial_dense")
    for what, _, nb, n_list, idle in DECODE_EDGES:
        # ---- the latent: paged fused, paged separate V, dense (both)
        for H in DECODE_LATENT_H:
            lens = decode_edge_lengths(what, gen, dev)
            B = len(lens)
            pool = rand(1 + B * nb, PAGE, DK)
            vpool = pool[..., :DV].contiguous()
            table = table_of(B, nb, lens, idle)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            q = rand(B, H, DK)
            kd = gather_blocks(pool, table)        # [B, nb 64, DK]
            vd = kd[..., :DV].contiguous()
            plans = {n: dense_split_plan(kd.shape[1], PAGE, n)
                     for n in set(n_list) | {1}}
            for mode in ("amla", "mul"):
                kw = dict(scale=SCALE, rescale=mode)
                tag = ran(("paged latent", "dense latent"), DK, B, n_list, H,
                          f"K3/K1 latent {what} B={B} H={H} {mode}")
                fo, fs = check_decode_pair(
                    lambda: K.etap_decode_mla_paged(q, pool, DV, table,
                                                    lengths, **kw),
                    lambda n: K.etap_paged_partial(q, pool, DV, table,
                                                   lengths, n_splits=n, **kw),
                    lambda: K.etap_decode_mla_paged_plain(
                        q, pool, DV, table, lengths, **kw),
                    lambda n: K.etap_paged_partial_plain(
                        q, pool, DV, table, lengths, n_splits=n, **kw),
                    n_list, tag, errs, paged_keys, mode=mode)
                check_decode_pair(
                    lambda: K.etap_decode_paged(q, pool, vpool, table,
                                                lengths, **kw),
                    lambda n: K.etap_paged_partial_sepv(
                        q, pool, vpool, table, lengths, n_splits=n, **kw),
                    lambda: K.etap_decode_paged_plain(
                        q, pool, vpool, table, lengths, **kw),
                    lambda n: K.etap_paged_partial_sepv_plain(
                        q, pool, vpool, table, lengths, n_splits=n, **kw),
                    n_list, tag + ", separate V", errs, sepv_keys,
                    mode=mode, fused_out=fo, fused_st=fs)
                for v, kind in ((kd[..., :DV], "fused"), (vd, "own V")):
                    check_decode_pair(
                        lambda v=v: K.etap_decode_dense(q, kd, v, lengths,
                                                        **kw),
                        lambda n, v=v: K.etap_partial_dense(
                            q, kd, v, lengths, plan=plans[n], **kw),
                        lambda v=v: K.etap_decode_dense_plain(
                            q, kd, v, lengths, **kw),
                        lambda n, v=v: K.etap_partial_dense_plain(
                            q, kd, v, lengths, plan=plans[n], **kw),
                        n_list, tag + f", dense {kind}", errs, dense_keys,
                        mode=mode, fused_out=fo, fused_st=fs)
            log(f"[decode edges] {tag}: K3, K1 n="
                f"{','.join(map(str, n_list))}, separate V, dense (fused and "
                "own V) ok in both modes; bitwise: n=1 + K2 == single pass, "
                "separate V == fused, dense == paged")
        # ---- the GQA widths: dense caches in place, Granite's paged pools
        for hd in (HD, 64, 256):
            for G, Kv in DECODE_GQA:
                if what == "many units" and G not in (4, 32, 48):
                    continue
                S = DECODE_DENSE_S[what]
                lens_b = decode_edge_lengths(what, gen, dev, cap=S)
                Bo = len(lens_b)
                lengths = torch.tensor(lens_b, dtype=torch.int32,
                                       device=dev).repeat_interleave(Kv)
                BG = Bo * Kv
                k, v = rand(Bo, S, Kv, hd), rand(Bo, S, Kv, hd)
                q = rand(BG, G, hd)
                _, kg, vg, _ = gqa_to_grouped(q.reshape(Bo, -1, hd), k, v)
                plans = {n: dense_split_plan(S, PAGE, n)
                         for n in set(n_list) | {1}}
                for mode in ("amla", "mul"):
                    kw = dict(scale=hd ** -0.5, rescale=mode)
                    insts = (f"dense {hd}",) + (("paged 128",) if hd == HD
                                                 else ())
                    tag = ran(insts, hd, BG, n_list, G,
                              f"K5/K6 [{hd}] {what} B={Bo} K={Kv} G={G} "
                              f"S={S} {mode}")
                    fo, fs = check_decode_pair(
                        lambda: K.etap_decode_dense(q, kg, vg, lengths, **kw),
                        lambda n: K.etap_partial_dense(
                            q, kg, vg, lengths, plan=plans[n], **kw),
                        lambda: K.etap_decode_dense_plain(
                            q, kg, vg, lengths, **kw),
                        lambda n: K.etap_partial_dense_plain(
                            q, kg, vg, lengths, plan=plans[n], **kw),
                        n_list, tag + ", grouped copy", errs,
                        tuple(f"{x}[{hd}]" for x in dense_keys), mode=mode)
                    check_decode_pair(
                        lambda: K.etap_decode_dense(q, k, v, lengths, **kw),
                        lambda n: K.etap_partial_dense(
                            q, k, v, lengths, plan=plans[n], **kw),
                        lambda: K.etap_decode_dense_plain(
                            q, k, v, lengths, **kw),
                        lambda n: K.etap_partial_dense_plain(
                            q, k, v, lengths, plan=plans[n], **kw),
                        n_list, tag + ", in place", errs,
                        tuple(f"{x}[{hd}]" for x in dense_keys), mode=mode,
                        fused_out=fo, fused_st=fs)
                    if hd != HD:
                        continue
                    # Granite's separate pools over the same rows: paged ==
                    # dense, bitwise (the dense rows are the pages gathered)
                    npg = -(-S // PAGE)      # a multiple of every n
                    npg = -(-npg // max(n_list)) * max(n_list)
                    kp = torch.zeros(1 + BG * npg, PAGE, hd, device=dev,
                                     dtype=torch.bfloat16)
                    vp = torch.zeros_like(kp)
                    tab = table_of(BG, npg, lengths.tolist(), ())
                    live = tab > 0
                    kpad = torch.zeros(BG, npg * PAGE, hd, device=dev,
                                       dtype=torch.bfloat16)
                    vpad = torch.zeros_like(kpad)
                    kpad[:, :S], vpad[:, :S] = kg, vg
                    kp[tab[live].long()] = kpad.reshape(BG, npg, PAGE, hd)[
                        live]
                    vp[tab[live].long()] = vpad.reshape(BG, npg, PAGE, hd)[
                        live]
                    kd2, vd2 = gather_blocks(kp, tab), gather_blocks(vp, tab)
                    do, ds = check_decode_pair(
                        lambda: K.etap_decode_dense(q, kd2, vd2, lengths,
                                                    **kw),
                        lambda n: K.etap_partial_dense(
                            q, kd2, vd2, lengths,
                            plan=dense_split_plan(npg * PAGE, PAGE, n), **kw),
                        lambda: K.etap_decode_dense_plain(
                            q, kd2, vd2, lengths, **kw),
                        lambda n: K.etap_partial_dense_plain(
                            q, kd2, vd2, lengths,
                            plan=dense_split_plan(npg * PAGE, PAGE, n), **kw),
                        n_list, tag + ", gathered pages", errs,
                        tuple(f"{x}[{hd}]" for x in dense_keys), mode=mode)
                    check_decode_pair(
                        lambda: K.etap_decode_paged(q, kp, vp, tab, lengths,
                                                    **kw),
                        lambda n: K.etap_paged_partial_sepv(
                            q, kp, vp, tab, lengths, n_splits=n, **kw),
                        lambda: K.etap_decode_paged_plain(
                            q, kp, vp, tab, lengths, **kw),
                        lambda n: K.etap_paged_partial_sepv_plain(
                            q, kp, vp, tab, lengths, n_splits=n, **kw),
                        n_list, tag + ", Granite's paged pools", errs,
                        tuple(f"{x}[128]" for x in sepv_keys), mode=mode,
                        fused_out=do, fused_st=ds)
                log(f"[decode edges] {tag}: K5, K6 n="
                    f"{','.join(map(str, n_list))} ok in both modes; "
                    "bitwise: n=1 + K2 == single pass, in place == "
                    "gqa_to_grouped's copy"
                    + (", Granite's paged pools == dense" if hd == HD
                       else ""))
    for inst, got in widths.items():
        want = {16, 32} if "latent" in inst or "256" in inst else \
            {16, 32, 64}
        log(f"[decode edges] {inst}: units of {sorted(got)} columns ran")
        if got != want:
            raise AssertionError(f"decode edges {inst}: units of "
                                 f"{sorted(got)}; {sorted(want)} must run")
    return errs


# ------------------------ phase 2: the baseline K7 / K8 at the same edges
# K7 / K8 over bf16 rows (flash_decode_wgmma.cu: the heads on wgmma's M, a
# TMA ring, warp-specialised) at DECODE_EDGES: the latent at H 16 and 128,
# fused and with V rows of its own, and GQA caches in place at 128, 64 and
# 256 with DECODE_GQA's G, over dense rows of S 300 / 600
# (DECODE_DENSE_S).  Their errors, by kernels-line key, for the phases
# that report them.
BASELINE_EDGE_ERRS: dict = {}
# the baseline's instances: (what, Dk, Dv, V of its own)
BASELINE_INSTANCES = (
    ("latent, fused", DK, DV, 0),
    ("latent, own V", DK, DV, 1),
    ("(128, 128)", 128, 128, 1),
    ("(64, 64)", 64, 64, 1),
    ("(256, 256)", 256, 256, 1))


def baseline_attrs() -> None:
    """An [attrs] line for each baseline instance over bf16 rows, single
    pass and split partial; fails on local memory (spills)."""
    for what, dk, dv, sepv in BASELINE_INSTANCES:
        got = [attr_values("flash_decode_sepv_attrs", dk, dv, sepv, stats)
               for stats in (0, 1)]
        log(f"[attrs] baseline K7 / K8 {what}: " + "; ".join(
            f"{x} {r} registers, {sm} B shared memory, {loc} B local"
            for x, (r, sm, loc) in zip(("K7", "K8"), got, strict=True)))
        if any(loc for _, _, loc in got):
            raise AssertionError(f"baseline {what}: local memory")


def check_baseline_pair(q, k, v, lengths, S, n_list, tag, errs, key, *,
                        mode, scale, same=None):
    """K7 against its plain version at the bf16 tolerance; K8 under each
    split count of ``n_list`` (splits of whole pages over S rows) after
    finalizing; K8(n=1) + K2 == K7 bitwise; and, with ``same`` = (out,
    partials) of another call over the same rows, the outputs bitwise
    those.  Returns (K7's output, the partials by split count)."""
    import torch
    from repro_torch.kernels.etap import combine as C
    from repro_torch.kernels.etap.schedule import dense_split_plan
    from repro_torch.kernels.flash_decode import flash_decode as FD
    kw = dict(scale=scale, rescale=mode)
    out = FD.flash_decode(q, k, v, lengths, block=PAGE, **kw)
    errs[key[0]] = max(errs.get(key[0], 0.0), bf16_close(
        out, FD.flash_decode_plain(q, k, v, lengths, block=PAGE, **kw),
        f"{tag} K7"))
    sts = {}
    for n in sorted(set(n_list) | {1}):
        plan = dense_split_plan(S, PAGE, n)
        sts[n] = FD.flash_decode_partial(q, k, v, lengths, plan=plan, **kw)
        if n > 1:
            errs[key[1]] = max(errs.get(key[1], 0.0), finalized_close(
                sts[n], FD.flash_decode_partial_plain(q, k, v, lengths,
                                                      plan=plan, **kw),
                f"{tag} K8 n={n}", transposed=False))
    bitwise(C.combine_splits_std(*sts[1], out_dtype=torch.bfloat16,
                                 rescale=mode), out,
            f"{tag}: K8(n=1)+K2 vs K7")
    if same is not None:
        bitwise(out, same[0], f"{tag}: K7")
        for n, st in sts.items():
            for a, b in zip(st, same[1][n], strict=True):
                bitwise(a, b, f"{tag}: K8 n={n}")
    return out, sts


def baseline_alone(q, k, v, lengths, S, n_list, out, sts, rows, tag, *,
                   mode, scale):
    """The batch's first ``rows`` rows of q (its first cache row) run
    alone: K7 and each K8 bitwise their rows of the whole batch's call."""
    from repro_torch.kernels.etap.schedule import dense_split_plan
    from repro_torch.kernels.flash_decode import flash_decode as FD
    kw = dict(scale=scale, rescale=mode)
    one = (q[:rows], k[:1] if k.dim() == 4 else k[:rows],
           v[:1] if v.dim() == 4 else v[:rows], lengths[:rows])
    bitwise(FD.flash_decode(*one, block=PAGE, **kw), out[:rows],
            f"{tag}: K7 alone vs in the batch")
    for n, st in sts.items():
        for a, b in zip(FD.flash_decode_partial(
                *one, plan=dense_split_plan(S, PAGE, n), **kw), st,
                strict=True):
            bitwise(a, b[:rows], f"{tag}: K8 n={n} alone vs in the batch")


def baseline_edge_checks(gen, dev) -> dict:
    """K7 / K8 over bf16 rows at DECODE_EDGES in both rescale modes
    against their plain versions: the latent (H 16 and 128) over dense rows
    of DECODE_DENSE_S (a length of 1, horizons mid-page and on a page's
    last row, splits past a row's length; 60 rows in 5 splits), fused and
    with V rows of its own (bitwise the fused kernel); GQA caches [B, S, K,
    hd] in place at 128, 64 and 256 with DECODE_GQA's G, bitwise the
    kernel on gqa_to_grouped's copy; K8(n=1) + K2 == K7 bitwise
    everywhere; and, in the 60-row batches, the first cache row's rows run
    alone bitwise their rows of the batch.  Returns {kernels-line key: max
    abs err}."""
    import torch
    from repro_torch.core.etap import gqa_to_grouped
    errs: dict = {}

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    keys = ("flash_decode", "flash_decode_partial")
    for what, _, _, n_list, _ in DECODE_EDGES:
        S = DECODE_DENSE_S[what]
        alone = what == "many units"
        for H in DECODE_LATENT_H:
            lens = decode_edge_lengths(what, gen, dev, cap=S)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            k = rand(len(lens), S, DK)
            q = rand(len(lens), H, DK)
            for mode in ("amla", "mul"):
                tag = f"K7/K8 latent {what} B={len(lens)} H={H} S={S} {mode}"
                kw = dict(mode=mode, scale=SCALE)
                fused = check_baseline_pair(q, k, k[..., :DV], lengths, S,
                                            n_list, tag, errs, keys, **kw)
                check_baseline_pair(q, k, k[..., :DV].contiguous(), lengths,
                                    S, n_list, tag + ", own V", errs, keys,
                                    same=fused, **kw)
                if alone:
                    baseline_alone(q, k, k[..., :DV], lengths, S, n_list,
                                   *fused, 1, tag, **kw)
            log(f"[decode edges] {tag}: K7, K8 n="
                f"{','.join(map(str, n_list))}, fused and own V ok in both "
                "modes; bitwise: n=1 + K2 == K7, own V == fused"
                + (", a row alone == in the batch" if alone else ""))
        for hd in (HD, 64, 256):
            gkeys = tuple(f"{x}[{hd}]" for x in keys)
            for G, Kv in DECODE_GQA:
                if alone and G not in (4, 32, 48):
                    continue
                lens_b = decode_edge_lengths(what, gen, dev, cap=S)
                Bo = len(lens_b)
                lengths = torch.tensor(lens_b, dtype=torch.int32,
                                       device=dev).repeat_interleave(Kv)
                k, v = rand(Bo, S, Kv, hd), rand(Bo, S, Kv, hd)
                q = rand(Bo * Kv, G, hd)
                _, kg, vg, _ = gqa_to_grouped(q.reshape(Bo, -1, hd), k, v)
                for mode in ("amla", "mul"):
                    tag = (f"K7/K8 [{hd}] {what} B={Bo} K={Kv} G={G} S={S} "
                           f"{mode}")
                    kw = dict(mode=mode, scale=hd ** -0.5)
                    grouped = check_baseline_pair(
                        q, kg, vg, lengths, S, n_list, tag + ", grouped copy",
                        errs, gkeys, **kw)
                    placed = check_baseline_pair(
                        q, k, v, lengths, S, n_list, tag + ", in place", errs,
                        gkeys, same=grouped, **kw)
                    if alone:
                        baseline_alone(q, k, v, lengths, S, n_list, *placed,
                                       Kv, tag, **kw)
                log(f"[decode edges] {tag}: K7, K8 n="
                    f"{','.join(map(str, n_list))} ok in both modes; "
                    "bitwise: n=1 + K2 == K7, in place == gqa_to_grouped's "
                    "copy" + (", a row alone == in the batch" if alone
                              else ""))
    return errs


# K7q / K8q over int8 / e4m3 code rows (flash_decode_wgmma.cu's kernel over
# codes): (what, Dk, Dv, V of its own); each with bf16 and with fp32 q, one
# instance for both code types (the converters read the code type)
BASELINE_QUANT_INSTANCES = (
    ("latent, fused", DK, DV, 0),
    ("latent, own V", DK, DV, 1),
    ("(128, 128)", 128, 128, 1),
    ("(64, 64)", 64, 64, 1))


def baseline_quant_attrs() -> None:
    """An [attrs] line for each baseline instance over codes, with bf16
    and with fp32 q, over int8 and e4m3 codes, single pass and split
    partial; fails on local memory (spills)."""
    for what, dk, dv, sepv in BASELINE_QUANT_INSTANCES:
        for qf32 in (0, 1):
            for code, kvd in enumerate(("int8", "fp8")):
                got = [attr_values("flash_decode_quant_sepv_attrs", dk, dv,
                                   sepv, stats, code, qf32)
                       for stats in (0, 1)]
                log(f"[attrs] baseline K7q / K8q {what} {kvd}, "
                    f"{'fp32' if qf32 else 'bf16'} q: " + "; ".join(
                        f"{x} {r} registers, {sm} B shared memory, {loc} B "
                        "local" for x, (r, sm, loc) in zip(
                            ("K7q", "K8q"), got, strict=True)))
                if any(loc for _, _, loc in got):
                    raise AssertionError(f"baseline over codes {what} {kvd} "
                                         f"qf32={qf32}: local memory")


def baseline_quant_edge_checks(gen, dev) -> dict:
    """K7q / K8q over int8 and e4m3 code rows at DECODE_EDGES, with bf16
    and with fp32 q, in both rescale modes, against their plain versions
    (f32_close; K8q's splits finalized, f32_finalized_close): the latent
    (H 16 and 128) over dense code rows of DECODE_DENSE_S (a length of 1,
    horizons mid-page and on a page's last row, splits past a row's
    length; 60 rows in 5 splits), fused (V the first 512 code columns with
    K's pairs) and with V code rows of their own (bitwise the fused
    kernel); GQA code caches [B, S, K, hd] and their pairs [B, S, K, 2] in
    place at 128 and 64 with DECODE_GQA's G, bitwise the kernel on the
    grouped copies; K8q(n=1) + K2 == K7q bitwise everywhere; in the 60-row
    batches the first cache row's rows run alone bitwise their rows of the
    batch; with fp32 q, K7q's and K8q + K2's RMSE against the fp64 oracle
    on the unquantized rows (rmse_within).  Returns {kernels-line key: max
    abs err}."""
    import torch
    from repro_torch.kernels import splitkv
    from repro_torch.kernels.etap import combine as C
    from repro_torch.kernels.etap.ref import etap_decode_ref
    from repro_torch.kernels.etap.schedule import dense_split_plan
    from repro_torch.kernels.flash_decode import flash_decode as FD
    from repro_torch.runtime import paged_cache
    errs: dict = {}
    f32, bf16 = torch.float32, torch.bfloat16

    def note(key, err):
        errs[key] = max(errs.get(key, 0.0), err)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def run(a, S, n_list, tag, keys, kw, same=None):
        """K7q and K8q under n_list over a = (q, k, v, k_sz, v_sz,
        lengths) against their plain versions; K8q(n=1) + K2 == K7q
        bitwise; with ``same`` = (out, partials) of another call over the
        same rows, the outputs bitwise those.  Returns (K7q's output, the
        partials by split count)."""
        q, k, v, ks, vs, lengths = a
        qkw = dict(k_sz=ks, v_sz=vs, **kw)
        out = FD.flash_decode_quant(q, k, v, lengths, block=PAGE, **qkw)
        note(keys[0], f32_close(out, FD.flash_decode_quant_plain(
            q, k, v, lengths, block=PAGE, **qkw), f"{tag} K7q"))
        sts = {}
        for n in sorted(set(n_list) | {1}):
            plan = dense_split_plan(S, PAGE, n)
            sts[n] = FD.flash_decode_partial_quant(q, k, v, lengths,
                                                   plan=plan, **qkw)
            if n > 1:
                note(keys[1], f32_finalized_close(
                    sts[n], FD.flash_decode_partial_quant_plain(
                        q, k, v, lengths, plan=plan, **qkw),
                    f"{tag} K8q n={n}", transposed=False))
        bitwise(C.combine_splits_std(*sts[1], out_dtype=f32,
                                     rescale=kw["rescale"]), out,
                f"{tag}: K8q(n=1)+K2 vs K7q")
        if same is not None:
            bitwise(out, same[0], f"{tag}: K7q")
            for n, st in sts.items():
                for x, y in zip(st, same[1][n], strict=True):
                    bitwise(x, y, f"{tag}: K8q n={n}")
        return out, sts

    def alone(a, S, out, sts, rows, tag, kw):
        """The batch's first ``rows`` rows of q (its first cache row) run
        alone: K7q and each K8q bitwise their rows of the batch's call."""
        q, k, v, ks, vs, lengths = a

        def head(x):
            return x[:1] if x.dim() == 4 else x[:rows]
        one = (q[:rows], head(k), head(v), lengths[:rows])
        qkw = dict(k_sz=head(ks), v_sz=head(vs), **kw)
        bitwise(FD.flash_decode_quant(*one, block=PAGE, **qkw), out[:rows],
                f"{tag}: K7q alone vs in the batch")
        for n, st in sts.items():
            for x, y in zip(FD.flash_decode_partial_quant(
                    *one, plan=dense_split_plan(S, PAGE, n), **qkw), st,
                    strict=True):
                bitwise(x, y[:rows], f"{tag}: K8q n={n} alone vs in the "
                        "batch")

    def gate(a, S, out, sts, oracle, kvd, tag, kw):
        """fp32 q: K7q and K8q + K2 at the largest split count within
        rmse_within of the oracle."""
        q, k, v, ks, vs, lengths = a
        qkw = dict(k_sz=ks, v_sz=vs, **kw)
        f = dict(out_dtype=f32, rescale=kw["rescale"])
        rmse_within(out, FD.flash_decode_quant_plain(
            q, k, v, lengths, block=PAGE, **qkw), oracle, kvd, f"{tag} K7q")
        n = max(sts)
        rmse_within(
            C.combine_splits_std(*sts[n], **f),
            C.combine_splits_std_plain(*FD.flash_decode_partial_quant_plain(
                q, k, v, lengths, plan=dense_split_plan(S, PAGE, n), **qkw),
                **f), oracle, kvd, f"{tag} K8q n={n} + K2")

    for what, _, _, n_list, _ in DECODE_EDGES:
        S = DECODE_DENSE_S[what]
        many = what == "many units"
        for H in DECODE_LATENT_H:
            lens = decode_edge_lengths(what, gen, dev, cap=S)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            kf, qf = randn(len(lens), S, DK), randn(len(lens), H, DK)
            oracle = etap_decode_ref(qf.double(), kf.double(),
                                     kf[..., :DV].double(), lengths,
                                     scale=SCALE, dtype=torch.float64)
            for kvd in ("int8", "fp8"):
                kc, ks = paged_cache.quantize_rows(kf, kvd)
                keys = (f"flash_decode_quant[{DK},{kvd}]",
                        f"flash_decode_partial_quant[{DK},{kvd}]")
                for qdt in (bf16, f32):
                    for mode in ("amla", "mul"):
                        tag = (f"K7q/K8q latent {what} B={len(lens)} H={H} "
                               f"S={S} {kvd} q {str(qdt)[6:]} {mode}")
                        kw = dict(scale=SCALE, rescale=mode)
                        a = (qf.to(qdt), kc, kc[..., :DV], ks, ks, lengths)
                        fused = run(a, S, n_list, tag, keys, kw)
                        run((*a[:2], kc[..., :DV].contiguous(), *a[3:]), S,
                            n_list, tag + ", own V", keys, kw, same=fused)
                        if many:
                            alone(a, S, *fused, 1, tag, kw)
                        if qdt == f32:
                            gate(a, S, *fused, oracle, kvd, tag, kw)
                log(f"[decode edges] K7q/K8q latent {what} B={len(lens)} "
                    f"H={H} S={S} {kvd}: K7q, K8q n="
                    f"{','.join(map(str, n_list))}, fused and own V ok with "
                    "bf16 and fp32 q in both modes; bitwise: n=1 + K2 == "
                    "K7q, own V == fused"
                    + (", a row alone == in the batch" if many else "")
                    + "; fp32 q within the RMSE gates")
        for hd in (HD, 64):
            for G, Kv in DECODE_GQA:
                if many and G not in (4, 32, 48):
                    continue
                lens_b = decode_edge_lengths(what, gen, dev, cap=S)
                Bo = len(lens_b)
                lengths = torch.tensor(lens_b, dtype=torch.int32,
                                       device=dev).repeat_interleave(Kv)
                kf, vf = randn(Bo, S, Kv, hd), randn(Bo, S, Kv, hd)
                qf = randn(Bo * Kv, G, hd)
                oracle = etap_decode_ref(
                    qf.double(), splitkv.grouped(kf).double(),
                    splitkv.grouped(vf).double(), lengths, scale=hd ** -0.5,
                    dtype=torch.float64)
                for kvd in ("int8", "fp8"):
                    kc, ks = paged_cache.quantize_rows(kf, kvd)
                    vc, vs = paged_cache.quantize_rows(vf, kvd)
                    grp = [splitkv.grouped(x) for x in (kc, vc, ks, vs)]
                    keys = (f"flash_decode_quant[{hd},{kvd}]",
                            f"flash_decode_partial_quant[{hd},{kvd}]")
                    for qdt in (bf16, f32):
                        q = qf.to(qdt)
                        for mode in ("amla", "mul"):
                            tag = (f"K7q/K8q [{hd}] {what} B={Bo} K={Kv} "
                                   f"G={G} S={S} {kvd} q {str(qdt)[6:]} "
                                   f"{mode}")
                            kw = dict(scale=hd ** -0.5, rescale=mode)
                            grouped = run((q, *grp, lengths), S, n_list,
                                          tag + ", grouped copy", keys, kw)
                            a = (q, kc, vc, ks, vs, lengths)
                            placed = run(a, S, n_list, tag + ", in place",
                                         keys, kw, same=grouped)
                            if many:
                                alone(a, S, *placed, Kv, tag, kw)
                            if qdt == f32:
                                gate(a, S, *placed, oracle, kvd, tag, kw)
                log(f"[decode edges] K7q/K8q [{hd}] {what} B={Bo} K={Kv} "
                    f"G={G} S={S}: K7q, K8q n={','.join(map(str, n_list))} "
                    "ok over int8 and fp8 with bf16 and fp32 q in both "
                    "modes; bitwise: n=1 + K2 == K7q, in place == the "
                    "grouped copy" + (", a row alone == in the batch"
                                      if many else "")
                    + "; fp32 q within the RMSE gates")
    return errs


# the bf16 decode instances: (what, dense, Dk, Dv, V of its own)
DECODE_INSTANCES = (
    ("paged latent, fused", 0, DK, DV, 0),
    ("paged latent, separate V", 0, DK, DV, 1),
    ("paged Granite (128, 128)", 0, 128, 128, 1),
    ("dense latent, fused", 1, DK, DV, 0),
    ("dense latent, own V", 1, DK, DV, 1),
    ("dense (128, 128)", 1, 128, 128, 1),
    ("dense (64, 64)", 1, 64, 64, 1),
    ("dense (256, 256)", 1, 256, 256, 1))


def decode_attrs() -> None:
    """An [attrs] line for each decode instance (bf16 rows, and over codes
    with bf16 and with fp32 q: QUANT_DECODE_INSTANCES) and unit width (16,
    32, 64 columns), single pass and split partial; fails on local memory
    (spills)."""
    for insts, qs in ((DECODE_INSTANCES, (-1,)),
                      (QUANT_DECODE_INSTANCES, (0, 1))):
        for what, dense, dk, dv, sepv in insts:
            for q in qs:
                kind = {-1: "bf16 decode", 0: "quantized decode, bf16 q",
                        1: "quantized decode, fp32 q"}[q]
                cap = decode_unit_cap(dk, q >= 0, q == 1)
                for cols in (c for c in (16, 32, 64) if c <= cap):
                    got = [attr_values("etap_decode_attrs", dense, dk, dv,
                                       sepv, stats, cols, q)
                           for stats in (0, 1)]
                    log(f"[attrs] {kind} {what}, units of {cols}: "
                        + "; ".join(
                            f"{x} {r} registers, {s} B shared memory, "
                            f"{loc} B local" for x, (r, s, loc) in zip(
                                ("single pass", "split"), got, strict=True)))
                    if any(loc for _, _, loc in got):
                        raise AssertionError(f"{kind} {what} units of "
                                             f"{cols}: local memory")


def decode_unit_width_bits(gen, dev) -> None:
    """Whether a column's bits depend on the decode kernels' unit width
    (logged, not gated): K3 at H 128 and K5 [128] at G 48, row 0 of a batch
    of 60 rows (units of 32) against row 0 alone (units of 16)."""
    import torch
    from repro_torch.kernels.etap import etap as K
    lens = [4000] + [int(x) for x in torch.randint(
        1, 4097, (59,), generator=gen, device=dev)]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    pool, table = make_pool(60, 64, lens, gen, dev)
    q = torch.randn(60, 128, DK, generator=gen, device=dev).to(torch.bfloat16)
    kw = dict(scale=SCALE, rescale="mul")
    unit_width_bits(
        "K3 latent H=128", K.etap_decode_mla_paged(q, pool, DV, table,
                                                   lengths, **kw),
        lambda: K.etap_decode_mla_paged(q[:1], pool, DV, table[:1],
                                        lengths[:1], **kw),
        wide=decode_unit_cols(DK, 60, 128), narrow=decode_unit_cols(DK, 1,
                                                                    128))
    k = torch.randn(60, 2048, 1, HD, generator=gen, device=dev).to(
        torch.bfloat16)
    v = torch.randn_like(k)
    q = torch.randn(60, 48, HD, generator=gen, device=dev).to(torch.bfloat16)
    lengths = lengths.clamp(max=2048)
    kw = dict(scale=HD ** -0.5, rescale="mul")
    unit_width_bits(
        "K5 [128] G=48", K.etap_decode_dense(q, k, v, lengths, **kw),
        lambda: K.etap_decode_dense(q[:1], k[:1], v[:1], lengths[:1], **kw),
        wide=decode_unit_cols(HD, 60, 48), narrow=decode_unit_cols(HD, 1, 48))


# the decode instances over int8 / e4m3 codes (etap_decode.cuh, QUANT):
# (what, dense, Dk, Dv, V of its own); each with bf16 q and with fp32 q,
# one instance for both code types (the converters read the code type)
QUANT_DECODE_INSTANCES = (
    ("paged latent, fused", 0, DK, DV, 0),
    ("paged latent, separate V", 0, DK, DV, 1),
    ("paged Granite (128, 128)", 0, 128, 128, 1),
    ("dense (128, 128)", 1, 128, 128, 1),
    ("dense (64, 64)", 1, 64, 64, 1))
# the quantized decode entries' keys in the kernels line, by instance
QUANT_EDGE_ERRS: dict = {}


def quant_close(out, ref, what: str) -> float:
    """A quantized decode output against its plain version: bf16_close
    for a bf16 output (bf16 q, paged), f32_close for an fp32 one."""
    import torch
    return (bf16_close if out.dtype == torch.bfloat16 else f32_close)(
        out, ref, what)


def quant_stats_close(st, ref, what: str, fp32_q: bool) -> float:
    """Split stats of a quantized decode kernel against its plain
    version's: finalized per split at the fp32 tolerance with fp32 q
    (f32_finalized_close), at F32_TOL with bf16 q (finalized_close)."""
    if fp32_q:
        return f32_finalized_close(st, ref, what, transposed=True)
    return finalized_close(st, ref, what)


def rmse_within(out, plain, oracle, kvd: str, what: str) -> float:
    """The RMSE of ``out`` against the fp64 ``oracle`` on the unquantized
    rows: the reference's gate (QUANT_RMSE) where the reference's route
    (the plain version, dequantized rows in fp32) meets it, else within 1%
    of that route's RMSE (a row of one key is one V row's quantization
    error).  Returns the RMSE."""
    def rms(x):
        return float(((x.double() - oracle) ** 2).mean().sqrt())
    r, pr = rms(out), rms(plain)
    gate = QUANT_RMSE[kvd]
    limit = gate if pr <= gate else pr * 1.01
    if not r <= limit:
        raise AssertionError(f"{what}: RMSE {r:.4e} against the fp64 oracle "
                             f"exceeds {limit:.4e} (the reference's route "
                             f"{pr:.4e}, gate {gate:.3e})")
    return r


def quant_decode_edge_checks(gen, dev) -> dict:
    """Every decode instance over codes (QUANT_DECODE_INSTANCES) at
    DECODE_EDGES over int8 and e4m3 codes, with bf16 and with fp32 q, in
    both rescale modes, against its plain version: K3q / K1q over the paged
    latent code pool (H 16 and 128) and over its first 512 columns and
    pairs as a V pool of their own (bitwise the fused kernels), K5q / K6q
    over GQA code caches [B, S, K, hd] and their pairs [B, S, K, 2] at 128
    and 64 with G = 1, 3, 4, 7, 16, 32 and 48 (S not a multiple of 64; in
    place bitwise the kernel on the grouped copies), and at 128 Granite's
    separate code pools over the same rows (bitwise the dense kernels on
    the pages gathered); split(n=1) + K2 == the single pass bitwise; with
    fp32 q each output's RMSE against the fp64 oracle on the unquantized
    rows (rmse_within).  Every instance must run each unit width it is
    built at (16 and 32 columns).  Returns {kernels-line key: max abs
    err}."""
    import torch
    from repro_torch.kernels import splitkv
    from repro_torch.kernels.etap import combine as C
    from repro_torch.kernels.etap import etap as K
    from repro_torch.kernels.etap.ref import etap_decode_ref
    from repro_torch.kernels.etap.schedule import dense_split_plan
    from repro_torch.runtime import paged_cache
    from repro_torch.runtime.paged_cache import gather_blocks, raw
    errs: dict = {}
    widths: dict = {}
    f32, bf16 = torch.float32, torch.bfloat16

    def note(key, err):
        errs[key] = max(errs.get(key, 0.0), err)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def table_of(B, nb, lens, idle):
        t = (torch.randperm(B * nb, generator=gen, device=dev) + 1
             ).reshape(B, nb).to(torch.int32)
        for b, n in enumerate(lens):
            t[b, -(-n // PAGE):] = 0
        for b in idle:
            t[b] = 0
        return t

    def ran(insts, dk, rows, n_list, C_, tag, fp32_q):
        got = {n: decode_unit_cols(dk, rows * n, C_, quant=True,
                                   fp32_q=fp32_q) for n in (1, *n_list)}
        for inst in insts:
            widths.setdefault(inst, set()).update(got.values())
        return tag + ", units of " + ", ".join(
            f"{c} (n={n})" for n, c in got.items())

    def pair(single, partial, plain_single, plain_partial, n_list, tag,
             keys, *, mode, qdt, comb_dtype):
        """The single pass and the partials under n_list against their
        plain versions, split(n=1) + K2 == the single pass bitwise.
        Returns (single pass, {n: partial}, plain single pass)."""
        out, plain = single(), plain_single()
        note(keys[0], quant_close(out, plain, f"{tag} single"))
        sts = {}
        for n in sorted(set(n_list) | {1}):
            sts[n] = partial(n)
            if n > 1:
                note(keys[1], quant_stats_close(
                    sts[n], plain_partial(n), f"{tag} partial n={n}",
                    qdt == f32))
        bitwise(C.combine_splits(*sts[1], out_dtype=comb_dtype,
                                 rescale=mode), out,
                f"{tag}: partial(n=1)+K2 vs single pass")
        return out, sts, plain

    def same(a, b, sa, sb, tag):
        bitwise(a, b, f"{tag}: single pass")
        for n, st in sa.items():
            for x, y in zip(st, sb[n], strict=True):
                bitwise(x, y, f"{tag}: partial n={n}")

    def gate(out, sts, plain, plain_partial, n_list, oracle, kvd, mode,
             tag):
        """fp32 q: the single pass and K1q / K6q + K2 at the largest split
        count within rmse_within of the oracle."""
        f = dict(out_dtype=f32, rescale=mode)
        rmse_within(out, plain, oracle, kvd, f"{tag} single")
        n = max(sts)
        rmse_within(C.combine_splits(*sts[n], **f),
                    C.combine_splits_plain(*plain_partial(n), **f), oracle,
                    kvd, f"{tag} n={n} + K2")

    for what, _, nb, n_list, idle in DECODE_EDGES:
        # ---- the latent: the fused code pool, its V as a pool of its own
        for H in DECODE_LATENT_H:
            lens = decode_edge_lengths(what, gen, dev)
            B = len(lens)
            rows = randn(1 + B * nb, PAGE, DK)
            table = table_of(B, nb, lens, idle)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            qf = randn(B, H, DK)
            kd = gather_blocks(rows, table)
            oracle = etap_decode_ref(qf.double(), kd.double(),
                                     kd[..., :DV].double(), lengths,
                                     scale=SCALE, dtype=torch.float64)
            del kd
            for kvd in ("int8", "fp8"):
                codes, sz = paged_cache.quantize_pool(rows, kvd)
                vc, vs = latent_v(codes, sz)
                keys = (f"etap_decode_mla_paged_quant[{kvd}]",
                        f"etap_paged_partial_quant[{kvd}]")
                skeys = (f"etap_decode_paged_quant[{DK},{DV},{kvd}]",
                         f"etap_paged_partial_sepv_quant[{DK},{DV},{kvd}]")
                for qdt in (bf16, f32):
                    q = qf.to(qdt)
                    for mode in ("amla", "mul"):
                        kw = dict(scale=SCALE, rescale=mode)
                        tag = ran(("paged latent, fused",
                                   "paged latent, separate V"), DK, B, n_list,
                                  H, f"K3q/K1q latent {what} B={B} H={H} "
                                  f"{kvd} q {str(qdt)[6:]} {mode}",
                                  qdt == f32)
                        a = (q, codes, sz, DV, table, lengths)
                        out, sts, plain = pair(
                            lambda: K.etap_decode_mla_paged_quant(*a, **kw),
                            lambda n: K.etap_paged_partial_quant(
                                *a, n_splits=n, **kw),
                            lambda: K.etap_decode_mla_paged_quant_plain(
                                *a, **kw),
                            lambda n: K.etap_paged_partial_quant_plain(
                                *a, n_splits=n, **kw),
                            n_list, tag, keys, mode=mode, qdt=qdt,
                            comb_dtype=qdt)
                        s = (q, codes, sz, vc, vs, table, lengths)
                        so = K.etap_decode_paged_quant(*s, **kw)
                        ss = {n: K.etap_paged_partial_sepv_quant(
                            *s, n_splits=n, **kw) for n in sts}
                        same(so, out, ss, sts, tag + ", separate V vs fused")
                        for key, k in zip(skeys, keys, strict=True):
                            note(key, errs.get(k, 0.0))
                        if qdt == f32:
                            gate(out, sts, plain,
                                 lambda n: K.etap_paged_partial_quant_plain(
                                     *a, n_splits=n, **kw),
                                 n_list, oracle, kvd, mode, tag)
                log(f"[quant decode edges] {tag}: K3q, K1q n="
                    f"{','.join(map(str, n_list))}, separate V ok over "
                    f"{kvd} with bf16 and fp32 q in both modes; bitwise: "
                    "n=1 + K2 == single pass, separate V == fused; fp32 q "
                    "within the RMSE gates")
        # ---- the GQA widths: dense code caches in place, Granite's pools
        for hd in (128, 64):
            for G, Kv in DECODE_GQA:
                if what == "many units" and G not in (4, 32, 48):
                    continue
                S = DECODE_DENSE_S[what]
                lens_b = decode_edge_lengths(what, gen, dev, cap=S)
                Bo = len(lens_b)
                lengths = torch.tensor(lens_b, dtype=torch.int32,
                                       device=dev).repeat_interleave(Kv)
                BG = Bo * Kv
                kf, vf = randn(Bo, S, Kv, hd), randn(Bo, S, Kv, hd)
                qf = randn(BG, G, hd)
                oracle = etap_decode_ref(
                    qf.double(), splitkv.grouped(kf).double(),
                    splitkv.grouped(vf).double(), lengths, scale=hd ** -0.5,
                    dtype=torch.float64)
                plans = {n: dense_split_plan(S, PAGE, n)
                         for n in set(n_list) | {1}}
                npg = -(-S // PAGE)                # a multiple of every n
                npg = -(-npg // max(n_list)) * max(n_list)
                tab = table_of(BG, npg, lengths.tolist(), ())
                live = tab > 0
                for kvd in ("int8", "fp8"):
                    kc, ks = paged_cache.quantize_rows(kf, kvd)
                    vc, vs = paged_cache.quantize_rows(vf, kvd)
                    grp = [splitkv.grouped(x) for x in (kc, vc, ks, vs)]
                    keys = (f"etap_decode_dense_quant[{hd},{kvd}]",
                            f"etap_partial_dense_quant[{hd},{kvd}]")
                    if hd == 128:
                        # Granite's pools over the grouped rows, and the
                        # dense rows gathered back from their pages
                        pools = []
                        for x, fill in zip(grp, (0, 0, 1, 1), strict=True):
                            w = x.shape[-1]
                            pad = torch.zeros(BG, npg * PAGE, w, device=dev,
                                              dtype=raw(x).dtype)
                            if fill:               # pairs past S: (1, 0)
                                pad[..., 0] = 1
                            pad[:, :S] = raw(x)
                            pool = torch.zeros(1 + BG * npg, PAGE, w,
                                               device=dev, dtype=pad.dtype)
                            if fill:
                                pool[..., 0] = 1
                            pool[tab[live].long()] = pad.reshape(
                                BG, npg, PAGE, w)[live]
                            pools.append(pool.view(x.dtype))
                        gath = [gather_blocks(raw(p), tab).view(p.dtype)
                                for p in pools]
                    for qdt in (bf16, f32):
                        q = qf.to(qdt)
                        for mode in ("amla", "mul"):
                            kw = dict(scale=hd ** -0.5, rescale=mode)
                            insts = (f"dense ({hd}, {hd})",) + (
                                ("paged Granite (128, 128)",) if hd == 128
                                else ())
                            tag = ran(insts, hd, BG, n_list, G,
                                      f"K5q/K6q [{hd}] {what} B={Bo} K={Kv} "
                                      f"G={G} S={S} {kvd} q "
                                      f"{str(qdt)[6:]} {mode}", qdt == f32)

                            def dense(kx, vx, kz, vz, plan_of=plans):
                                args = (q, kx, vx, lengths)
                                qkw = dict(k_sz=kz, v_sz=vz, **kw)
                                return (
                                    lambda: K.etap_decode_dense_quant(
                                        *args, **qkw),
                                    lambda n: K.etap_partial_dense_quant(
                                        *args, plan=plan_of[n], **qkw),
                                    lambda: K.etap_decode_dense_quant_plain(
                                        *args, **qkw),
                                    lambda n:
                                        K.etap_partial_dense_quant_plain(
                                            *args, plan=plan_of[n], **qkw))
                            out, sts, plain = pair(
                                *dense(*grp), n_list, tag + ", grouped copy",
                                keys, mode=mode, qdt=qdt, comb_dtype=f32)
                            io, ist, _ = pair(
                                *dense(kc, vc, ks, vs), n_list,
                                tag + ", in place", keys, mode=mode, qdt=qdt,
                                comb_dtype=f32)
                            same(io, out, ist, sts,
                                 tag + ", in place vs grouped copy")
                            if qdt == f32:
                                gate(out, sts, plain, dense(*grp)[3],
                                     n_list, oracle, kvd, mode, tag)
                            if hd != 128:
                                continue
                            gplans = {n: dense_split_plan(npg * PAGE, PAGE, n)
                                      for n in plans}
                            do, ds, _ = pair(
                                *dense(*gath, plan_of=gplans), n_list,
                                tag + ", gathered pages", keys, mode=mode,
                                qdt=qdt, comb_dtype=f32)
                            s = (q, pools[0], pools[2], pools[1], pools[3],
                                 tab, lengths)
                            po, ps, _ = pair(
                                lambda: K.etap_decode_paged_quant(*s, **kw),
                                lambda n: K.etap_paged_partial_sepv_quant(
                                    *s, n_splits=n, **kw),
                                lambda: K.etap_decode_paged_quant_plain(
                                    *s, **kw),
                                lambda n:
                                    K.etap_paged_partial_sepv_quant_plain(
                                        *s, n_splits=n, **kw),
                                n_list, tag + ", Granite's paged pools",
                                (f"etap_decode_paged_quant[128,128,{kvd}]",
                                 f"etap_paged_partial_sepv_quant[128,128,"
                                 f"{kvd}]"), mode=mode, qdt=qdt,
                                comb_dtype=qdt)
                            same(po, do.to(po.dtype), ps, ds,
                                 tag + ", Granite's paged pools vs dense")
                log(f"[quant decode edges] {tag}: K5q, K6q n="
                    f"{','.join(map(str, n_list))} ok over int8 and fp8 with "
                    "bf16 and fp32 q in both modes; bitwise: n=1 + K2 == "
                    "single pass, in place == the grouped copy"
                    + (", Granite's paged pools == dense" if hd == 128
                       else "") + "; fp32 q within the RMSE gates")
    for inst, got in widths.items():
        want = {16, 32}
        log(f"[quant decode edges] {inst}: units of {sorted(got)} columns "
            "ran")
        if got != want:
            raise AssertionError(f"quant decode edges {inst}: units of "
                                 f"{sorted(got)}; {sorted(want)} must run")
    return errs


def quant_decode_unit_width_bits(gen, dev) -> None:
    """Whether a column's bits depend on the unit width over codes (logged,
    not gated): K3q over an int8 latent pool at H 128 with bf16 q (with
    fp32 q the latent takes units of 16 only), and K5q [128] at G 48 over
    e4m3 rows with fp32 q, row 0 of a batch of 60 rows (units of 32)
    against row 0 alone (units of 16)."""
    import torch
    from repro_torch.kernels.etap import etap as K
    from repro_torch.runtime import paged_cache
    lens = [4000] + [int(x) for x in torch.randint(
        1, 4097, (59,), generator=gen, device=dev)]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    codes, sz, table = make_quant_pool(60, 64, lens, "int8", gen, dev)
    q = torch.randn(60, 128, DK, generator=gen, device=dev).to(
        torch.bfloat16)
    kw = dict(scale=SCALE, rescale="mul")
    unit_width_bits(
        "K3q int8 latent H=128 q bfloat16",
        K.etap_decode_mla_paged_quant(q, codes, sz, DV, table, lengths,
                                      **kw),
        lambda: K.etap_decode_mla_paged_quant(
            q[:1], codes, sz, DV, table[:1], lengths[:1], **kw),
        wide=decode_unit_cols(DK, 60, 128, quant=True),
        narrow=decode_unit_cols(DK, 1, 128, quant=True))
    del codes, sz
    kc, ks = paged_cache.quantize_rows(torch.randn(
        60, 2048, 1, 128, generator=gen, device=dev), "fp8")
    vc, vs = paged_cache.quantize_rows(torch.randn(
        60, 2048, 1, 128, generator=gen, device=dev), "fp8")
    q = torch.randn(60, 48, 128, generator=gen, device=dev)
    lengths = lengths.clamp(max=2048)
    kw = dict(scale=128 ** -0.5, rescale="mul")
    unit_width_bits(
        "K5q fp8 [128] G=48 q float32",
        K.etap_decode_dense_quant(q, kc, vc, lengths, k_sz=ks, v_sz=vs, **kw),
        lambda: K.etap_decode_dense_quant(
            q[:1], kc[:1], vc[:1], lengths[:1], k_sz=ks[:1], v_sz=vs[:1],
            **kw),
        wide=decode_unit_cols(128, 60, 48, quant=True, fp32_q=True),
        narrow=decode_unit_cols(128, 1, 48, quant=True, fp32_q=True))


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
    errs = {k: 0.0 for k in KERNELS}

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

    for name, e in paged_main_path("fp", gen, dev).items():
        errs[name] = max(errs[name], e)
    decode_attrs()
    for name, e in decode_edge_checks(gen, dev).items():
        if name in errs:
            errs[name] = max(errs[name], e)
    decode_unit_width_bits(gen, dev)

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

    kd = poolp[tablep.long()].reshape(Bp, nb * PAGE, DK)
    t = cuda_time_ms(lambda: K.etap_prefill_mla_paged(
        qp, poolp, DV, tablep, start, scale=SCALE), iters)
    tp = cuda_time_ms(lambda: K.etap_prefill_mla_paged_plain(
        qp, poolp, DV, tablep, start, scale=SCALE), piters, warmup=1)
    tl = cuda_time_ms(sdpa_chunk(qp, kd, kd[..., :DV], start, SCALE), iters)
    del kd
    timing["etap_prefill_mla_paged"] = (
        t, tp, *bound_ms(pf_bytes, 2 * keys_p * (DK + DV)), tl,
        f"B={Bp} Cq={Cq} H={H} start={int(start[0])}")
    for name, (t, tp, tb, by, tl, shape) in timing.items():
        lib = "null" if tl is None else f"{tl:.4f}"
        rate = (f" ({2 * keys_p * (DK + DV) / t / 1e9:.1f} TFLOP/s)"
                if name == "etap_prefill_mla_paged" else "")
        log(f"[timing] {name} ({shape}): {t:.4f} ms{rate}, plain {tp:.4f} "
            f"ms, bound {tb:.4f} ms ({by}), library {lib} ms")
        report[name] = {"max_abs_err": errs[name], "ms": t, "plain_ms": tp,
                        "bound_ms": tb, "bound_by": by, "library_ms": tl}
    k4_timing(gen, dev, iters, piters)


# ------------------------------------------------- phase 2: quantized
def make_quant_pool(B, nb, lengths, kv_dtype, gen, device):
    """A random latent pool quantized to ``kv_dtype`` (codes [N, 64, 576]
    and (scale, zp) [N, 64, 2]) with a shuffled block table, as
    :func:`make_pool`; every row, the null block's too, holds the codes of
    real fp32 rows (finite by construction)."""
    import torch
    from repro_torch.runtime import paged_cache
    N = 1 + B * nb
    rows = torch.randn(N, PAGE, DK, generator=gen, device=device)
    codes, sz = paged_cache.quantize_pool(rows, kv_dtype)
    _, table = make_pool(B, nb, lengths, gen, device)
    return codes, sz, table


def latent_v(pool, sz=None):
    """The latent pool's V as a pool of its own: its first DV columns
    (codes through their bytes) and, over codes, a copy of its pairs."""
    from repro_torch.runtime.paged_cache import raw
    v = raw(pool)[..., :DV].contiguous().view(pool.dtype)
    return v if sz is None else (v, sz.clone())


def rmse_gate(kv_dtype, mode, dev):
    """The reference's accuracy gate at its own geometry and seed (B 2,
    H 16, S 1024, page 64, numpy default_rng(0), lengths 515 and 1024):
    fp32 q through K3q, through K1q (n = 4) + K2, and through K4q (the
    decode queries as one-row chunks, the gate strictly, and a 16-row
    chunk at the end of each row: k4q_rmse), over the quantized
    pool, against the fp64 oracle on the unquantized rows, and against the
    plain version within F32_Q_TOL; their separate-V twins over the V
    columns as a pool of their own give the same bits.  Returns the
    largest RMSE and K3q's max abs error from its plain version."""
    import numpy as np
    import torch
    from repro_torch.kernels.etap import combine as C
    from repro_torch.kernels.etap import etap as K
    from repro_torch.kernels.etap.ref import etap_decode_ref
    from repro_torch.runtime import paged_cache
    B, H, S, dv, page = 2, 16, 1024, DV, PAGE
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(B, H, DK)).astype(np.float32))
    kv = torch.from_numpy(rng.normal(size=(B, S, DK)).astype(np.float32))
    lengths = [S // 2 + 3, S]
    layout = paged_cache.layout_for(B, S, block_size=page)
    bp = paged_cache.BlockPool(layout, B)
    pool = torch.zeros(layout.num_blocks, page, DK)
    for b, n in enumerate(lengths):          # as the reference's dense_to_paged
        bp.admit(n, n)
        ids = bp.block_ids(b)
        rows = torch.zeros(len(ids) * page, DK)
        rows[:n] = kv[b, :n]
        pool[torch.as_tensor(ids)] = rows.reshape(len(ids), page, DK)
    table, lens = bp.device_views(dev)
    lens_cpu = torch.tensor(lengths, dtype=torch.int32)
    ref = etap_decode_ref(q.double(), kv.double(), kv[..., :dv].double(),
                          lens_cpu, scale=DK ** -0.5, dtype=torch.float64)
    codes, sz = paged_cache.quantize_pool(pool.to(dev), kv_dtype)
    qd = q.to(dev)
    out1 = K.etap_decode_mla_paged_quant(qd, codes, sz, dv, table, lens,
                                         scale=DK ** -0.5, rescale=mode)
    n = 4
    st = K.etap_paged_partial_quant(qd, codes, sz, dv, table, lens,
                                    scale=DK ** -0.5, n_splits=n,
                                    rescale=mode)
    out4 = C.combine_splits(*st, out_dtype=torch.float32, rescale=mode)
    plain = K.etap_decode_mla_paged_quant_plain(qd, codes, sz, dv, table,
                                                lens, scale=DK ** -0.5,
                                                rescale=mode)
    # the separate-V twins over V = the codes' first dv columns with a
    # copy of K's pairs: the fused kernels' bits, so the same RMSE
    vc, vs = latent_v(codes, sz)
    bitwise(K.etap_decode_paged_quant(qd, codes, sz, vc, vs, table, lens,
                                      scale=DK ** -0.5, rescale=mode), out1,
            f"K3q separate V vs fused {kv_dtype} {mode} fp32 q")
    bitwise(C.combine_splits(*K.etap_paged_partial_sepv_quant(
        qd, codes, sz, vc, vs, table, lens, scale=DK ** -0.5, n_splits=n,
        rescale=mode), out_dtype=torch.float32, rescale=mode), out4,
        f"K1q(n=4)+K2 separate V vs fused {kv_dtype} {mode} fp32 q")
    for what, out in (("K3q", out1), ("K1q+K2", out4)):
        err = float((out - plain).abs().max())
        if not err <= F32_Q_TOL:
            raise AssertionError(f"{what} {kv_dtype} {mode} fp32 q: "
                                 f"{err:.3e} from its plain version")
    # K4q: the decode queries as one-row chunks (the gate, strictly), and
    # a chunk of 16 rows at the end of each row
    rows = pool.to(dev)
    worst = 0.0
    for Cq in (1, 16):
        qc = qd[:, None] if Cq == 1 else torch.from_numpy(rng.normal(
            size=(B, Cq, H, DK)).astype(np.float32)).to(dev)
        start = torch.tensor([n - Cq for n in lengths], dtype=torch.int32,
                             device=dev)
        worst = max(worst, k4q_rmse(
            qc, (codes, sz, vc, vs), table, start, (rows, rows[..., :dv]),
            kv_dtype, f"reference geometry Cq={Cq} {mode}", rescale=mode,
            fused=(codes, sz), strict=Cq == 1))
    for what, out in (("K3q", out1), ("K1q+K2", out4)):
        if out.dtype != torch.float32:
            raise AssertionError(f"{what} fp32 q gave {out.dtype}")
        r = float(((out.cpu().double() - ref) ** 2).mean().sqrt())
        if not r <= QUANT_RMSE[kv_dtype]:
            raise AssertionError(f"{what} {kv_dtype} {mode}: RMSE {r:.4e} "
                                 f"against the fp64 oracle exceeds "
                                 f"{QUANT_RMSE[kv_dtype]:.3e}")
        worst = max(worst, r)
    return worst, float((out1 - plain).abs().max())


def phase_quant_kernels(quick: bool, report: dict) -> None:
    """K3q, K1q (n = 4), K2 over K1q's stats and K4q (Cq 32, with and
    without a tree qpos) against their plain versions on int8 and fp8
    pools, bf16 q, H = 128 and 16, ragged contexts up to 4096, both
    rescale modes; the bitwise contracts; quantize_rows on the card against
    the CPU; the RMSE gate with fp32 q; then the timings."""
    import torch
    from repro_torch.kernels.etap import combine as C
    from repro_torch.kernels.etap import etap as K
    from repro_torch.kernels.etap import ops
    from repro_torch.runtime import paged_cache

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    ctx = 4096
    nb = ctx // PAGE
    errs = {k: 0.0 for k in QUANT_KERNELS}
    k2_err = 0.0

    # quantize_rows on the card: bitwise the CPU's codes and pairs
    rows = torch.randn(4096, DK, generator=gen, device=dev) * torch.rand(
        4096, 1, generator=gen, device=dev) * 50
    rows[0] = 0.0                                  # degenerate rows
    rows[1] = 3.5
    for kvd in ("int8", "fp8"):
        cg, sg = paged_cache.quantize_rows(rows, kvd)
        cc, sc = paged_cache.quantize_rows(rows.cpu(), kvd)
        if not (torch.equal(paged_cache.raw(cg).cpu(), paged_cache.raw(cc))
                and torch.equal(sg.cpu().view(torch.int32),
                                sc.view(torch.int32))):
            raise AssertionError(f"quantize_rows {kvd}: the card's codes or "
                                 "pairs differ from the CPU's")
    log("[quant] quantize_rows on the card == on the CPU, bitwise, int8 "
        "and fp8 (4096 rows of 576)")
    k4q_widen_check(dev)

    for kvd in ("int8", "fp8"):
        name = {w: f"{w}[{kvd}]" for w in (
            "etap_decode_mla_paged_quant", "etap_paged_partial_quant",
            "etap_prefill_mla_paged_quant")}
        for H in (128, 16):
            B = 8
            lengths = torch.tensor([ctx, 1, 4033, 64, 65, 2500, 3999, 1234],
                                   dtype=torch.int32, device=dev)
            codes, sz, table = make_quant_pool(B, nb, lengths.tolist(), kvd,
                                               gen, dev)
            q = torch.randn(B, H, DK, generator=gen, device=dev).to(
                torch.bfloat16)
            for mode in ("amla", "mul"):
                tag = f"{kvd} H={H} {mode}"
                kw = dict(scale=SCALE, rescale=mode)
                out = K.etap_decode_mla_paged_quant(q, codes, sz, DV, table,
                                                    lengths, **kw)
                ref = K.etap_decode_mla_paged_quant_plain(
                    q, codes, sz, DV, table, lengths, **kw)
                key = name["etap_decode_mla_paged_quant"]
                errs[key] = max(errs[key], bf16_close(out, ref, f"K3q {tag}"))
                st = K.etap_paged_partial_quant(q, codes, sz, DV, table,
                                                lengths, n_splits=4, **kw)
                st_ref = K.etap_paged_partial_quant_plain(
                    q, codes, sz, DV, table, lengths, n_splits=4, **kw)
                key = name["etap_paged_partial_quant"]
                errs[key] = max(errs[key], finalized_close(
                    st, st_ref, f"K1q {tag}"))
                bf16 = dict(out_dtype=torch.bfloat16, rescale=mode)
                o2 = C.combine_splits(*st, **bf16)
                k2_err = max(k2_err, bf16_close(
                    o2, C.combine_splits_plain(*st, **bf16),
                    f"K2 over K1q {tag}"))
                bf16_close(o2, ref, f"K1q+K2 vs plain K3q {tag}")
                st1 = K.etap_paged_partial_quant(q, codes, sz, DV, table,
                                                 lengths, n_splits=1, **kw)
                bitwise(C.combine_splits(*st1, **bf16), out,
                        f"K1q(n=1)+K2 vs K3q {tag}")
                log(f"[quant] decode {tag}: K3q ok, K1q ok, K2 ok, "
                    f"n=1 bitwise ok")

            Cq, Bp = 32, 2
            start = torch.tensor([ctx - Cq, 1000], dtype=torch.int32,
                                 device=dev)
            codesp, szp, tablep = make_quant_pool(Bp, nb, (start + Cq).tolist(),
                                                  kvd, gen, dev)
            qp = torch.randn(Bp, Cq, H, DK, generator=gen, device=dev).to(
                torch.bfloat16)
            depth = torch.tensor([0] + [1 + (c - 1) // 3 for c in range(1, Cq)],
                                 dtype=torch.int32, device=dev)
            tree = start[:, None] + depth[None, :]
            linear = start[:, None] + torch.arange(Cq, dtype=torch.int32,
                                                   device=dev)[None, :]
            for mode in ("amla", "mul"):
                tag = f"{kvd} H={H} Cq={Cq} {mode}"
                kw = dict(scale=SCALE, rescale=mode)
                out = K.etap_prefill_mla_paged_quant(qp, codesp, szp, DV,
                                                     tablep, start, **kw)
                ref = K.etap_prefill_mla_paged_quant_plain(
                    qp, codesp, szp, DV, tablep, start, **kw)
                e = bf16_close(out, ref, f"K4q prefill {tag}")
                outv = K.etap_verify_mla_paged_quant(qp, codesp, szp, DV,
                                                     tablep, start, tree, **kw)
                refv = K.etap_prefill_mla_paged_quant_plain(
                    qp, codesp, szp, DV, tablep, start, qpos=tree, **kw)
                e = max(e, bf16_close(outv, refv, f"K4q verify(tree) {tag}"))
                key = name["etap_prefill_mla_paged_quant"]
                errs[key] = max(errs[key], e)
                bitwise(K.etap_verify_mla_paged_quant(
                    qp, codesp, szp, DV, tablep, start, linear, **kw), out,
                    f"K4q verify(linear) vs prefill {tag}")
                log(f"[quant] prefill {tag}: K4q ok, tree verify ok, "
                    f"linear verify bitwise ok")

        for mode in ("amla", "mul"):
            r, e = rmse_gate(kvd, mode, dev)
            log(f"[quant] RMSE gate {kvd} {mode} (fp32 q, reference "
                f"geometry; K3q, K1q+K2, K4q): {r:.4e} <= "
                f"{QUANT_RMSE[kvd]:.3e} or its limit; K3q within "
                f"{e:.3e} of its plain version")

        for wrapper, e in paged_main_path(kvd, gen, dev).items():
            if wrapper == "combine_splits":
                k2_err = max(k2_err, e)
            else:
                errs[f"{wrapper}[{kvd}]"] = max(errs[f"{wrapper}[{kvd}]"], e)
    report["combine_splits"]["max_abs_err"] = max(
        report["combine_splits"]["max_abs_err"], k2_err)
    # every decode instance over codes at the edges of its tiling (their
    # errors join the separate-V and dense phases' entries too)
    QUANT_EDGE_ERRS.update(quant_decode_edge_checks(gen, dev))
    # and the baseline over codes (K7q / K8q: the kernels line's
    # flash_decode[_partial]_quant entries)
    baseline_quant_attrs()
    QUANT_EDGE_ERRS.update(baseline_quant_edge_checks(gen, dev))
    for key in errs:
        errs[key] = max(errs[key], QUANT_EDGE_ERRS.get(key, 0.0))
    quant_decode_unit_width_bits(gen, dev)

    # ---- timing at the main path's widths: H = 128, ~4K ragged context
    iters, piters = (1, 1) if quick else (20, 3)
    H, B = 128, 8
    lengths = torch.tensor([4096, 3900, 4033, 3500, 4000, 2500, 3999, 3210],
                           dtype=torch.int32, device=dev)
    keys = int(lengths.sum())
    row_b = DK + 8                                 # codes + (scale, zp)
    q_bytes, out_b = B * H * DK * 2, B * H * DV * 2
    flops = 2 * keys * H * (DK + DV)
    n = ops.paged_split_geometry(nb, 4)[0]
    stats_b = B * n * H * (DV + 2) * 4
    Cq = 32
    startp = torch.tensor([4096 - Cq], dtype=torch.int32, device=dev)
    keys_p = sum(int(startp[0]) + c + 1 for c in range(Cq)) * H
    pf_bytes = Cq * H * DK * 2 + 4096 * row_b + Cq * H * DV * 2
    for kvd in ("int8", "fp8"):
        codes, sz, table = make_quant_pool(B, nb, lengths.tolist(), kvd, gen,
                                           dev)
        q = torch.randn(B, H, DK, generator=gen, device=dev).to(
            torch.bfloat16)
        codesp, szp, tablep = make_quant_pool(1, nb, [4096], kvd, gen, dev)
        qp = torch.randn(1, Cq, H, DK, generator=gen, device=dev).to(
            torch.bfloat16)
        dec = (q, codes, sz, DV, table, lengths)
        pre = (qp, codesp, szp, DV, tablep, startp)
        cases = {
            "etap_decode_mla_paged_quant": (
                lambda f: f(*dec, scale=SCALE),
                bound_ms(q_bytes + keys * row_b + out_b, flops),
                f"B={B} H={H} ctx<=4096 ragged"),
            "etap_paged_partial_quant": (
                lambda f: f(*dec, scale=SCALE, n_splits=n),
                bound_ms(q_bytes + keys * row_b + stats_b, flops),
                f"B={B} H={H} n_splits={n}"),
            "etap_prefill_mla_paged_quant": (
                lambda f: f(*pre, scale=SCALE),
                bound_ms(pf_bytes, 2 * keys_p * (DK + DV)),
                f"B=1 Cq={Cq} H={H} start={int(startp[0])}"),
        }
        for wrapper, (call, (tb, by), shape) in cases.items():
            fn, plain = getattr(K, wrapper), getattr(K, wrapper + "_plain")
            t = cuda_time_ms(lambda: call(fn), iters)
            tp = cuda_time_ms(lambda: call(plain), piters, warmup=1)
            key = f"{wrapper}[{kvd}]"
            log(f"[timing] {key} ({shape}): {t:.4f} ms, plain {tp:.4f} ms, "
                f"bound {tb:.4f} ms ({by}), library null ms")
            report[key] = {"max_abs_err": errs[key], "ms": t, "plain_ms": tp,
                           "bound_ms": tb, "bound_by": by,
                           "library_ms": None}
    k4q_timing(gen, dev, iters, piters)


def k4q_timing(gen, dev, iters: int, piters: int) -> None:
    """K4q at serve-long's chunk (B 1, Cq 256 from start 3840, H 128, the
    latent's 64 pages, bf16 q), over int8 and e4m3 pools, each beside its
    achieved TFLOP/s, its plain version's time, its operations bound, and
    K4 over a bf16 pool at the same shape timed in turns with it (Cq 32's
    line is phase_quant_kernels')."""
    import torch
    from repro_torch.kernels.etap import etap as K
    nb = 4096 // PAGE
    Cq, s0 = 256, 3840
    start = torch.tensor([s0], dtype=torch.int32, device=dev)
    qp = torch.randn(1, Cq, 128, DK, generator=gen, device=dev).to(
        torch.bfloat16)
    flops = 2 * sum(s0 + c + 1 for c in range(Cq)) * 128 * (DK + DV)
    pool, table = make_pool(1, nb, [nb * PAGE], gen, dev)

    def k4():
        return K.etap_prefill_mla_paged(qp, pool, DV, table, start,
                                        scale=SCALE)
    for kvd in ("int8", "fp8"):
        codes, sz, ctable = make_quant_pool(1, nb, [nb * PAGE], kvd, gen,
                                            dev)
        args = (qp, codes, sz, DV, ctable, start)

        def k4q(args=args):
            return K.etap_prefill_mla_paged_quant(*args, scale=SCALE)
        nbytes = qp.numel() * 2 + (s0 + Cq) * (DK + 8) + Cq * 128 * DV * 2
        tb, by = bound_ms(nbytes, flops)
        ts = [cuda_time_ms(f, iters) for f in (k4q, k4, k4, k4q)]
        t, t4 = (ts[0] + ts[3]) / 2, (ts[1] + ts[2]) / 2
        tp = cuda_time_ms(lambda args=args: K.etap_prefill_mla_paged_quant_plain(
            *args, scale=SCALE), piters, warmup=1)
        log(f"[timing] K4q {kvd} B=1 Cq={Cq} H=128 start={s0}: {t:.4f} ms "
            f"({flops / t / 1e9:.1f} TFLOP/s), plain {tp:.4f} ms, bound "
            f"{tb:.4f} ms ({by}); K4 over bf16 in turns {t4:.4f} ms: "
            f"{t / t4:.2f}x")


def dense_as_paged(k, gen):
    """The rows of a dense latent cache [B, S, DK] (S a multiple of the
    page) as a pool [1 + B*nb, PAGE, DK] with a shuffled block table."""
    import torch
    B, S, _ = k.shape
    nb = S // PAGE
    perm = torch.randperm(B * nb, generator=gen, device=k.device)
    pool = torch.zeros(1 + B * nb, PAGE, DK, dtype=k.dtype, device=k.device)
    pool[1 + perm] = k.reshape(B * nb, PAGE, DK)
    return pool, (1 + perm).reshape(B, nb).to(torch.int32)


def sdpa_dense(q, k, lengths):
    """Yardstick for a decode over a dense latent cache: one SDPA call with
    V = the first DV columns and a length mask."""
    import torch
    S = k.shape[1]
    mask = (torch.arange(S, device=k.device)[None, :]
            < lengths[:, None])[:, None, None, :]
    qd, kk = q[:, :, None, :], k[:, None]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qd, kk, kk[..., :DV], attn_mask=mask, scale=SCALE, enable_gqa=True)


def check_dense(q, k, v, lengths, *, block, plan, mode, tag, errs,
                scale=SCALE):
    """K5 and K7 (single pass, ``block``) and, when ``plan`` has more than
    one split, K6 / K8 under it and K2 in both orientations, each against
    its plain version on the same inputs; then split(n=1) + K2 == single
    pass, bitwise, for both orientations.  Returns the K5 output."""
    import torch
    from repro_torch.kernels.etap import combine as C
    from repro_torch.kernels.etap import etap as K
    from repro_torch.kernels.etap.schedule import dense_split_plan
    from repro_torch.kernels.flash_decode import flash_decode as FD

    def note(name, err):
        errs[name] = max(errs.get(name, 0.0), err)

    kw = dict(scale=scale, rescale=mode)
    bf16 = dict(out_dtype=torch.bfloat16, rescale=mode)
    o5 = K.etap_decode_dense(q, k, v, lengths, block=block, **kw)
    r5 = K.etap_decode_dense_plain(q, k, v, lengths, block=block, **kw)
    note("etap_decode_dense", bf16_close(o5, r5, f"K5 {tag}"))
    o7 = FD.flash_decode(q, k, v, lengths, block=block, **kw)
    r7 = FD.flash_decode_plain(q, k, v, lengths, block=block, **kw)
    note("flash_decode", bf16_close(o7, r7, f"K7 {tag}"))
    if plan.n_splits > 1:
        st6 = K.etap_partial_dense(q, k, v, lengths, plan=plan, **kw)
        rs6 = K.etap_partial_dense_plain(q, k, v, lengths, plan=plan, **kw)
        note("etap_partial_dense", finalized_close(st6, rs6, f"K6 {tag}"))
        o2 = C.combine_splits(*st6, **bf16)
        note("combine_splits", bf16_close(
            o2, C.combine_splits_plain(*st6, **bf16), f"K2 {tag}"))
        bf16_close(o2, r5, f"K6+K2 vs plain K5 {tag}")
        st8 = FD.flash_decode_partial(q, k, v, lengths, plan=plan, **kw)
        rs8 = FD.flash_decode_partial_plain(q, k, v, lengths, plan=plan,
                                            **kw)
        note("flash_decode_partial", finalized_close(
            st8, rs8, f"K8 {tag}", transposed=False))
        o2 = C.combine_splits_std(*st8, **bf16)
        note("combine_splits_std", bf16_close(
            o2, C.combine_splits_std_plain(*st8, **bf16),
            f"K2 [n,H,Dv] {tag}"))
        bf16_close(o2, r7, f"K8+K2 vs plain K7 {tag}")
    one = dense_split_plan(k.shape[1], block, 1)
    bitwise(C.combine_splits(*K.etap_partial_dense(
        q, k, v, lengths, plan=one, **kw), **bf16), o5,
        f"K6(n=1)+K2 vs K5 {tag}")
    bitwise(C.combine_splits_std(*FD.flash_decode_partial(
        q, k, v, lengths, plan=one, **kw), **bf16), o7,
        f"K8(n=1)+K2 vs K7 {tag}")
    return o5


# K2's instances (combine.cu: one kernel templated over the orientation):
# ([n, H, Dv] orientation, floats a thread (8: two vectors of 4), splits
# loaded at once, fp32 out)
COMBINE_INSTANCES = tuple((rows, vec, nb, f32) for rows in (0, 1)
                          for vec, nb in ((1, 4), (1, 8), (1, 16), (1, 24),
                                          (1, 32), (4, 8), (8, 4))
                          for f32 in (0, 1))
# K2's edges: every (n, H, Dv), B 7 rows, both orientations and modes, bf16
# and fp32 out (n 5 and 16: the batches of 8 and 16 splits)
COMBINE_EDGE_N = (1, 2, 3, 5, 16, 22, 64, 256)
COMBINE_EDGE_H = (1, 3, 4, 16, 128)
COMBINE_EDGE_DV = (64, 128, 256, 512)
COMBINE_EDGE_B = 7


def combine_attrs() -> None:
    """An [attrs] line for each K2 instance; fails on local memory."""
    for rows, vec, nb, f32 in COMBINE_INSTANCES:
        regs, smem, loc = attr_values("etap_combine_attrs", rows, vec, nb,
                                      f32)
        log(f"[attrs] K2 {'[n,H,Dv]' if rows else 'transposed'}, "
            f"{'2 x 4' if vec == 8 else vec} float{'s' if vec > 1 else ''} "
            f"a thread, {nb} splits at once, {'fp32' if f32 else 'bf16'} "
            f"out: {regs} registers, {smem} B shared memory, {loc} B local")
        if loc:
            raise AssertionError(f"K2 rows={rows} vec={vec} nb={nb} "
                                 f"f32={f32}: local memory")


def combine_stats(B, n, H, Dv, mode, gen, dev):
    """Seeded split stats (m, l [B, n, H], Acc [B, n, H, Dv] fp32): in amla
    mode integer-valued m; split 0 far below the others (weights around
    2^-140 or e^-95: subnormal, or 0); with n > 1, split n // 2 of every
    row fully masked (m = -1e30, l = 0, a finite garbage Acc) and row 3's
    splits all masked but the first."""
    import torch

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    m = randn(B, n, H) * 4
    if mode == "amla":
        m = m.round()
    m[:, 0] -= 140 if mode == "amla" else 95
    l = torch.rand(B, n, H, generator=gen, device=dev) + 1
    acc = randn(B, n, H, Dv)
    if n > 1:
        for idx in ((slice(None), n // 2), (3, slice(1, n))):
            m[idx], l[idx] = -1e30, 0.0
            acc[idx] = 1e3 * randn(*acc[idx].shape)
    return m, l, acc


def combine_edge_checks(gen, dev) -> dict:
    """K2 at its edges: every (n, H, Dv) of COMBINE_EDGE_N x COMBINE_EDGE_H
    x COMBINE_EDGE_DV over COMBINE_EDGE_B rows of combine_stats, both
    orientations, both rescale modes, bf16 and fp32 out (so every
    instance of COMBINE_INSTANCES runs, the row alone on another instance
    than its batch at the larger shapes): each against its plain version
    (bf16_close / f32_close);
    the two orientations bitwise equal; n = 1 bitwise the acc / l cast; row 3
    alone bitwise its row of the batch.  Returns {kernels-line key: max abs
    err}."""
    import torch
    from repro_torch.kernels.etap import combine as C
    errs = {"combine_splits": 0.0, "combine_splits_std": 0.0}
    B = COMBINE_EDGE_B
    for n in COMBINE_EDGE_N:
        for H in COMBINE_EDGE_H:
            for Dv in COMBINE_EDGE_DV:
                for mode in ("amla", "mul"):
                    m, l, acc = combine_stats(B, n, H, Dv, mode, gen, dev)
                    acc_t = acc.transpose(2, 3).contiguous()
                    for dt in (torch.bfloat16, torch.float32):
                        tag = (f"K2 edges n={n} H={H} Dv={Dv} {mode} "
                               f"{str(dt)[6:]}")
                        kw = dict(out_dtype=dt, rescale=mode)
                        close = bf16_close if dt == torch.bfloat16 else \
                            f32_close
                        o_t = C.combine_splits(m, l, acc_t, **kw)
                        o_r = C.combine_splits_std(m, l, acc, **kw)
                        for name, o, ref in (
                                ("combine_splits", o_t,
                                 C.combine_splits_plain(m, l, acc_t, **kw)),
                                ("combine_splits_std", o_r,
                                 C.combine_splits_std_plain(m, l, acc,
                                                            **kw))):
                            errs[name] = max(errs[name], close(
                                o, ref, f"{tag} {name}"))
                        bitwise(o_t, o_r, f"{tag}: transposed vs [n,H,Dv]")
                        if n == 1:
                            bitwise(o_r, (acc[:, 0] / l[:, 0, :, None]).to(
                                dt), f"{tag}: n=1 vs acc / l")
                        one = slice(3, 4)
                        bitwise(C.combine_splits(m[one], l[one], acc_t[one],
                                                 **kw), o_t[one],
                                f"{tag}: transposed, a row alone")
                        bitwise(C.combine_splits_std(m[one], l[one],
                                                     acc[one], **kw),
                                o_r[one], f"{tag}: [n,H,Dv], a row alone")
                    del m, l, acc, acc_t
        log(f"[K2 edges] n={n}: H {', '.join(map(str, COMBINE_EDGE_H))} x "
            f"Dv {', '.join(map(str, COMBINE_EDGE_DV))} over {B} rows ok "
            "in both orientations and modes, bf16 and fp32 out (a masked "
            "split, a row masked but one split); bitwise: transposed == "
            "[n,H,Dv], a row alone == in the batch"
            + (", == acc / l" if n == 1 else ""))
        torch.cuda.empty_cache()
    return errs


def main_path_cases(gen, dev):
    """The dense decode shapes the serve phases run, at H = 128, with
    ragged lengths that reach the last row: (tag, q, k, v, lengths, block).
    dense-short's S 544 ends in a 32-row tile; dense-long's S 4128 is cut
    into 3 effective splits of 1536 rows, padded to 4608; serve-long-std
    gathers 65 pages (S 4160) and walks them in blocks of one page."""
    import torch
    from repro_torch.runtime.paged_cache import gather_blocks
    H = 128

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    def i32(xs):
        return torch.tensor(xs, dtype=torch.int32, device=dev)

    k = rand(8, 544, DK)
    yield ("dense-short S=544", rand(8, H, DK), k, k[..., :DV],
           i32([544, 543, 513, 520, 1, 64, 300, 541]), 512)
    k = rand(4, 4128, DK)
    yield ("dense-long S=4128", rand(4, H, DK), k, k[..., :DV],
           i32([4128, 4097, 3073, 1000]), 512)
    lengths = [4128, 4097, 1089, 65]
    pool, table = make_pool(4, 65, lengths, gen, dev)
    k = gather_blocks(pool, table)
    yield ("serve-long-std 65 pages", rand(4, H, DK), k, k[..., :DV],
           i32(lengths), PAGE)


def phase_dense_kernels(quick: bool, report: dict) -> None:
    """K5 / K6 (dense ETAP), K7 / K8 (untransposed baseline) and K2 in both
    orientations against their plain versions — at H = 128 and 16 over
    ~4K ragged contexts, and at the main path's own shapes — the bitwise
    contracts, the timings, and ETAP beside the baseline."""
    import torch
    from repro_torch.core.attn_spec import AttnSpec
    from repro_torch.kernels import splitkv
    from repro_torch.kernels.etap import combine as C
    from repro_torch.kernels.etap import etap as K
    from repro_torch.kernels.etap.schedule import dense_split_plan
    from repro_torch.kernels.flash_decode import flash_decode as FD

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    ctx, B, block = 4096, 8, 512
    plan = dense_split_plan(ctx, block, 4)
    n = plan.n_splits
    errs: dict = {}
    bf16 = dict(out_dtype=torch.bfloat16)
    for H in (128, 16):
        lengths = torch.tensor([ctx, 1, 4033, 64, 65, 2500, 3999, 1234],
                               dtype=torch.int32, device=dev)
        k = torch.randn(B, ctx, DK, generator=gen, device=dev).to(
            torch.bfloat16)
        v = k[..., :DV]                      # the latent's V: a strided view
        q = torch.randn(B, H, DK, generator=gen, device=dev).to(torch.bfloat16)
        pool, table = dense_as_paged(k, gen)
        for mode in ("amla", "mul"):
            tag = f"H={H} {mode}"
            o5 = check_dense(q, k, v, lengths, block=block, plan=plan,
                             mode=mode, tag=tag, errs=errs)
            bitwise(K.etap_decode_mla_paged(q, pool, DV, table, lengths,
                                            scale=SCALE, rescale=mode),
                    o5, f"paged K3 vs dense K5 {tag}")
            v_sep = k.clone()[..., :DV]      # own pointer, ldv = ldk
            bitwise(K.etap_decode_dense(q, k, v_sep, lengths, scale=SCALE,
                                        block=block, rescale=mode), o5,
                    f"separate-V K5 vs fused K5 {tag}")
            log(f"[kernels] dense {tag}: K5 ok, K6 ok, K7 ok, K8 ok, "
                f"K2 both ok; bitwise: K6(n=1)+K2 == K5, "
                f"K8(n=1)+K2 == K7, paged K3 == dense K5, "
                f"separate V == fused V")
    for tag, q, k, v, lengths, blk in main_path_cases(gen, dev):
        mplan = splitkv.split_plan(q, k, v, spec=AttnSpec(block=blk))
        for mode in ("amla", "mul"):
            check_dense(q, k, v, lengths, block=blk, plan=mplan, mode=mode,
                        tag=f"{tag} {mode}", errs=errs)
        log(f"[kernels] main path {tag}: B={q.shape[0]} block={blk}, plan "
            f"n_splits={mplan.n_splits} x {mplan.nb_per_split} blocks "
            f"(padded to {mplan.padded_s} rows): K5, K7"
            + (", K6, K8, K2 both" if mplan.n_splits > 1 else "")
            + " ok in both modes; split(n=1)+K2 == single pass bitwise")
    report["combine_splits"]["max_abs_err"] = max(
        report["combine_splits"]["max_abs_err"], errs.pop("combine_splits"))
    baseline_attrs()
    BASELINE_EDGE_ERRS.update(baseline_edge_checks(gen, dev))
    for name in ("flash_decode", "flash_decode_partial"):
        errs[name] = max(errs[name], BASELINE_EDGE_ERRS[name])
    combine_attrs()
    k2 = combine_edge_checks(gen, dev)
    report["combine_splits"]["max_abs_err"] = max(
        report["combine_splits"]["max_abs_err"], k2["combine_splits"])
    errs["combine_splits_std"] = max(errs["combine_splits_std"],
                                     k2["combine_splits_std"])

    # ---- timing, and ETAP beside the baseline at the same shapes
    iters, piters = (1, 1) if quick else (20, 3)
    lengths = torch.tensor([4096, 3900, 4033, 3500, 4000, 2500, 3999, 3210],
                           dtype=torch.int32, device=dev)
    keys = int(lengths.sum())
    for H in (128, 16):
        k = torch.randn(B, ctx, DK, generator=gen, device=dev).to(
            torch.bfloat16)
        v = k[..., :DV]
        q = torch.randn(B, H, DK, generator=gen, device=dev).to(torch.bfloat16)
        pool, table = dense_as_paged(k, gen)
        kw = dict(scale=SCALE, block=block)
        io = B * H * DK * 2 + keys * DK * 2               # q + live rows
        out_b = B * H * DV * 2
        stats_b = B * n * H * (DV + 2) * 4
        flops = 2 * keys * H * (DK + DV)
        t = {
            "K3": cuda_time_ms(lambda: K.etap_decode_mla_paged(
                q, pool, DV, table, lengths, scale=SCALE), iters),
            "K5": cuda_time_ms(lambda: K.etap_decode_dense(
                q, k, v, lengths, **kw), iters),
            "K7": cuda_time_ms(lambda: FD.flash_decode(
                q, k, v, lengths, **kw), iters),
            "K1": cuda_time_ms(lambda: K.etap_paged_partial(
                q, pool, DV, table, lengths, scale=SCALE, n_splits=n), iters),
            "K6": cuda_time_ms(lambda: K.etap_partial_dense(
                q, k, v, lengths, scale=SCALE, plan=plan), iters),
            "K8": cuda_time_ms(lambda: FD.flash_decode_partial(
                q, k, v, lengths, scale=SCALE, plan=plan), iters),
        }
        lib = cuda_time_ms(sdpa_dense(q, k, lengths), iters)
        log(f"[compare] B={B} H={H} ctx<=4096 ragged: single pass "
            f"K3 (ETAP, paged) {t['K3']:.4f} ms, K5 (ETAP, dense) "
            f"{t['K5']:.4f} ms, K7 (standard) {t['K7']:.4f} ms; "
            f"split phase 1 at n={n}: K1 (ETAP, paged) {t['K1']:.4f} ms, "
            f"K6 (ETAP, dense) {t['K6']:.4f} ms, K8 (standard) "
            f"{t['K8']:.4f} ms; SDPA {lib:.4f} ms")
        if H != 128:
            continue
        st8 = FD.flash_decode_partial(q, k, v, lengths, scale=SCALE,
                                      plan=plan)
        tp = {
            "etap_decode_dense": cuda_time_ms(
                lambda: K.etap_decode_dense_plain(q, k, v, lengths, **kw),
                piters, warmup=1),
            "etap_partial_dense": cuda_time_ms(
                lambda: K.etap_partial_dense_plain(q, k, v, lengths,
                                                   scale=SCALE, plan=plan),
                piters, warmup=1),
            "flash_decode": cuda_time_ms(
                lambda: FD.flash_decode_plain(q, k, v, lengths, **kw),
                piters, warmup=1),
            "flash_decode_partial": cuda_time_ms(
                lambda: FD.flash_decode_partial_plain(q, k, v, lengths,
                                                      scale=SCALE, plan=plan),
                piters, warmup=1),
            "combine_splits_std": cuda_time_ms(
                lambda: C.combine_splits_std_plain(*st8, **bf16), piters,
                warmup=1),
        }
        t2 = cuda_time_ms(lambda: C.combine_splits_std(*st8, **bf16), iters)
        rows = {
            "etap_decode_dense": (t["K5"], bound_ms(io + out_b, flops), lib),
            "etap_partial_dense": (t["K6"], bound_ms(io + stats_b, flops),
                                   None),
            "flash_decode": (t["K7"], bound_ms(io + out_b, flops), lib),
            "flash_decode_partial": (t["K8"], bound_ms(io + stats_b, flops),
                                     None),
            "combine_splits_std": (t2, bound_ms(stats_b + out_b,
                                                B * n * H * DV * 2), None),
        }
        for name, (ms, (tb, by), tl) in rows.items():
            libs = "null" if tl is None else f"{tl:.4f}"
            log(f"[timing] {name} (B={B} H={H} ctx<=4096 ragged, "
                f"n_splits={n} where split): {ms:.4f} ms, plain "
                f"{tp[name]:.4f} ms, bound {tb:.4f} ms ({by}), library "
                f"{libs} ms")
            report[name] = {"max_abs_err": errs[name], "ms": ms,
                            "plain_ms": tp[name], "bound_ms": tb,
                            "bound_by": by, "library_ms": tl}


# ---------------------------------- phase 2: the GQA widths 128, 64, 256
# the dense kernels at a GQA head: entry -> (the TPU kernel it replaces,
# its CUDA source, the wrapper, the width).  [128]: Qwen3-8B, LLaVA-NeXT;
# [64]: SmolLM-360M (G = 3), StableLM-1.6B and MusicGen-large (MHA, G = 1);
# [256]: RecurrentGemma-9B's local attention (16 heads over one kv head);
# their launches are counted on those models' main-path calls
HD = 128                       # Qwen3-8B's head_dim (Dk = Dv)
GQA_WIDTHS = (HD, 64, 256)
GQA_KERNELS = {f"{wrapper}[{hd}]": (tpu, src, wrapper, hd)
               for hd in GQA_WIDTHS
               for wrapper, (tpu, src) in KERNELS.items()
               if wrapper in ("etap_decode_dense", "etap_partial_dense",
                              "flash_decode", "flash_decode_partial",
                              "combine_splits", "combine_splits_std")}


def gqa_cases(gen, dev):
    """The dense decode shapes the GQA phases give K5-K8, as GQA caches
    [B, S, K, hd] read in place (BG = B·K grouped rows of G = H/K columns),
    with ragged lengths that reach the last row: (tag, hd, q [BG, G, hd],
    k, v, lengths [BG], block).  At 128: qwen-dense's B 8 x S 544 (one
    split at block 512); qwen-short's gathered paged rows (9 pages, block
    64: the auto plan cuts them into 3 splits); qwen-long's 65 gathered
    pages at B 1 (BG 8, block 64); granite-20b's MQA (48 heads over one kv
    head: three column tiles) at B 8 x S 2048; llava-dense's B 4 x S 528
    (56 heads over 8 kv heads: G = 7, one split); dbrx-short's gathered
    paged rows (48 heads over 8 kv heads: G = 6, 9 pages).  At 64: smol-short's
    gathered pages (B 8 x 9 pages, K 5, G 3: 3 splits), smol-long's (B 1 x
    65 pages: 22 splits), stablelm-dense's B 8 x S 544 (K 32, G 1: one
    split), musicgen-short's gathered pages (B 8 x 9 pages, G 1: 2 splits).
    At 256: rgemma-short's B 8 x S 544 (K 1, G 16: one split) and
    rgemma-long's ring of 2048 rows, all live (B 1: 2 splits)."""
    import torch

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    def lens(per_b, K):
        return torch.tensor(per_b, dtype=torch.int32,
                            device=dev).repeat_interleave(K)

    short = [545, 544, 289, 1, 64, 300, 541, 520]
    dense = [544, 543, 513, 1, 64, 300, 541, 520]
    for tag, hd, B, S, K, G, per_b, blk in (
            ("qwen-dense B=8 S=544", HD, 8, 544, 8, 4,
             [544, 543, 513, 1, 64, 300, 541, 520], 512),
            ("qwen-short paged S=576", HD, 8, 576, 8, 4, short, PAGE),
            ("qwen-long paged S=4160", HD, 1, 4160, 8, 4, [4128], PAGE),
            ("granite MQA G=48 S=2048", HD, 8, 2048, 1, 48,
             [2048, 2047, 1, 64, 65, 1500, 999, 1234], 512),
            ("llava-dense G=7 S=528", HD, 4, 528, 8, 7, [528, 527, 1, 300],
             512),
            ("dbrx-short paged G=6 S=576", HD, 8, 576, 8, 6, short, PAGE),
            ("smol-short paged S=576", 64, 8, 576, 5, 3, short, PAGE),
            ("smol-long paged S=4160", 64, 1, 4160, 5, 3, [4128], PAGE),
            ("stablelm-dense S=544", 64, 8, 544, 32, 1, dense, 512),
            ("musicgen-short paged S=576", 64, 8, 576, 32, 1, short, PAGE),
            ("rgemma-short S=544", 256, 8, 544, 1, 16, dense, 512),
            ("rgemma-long ring S=2048", 256, 1, 2048, 1, 16, [2048], 512)):
        yield (tag, hd, rand(B * K, G, hd), rand(B, S, K, hd),
               rand(B, S, K, hd), lens(per_b, K), blk)


# the shapes each width is timed at: (single pass, split phase 1 + K2)
GQA_TIMED = {HD: ("qwen-dense B=8 S=544", "qwen-long paged S=4160"),
             64: ("stablelm-dense S=544", "smol-long paged S=4160"),
             256: ("rgemma-short S=544", "rgemma-long ring S=2048")}
# ETAP beside the baseline, one split, at G = 1, 3, 7 and 16
GQA_COMPARED = ("stablelm-dense S=544", "smol-short paged S=576",
                "llava-dense G=7 S=528", "rgemma-short S=544")


def attr_values(fn: str, *args) -> tuple[int, int, int]:
    """Registers a thread, dynamic shared memory and local memory (spills)
    of one kernel instance, from the library's query ``fn``."""
    import ctypes
    from repro_torch.kernels import build
    buf = (ctypes.c_int * 3)()
    build.check(getattr(build.library(), fn)(*args, buf), fn)
    return buf[0], buf[1], buf[2]


def instance_attrs(fn: str, *args) -> str:
    """attr_values, as printed on an ``[attrs]`` line."""
    regs, smem, local = attr_values(fn, *args)
    return f"{regs} registers, {smem} B shared memory, {local} B local"


def sdpa_gqa(q, k, v, lengths, hd):
    """Yardstick for a GQA decode over a [B, S, K, hd] cache: one SDPA call
    (enable_gqa) with a length mask; q [B·K, G, hd], lengths [B·K]."""
    import torch
    Bo, S, Kv, _ = k.shape
    G = q.shape[1]
    mask = (torch.arange(S, device=k.device)[None, :]
            < lengths.reshape(Bo, Kv)[:, :1])[:, None, None, :]
    qd = q.reshape(Bo, Kv * G, 1, hd)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)        # [B, K, S, hd]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qd, kt, vt, attn_mask=mask, scale=hd ** -0.5, enable_gqa=True)


def phase_gqa_kernels(quick: bool, report: dict) -> None:
    """K5-K8 at the GQA widths (Dk, Dv) = (128, 128), (64, 64) and
    (256, 256) and K2 at Dv 128, 64 and 256 in both orientations against
    their plain versions, at the GQA phases' own shapes and auto split
    plans and at an MQA shape (gqa_cases), in both rescale modes; the
    bitwise contracts there (split(n=1) + K2 == single pass for ETAP and
    the baseline; the cache read in place == the kernel on
    gqa_to_grouped's copy); the registers and shared memory of the 64- and
    256-wide instances; then each kernel's time, its plain version's, its
    byte bound and, for K5 and K7, SDPA's (enable_gqa, a length mask) at
    GQA_TIMED's shapes; and ETAP beside the baseline, in turns, at G = 1,
    3, 7 and 16 (GQA_COMPARED)."""
    import torch
    from repro_torch.core.attn_spec import AttnSpec
    from repro_torch.core.etap import gqa_to_grouped
    from repro_torch.kernels import splitkv
    from repro_torch.kernels.etap import combine as C
    from repro_torch.kernels.etap import etap as K
    from repro_torch.kernels.flash_decode import flash_decode as FD

    dev = torch.device("cuda")
    for hd in (64, 256):
        for stats, what in ((0, "K5 / K7"), (1, "K6 / K8")):
            log(f"[attrs] ({hd}, {hd}) {what}: ETAP "
                + instance_attrs("etap_dense_attrs", hd, hd, stats)
                + "; baseline "
                + instance_attrs("flash_decode_attrs", hd, hd, stats))
    for code, kvd in enumerate(("int8", "fp8")):
        for stats, what in ((0, "K5q / K7q"), (1, "K6q / K8q")):
            log(f"[attrs] (64, 64) {what} {kvd}, fp32 q: ETAP "
                + instance_attrs("etap_dense_quant_attrs", 64, 64, stats,
                                 code, 1)
                + "; baseline "
                + instance_attrs("flash_decode_quant_attrs", 64, 64, stats,
                                 code, 1))
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    errs = {hd: {} for hd in GQA_WIDTHS}
    cases = list(gqa_cases(gen, dev))
    for tag, hd, q, k, v, lengths, blk in cases:
        plan = splitkv.split_plan(q, k, v, spec=AttnSpec(block=blk))
        Bo, _, Kv, _ = k.shape
        _, kg, vg, _ = gqa_to_grouped(q.reshape(Bo, -1, hd), k, v)
        for mode in ("amla", "mul"):
            t = f"{tag} {mode}"
            kw = dict(scale=hd ** -0.5, rescale=mode)
            o5 = check_dense(q, k, v, lengths, block=blk, plan=plan,
                             mode=mode, tag=t, errs=errs[hd],
                             scale=hd ** -0.5)
            bitwise(K.etap_decode_dense(q, kg, vg, lengths, block=blk, **kw),
                    o5, f"K5 in place vs K5 on gqa_to_grouped {t}")
            bitwise(FD.flash_decode(q, kg, vg, lengths, block=blk, **kw),
                    FD.flash_decode(q, k, v, lengths, block=blk, **kw),
                    f"K7 in place vs K7 on gqa_to_grouped {t}")
            if plan.n_splits > 1:
                for fn in (K.etap_partial_dense, FD.flash_decode_partial):
                    for a, b_ in zip(fn(q, k, v, lengths, plan=plan, **kw),
                                     fn(q, kg, vg, lengths, plan=plan, **kw),
                                     strict=True):
                        bitwise(a, b_, f"{fn.__name__} in place vs on "
                                f"gqa_to_grouped {t}")
        log(f"[kernels] GQA ({hd}, {hd}) {tag}: BG={q.shape[0]} "
            f"G={q.shape[1]} K={Kv} block={blk}, plan n_splits="
            f"{plan.n_splits} x {plan.nb_per_split} blocks (padded to "
            f"{plan.padded_s} rows): K5, K7"
            + (", K6, K8, K2 both" if plan.n_splits > 1 else "")
            + " ok in both modes; bitwise: split(n=1)+K2 == single pass, in "
            "place == on gqa_to_grouped's copy")

    # ---- timing: K5 / K7 at each width's single-split shape, K6 / K8 / K2
    #      at its split one, each under its auto plan
    iters, piters = (1, 1) if quick else (50, 3)
    bf16 = dict(out_dtype=torch.bfloat16)
    by_tag = {c[0]: c for c in cases}
    for hd, (single, split) in GQA_TIMED.items():
        for tag in (single, split):
            _, _, q, k, v, lengths, blk = by_tag[tag]
            plan = splitkv.split_plan(q, k, v, spec=AttnSpec(block=blk))
            BG, G, _ = q.shape
            keys = int(lengths.sum())
            io = BG * G * hd * 2 + keys * hd * 2 * 2     # q + live K, V rows
            out_b = BG * G * hd * 2
            flops = 2 * keys * G * (hd + hd)
            kw = dict(scale=hd ** -0.5)
            shape = f"{tag} BG={BG} G={G}"
            rows = {}
            if tag == single:
                lib = cuda_time_ms(sdpa_gqa(q, k, v, lengths, hd), iters)
                for name, fn, plain in (
                        ("etap_decode_dense", K.etap_decode_dense,
                         K.etap_decode_dense_plain),
                        ("flash_decode", FD.flash_decode,
                         FD.flash_decode_plain)):
                    rows[name] = (
                        cuda_time_ms(lambda fn=fn: fn(
                            q, k, v, lengths, block=blk, **kw), iters),
                        cuda_time_ms(lambda plain=plain: plain(
                            q, k, v, lengths, block=blk, **kw), piters,
                            warmup=1),
                        bound_ms(io + out_b, flops), lib)
            else:
                n = plan.n_splits
                stats_b = BG * n * G * (hd + 2) * 4
                shape += f" n_splits={n}"
                for name, fn, plain, comb, cplain in (
                        ("etap_partial_dense", K.etap_partial_dense,
                         K.etap_partial_dense_plain, C.combine_splits,
                         C.combine_splits_plain),
                        ("flash_decode_partial", FD.flash_decode_partial,
                         FD.flash_decode_partial_plain, C.combine_splits_std,
                         C.combine_splits_std_plain)):
                    rows[name] = (
                        cuda_time_ms(lambda fn=fn: fn(
                            q, k, v, lengths, plan=plan, **kw), iters),
                        cuda_time_ms(lambda plain=plain: plain(
                            q, k, v, lengths, plan=plan, **kw), piters,
                            warmup=1),
                        bound_ms(io + stats_b, flops), None)
                    st = fn(q, k, v, lengths, plan=plan, **kw)
                    rows[comb.__name__] = (
                        cuda_time_ms(lambda comb=comb, st=st: comb(
                            *st, **bf16), iters),
                        cuda_time_ms(lambda cplain=cplain, st=st: cplain(
                            *st, **bf16), piters, warmup=1),
                        bound_ms(stats_b + out_b, BG * n * G * hd * 2), None)
            for name, (t, tp, (tb, by), tl) in rows.items():
                libs = "null" if tl is None else f"{tl:.4f}"
                log(f"[timing] {name}[{hd}] ({shape}): {t:.4f} ms, plain "
                    f"{tp:.4f} ms, bound {tb:.4f} ms ({by}), library {libs} "
                    "ms")
                report[f"{name}[{hd}]"] = {
                    "max_abs_err": max(errs[hd][name], BASELINE_EDGE_ERRS.get(
                        f"{name}[{hd}]", 0.0)), "ms": t, "plain_ms": tp,
                    "bound_ms": tb, "bound_by": by, "library_ms": tl}

    # ---- ETAP beside the baseline, single pass, in turns
    for tag in GQA_COMPARED:
        _, hd, q, k, v, lengths, blk = by_tag[tag]
        kw = dict(scale=hd ** -0.5, block=blk)
        t5, t7 = [], []                   # in turns: K7, K5, K5, K7, ...
        for i in range(1 if quick else 6):
            for fn, ts in ((K.etap_decode_dense, t5),
                           (FD.flash_decode, t7))[::1 if i % 2 else -1]:
                ts.append(cuda_time_ms(lambda fn=fn: fn(q, k, v, lengths,
                                                        **kw), iters))
        m5, m7 = sorted(t5)[len(t5) // 2], sorted(t7)[len(t7) // 2]
        log(f"[compare] G={q.shape[1]} ({tag}, BG={q.shape[0]}, hd {hd}, "
            f"one split; median of {len(t5)} in turns, range): K5 (ETAP) "
            f"{m5:.4f} ms ({min(t5):.4f}-{max(t5):.4f}), K7 (standard) "
            f"{m7:.4f} ms ({min(t7):.4f}-{max(t7):.4f}), K7/K5 "
            f"{m7 / m5:.3f}")


# ------------------------------------ phase 2: K5q-K8q over dense code rows
# the quantized dense kernels, one entry per width and code type: entry ->
# (the TPU kernel it replaces, its CUDA source, the wrapper, the width, the
# code type).  K5q / K6q at the GQA heads (128: Qwen3-8B; 64: SmolLM-360M);
# K7q / K8q also at the latent (DeepSeek's --mode standard over its code
# pool).
QDENSE_KERNELS = {
    f"{wrapper}[{w},{kvd}]": (tpu, _CSRC + src, wrapper, w, kvd)
    for wrapper, tpu, src, widths in (
        ("etap_decode_dense_quant", "src/repro/kernels/etap/etap.py:154",
         "etap_quant.cu", (128, 64)),
        ("etap_partial_dense_quant", "src/repro/kernels/etap/etap.py:603",
         "etap_quant.cu", (128, 64)),
        ("flash_decode_quant",
         "src/repro/kernels/flash_decode/flash_decode.py:83",
         "flash_decode_wgmma.cu", (128, DK, 64)),
        ("flash_decode_partial_quant",
         "src/repro/kernels/flash_decode/flash_decode.py:168",
         "flash_decode_wgmma.cu", (128, DK, 64)))
    for w in widths for kvd in ("int8", "fp8")}
# the quantized phases that pin one split (--kv-splits 1)
QDENSE_PINNED = ("qwen-short", "smol-short")


def f32_close(out, ref, what: str) -> float:
    """Max |out - ref| of fp32 outputs; raises beyond F32_Q_TOL * (1 +
    |ref|), the CPU tests' fp32 tolerance (atol = rtol = 1e-5): the
    quantized kernels carry fp32 q and P * scale as three bf16 terms (24
    bits) and sum in another order than the plain version; the relative
    term covers outputs of a few units (a row with one live key is that
    key's V row)."""
    import torch
    o, r = out.float(), ref.float()
    d = (o - r).abs()
    err = float(d.max())
    if not (bool((d <= F32_Q_TOL * (1 + r.abs())).all())
            and bool(torch.isfinite(o).all())):
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version (max abs err {err:.3e})")
    return err


def f32_finalized_close(state, ref, what: str, transposed: bool) -> float:
    """Split stats of a quantized kernel: acc / l per split against its
    plain version's under f32_close's tolerance (NaN where l = 0 on
    both)."""
    import torch
    _, l, acc = state
    _, rl, racc = ref
    ex = (lambda x: x[:, :, None, :]) if transposed else \
        (lambda x: x[..., None])
    o, r = acc / ex(l), racc / ex(rl)
    nan_r = torch.isnan(r)
    if not torch.equal(torch.isnan(o), nan_r):
        raise AssertionError(f"{what}: empty splits differ")
    return f32_close(o[~nan_r], r[~nan_r], what) if (~nan_r).any() else 0.0


def quant_dense_cases():
    """The dense code rows the quantized serve phases give K5q-K8q, with
    lengths in the phases' own ranges (their prompts are 512 or 4096 tokens
    plus up to 32 generated; a ragged set with a one-key row for the
    kernel-vs-plain checks): (tag, B, S, K, G, Dk, Dv, fused V, q dtype,
    split count of the phase's auto plan, ragged lengths [B], serve lengths
    [B]).  qwen-short-int8 and qwen-short-std-fp8: 15 slots of 9 pages
    (the int8 / fp8 pool at the fp pool's bytes), K = 8 kv heads of G = 4,
    one split (--kv-splits 1); qwen-long-fp8 and qwen-long-std-int8: one
    slot of 65 pages, 22 splits; serve-short-std-int8: DeepSeek's 15 slots
    of 9 latent pages, H = 128, one split; serve-long-std-fp8: 7 slots of
    65 pages, 4 splits; smol-short: SmolLM-360M's 14 slots of 9 pages
    (K = 5, G = 3, head_dim 64), one split; smol-long: one slot of 65
    pages, 22 splits.  GQA q is fp32 (the model casts it, as the reference
    does), DeepSeek's bf16."""
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    short = [512 + (7 * i) % 33 for i in range(15)]
    yield ("qwen-short", 15, 576, 8, 4, HD, HD, False, f32, 1,
           [545, 544, 289, 1, 64, 300, 541, 520, 513, 2, 100, 576, 575, 33,
            400], short)
    yield ("qwen-long", 1, 4160, 8, 4, HD, HD, False, f32, 22, [4128],
           [4128])
    yield ("serve-short-std", 15, 576, 1, 128, DK, DV, True, bf16, 1,
           [545, 544, 289, 1, 64, 300, 541, 520, 513, 2, 100, 576, 575, 33,
            400], short)
    yield ("serve-long-std", 7, 4160, 1, 128, DK, DV, True, bf16, 4,
           [4127, 4096, 1088, 64, 4160, 2, 3000],
           [4096 + (5 * i) % 33 for i in range(7)])
    yield ("smol-short", 14, 576, 5, 3, 64, 64, False, f32, 1,
           [545, 544, 289, 1, 64, 300, 541, 520, 513, 2, 100, 576, 575, 33],
           short[:14])
    yield ("smol-long", 1, 4160, 5, 3, 64, 64, False, f32, 22, [4128],
           [4128])


def quant_dense_inputs(B, S, Kv, G, Dk, Dv, fused, qdt, kv_dtype, rng):
    """fp32 rows from numpy's ``rng`` (q [B·K, G, Dk]; k [B, S, K, Dk] and
    v [B, S, K, Dv], or a latent k [B, S, Dk] with V its first Dv columns)
    and their codes and (scale, zp) rows on the card: (q, rows k, rows v,
    codes k, pairs k, codes v, pairs v)."""
    import numpy as np
    import torch
    from repro_torch.runtime import paged_cache
    dev = torch.device("cuda")

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(dev)

    q = normal(B * Kv, G, Dk).to(qdt)
    if fused:
        k = normal(B, S, Dk)
        v = k[..., :Dv]
    else:
        k, v = normal(B, S, Kv, Dk), normal(B, S, Kv, Dv)
    kc, ks = paged_cache.quantize_rows(k, kv_dtype)
    if fused:
        vc, vs = kc[..., :Dv], ks
    else:
        vc, vs = paged_cache.quantize_rows(v, kv_dtype)
    return q, k, v, kc, ks, vc, vs


def phase_quant_dense_kernels(quick: bool, report: dict) -> None:
    """K5q / K6q (ETAP) and K7q / K8q (the baseline) over dense int8 and
    fp8 code rows, at the quantized serve phases' shapes
    (quant_dense_cases), in both rescale modes: each against its plain
    version (fp32 outputs, f32_close; split stats finalized per split), K2
    in both orientations over their stats, split(n=1) + K2 == single pass
    bitwise, and the RMSE against the fp64 oracle on the unquantized rows
    with the phases' own lengths; then the reference's own RMSE test at its
    geometry (B 2, H 16, S 1024, lengths 515 and 1024, numpy
    default_rng(0), scale Dk^-0.5: tests/test_softmax_state.py:258) for
    K7q and K8q (n = 4) + K2 at the latent; then each instance's time, its
    plain version's and its byte bound at its phase's shape."""
    import numpy as np
    import torch
    from repro_torch.core.attn_spec import AttnSpec
    from repro_torch.kernels import splitkv
    from repro_torch.kernels.etap import combine as C
    from repro_torch.kernels.etap import etap as K
    from repro_torch.kernels.etap.ref import etap_decode_ref
    from repro_torch.kernels.etap.schedule import dense_split_plan
    from repro_torch.kernels.flash_decode import flash_decode as FD

    dev = torch.device("cuda")
    errs = {k: QUANT_EDGE_ERRS.get(k, 0.0) for k in QDENSE_KERNELS}
    k2_err = {"combine_splits[128]": 0.0, "combine_splits_std[128]": 0.0,
              "combine_splits[64]": 0.0, "combine_splits_std[64]": 0.0,
              "combine_splits_std": 0.0}
    plain_partial = {K.etap_partial_dense_quant:
                     K.etap_partial_dense_quant_plain,
                     FD.flash_decode_partial_quant:
                     FD.flash_decode_partial_quant_plain}
    timing_cases = []
    for (tag, B, S, Kv, G, Dk, Dv, fused, qdt, n, ragged,
         serve_lens) in quant_dense_cases():
        etap_ok = Dk != DK                   # K5q / K6q: the GQA heads only
        plan = dense_split_plan(S, PAGE, n)
        one = dense_split_plan(S, PAGE, 1)
        scale = Dk ** -0.5
        for kvd in ("int8", "fp8"):
            rng = np.random.default_rng(11)
            q, kf, vf, kc, ks, vc, vs = quant_dense_inputs(
                B, S, Kv, G, Dk, Dv, fused, qdt, kvd, rng)
            auto = splitkv.split_plan(q, kc, vc, spec=AttnSpec(block=PAGE))
            if tag not in QDENSE_PINNED and auto.n_splits != n:
                raise AssertionError(f"{tag}: the auto plan has "
                                     f"{auto.n_splits} splits, not {n}")
            kgrp = splitkv.grouped(kf)
            vgrp = kgrp[..., :Dv] if fused else splitkv.grouped(vf)
            name = {x: f"{x}[{Dk},{kvd}]" for x in (
                "etap_decode_dense_quant", "etap_partial_dense_quant",
                "flash_decode_quant", "flash_decode_partial_quant")}
            qkw = dict(k_sz=ks, v_sz=vs)
            for lens_of, what in ((ragged, "ragged"), (serve_lens, "serve")):
                lengths = torch.tensor(lens_of, dtype=torch.int32,
                                       device=dev).repeat_interleave(Kv)
                oracle = etap_decode_ref(
                    q.double(), kgrp.double(), vgrp.double(), lengths,
                    scale=scale, dtype=torch.float64)
                for mode in ("amla", "mul"):
                    t = f"{tag} {kvd} {what} {mode}"
                    kw = dict(scale=scale, rescale=mode)
                    f32 = dict(out_dtype=torch.float32, rescale=mode)
                    singles = [("flash_decode_quant",
                                FD.flash_decode_quant,
                                FD.flash_decode_quant_plain,
                                FD.flash_decode_partial_quant,
                                C.combine_splits_std)]
                    if etap_ok:
                        singles.insert(0, (
                            "etap_decode_dense_quant",
                            K.etap_decode_dense_quant,
                            K.etap_decode_dense_quant_plain,
                            K.etap_partial_dense_quant, C.combine_splits))
                    outs = {}
                    for key, fn, plain, part, comb in singles:
                        if n == 1:
                            o = fn(q, kc, vc, lengths, block=PAGE, **qkw,
                                   **kw)
                            r = plain(q, kc, vc, lengths, block=PAGE, **qkw,
                                      **kw)
                            errs[name[key]] = max(errs[name[key]], f32_close(
                                o, r, f"{key} {t}"))
                            bitwise(comb(*part(q, kc, vc, lengths, plan=one,
                                               **qkw, **kw), **f32), o,
                                    f"{key} split(n=1)+K2 vs single {t}")
                            outs[key] = o
                            continue
                        # the phase's split plan: phase 1 against its plain
                        # version, K2 over its stats against K2's plain
                        # version, and split(n=1) + K2 == the single pass
                        pkey = name[part.__name__]
                        st = part(q, kc, vc, lengths, plan=plan, **qkw, **kw)
                        rs = plain_partial[part](q, kc, vc, lengths,
                                                 plan=plan, **qkw, **kw)
                        errs[pkey] = max(errs[pkey], f32_finalized_close(
                            st, rs, f"{part.__name__} {t}",
                            transposed=part is K.etap_partial_dense_quant))
                        o = comb(*st, **f32)
                        cplain = getattr(C, comb.__name__ + "_plain")
                        ckey = (comb.__name__ if Dk == DK
                                else f"{comb.__name__}[{Dk}]")
                        k2_err[ckey] = max(k2_err[ckey], f32_close(
                            o, cplain(*st, **f32), f"K2 {comb.__name__} {t}"))
                        o1 = fn(q, kc, vc, lengths, block=PAGE, **qkw, **kw)
                        bitwise(comb(*part(q, kc, vc, lengths, plan=one,
                                           **qkw, **kw), **f32), o1,
                                f"{key} split(n=1)+K2 vs single {t}")
                        outs[key] = o
                    if what != "serve":
                        continue
                    for key, o in outs.items():
                        rmse = float(((o.double() - oracle) ** 2).mean()
                                     .sqrt())
                        kw_plain = dict(block=PAGE, **qkw, **kw)
                        plain = (K.etap_decode_dense_quant_plain
                                 if key == "etap_decode_dense_quant"
                                 else FD.flash_decode_quant_plain)
                        pr = float(((plain(q, kc, vc, lengths, **kw_plain)
                                     .double() - oracle) ** 2).mean().sqrt())
                        gate = QUANT_RMSE[kvd]
                        limit = gate if pr <= gate else pr * 1.01
                        log(f"[qdense] RMSE {key} {t} (n={n}): {rmse:.4e}, "
                            f"the reference's route (plain) {pr:.4e}, gate "
                            f"{gate:.3e}, limit {limit:.4e}")
                        if not rmse <= limit:
                            raise AssertionError(
                                f"{key} {t}: RMSE {rmse:.4e} against the "
                                f"fp64 oracle exceeds {limit:.4e}")
            # the other q type, once: fp32 q at the latent, bf16 at 128
            lengths = torch.tensor(ragged, dtype=torch.int32,
                                   device=dev).repeat_interleave(Kv)
            qo = q.to(torch.bfloat16 if qdt == torch.float32
                      else torch.float32)
            kw = dict(scale=scale, rescale="amla", block=PAGE, **qkw)
            for key, fn, plain in (
                    ("flash_decode_quant", FD.flash_decode_quant,
                     FD.flash_decode_quant_plain),
                    ("etap_decode_dense_quant", K.etap_decode_dense_quant,
                     K.etap_decode_dense_quant_plain)):
                if key == "etap_decode_dense_quant" and not etap_ok:
                    continue
                f32_close(fn(qo, kc, vc, lengths, **kw),
                          plain(qo, kc, vc, lengths, **kw),
                          f"{key} {tag} {kvd} q {qo.dtype}")
            log(f"[qdense] {tag} {kvd}: B={B} S={S} K={Kv} G={G} "
                f"(Dk, Dv)=({Dk}, {Dv}) {'fused' if fused else 'separate'} "
                f"V, q {qdt}, n_splits={n}: "
                + ("K5q, K7q" if n == 1 and etap_ok else
                   "K7q" if n == 1 else
                   "K6q + K2, K8q + K2" if etap_ok else "K8q + K2")
                + " ok against their plain versions in both modes (ragged "
                "and serve lengths); split(n=1)+K2 == single pass bitwise; "
                f"other q type ({qo.dtype}) ok")
            timing_cases.append((tag, B, S, Kv, G, Dk, Dv, n, qdt, kvd,
                                 serve_lens, q, kc, ks, vc, vs))

    # the reference's RMSE test at its own geometry, for the latent's K7q
    # and K8q (n = 4) + K2 (the ETAP paged bodies hold it in rmse_gate)
    for kvd in ("int8", "fp8"):
        rng = np.random.default_rng(0)
        Bg, Hg, Sg = 2, 16, 1024
        qg = torch.from_numpy(rng.normal(size=(Bg, Hg, DK)).astype(
            np.float32)).to(dev)
        kvg = torch.from_numpy(rng.normal(size=(Bg, Sg, DK)).astype(
            np.float32)).to(dev)
        lg = torch.tensor([Sg // 2 + 3, Sg], dtype=torch.int32, device=dev)
        oracle = etap_decode_ref(qg.double(), kvg.double(),
                                 kvg[..., :DV].double(), lg, scale=DK ** -0.5,
                                 dtype=torch.float64)
        from repro_torch.runtime import paged_cache
        kc, ks = paged_cache.quantize_rows(kvg, kvd)
        for mode in ("amla", "mul"):
            kw = dict(scale=DK ** -0.5, rescale=mode, k_sz=ks, v_sz=ks)
            o7 = FD.flash_decode_quant(qg, kc, kc[..., :DV], lg, block=PAGE,
                                       **kw)
            o8 = C.combine_splits_std(*FD.flash_decode_partial_quant(
                qg, kc, kc[..., :DV], lg, plan=dense_split_plan(Sg, PAGE, 4),
                **kw), out_dtype=torch.float32, rescale=mode)
            for what, o in (("K7q", o7), ("K8q(n=4)+K2", o8)):
                r = float(((o.double() - oracle) ** 2).mean().sqrt())
                log(f"[qdense] reference RMSE test {what} {kvd} {mode}: "
                    f"{r:.4e} <= {QUANT_RMSE[kvd]:.3e}")
                if not r <= QUANT_RMSE[kvd]:
                    raise AssertionError(f"{what} {kvd} {mode}: RMSE {r:.4e} "
                                         "exceeds the reference's gate")
    for key, e in k2_err.items():
        report[key]["max_abs_err"] = max(report[key]["max_abs_err"], e)

    # ---- timing at the phases' shapes, serve lengths
    iters, piters = (1, 1) if quick else (50, 3)
    for (tag, B, S, Kv, G, Dk, Dv, n, qdt, kvd, serve_lens, q, kc, ks, vc,
         vs) in timing_cases:
        lengths = torch.tensor(serve_lens, dtype=torch.int32,
                               device=dev).repeat_interleave(Kv)
        BG = B * Kv
        keys = int(lengths.sum())
        row_b = Dk + 8 + (0 if Dk == DK else Dv + 8)   # codes + pairs
        q_b = BG * G * Dk * q.element_size()
        out_b = BG * G * Dv * 4
        flops = 2 * keys * G * (Dk + Dv)
        plan = dense_split_plan(S, PAGE, n)
        stats_b = BG * n * G * (Dv + 2) * 4
        kw = dict(scale=Dk ** -0.5, k_sz=ks, v_sz=vs)
        cases = []
        if n == 1:
            cases.append(("flash_decode_quant", FD.flash_decode_quant,
                          FD.flash_decode_quant_plain, dict(block=PAGE),
                          q_b + keys * row_b + out_b))
            if Dk != DK:
                cases.append(("etap_decode_dense_quant",
                              K.etap_decode_dense_quant,
                              K.etap_decode_dense_quant_plain,
                              dict(block=PAGE), q_b + keys * row_b + out_b))
        else:
            cases.append(("flash_decode_partial_quant",
                          FD.flash_decode_partial_quant,
                          FD.flash_decode_partial_quant_plain,
                          dict(plan=plan), q_b + keys * row_b + stats_b))
            if Dk != DK:
                cases.append(("etap_partial_dense_quant",
                              K.etap_partial_dense_quant,
                              K.etap_partial_dense_quant_plain,
                              dict(plan=plan), q_b + keys * row_b + stats_b))
        for wrapper, fn, plain, extra, nbytes in cases:
            t = cuda_time_ms(lambda fn=fn, extra=extra: fn(
                q, kc, vc, lengths, **kw, **extra), iters)
            tp = cuda_time_ms(lambda plain=plain, extra=extra: plain(
                q, kc, vc, lengths, **kw, **extra), piters, warmup=1)
            tb, by = bound_ms(nbytes, flops)
            key = f"{wrapper}[{Dk},{kvd}]"
            log(f"[timing] {key} ({tag} BG={BG} G={G} S={S} n_splits={n} "
                f"q {qdt}): {t:.4f} ms, plain {tp:.4f} ms, bound {tb:.4f} ms "
                f"({by}), library null ms")
            report[key] = {"max_abs_err": errs[key], "ms": t, "plain_ms": tp,
                           "bound_ms": tb, "bound_by": by,
                           "library_ms": None}


# ------------------------------------------ phase 2: separate-V paged pools
# The paged bodies over separate K and V pools, one entry per width and
# code type: entry -> (the TPU kernel it replaces, its CUDA source, the
# wrapper, (Dk, Dv), kv_dtype).  Their launches are counted on the paged
# attention entries (core.etap with a v_pool), this slice's path.
SEPV_WIDTHS = ((DK, DV), (HD, HD))
SEPV_KERNELS = {
    f"{wrapper}{'' if kvd == 'fp' else '_quant'}[{dk},{dv}"
    f"{'' if kvd == 'fp' else ',' + kvd}]":
        (tpu, _CSRC + ("etap_prefill.cu" if wrapper == "etap_prefill_paged"
                       else "etap_decode.cu" if kvd == "fp"
                       else "etap_sepv.cu"),
         wrapper + ("" if kvd == "fp" else "_quant"), (dk, dv), kvd)
    for dk, dv in SEPV_WIDTHS
    for kvd in ("fp", "int8", "fp8")
    for wrapper, tpu in (
        ("etap_decode_paged", "src/repro/kernels/etap/etap.py:237"),
        ("etap_paged_partial_sepv", "src/repro/kernels/etap/etap.py:713"),
        ("etap_prefill_paged", "src/repro/kernels/etap/etap.py:430"))}
# Granite-20B's MQA pools: 48 query heads over one kv head of 128, pages of
# 64 rows, a 32-column table; gqa_cases' granite lengths, and block-aligned
# ones for paged == dense
GRANITE_H, GRANITE_NB = 48, 32
GRANITE_LENGTHS = [2048, 2047, 1, 64, 65, 1500, 999, 1234]
GRANITE_ALIGNED = [2048, 1984, 64, 128, 640, 1536, 960, 1216]
GRANITE_CQ, GRANITE_STARTS = 128, (1920, 0)   # K4: 6,144 columns a row
# the latent at serve-long's decode shapes (4 live slots; 3 idle ones on a
# code pool), serve-short's (B 8, 9 pages) and its 256-token chunks
SEPV_LONG = [4128, 4097, 1089, 65]
SEPV_SHORT = [545, 544, 289, 1, 64, 300, 541, 520]
SEPV_CQ, SEPV_STARTS = 256, (0, 3840)
# the latent's timed decode shape (phase_kernels' timing: B 8, ~4K ragged)
LATENT_TIMED = [4096, 3900, 4033, 3500, 4000, 2500, 3999, 3210]
# the paper's geometry (B, H, context), fused against separate V
PAPER = (16, 16, 65536)


def pages(lengths) -> int:
    """Table columns that hold the longest of ``lengths``."""
    return -(-max(lengths) // PAGE)


def sepv_pools(k_rows, v_rows, kvd):
    """Separate K and V pools from fp32 rows [N, PAGE, D*]: bf16 ("fp"), or
    int8 / fp8 codes, each with its own (scale, zp) pool.  Returns the
    wrappers' pool arguments (k, v) or (k, k_sz, v, v_sz)."""
    import torch
    from repro_torch.runtime import paged_cache
    if kvd == "fp":
        return k_rows.to(torch.bfloat16), v_rows.to(torch.bfloat16)
    kc, ks = paged_cache.quantize_rows(k_rows, kvd)
    vc, vs = paged_cache.quantize_rows(v_rows, kvd)
    return kc, ks, vc, vs


def pool_kw(args):
    """The attention entries' pool keywords of the wrappers' arguments."""
    if len(args) == 2:
        return dict(k_pool=args[0], v_pool=args[1])
    return dict(k_pool=args[0], k_sz=args[1], v_pool=args[2], v_sz=args[3])


def granite_case(kvd, lengths, gen, dev):
    """Granite's pools with K and V drawn independently (so, over codes,
    V's pairs differ from K's), a shuffled 32-column table with the null
    block past each row's length, q [8, 48, 128] (bf16 over bf16 pools,
    fp32 over codes, as the GQA decode casts it) and the lengths; also the
    fp32 rows, for the fp64 oracle.  Returns (q, pool args, table,
    lengths, (k rows, v rows))."""
    import torch
    B = len(lengths)
    N = 1 + B * GRANITE_NB
    k = torch.randn(N, PAGE, HD, generator=gen, device=dev)
    v = torch.randn(N, PAGE, HD, generator=gen, device=dev)
    perm = torch.randperm(N - 1, generator=gen, device=dev) + 1
    table = perm.reshape(B, GRANITE_NB).to(torch.int32)
    for b, n in enumerate(lengths):
        table[b, -(-n // PAGE):] = 0
    q = torch.randn(B, GRANITE_H, HD, generator=gen, device=dev)
    q = q.to(torch.bfloat16) if kvd == "fp" else q
    return (q, sepv_pools(k, v, kvd), table,
            torch.tensor(lengths, dtype=torch.int32, device=dev), (k, v))


def latent_case(kvd, lengths, nb, gen, dev):
    """A random latent pool (bf16, or int8 / fp8 codes) with V its first
    512 columns as a pool of its own (pairs a copy of K's): (fused pool
    args (pool[, sz]), separate pool args, table)."""
    if kvd == "fp":
        pool, table = make_pool(len(lengths), nb, lengths, gen, dev)
        return (pool,), (pool, latent_v(pool)), table
    codes, sz, table = make_quant_pool(len(lengths), nb, lengths, kvd, gen,
                                       dev)
    return (codes, sz), (codes, sz, *latent_v(codes, sz)), table


def sepv_out_close(out, ref, what):
    """bf16 outputs at the bf16 tolerance, fp32 ones (fp32 q over codes)
    at the fp32 one."""
    import torch
    if out.dtype == torch.float32:
        return f32_close(out, ref, what)
    return bf16_close(out, ref, what)


def check_sepv_decode(q, args, table, lens, *, kvd, tag, errs, key,
                      fused=None, n_splits=None):
    """K3 (K3q) over separate pools, K1 (K1q) under ``n_splits`` (the auto
    plan's when None) with K2, against their plain versions in both modes;
    split(n=1) + K2 == K3 and the auto entry == K1 + K2, bitwise; with
    ``fused`` (the latent pool's fused args), K3 and K1 give the fused
    kernels' bits.  Returns the split count."""
    import torch
    from repro_torch.core.attn_spec import AttnSpec
    from repro_torch.kernels.etap import combine as C
    from repro_torch.kernels.etap import etap as K
    from repro_torch.kernels.etap import ops
    sfx = "" if kvd == "fp" else "_quant"
    dk, dv = q.shape[-1], args[-1 if kvd == "fp" else -2].shape[-1]
    qt = "fp32 q" if q.dtype == torch.float32 else "bf16 q"
    pkw = {} if kvd == "fp" else dict(kv_sz=args[1], v_sz=args[3])
    vpool = args[1] if kvd == "fp" else args[2]
    spec = AttnSpec(scale=dk ** -0.5)
    n = n_splits or ops._paged_n_splits(q, table, PAGE, dv, spec)
    _, _, padded = ops.paged_split_geometry(table.shape[1], n)
    tpad = ops._pad_table(table, padded)
    for mode in ("amla", "mul"):
        t = f"{tag} {kvd} {mode} {qt}"
        kw = dict(scale=dk ** -0.5, rescale=mode)
        out_kw = dict(out_dtype=q.dtype, rescale=mode)
        o3 = getattr(K, f"etap_decode_paged{sfx}")(q, *args, table, lens,
                                                   **kw)
        r3 = getattr(K, f"etap_decode_paged{sfx}_plain")(q, *args, table,
                                                         lens, **kw)
        k3 = key("etap_decode_paged")
        errs[k3] = max(errs[k3], sepv_out_close(o3, r3, f"K3{sfx} {t}"))
        st = ops._paged_partial(q, args[0], dv, table, lens, n_splits=n,
                                v_pool=vpool, **pkw, **kw)
        rs = getattr(K, f"etap_paged_partial_sepv{sfx}_plain")(
            q, *args, tpad, lens, n_splits=n, **kw)
        k1 = key("etap_paged_partial_sepv")
        errs[k1] = max(errs[k1], f32_finalized_close(
            st, rs, f"K1{sfx} {t}", transposed=True)
            if q.dtype == torch.float32 else
            finalized_close(st, rs, f"K1{sfx} {t}"))
        o2 = C.combine_splits(*st, **out_kw)
        sepv_out_close(o2, r3, f"K1{sfx}(n={n})+K2 vs plain K3{sfx} {t}")
        bitwise(C.combine_splits(*ops._paged_partial(
            q, args[0], dv, table, lens, n_splits=1, v_pool=vpool, **pkw,
            **kw), **out_kw), o3, f"K1{sfx}(n=1)+K2 vs K3{sfx} {t}")
        if n_splits is None:
            bitwise(ops.etap_decode_paged_splitkv(
                q, args[0], vpool, table, lens, spec=AttnSpec(
                    scale=dk ** -0.5, rescale=mode),
                k_sz=pkw.get("kv_sz"), v_sz=pkw.get("v_sz")),
                o2 if n > 1 else o3, f"auto plan (n={n}) {t}")
        if fused is not None:
            bitwise(getattr(K, f"etap_decode_mla_paged{sfx}")(
                q, *fused, DV, table, lens, **kw), o3,
                f"K3{sfx} separate V vs fused {t}")
            sf = ops._paged_partial(q, fused[0], DV, table, lens, n_splits=n,
                                    kv_sz=pkw.get("kv_sz"), **kw)
            for a, b in zip(st, sf, strict=True):
                bitwise(a, b, f"K1{sfx} separate V vs fused {t}")
    return n


def check_sepv_prefill(qp, args, table, start, *, kvd, tag, errs, key,
                       fused=None):
    """K4 (K4q) over separate pools, prefill and a tree-shaped verify,
    against their plain versions in both modes; a linear verify ==
    prefill, bitwise; with ``fused``, the fused K4's bits."""
    import torch
    from repro_torch.kernels.etap import etap as K
    sfx = "" if kvd == "fp" else "_quant"
    dk = qp.shape[-1]
    Cq = qp.shape[1]
    dev = qp.device
    qt = "fp32 q" if qp.dtype == torch.float32 else "bf16 q"
    depth = torch.tensor([0] + [1 + (c - 1) // 3 for c in range(1, Cq)],
                         dtype=torch.int32, device=dev)
    tree = start[:, None] + depth[None, :]
    linear = start[:, None] + torch.arange(Cq, dtype=torch.int32,
                                           device=dev)[None, :]
    k4 = key("etap_prefill_paged")
    for mode in ("amla", "mul"):
        t = f"{tag} {kvd} {mode} {qt}"
        kw = dict(scale=dk ** -0.5, rescale=mode)
        out = getattr(K, f"etap_prefill_paged{sfx}")(qp, *args, table, start,
                                                     **kw)
        ref = getattr(K, f"etap_prefill_paged{sfx}_plain")(
            qp, *args, table, start, **kw)
        errs[k4] = max(errs[k4], sepv_out_close(out, ref, f"K4{sfx} {t}"))
        outv = getattr(K, f"etap_verify_paged{sfx}")(qp, *args, table, start,
                                                     tree, **kw)
        refv = getattr(K, f"etap_prefill_paged{sfx}_plain")(
            qp, *args, table, start, qpos=tree, **kw)
        errs[k4] = max(errs[k4], sepv_out_close(outv, refv,
                                                f"K4{sfx} verify(tree) {t}"))
        bitwise(getattr(K, f"etap_verify_paged{sfx}")(
            qp, *args, table, start, linear, **kw), out,
            f"K4{sfx} verify(linear) vs prefill {t}")
        if fused is not None:
            bitwise(getattr(K, f"etap_prefill_mla_paged{sfx}")(
                qp, *fused, DV, table, start, **kw), out,
                f"K4{sfx} separate V vs fused {t}")


# K4 over bf16 pools (etap_prefill.cu: wgmma on the page's 64 rows, units
# of 64 columns of one batch row, or 32 where 64-column units would leave
# SMs idle), at the edges of its tiling: (what, H, Cq, start per row, the
# second row idle on the null block, table columns or 0 for what the
# chunks need).  All but the B 44 case have fewer units than SMs, so units
# of 32 columns run; B 44 rows of 144 columns make 132 units of 64 (as the
# serve shapes do, Cq 256 at the latent and Cq 128 at Granite).  The last
# has horizons past its 3-page table: at Granite's page pairs the walk's
# second step takes a pad page, masked whole.
K4_EDGES = (
    ("H 48 x Cq 3 (144 columns, not a multiple of 64)", 48, 3, (100, 37),
     False, 0),
    ("H 16 x Cq 5 (4 query rows a unit)", 16, 5, (37, 0), False, 0),
    ("start 0, and a horizon mid-page", 128, 4, (0, 81), False, 0),
    ("B 2, the second row idle on the null block", 128, 8, (2000, 0), True,
     0),
    ("B 44 x H 48 x Cq 3 (132 units of 64 columns)", 48, 3,
     tuple(37 * i % 211 for i in range(44)), False, 0),
    ("horizons past a 3-page table (an odd page count)", 48, 4, (200, 70),
     False, 3),
)


def k4_edge_checks(dk, dv, kvd, gen, dev) -> dict:
    """K4 over bf16 pools (``kvd`` "fp") or K4q over int8 / e4m3 pools
    quantized from random rows ("int8", "fp8") at (dk, dv) (the latent,
    fused and with V in its own pool: V the pool's first 512 columns, over
    codes with a copy of K's pairs; Granite's (128, 128) over separate
    pools) at K4_EDGES in both rescale modes, with bf16 q (units of 64 or
    32, the grid's pick) and, over codes, fp32 q (units of 32): prefill and
    a tree-shaped verify against their plain versions (bf16 outputs at the
    bf16 tolerance, fp32 ones at f32_close's); linear verify == prefill
    and, at the latent, separate V == fused, bitwise; both unit widths
    must run with bf16 q.  Returns {"fused": err, "sepv": err} (max
    abs)."""
    import torch
    from repro_torch.kernels.etap import etap as K
    from repro_torch.kernels.etap import ops
    from repro_torch.runtime import paged_cache
    latent, quant = dk == DK, kvd != "fp"
    sfx, name = ("_quant", "K4q") if quant else ("", "K4")
    errs = {"fused": 0.0, "sepv": 0.0}
    widths = set()
    for what, H, Cq, starts, idle, nbt in (K4Q_EDGES if quant else K4_EDGES):
        B = len(starts)
        start = torch.tensor(starts, dtype=torch.int32, device=dev)
        lengths = [st + Cq for st in starts]
        nb = nbt or pages(lengths)
        N = 1 + B * nb
        k = torch.randn(N, PAGE, dk, generator=gen, device=dev)
        if quant:                          # (k, k_sz, v, v_sz)
            kc, ks = paged_cache.quantize_rows(k, kvd)
            pools = (kc, ks, *(latent_v(kc, ks) if latent else
                               paged_cache.quantize_rows(torch.randn(
                                   N, PAGE, dv, generator=gen, device=dev),
                                   kvd)))
            fpools = (kc, ks)
        else:                              # (k, v)
            k = k.to(torch.bfloat16)
            pools = (k, k[..., :dv].contiguous() if latent else torch.randn(
                N, PAGE, dv, generator=gen, device=dev).to(torch.bfloat16))
            fpools = (k,)
        table = (torch.randperm(N - 1, generator=gen, device=dev) + 1
                 ).reshape(B, nb).to(torch.int32)
        for b, n in enumerate(lengths):
            table[b, -(-n // PAGE):] = 0
        if idle:
            table[1:] = 0
        qf = torch.randn(B, Cq, H, dk, generator=gen, device=dev)
        depth = torch.tensor([0] + [1 + (c - 1) // 3 for c in range(1, Cq)],
                             dtype=torch.int32, device=dev)
        tree = start[:, None] + depth[None, :]
        linear = start[:, None] + torch.arange(Cq, dtype=torch.int32,
                                               device=dev)[None, :]
        # the kernel's pick (etap_prefill.cu: unit_cols; fp32 q: 32)
        units = 64 if B * -(-Cq * H // 64) >= ops.num_cores(dev) else 32
        widths.add(units)
        args, fargs = (*pools, table, start), (*fpools, DV, table, start)
        for q in (qf.to(torch.bfloat16), qf) if quant else \
                (qf.to(torch.bfloat16),):
            u = units if q.dtype == torch.bfloat16 else 32
            qt = "bf16 q" if q.dtype == torch.bfloat16 else "fp32 q"
            for mode in ("amla", "mul"):
                kw = dict(scale=dk ** -0.5, rescale=mode)
                tag = (f"{name} ({dk}, {dv}) {kvd} {qt} {what}, units of "
                       f"{u}, {mode}")
                sep = getattr(K, f"etap_prefill_paged{sfx}")(q, *args, **kw)
                plain = getattr(K, f"etap_prefill_paged{sfx}_plain")
                e = sepv_out_close(sep, plain(q, *args, **kw),
                                   f"{tag}, separate V")
                e = max(e, sepv_out_close(
                    getattr(K, f"etap_verify_paged{sfx}")(q, *args, tree,
                                                          **kw),
                    plain(q, *args, qpos=tree, **kw),
                    f"{tag}, separate V, verify(tree)"))
                errs["sepv"] = max(errs["sepv"], e)
                bitwise(getattr(K, f"etap_verify_paged{sfx}")(
                    q, *args, linear, **kw), sep,
                    f"{tag}, separate V, verify(linear) vs prefill")
                if not latent:
                    continue
                fused = getattr(K, f"etap_prefill_mla_paged{sfx}")(
                    q, *fargs, **kw)
                plain = getattr(K, f"etap_prefill_mla_paged{sfx}_plain")
                e = sepv_out_close(fused, plain(q, *fargs, **kw),
                                   f"{tag}, fused")
                e = max(e, sepv_out_close(
                    getattr(K, f"etap_verify_mla_paged{sfx}")(
                        q, *fargs, tree, **kw),
                    plain(q, *fargs, qpos=tree, **kw),
                    f"{tag}, fused, verify(tree)"))
                errs["fused"] = max(errs["fused"], e)
                bitwise(getattr(K, f"etap_verify_mla_paged{sfx}")(
                    q, *fargs, linear, **kw), fused,
                    f"{tag}, fused, verify(linear) vs prefill")
                bitwise(sep, fused, f"{tag}, separate V vs fused")
            if u == 64:
                unit_width_bits(
                    f"{name} ({dk}, {dv}) {kvd} {qt}", sep,
                    lambda q=q: getattr(K, f"etap_prefill_paged{sfx}")(
                        q[:1], *pools, table[:1], start[:1],
                        scale=dk ** -0.5, rescale="mul"))
        log(f"[{name.lower()}] ({dk}, {dv}) {kvd} {what}, units of {units}"
            + (" (bf16 q) and 32 (fp32 q)" if quant else "") + ": prefill "
            "and tree verify within tolerance of their plain versions in "
            "both modes; linear verify == prefill"
            + (", separate V == fused" if latent else "") + " bitwise")
    if widths != {64, 32}:
        raise AssertionError(f"{name} ({dk}, {dv}) {kvd} edges ran units of "
                             f"{widths} only: both widths must run")
    return errs


def unit_width_bits(what, out, alone, wide=64, narrow=32) -> bool:
    """Whether a column's bits depend on the unit width: ``out`` (a call
    whose units are ``wide`` columns wide, its last mode "mul") against
    ``alone()``, its first batch row on its own (fewer units than SMs, so
    units of ``narrow``), compared bitwise and logged; the serve contracts
    that could see a difference (prefix cache on / off, whose chunks start
    at other rows and so may split a batch differently) are named in
    PERF.md."""
    import torch
    a, b = out[:1], alone()

    def bits(x):
        return x.view(torch.int16 if x.element_size() == 2 else torch.int32)
    same = bool(torch.equal(bits(a), bits(b)))
    log(f"[unit width] {what}: a row in units of {wide} columns "
        + ("== " if same else "!= ") + f"the same row alone in units of "
        f"{narrow}, bitwise (max abs diff {float((a.float() - b.float()).abs().max()):.3e})")
    return same


# K4q, K4 over int8 / e4m3 code pools (etap_prefill.cu: the same kernel over
# code boxes the producer warpgroup's other warps widen to bf16), at the same
# edges of its tiling as K4 (k4_edge_checks), with bf16 q (units of 64 or
# 32, the grid's pick) and with fp32 q (units of 32 always).
K4Q_EDGES = K4_EDGES


def k4q_widen_check(dev) -> None:
    """Every code value through K4q's widening, exactly: a latent code pool
    whose block 1, row 0 holds each byte value (int8 -128..127; e4m3 all
    but its two NaN codes, 0 in their place) twice over the 512 V columns,
    its pairs (1, 0); a one-row chunk at start 0 with fp32 q in the "mul"
    rescale mode (one live row: p = exp(0) = 1, the output is that row)
    gives the codes' values, bitwise the plain version's dequantized row,
    fused and with V in its own pool."""
    import torch
    from repro_torch.kernels.etap import etap as K
    for kvd, dt in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        raw = torch.arange(256, device=dev).to(torch.uint8)
        if kvd == "fp8":
            raw[(raw & 0x7F) == 0x7F] = 0
        codes = torch.zeros(2, PAGE, DK, dtype=torch.uint8, device=dev)
        codes[1, 0] = torch.cat([raw, raw, raw[:DK - 2 * 256]])
        codes = codes.view(dt)
        sz = torch.zeros(2, PAGE, 2, device=dev)
        sz[..., 0] = 1.0
        table = torch.ones(1, 1, dtype=torch.int32, device=dev)
        start = torch.zeros(1, dtype=torch.int32, device=dev)
        q = torch.ones(1, 1, 16, DK, device=dev)
        kw = dict(scale=SCALE, rescale="mul")
        out = K.etap_prefill_mla_paged_quant(q, codes, sz, DV, table, start,
                                             **kw)
        ref = K.etap_prefill_mla_paged_quant_plain(q, codes, sz, DV, table,
                                                   start, **kw)
        bad = (out != ref).nonzero()
        if bad.numel():
            i = tuple(bad[0].tolist())
            raise AssertionError(
                f"K4q widening {kvd}: {bad.shape[0]} values differ, first "
                f"at {i} (code byte {int(raw[i[-1] % 256])}): "
                f"{float(out[i])} against {float(ref[i])}")
        bitwise(K.etap_prefill_paged_quant(q, codes, sz, *latent_v(codes, sz),
                                           table, start, **kw), out,
                f"K4q widening {kvd}, separate V")
        log(f"[k4q] widening {kvd}: every code value exact (bitwise the "
            "plain version's dequantized row), fused and separate V")


def chunk_oracle(q, k, v, start, scale):
    """fp64 attention of a chunk q [B, Cq, H, Dk] over the rows k [B, S,
    Dk], v [B, S, Dv]: column (c, h) of row b attends to rows <= start[b] +
    c.  Returns [B, Cq, H, Dv] fp64."""
    import torch
    q, k, v = q.double(), k.double(), v.double()
    Cq, S = q.shape[1], k.shape[1]
    s = torch.einsum("bchd,bsd->bchs", q, k) * scale
    live = (torch.arange(S, device=q.device)[None, None, :]
            <= (start[:, None] + torch.arange(Cq, device=q.device)[None, :])
            [:, :, None])[:, :, None, :]
    p = torch.softmax(s.masked_fill(~live, float("-inf")), dim=-1)
    return torch.einsum("bchs,bsv->bchv", p, v)


def k4q_rmse(q, args, table, start, rows, kvd, tag, *, rescale=None,
             fused=None, strict=False):
    """K4q with fp32 q over code pools ``args`` (k, k_sz, v, v_sz: the
    separate-V entry's; ``fused`` the fused entry's (codes, sz) over the
    same rows) against the fp64 oracle on the unquantized rows ``rows``
    (K's and V's fp32 pools): RMSE within the reference's gate (``strict``)
    or, where the reference's own route (the plain version) misses it,
    within 1% above that route's RMSE; within f32_close of the plain
    version; the fused entry bitwise the separate-V one.  Returns the
    kernel's RMSE."""
    from repro_torch.kernels.etap import etap as K
    from repro_torch.runtime.paged_cache import gather_blocks
    dk = q.shape[-1]
    kw = dict(scale=dk ** -0.5, rescale=rescale)
    k, v = (gather_blocks(r, table) for r in rows)
    oracle = chunk_oracle(q, k, v, start, dk ** -0.5)
    plain = K.etap_prefill_paged_quant_plain(q, *args, table, start, **kw)
    out = K.etap_prefill_paged_quant(q, *args, table, start, **kw)
    f32_close(out, plain, f"K4q {tag} {kvd} fp32 q")
    if fused is not None:
        bitwise(K.etap_prefill_mla_paged_quant(q, *fused, DV, table, start,
                                               **kw), out,
                f"K4q {tag} {kvd} fp32 q, fused vs separate V")
    pr = float(((plain.double() - oracle) ** 2).mean().sqrt())
    r = float(((out.double() - oracle) ** 2).mean().sqrt())
    gate = QUANT_RMSE[kvd]
    limit = gate if strict or pr <= gate else pr * 1.01
    log(f"[quant] RMSE K4q {tag} {kvd} fp32 q: {r:.4e}, the reference's "
        f"route (plain) {pr:.4e}, gate {gate:.3e}, limit {limit:.4e}")
    if not r <= limit:
        raise AssertionError(f"K4q {tag} {kvd}: RMSE {r:.4e} against the "
                             f"fp64 oracle exceeds {limit:.4e}")
    return r


def k4_attrs() -> None:
    """An [attrs] line for each K4 instance over bf16 pools and each K4q
    instance over code pools (bf16 q at each unit width, fp32 q at 32);
    fails on local memory (spills)."""
    for dk, dv, sepv in ((DK, DV, 0), (DK, DV, 1), (HD, HD, 1)):
        kind = "separate V" if sepv else "fused"
        for what, fn, cols, extra in (
                ("K4", "etap_prefill_attrs", 64, ()),
                ("K4", "etap_prefill_attrs", 32, ()),
                ("K4q bf16 q", "etap_prefill_quant_attrs", 64, (0,)),
                ("K4q bf16 q", "etap_prefill_quant_attrs", 32, (0,)),
                ("K4q fp32 q", "etap_prefill_quant_attrs", 32, (1,))):
            regs, smem, local = attr_values(fn, dk, dv, sepv, cols, *extra)
            log(f"[attrs] {what} ({dk}, {dv}) {kind}, units of {cols}: "
                f"{regs} registers, {smem} B shared memory, {local} B local")
            if local:
                raise AssertionError(f"{what} ({dk}, {dv}) {kind} units of "
                                     f"{cols}: {local} B of local memory")


def sdpa_chunk(qp, k, v, start, scale):
    """Yardstick for a paged chunk: one SDPA call (enable_gqa, a causal
    chunk mask) over the rows the table gathered, before the timing."""
    import torch
    Cq, S = qp.shape[1], k.shape[1]
    dev = qp.device
    mask = (torch.arange(S, device=dev)[None, None, :]
            <= (start[:, None] + torch.arange(Cq, device=dev)[None, :])
            [:, :, None])[:, None]
    qd = qp.transpose(1, 2)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qd, k[:, None], v[:, None], attn_mask=mask, scale=scale,
        enable_gqa=True)


def k4_timing(gen, dev, iters: int, piters: int) -> None:
    """K4 at serve-long's chunk (B 1, Cq 256 from start 3840, H 128, the
    latent's 64 pages), fused and with V in its own pool, each beside its
    achieved TFLOP/s, its plain version's time, its bound and SDPA's (Cq
    32's line and Granite's are phase_kernels' and phase_sepv_kernels')."""
    import torch
    from repro_torch.kernels.etap import etap as K
    nb = 4096 // PAGE
    pool, table = make_pool(1, nb, [nb * PAGE], gen, dev)
    vpool = latent_v(pool)
    Cq, s0 = 256, 3840
    start = torch.tensor([s0], dtype=torch.int32, device=dev)
    qp = torch.randn(1, Cq, 128, DK, generator=gen, device=dev).to(
        torch.bfloat16)
    flops = 2 * sum(s0 + c + 1 for c in range(Cq)) * 128 * (DK + DV)
    kd = pool[table.long()].reshape(1, nb * PAGE, DK)[:, :s0 + Cq]
    tl = cuda_time_ms(sdpa_chunk(qp, kd, kd[..., :DV], start, SCALE), iters)
    for what, call, plain, v_bytes in (
            ("fused", lambda: K.etap_prefill_mla_paged(
                qp, pool, DV, table, start, scale=SCALE),
             lambda: K.etap_prefill_mla_paged_plain(
                 qp, pool, DV, table, start, scale=SCALE), 0),
            ("separate V", lambda: K.etap_prefill_paged(
                qp, pool, vpool, table, start, scale=SCALE),
             lambda: K.etap_prefill_paged_plain(
                 qp, pool, vpool, table, start, scale=SCALE), DV * 2)):
        nbytes = (qp.numel() * 2 + (s0 + Cq) * (DK * 2 + v_bytes)
                  + Cq * 128 * DV * 2)
        tb, by = bound_ms(nbytes, flops)
        t = cuda_time_ms(call, iters)
        tp = cuda_time_ms(plain, piters, warmup=1)
        log(f"[timing] K4 {what} B=1 Cq={Cq} H=128 start={s0}: {t:.4f} ms "
            f"({flops / t / 1e9:.1f} TFLOP/s), plain {tp:.4f} ms, bound "
            f"{tb:.4f} ms ({by}), SDPA {tl:.4f} ms")


def granite_paged_is_dense(q, args, table, lens, kvd, tag):
    """Paged == dense, bitwise, at block-aligned lengths: K3 (K3q) over the
    pools against K5 (K5q) on the gathered rows with block = page, and K1
    (K1q, n = 4) against K6 (K6q) under the same split plan."""
    from repro_torch.kernels.etap import etap as K
    from repro_torch.kernels.etap.schedule import dense_split_plan
    from repro_torch.runtime.paged_cache import gather_blocks
    quant = kvd != "fp"
    sfx = "_quant" if quant else ""
    k, v = gather_blocks(args[0], table), gather_blocks(args[-2 if quant
                                                             else -1], table)
    dkw = {}
    if quant:
        dkw = dict(k_sz=gather_blocks(args[1], table),
                   v_sz=gather_blocks(args[3], table))
    kw = dict(scale=HD ** -0.5)
    bitwise(getattr(K, f"etap_decode_paged{sfx}")(q, *args, table, lens,
                                                  **kw),
            getattr(K, f"etap_decode_dense{sfx}")(q, k, v, lens, block=PAGE,
                                                  **dkw, **kw),
            f"K3{sfx} paged vs K5{sfx} dense {tag}")
    st = getattr(K, f"etap_paged_partial_sepv{sfx}")(
        q, *args, table, lens, n_splits=4, **kw)
    sd = getattr(K, f"etap_partial_dense{sfx}")(
        q, k, v, lens, plan=dense_split_plan(k.shape[1], PAGE, 4), **dkw,
        **kw)
    for a, b in zip(st, sd, strict=True):
        bitwise(a, b, f"K1{sfx} paged vs K6{sfx} dense {tag}")


def granite_rmse(q, args, table, lens, rows, kvd, tag):
    """K3q over Granite's code pools and K1q + K2 under the auto plan, fp32
    q, against the fp64 oracle on the unquantized rows.  At these ragged
    lengths (a one-key row decodes one V row's quantization error) the
    reference's own route is above its gate, so the gate is the
    reference's where that route meets it, else 1% above that route's
    RMSE (the rule of phase_quant_dense_kernels)."""
    import torch
    from repro_torch.core.attn_spec import AttnSpec
    from repro_torch.kernels.etap import etap as K
    from repro_torch.kernels.etap import ops
    from repro_torch.kernels.etap.ref import etap_decode_ref
    from repro_torch.runtime.paged_cache import gather_blocks
    k, v = (gather_blocks(r, table) for r in rows)
    oracle = etap_decode_ref(q.double(), k.double(), v.double(), lens,
                             scale=HD ** -0.5, dtype=torch.float64)
    kw = dict(scale=HD ** -0.5)
    plain = K.etap_decode_paged_quant_plain(q, *args, table, lens, **kw)
    pr = float(((plain.double() - oracle) ** 2).mean().sqrt())
    gate = QUANT_RMSE[kvd]
    limit = gate if pr <= gate else pr * 1.01
    for what, out in (
            ("K3q", K.etap_decode_paged_quant(q, *args, table, lens, **kw)),
            ("K1q+K2 auto", ops.etap_decode_paged_splitkv(
                q, args[0], args[2], table, lens, spec=AttnSpec(**kw),
                k_sz=args[1], v_sz=args[3]))):
        r = float(((out.double() - oracle) ** 2).mean().sqrt())
        log(f"[sepv] RMSE {what} {tag} {kvd} fp32 q: {r:.4e}, the "
            f"reference's route (plain) {pr:.4e}, gate {gate:.3e}, limit "
            f"{limit:.4e}")
        if not r <= limit:
            raise AssertionError(f"{what} {tag} {kvd}: RMSE {r:.4e} against "
                                 f"the fp64 oracle exceeds {limit:.4e}")


def sepv_entry_path(dev, gen) -> dict:
    """This slice's path: core.etap's paged entries with a v_pool, in both
    modes, over fp, int8 and fp8 pools, at Granite's MQA shapes (decode
    with the auto plan and one split, prefill and verify at Cq 16) and at
    the latent's timed shapes (B 8 ~4K ragged; Cq 32): every launch count
    zeroed just before each (width, code type) group and read just after,
    and each output held to the same call through the plain versions.
    Returns {entry: launches}."""
    import torch
    from repro_torch.core import etap as core
    from repro_torch.core.attn_spec import AttnSpec
    from repro_torch.kernels.etap import etap as K
    launches = {k: 0 for k in SEPV_KERNELS}
    fd_names = ("flash_decode", "flash_decode_partial", "flash_decode_quant",
                "flash_decode_partial_quant")
    for (dk, dv), kvd in [(w, c) for w in SEPV_WIDTHS
                          for c in ("fp", "int8", "fp8")]:
        sfx = "" if kvd == "fp" else "_quant"
        if dk == HD:
            q, args, table, lens, _ = granite_case(kvd, GRANITE_LENGTHS, gen,
                                                   dev)
            Cq, start = 16, torch.tensor([GRANITE_LENGTHS[0] - 16, 0],
                                         dtype=torch.int32, device=dev)
            ptable = table[:2]
        else:
            _, args, table = latent_case(kvd, LATENT_TIMED,
                                         pages(LATENT_TIMED), gen, dev)
            lens = torch.tensor(LATENT_TIMED, dtype=torch.int32, device=dev)
            q = torch.randn(len(LATENT_TIMED), 128, DK, generator=gen,
                            device=dev).to(torch.bfloat16)
            Cq, start = 32, torch.tensor([LATENT_TIMED[0] - 32],
                                         dtype=torch.int32, device=dev)
            ptable = table[:1]
        qp = torch.randn(start.shape[0], Cq, q.shape[1], dk, generator=gen,
                         device=dev).to(q.dtype)
        qpos = start[:, None] + torch.arange(Cq, dtype=torch.int32,
                                             device=dev)[None, :] // 2
        pools = pool_kw(args)
        plain_k4 = getattr(K, f"etap_prefill_paged{sfx}_plain")
        calls = []                          # (what, entry call, plain call)
        for mode in ("etap", "standard"):
            for kv_splits in (None, 1):
                spec = AttnSpec(scale=dk ** -0.5, mode=mode,
                                kv_splits=kv_splits)

                def decode(spec=spec):
                    return core.decode_attention_paged(
                        q, table=table, lengths=lens, spec=spec, **pools)
                calls.append((f"decode {mode} kv_splits={kv_splits}", decode,
                              None))
        spec = AttnSpec(scale=dk ** -0.5)
        calls.append(("prefill", lambda: core.prefill_attention_paged(
            qp, table=ptable, start=start, spec=spec, **pools),
            lambda: plain_k4(qp, *args, ptable, start, scale=dk ** -0.5)))
        calls.append(("verify", lambda: core.verify_attention_paged(
            qp, table=ptable, start=start, qpos=qpos, spec=spec, **pools),
            lambda: plain_k4(qp, *args, ptable, start, scale=dk ** -0.5,
                             qpos=qpos)))
        for fn in counters().values():
            fn.launches = 0
        outs = [call() for _, call, _ in calls]
        torch.cuda.synchronize()
        got = {k: fn.launches for k, fn in counters().items()}
        err = 0.0
        with plain_kernels():              # decode: the entry, plain
            for (what, call, plain), out in zip(calls, outs, strict=True):
                err = max(err, sepv_out_close(
                    out, (plain or call)(),
                    f"entry {what} ({dk}, {dv}) {kvd}"))
        for k, (_, _, wrapper, w, code) in SEPV_KERNELS.items():
            if (w, code) == ((dk, dv), kvd):
                launches[k] = got[wrapper]
                if not got[wrapper]:
                    raise AssertionError(f"entry path ({dk}, {dv}) {kvd}: "
                                         f"{wrapper} did not launch")
        if not any(got[n] for n in fd_names):
            raise AssertionError(f"entry path ({dk}, {dv}) {kvd}: the "
                                 "standard mode launched no baseline kernel")
        log(f"[sepv] entry path ({dk}, {dv}) {kvd} q {q.dtype}: "
            f"{len(calls)} calls (decode etap / standard x auto / 1 split, "
            f"prefill, verify Cq={Cq}), within tolerance of their plain "
            f"routes (max abs err {err:.3e}); launches "
            f"{ {k: v for k, v in got.items() if v} }")
    return launches


def phase_sepv_kernels(quick: bool, report: dict, launches: dict) -> None:
    """K3, K1 + K2 and K4 over separate K and V pools, and their quantized
    twins over int8 / fp8 code pools each with its own (scale, zp) pool, at
    (576, 512) and (128, 128), in both rescale modes, against their plain
    versions: the latent with V = pool[..., :512] as its own pool at
    serve-long's decode shapes (4 / 7 slots, idle rows on the null block,
    a 65-column table padded to 68: 4 splits of 17), serve-short's (B 8,
    9 pages, one split) and K4 at Cq 256 from start 0 and 3840, bitwise
    the fused kernels there; Granite-20B's MQA pools (q [8, 48, 128], a
    shuffled 32-column table, ragged lengths) with the auto plan and one
    split, K4 at Cq 128 (6,144 columns), paged == dense bitwise at
    block-aligned lengths, and the RMSE of the code pools against the
    fp64 oracle; then each instance's registers, its time beside its
    plain version's, its bound and SDPA's, the fused kernels beside at
    the latent, and the paper's geometry (B 16, H 16, context 65,536)
    fused against separate V through K1 + K2, timed only; then this
    slice's path, the paged attention entries (sepv_entry_path), whose
    launches go to ``launches``."""
    import torch
    from repro_torch.core.attn_spec import AttnSpec
    from repro_torch.kernels.etap import etap as K
    from repro_torch.kernels.etap import ops
    from repro_torch.runtime.paged_cache import gather_blocks
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    errs = {k: QUANT_EDGE_ERRS.get(k, 0.0) for k in SEPV_KERNELS}
    codes = ("fp", "int8", "fp8")

    def keyf(dk, dv, kvd):
        sfx = "" if kvd == "fp" else "_quant"
        tail = "" if kvd == "fp" else f",{kvd}"
        return lambda w: f"{w}{sfx}[{dk},{dv}{tail}]"

    for dk, dv in SEPV_WIDTHS:
        for code, qf in ((-1, 0), (0, 0), (0, 1), (1, 0), (1, 1)):
            what = {-1: "bf16", 0: "int8", 1: "fp8"}[code] + \
                (" fp32 q" if qf else "")
            log(f"[attrs] separate V ({dk}, {dv}) {what}: "
                + ("K3 " if code < 0 else "K3q ")
                + instance_attrs("etap_paged_sepv_attrs", dk, dv, 0, code, qf)
                + "; K1 "
                + instance_attrs("etap_paged_sepv_attrs", dk, dv, 1, code,
                                 qf))

    k4_attrs()

    # ---- K4 over bf16 pools and K4q over int8 / e4m3 pools at the edges
    #      of their tiling
    for kvd in codes:
        for dk, dv in SEPV_WIDTHS:
            got = k4_edge_checks(dk, dv, kvd, gen, dev)
            k4 = keyf(dk, dv, kvd)("etap_prefill_paged")
            errs[k4] = max(errs[k4], got["sepv"])
            if dk == DK:
                rep = report["etap_prefill_mla_paged" + (
                    "" if kvd == "fp" else f"_quant[{kvd}]")]
                rep["max_abs_err"] = max(rep["max_abs_err"], got["fused"])

    # ---- the latent, V in its own pool: the fused kernels' bits
    for kvd in codes:
        key = keyf(DK, DV, kvd)
        quant = kvd != "fp"
        lengths = SEPV_LONG + ([1, 1, 1] if quant else [])
        fused, args, table = latent_case(kvd, lengths, pages(lengths), gen,
                                         dev)
        table[4:] = 0                      # idle slots read the null block
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        q = torch.randn(len(lengths), 128, DK, generator=gen,
                        device=dev).to(torch.bfloat16)
        n = check_sepv_decode(q, args, table, lens, kvd=kvd,
                              tag="serve-long", errs=errs, key=key,
                              fused=fused)
        if n != 4:
            raise AssertionError(f"serve-long {kvd}: the auto plan has {n} "
                                 "splits, not serve-long's 4")
        fused, args, table = latent_case(kvd, SEPV_SHORT, pages(SEPV_SHORT),
                                         gen, dev)
        lens = torch.tensor(SEPV_SHORT, dtype=torch.int32, device=dev)
        q = torch.randn(8, 128, DK, generator=gen, device=dev).to(
            torch.bfloat16)
        n = check_sepv_decode(q, args, table, lens, kvd=kvd,
                              tag="serve-short", errs=errs, key=key,
                              fused=fused)
        if n != 1:
            raise AssertionError(f"serve-short {kvd}: the auto plan has {n} "
                                 "splits, not one")
        fused, args, table = latent_case(kvd, SEPV_LONG[:1],
                                         pages(SEPV_LONG), gen, dev)
        qp = torch.randn(1, SEPV_CQ, 128, DK, generator=gen, device=dev).to(
            torch.bfloat16)
        for s0 in SEPV_STARTS:
            check_sepv_prefill(qp, args, table,
                               torch.tensor([s0], dtype=torch.int32,
                                            device=dev),
                               kvd=kvd, tag=f"Cq={SEPV_CQ} start={s0}",
                               errs=errs, key=key, fused=fused)
        log(f"[sepv] latent {kvd}: K3, K1 (n=4) + K2 at serve-long's shapes "
            f"and K3 at serve-short's, K4 at Cq {SEPV_CQ} (start "
            f"{SEPV_STARTS}): ok "
            "against their plain versions in both modes; bitwise the fused "
            "kernels; auto plan, split(n=1)+K2 and linear verify bitwise")

    # ---- Granite-20B's MQA pools
    for kvd in codes:
        key = keyf(HD, HD, kvd)
        q, args, table, lens, rows = granite_case(kvd, GRANITE_LENGTHS, gen,
                                                  dev)
        n = check_sepv_decode(q, args, table, lens, kvd=kvd, tag="granite",
                              errs=errs, key=key)
        check_sepv_decode(q, args, table, lens, kvd=kvd,
                          tag="granite one split", errs=errs, key=key,
                          n_splits=1)
        if kvd != "fp":                    # the other q type, once
            qb = q.to(torch.bfloat16)
            sepv_out_close(K.etap_decode_paged_quant(qb, *args, table, lens,
                                                     scale=HD ** -0.5),
                           K.etap_decode_paged_quant_plain(
                               qb, *args, table, lens, scale=HD ** -0.5),
                           f"K3q granite {kvd} bf16 q")
            granite_rmse(q, args, table, lens, rows, kvd, "granite")
        qp = torch.randn(2, GRANITE_CQ, GRANITE_H, HD, generator=gen,
                         device=dev).to(q.dtype)
        gst = torch.tensor(GRANITE_STARTS, dtype=torch.int32, device=dev)
        check_sepv_prefill(qp, args, table[:2], gst, kvd=kvd,
                           tag=f"granite Cq={GRANITE_CQ}", errs=errs,
                           key=key)
        if kvd != "fp":                    # fp32 q, the fp64 oracle
            k4q_rmse(qp, args, table[:2], gst, rows, kvd,
                     f"granite Cq={GRANITE_CQ}")
        qa, aargs, atable, alens, _ = granite_case(kvd, GRANITE_ALIGNED, gen,
                                                   dev)
        granite_paged_is_dense(qa, aargs, atable, alens, kvd,
                               "granite aligned")
        log(f"[sepv] granite {kvd} q {q.dtype}: K3, K1 (auto plan: {n} "
            f"splits) + K2 and one split, K4 at Cq {GRANITE_CQ}: ok "
            "against their plain versions in both modes; paged == dense "
            "bitwise at block-aligned lengths (K3 == K5, K1 == K6)"
            + ("" if kvd == "fp" else "; RMSE within its limit"))

    # ---- timing: each instance beside its plain version, bound, SDPA
    iters, piters = (1, 1) if quick else (20, 3)
    for (dk, dv), kvd in [(w, c) for w in SEPV_WIDTHS for c in codes]:
        key = keyf(dk, dv, kvd)
        quant = kvd != "fp"
        sfx = "_quant" if quant else ""
        if dk == DK:
            nb = pages(LATENT_TIMED)
            fused, args, table = latent_case(kvd, LATENT_TIMED, nb, gen, dev)
            lens = torch.tensor(LATENT_TIMED, dtype=torch.int32, device=dev)
            q = torch.randn(len(LATENT_TIMED), 128, DK, generator=gen,
                            device=dev).to(torch.bfloat16)
            Cq, start = 32, torch.tensor([nb * PAGE - 32], dtype=torch.int32,
                                         device=dev)
            pfused, pargs, ptable = latent_case(kvd, [nb * PAGE], nb, gen,
                                                dev)
            qp = torch.randn(1, Cq, 128, DK, generator=gen, device=dev).to(
                torch.bfloat16)
            n = 4
        else:
            fused = None
            q, args, table, lens, _ = granite_case(kvd, GRANITE_LENGTHS, gen,
                                                   dev)
            n = ops._paged_n_splits(q, table, PAGE, HD,
                                    AttnSpec(scale=HD ** -0.5))
            Cq, start = GRANITE_CQ, torch.tensor(
                GRANITE_STARTS, dtype=torch.int32, device=dev)
            pargs, ptable = args, table[:2]
            qp = torch.randn(2, Cq, GRANITE_H, HD, generator=gen,
                             device=dev).to(q.dtype)
        B, H = q.shape[:2]
        _, _, padded = ops.paged_split_geometry(table.shape[1], n)
        tpad = ops._pad_table(table, padded)
        keys = int(lens.sum())
        row_b = dk + dv + (16 if quant else (dk + dv))  # K, V (+ 2 pairs)
        q_b, out_b = q.numel() * q.element_size(), B * H * dv * \
            q.element_size()
        stats_b = B * n * H * (dv + 2) * 4
        flops = 2 * keys * H * (dk + dv)
        pcols = [int(s) + c + 1 for s in start.tolist() for c in range(Cq)]
        keys_p = sum(pcols) * qp.shape[2]
        prow = int(start.max()) + Cq
        p_bytes = (qp.numel() * qp.element_size()
                   + sum(int(s) + Cq for s in start.tolist()) * row_b
                   + qp.numel() // dk * dv * qp.element_size())
        kw = dict(scale=dk ** -0.5)
        dec = (q, *args, table, lens)
        cases = {
            "etap_decode_paged": (lambda f: f(*dec, **kw),
                                  bound_ms(q_b + keys * row_b + out_b,
                                           flops)),
            "etap_paged_partial_sepv": (
                lambda f: f(q, *args, tpad, lens, n_splits=n, **kw),
                bound_ms(q_b + keys * row_b + stats_b, flops)),
            "etap_prefill_paged": (
                lambda f: f(qp, *pargs, ptable, start, **kw),
                bound_ms(p_bytes, 2 * keys_p * (dk + dv))),
        }
        lib = {"etap_decode_paged": None, "etap_paged_partial_sepv": None,
               "etap_prefill_paged": None}
        if not quant:                       # SDPA on the gathered rows
            kd, vd = (gather_blocks(x, table) for x in args)
            mask = (torch.arange(kd.shape[1], device=dev)[None, :]
                    < lens[:, None])[:, None, None, :]
            qd = q[:, :, None, :]
            lib["etap_decode_paged"] = lambda: \
                torch.nn.functional.scaled_dot_product_attention(
                    qd, kd[:, None], vd[:, None], attn_mask=mask,
                    scale=dk ** -0.5, enable_gqa=True)
            kp, vp = (gather_blocks(x, ptable)[:, :prow] for x in pargs)
            lib["etap_prefill_paged"] = sdpa_chunk(qp, kp, vp, start,
                                                   dk ** -0.5)
        shapes = {"etap_decode_paged": f"B={B} H={H} ctx<={max(lens.tolist())}"
                  " ragged", "etap_paged_partial_sepv": f"B={B} H={H} "
                  f"n_splits={n}", "etap_prefill_paged":
                  f"B={start.shape[0]} Cq={Cq} H={qp.shape[2]} "
                  f"start={start.tolist()}"}
        for wrapper, (call, (tb, by)) in cases.items():
            fn = getattr(K, wrapper + sfx)
            plain = getattr(K, wrapper + sfx + "_plain")
            t = cuda_time_ms(lambda: call(fn), iters)
            tp = cuda_time_ms(lambda: call(plain), piters, warmup=1)
            tl = cuda_time_ms(lib[wrapper], iters) if lib[wrapper] else None
            k = key(wrapper)
            extra = ""
            if fused is not None:           # the fused kernel, in turns
                ffn = {"etap_decode_paged":
                       lambda: getattr(K, f"etap_decode_mla_paged{sfx}")(
                           q, *fused, DV, table, lens, **kw),
                       "etap_paged_partial_sepv":
                       lambda: getattr(K, f"etap_paged_partial{sfx}")(
                           q, *fused, DV, tpad, lens, n_splits=n, **kw),
                       "etap_prefill_paged":
                       lambda: getattr(K, f"etap_prefill_mla_paged{sfx}")(
                           qp, *pfused, DV, ptable, start, **kw)}[wrapper]
                tf = [cuda_time_ms(ffn, iters),
                      cuda_time_ms(lambda: call(fn), iters)]
                tf += [cuda_time_ms(lambda: call(fn), iters),
                       cuda_time_ms(ffn, iters)]
                tfused, tsep = (tf[0] + tf[3]) / 2, (tf[1] + tf[2]) / 2
                extra = (f"; fused {tfused:.4f} ms, separate V in turns "
                         f"{tsep:.4f} ms: {tsep / tfused:.2f}x")
            lname = "null" if tl is None else f"{tl:.4f}"
            if wrapper == "etap_prefill_paged":
                extra = (f"; {2 * keys_p * (dk + dv) / t / 1e9:.1f} TFLOP/s"
                         + extra)
            log(f"[timing] {k} ({shapes[wrapper]}): {t:.4f} ms, plain "
                f"{tp:.4f} ms, bound {tb:.4f} ms ({by}), library {lname} ms"
                + extra)
            report[k] = {"max_abs_err": errs[k], "ms": t, "plain_ms": tp,
                         "bound_ms": tb, "bound_by": by, "library_ms": tl}

    # ---- the paper's geometry, fused against separate V, timed only
    Bp, Hp, ctx = PAPER
    nbp = ctx // PAGE
    pool, table = make_pool(Bp, nbp, [ctx] * Bp, gen, dev)
    vpool = latent_v(pool)
    lens = torch.full((Bp,), ctx, dtype=torch.int32, device=dev)
    q = torch.randn(Bp, Hp, DK, generator=gen, device=dev).to(torch.bfloat16)
    spec = AttnSpec(scale=SCALE)
    n = ops._paged_n_splits(q, table, PAGE, DV, spec)

    def fused_call():
        return ops.etap_decode_mla_paged_splitkv(q, pool, DV, table, lens,
                                                 spec=spec)

    def sep_call():
        return ops.etap_decode_paged_splitkv(q, pool, vpool, table, lens,
                                             spec=spec)
    bitwise(sep_call(), fused_call(), "paper geometry separate V vs fused")
    pit = 1 if quick else 10
    ts = [cuda_time_ms(fused_call, pit), cuda_time_ms(sep_call, pit),
          cuda_time_ms(sep_call, pit), cuda_time_ms(fused_call, pit)]
    tfu, tse = (ts[0] + ts[3]) / 2, (ts[1] + ts[2]) / 2
    keys = Bp * ctx
    bf, _ = bound_ms(keys * DK * 2, 2 * keys * Hp * (DK + DV))
    bs, _ = bound_ms(keys * (DK + DV) * 2, 2 * keys * Hp * (DK + DV))
    log(f"[timing] paper geometry B={Bp} H={Hp} ctx={ctx} latent, K1 + K2 "
        f"(auto plan: {n} splits), in turns: fused {tfu:.4f} ms (bound "
        f"{bf:.4f}, bytes), separate V {tse:.4f} ms (bound {bs:.4f}, "
        f"bytes): {tse / tfu:.2f}x; bitwise equal")
    del pool, vpool, table
    torch.cuda.empty_cache()

    launches.update(sepv_entry_path(dev, gen))


# ------------------------------------------------- phase 2: K10 (scan)
# the reference test's shapes (tests/test_kernels.py:174): (B, L, D, N)
SCAN_SMALL = [(2, 64, 32, 8), (1, 100, 48, 4), (2, 256, 128, 16)]
# falcon's widths (d_inner 8192, N 16): B 2 x L 256, and a ragged L 200
SCAN_FALCON = [(2, 256, 8192, 16), (2, 200, 8192, 16)]


def scan_inputs(B, L, D, N, gen, dev):
    """Decays in (0.5, 1), small increments, unit-normal C, as the
    reference's test draws them."""
    import torch
    dA = torch.rand(B, L, D, N, generator=gen, device=dev) * 0.5 + 0.5
    dBx = torch.randn(B, L, D, N, generator=gen, device=dev) * 0.1
    c = torch.randn(B, L, N, generator=gen, device=dev)
    return dA, dBx, c


def scan_bytes_ops(B, L, D, N) -> tuple[float, float]:
    """Bytes K10 must move (dA, dBx, C read once; y, h written once, all
    fp32) and its fp32 operations (per (t, d, n): the update's mul and add,
    the product with C and its share of the sum over N)."""
    return (2 * B * L * D * N + B * L * N + B * L * D + B * D * N) * 4, \
        4 * B * L * D * N


def phase_scan(quick: bool, report: dict) -> None:
    """K10 against its plain version on the card: at the reference test's
    small shapes (N 4, 8, 16; ragged D 48 and L 100) and at falcon's widths
    (B 2 x L 256, chunk 64; ragged L 200) and at the shapes the main path
    gives it, mamba-short's prefill (B 8 x L 512) and mamba-long's (B 1 x
    L 8192).  h_last and y bitwise (the tolerance is zero: the plain
    version sums over N in the kernel's order); through ops, h only where
    L is a chunk multiple.  Then its time and its plain version's at the
    main path's two shapes."""
    import torch
    from repro_torch.kernels.selective_scan import ops as scan_ops
    from repro_torch.kernels.selective_scan import scan as S
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    err = 0.0
    for B, L, D, N in SCAN_SMALL + SCAN_FALCON:
        dA, dBx, c = scan_inputs(B, L, D, N, gen, dev)
        y, h = S.selective_scan(dA, dBx, c)
        torch.cuda.synchronize()
        py, ph = S.selective_scan_plain(dA, dBx, c)
        what = f"selective_scan B={B} L={L} D={D} N={N}"
        e = float((y - py).abs().max())
        log(f"[scan] {what}: y max abs err {e:.3e} (max |y| "
            f"{float(py.abs().max()):.3f})")
        bitwise(h, ph, what + " h_last")
        bitwise(y, py, what + " y")
        if not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{what}: y is not finite")
        if D == 8192:
            err = max(err, e)
            chunk = 64
            yo, ho = scan_ops.selective_scan(dA, dBx, c, chunk=chunk)
            if (ho is None) != (L % chunk != 0) or not torch.equal(yo, y):
                raise AssertionError(f"{what}: ops' contract (chunk {chunk})")
        del dA, dBx, c
    iters = 1 if quick else 10
    t_short = None
    for B, L in ((8, 512), (1, 8192)):
        D, N = 8192, 16
        what = f"selective_scan B={B} L={L} D={D} N={N}"
        dA, dBx, c = scan_inputs(B, L, D, N, gen, dev)
        # the shapes the main path gives K10 (mamba-short's prefill, and
        # mamba-long's left-padded to two chunks): held bitwise as above
        y, h = S.selective_scan(dA, dBx, c)
        py, ph = S.selective_scan_plain(dA, dBx, c)
        e = float((y - py).abs().max())
        log(f"[scan] {what}: y max abs err {e:.3e} (max |y| "
            f"{float(py.abs().max()):.3f})")
        bitwise(h, ph, what + " h_last")
        bitwise(y, py, what + " y")
        if not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{what}: y is not finite")
        err = max(err, e)
        del y, h, py, ph
        t = cuda_time_ms(lambda: S.selective_scan(dA, dBx, c), iters)
        tp = cuda_time_ms(lambda: S.selective_scan_plain(dA, dBx, c), 1,
                          warmup=0)
        nbytes, ops = scan_bytes_ops(B, L, D, N)
        tb, by = nbytes / HBM_BYTES_PER_S * 1e3, "bytes"
        if ops / FP32_FLOP_PER_S * 1e3 > tb:
            tb, by = ops / FP32_FLOP_PER_S * 1e3, "operations"
        if t_short is None:
            t_short = (t, tp, tb, by)
        log(f"[timing] {what}: {t:.4f} ms, plain {tp:.4f} ms, bound "
            f"{tb:.4f} ms ({by}, {nbytes / 1e9:.2f} GB), "
            f"{nbytes / t / 1e6:.0f} GB/s, library null")
        del dA, dBx, c
    t, tp, tb, by = t_short
    report["selective_scan"] = {"max_abs_err": err, "ms": t, "plain_ms": tp,
                                "bound_ms": tb, "bound_by": by,
                                "library_ms": None}


# ------------------------------------------- phase 2: K9 (causal prefill)
# the causal prefill kernel at each (D, Dv) it is built for: entry -> (the
# TPU kernel it replaces, its CUDA source, the wrapper, (D, Dv)).  Launches
# are counted on the dense serve phases of the models of that width:
# [192,128] DeepSeek-R1's decompressed MLA heads, [128,128] Qwen3-8B and
# LLaVA-NeXT, [64,64] StableLM-1.6B
PREFILL_WIDTHS = ((192, 128), (128, 128), (64, 64))
PREFILL_KERNELS = {
    f"flash_prefill[{d},{dv}]": (
        "src/repro/kernels/flash_prefill/flash_prefill.py:78",
        _CSRC + "flash_prefill.cu", "flash_prefill", (d, dv))
    for d, dv in PREFILL_WIDTHS}
# (tag, (D, Dv), B, S, H, K): the dense serve phases' prefill shapes, a
# SmolLM and an MQA shape (G = 3, G = 48), a ragged S and an S that is a
# multiple of 64 but not of the kernel's 128-row tiles at each width, a
# grid of fewer work items (B H S / 128) than SMs, and a long GQA case whose
# persistent CTAs each take many items
PREFILL_CASES = [
    ("dense-long MLA", (192, 128), 4, 4096, 128, 128),
    ("dense-short MLA", (192, 128), 8, 512, 128, 128),
    ("ragged MLA", (192, 128), 2, 200, 128, 128),
    ("S 576 MLA", (192, 128), 2, 576, 128, 128),
    ("qwen-dense G=4", (128, 128), 8, 512, 32, 8),
    ("llava-dense G=7", (128, 128), 4, 512, 56, 8),
    ("granite MQA G=48", (128, 128), 2, 2048, 48, 1),
    ("ragged G=4", (128, 128), 2, 200, 32, 8),
    ("S 576 G=4", (128, 128), 2, 576, 32, 8),
    ("few items G=4", (128, 128), 1, 256, 4, 1),
    ("long GQA G=4", (128, 128), 2, 4096, 32, 8),
    ("stablelm-dense G=1", (64, 64), 8, 512, 32, 32),
    ("smollm G=3", (64, 64), 8, 512, 15, 5),
    ("ragged G=3", (64, 64), 2, 200, 15, 5),
    ("S 576 G=1", (64, 64), 2, 576, 32, 32),
]
# the shape each width is timed at: its main serve phase's prefill
PREFILL_TIMED = {(192, 128): "dense-long MLA", (128, 128): "qwen-dense G=4",
                 (64, 64): "stablelm-dense G=1"}


def prefill_bytes_ops(B, S, H, K, D, Dv) -> tuple[float, float]:
    """Bytes K9 must move (q, k, v read once, out written once, bf16) and
    the operations of its causal half: both products over the S (S + 1) / 2
    live (query, key) pairs of each head."""
    nbytes = 2 * B * S * (H * D + K * D + K * Dv + H * Dv)
    flops = 2 * B * H * (S * (S + 1) / 2) * (D + Dv)
    return nbytes, flops


def sdpa_causal(q, k, v, scale):
    """Yardstick: one scaled_dot_product_attention call (is_causal,
    enable_gqa) on [B, H, S, D] views of the same q, k, v."""
    import torch
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=scale, enable_gqa=True)


def phase_prefill_kernels(quick: bool, report: dict) -> None:
    """K9 against its plain version on the card at each width it is built
    for (the library's list must be PREFILL_WIDTHS), at PREFILL_CASES'
    shapes, in both rescale modes (bf16_close); rows [:T] of a call
    bitwise a call on the first T rows; each instance's registers and
    shared memory, failing on any local memory (spills); then at
    PREFILL_TIMED's shapes its time (CUDA events) and achieved TFLOP/s,
    the plain version's time, its bound and SDPA's."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_prefill import flash_prefill as FP
    from repro_torch.kernels.launch import dense_widths
    dev = torch.device("cuda")
    built = dense_widths(build.library(), "flash_prefill_widths")
    if built != set(PREFILL_WIDTHS):
        raise AssertionError(f"K9 is built for {sorted(built)}, the checks "
                             f"cover {sorted(PREFILL_WIDTHS)}")
    for d, dv in PREFILL_WIDTHS:
        log(f"[attrs] K9 ({d}, {dv}): "
            + instance_attrs("flash_prefill_attrs", d, dv))
        if attr_values("flash_prefill_attrs", d, dv)[2]:
            raise AssertionError(f"K9 ({d}, {dv}) spills to local memory")
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    errs = {w: 0.0 for w in PREFILL_WIDTHS}
    inputs = {}
    for tag, (d, dv), B, S, H, K in PREFILL_CASES:
        q, k, v = (torch.randn(B, S, n, w, generator=gen, device=dev).to(
            torch.bfloat16) for n, w in ((H, d), (K, d), (K, dv)))
        scale = d ** -0.5
        for mode in ("amla", "mul"):
            out = FP.flash_prefill(q, k, v, scale=scale, rescale=mode)
            ref = FP.flash_prefill_plain(q, k, v, scale=scale, rescale=mode)
            errs[(d, dv)] = max(errs[(d, dv)], bf16_close(
                out, ref, f"K9 ({d}, {dv}) {tag} B={B} S={S} {mode}"))
            del ref
        T = S - 77
        bitwise(FP.flash_prefill(q[:, :T], k[:, :T], v[:, :T], scale=scale),
                FP.flash_prefill(q, k, v, scale=scale)[:, :T],
                f"K9 prefix invariance {tag} T={T}")
        log(f"[kernels] K9 ({d}, {dv}) {tag}: B={B} S={S} H={H} K={K} "
            f"(G {H // K}): kernel vs plain ok in both modes; rows [:{T}] "
            "bitwise a call on the first rows")
        if tag in PREFILL_TIMED.values():
            inputs[(d, dv)] = (tag, B, S, H, K, q, k, v)
        del q, k, v, out
    torch.cuda.empty_cache()

    iters, piters = (1, 1) if quick else (10, 2)
    for (d, dv), (tag, B, S, H, K, q, k, v) in inputs.items():
        scale = d ** -0.5
        t = cuda_time_ms(lambda q=q, k=k, v=v, s=scale: FP.flash_prefill(
            q, k, v, scale=s), iters)
        tp = cuda_time_ms(lambda q=q, k=k, v=v, s=scale:
                          FP.flash_prefill_plain(q, k, v, scale=s), piters,
                          warmup=1)
        tl = cuda_time_ms(sdpa_causal(q, k, v, scale), iters)
        nbytes, flops = prefill_bytes_ops(B, S, H, K, d, dv)
        tb, by = bound_ms(nbytes, flops)
        log(f"[timing] flash_prefill[{d},{dv}] ({tag} B={B} S={S} H={H} "
            f"K={K}): {t:.4f} ms ({flops / t / 1e9:.1f} TFLOP/s of the "
            f"causal half), plain {tp:.4f} ms, bound {tb:.4f} ms ({by}; "
            f"{100 * tb / t:.1f}% of it), library (SDPA, is_causal) "
            f"{tl:.4f} ms")
        report[f"flash_prefill[{d},{dv}]"] = {
            "max_abs_err": errs[(d, dv)], "ms": t, "plain_ms": tp,
            "bound_ms": tb, "bound_by": by, "library_ms": tl}
    del inputs
    torch.cuda.empty_cache()


# ---------------- phase 2: K4 / K4q at the spec serve phases' verify shape
# A spec serve phase's verify launch: Cq = SPEC_K rows (the window) of H
# 128 for every batch slot, the live rows' starts ragged over the phase's
# contexts, the last rows idle on the null block (a masked slot: table row
# 0, start 0).  B x ceil(Cq H / 64) units of 64 columns leave SMs idle at
# each, so K4 runs units of 32.
SPEC_K = 4
# (pool, batch slots, live starts lo-hi, idle rows, the phase it stands
# for): the short cases at serve-short's contexts (8 bf16 slots, 15 int8 at
# serve-short-int8's pool bytes, 7 e4m3), the long ones at serve-long's
# (4 bf16 slots, 7 e4m3 at serve-long-fp8's pool bytes).  The first case of
# each pool type gives its kernels-line entry.
SPEC_VERIFY_CASES = (
    ("fp", 8, (480, 600), 2, "serve-short-spec"),
    ("int8", 15, (480, 600), 2, "serve-short-int8-spec-head"),
    ("fp8", 7, (480, 600), 2, "serve-short's contexts over e4m3"),
    ("fp", 4, (4096, 4160), 1, "serve-long-std-spec"),
    ("fp8", 7, (4096, 4160), 2, "serve-long-fp8-spec"),
)
SPEC_TREE = (0, 1, 1, 2)          # two siblings after the committed token


def device_ms(fn, name_part: str, iters: int):
    """Device time of one call of ``fn`` (ms) from torch.profiler: the
    device time of the kernels whose name holds ``name_part``, over
    ``iters`` calls; None when the profiler saw no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and name_part in e.key)
    return us / 1e3 / iters if us > 0 else None


def spec_verify_case(spec_case, gen, dev) -> dict:
    """The operands of one verify launch of ``spec_case`` (an entry of
    SPEC_VERIFY_CASES): q bf16 [B, SPEC_K, 128, 576], the pool (codes and
    pairs over int8 / e4m3, with the fp32 rows they code), the table,
    starts and the linear and tree horizons."""
    import torch
    from repro_torch.runtime import paged_cache
    kvd, B, (lo, hi), idle, _ = spec_case
    Cq = SPEC_K
    start = torch.randint(lo, hi + 1, (B,), generator=gen, device=dev,
                          dtype=torch.int32)
    start[-idle:] = 0                    # idle slots: table row 0, start 0
    lengths = (start + Cq).tolist()
    nb = pages(lengths)
    pool, table = make_pool(B, nb, lengths, gen, dev)
    table[-idle:] = 0
    case = {"B": B, "start": start, "table": table, "nb": nb,
            "pool": pool, "extra": (), "rows": None, "idle": idle,
            "tag": f"B={B} Cq={Cq} H=128 starts {lo}-{hi} ({idle} idle)"}
    if kvd != "fp":
        rows = torch.randn(pool.shape, generator=gen, device=dev)
        codes, sz = paged_cache.quantize_pool(rows, kvd)
        case.update(pool=codes, extra=(sz,), rows=rows)
    case["q"] = torch.randn(B, Cq, 128, DK, generator=gen, device=dev).to(
        torch.bfloat16)
    ar = torch.arange(Cq, dtype=torch.int32, device=dev)
    case["linear"] = start[:, None] + ar[None, :]
    case["tree"] = start[:, None] + torch.tensor(
        SPEC_TREE, dtype=torch.int32, device=dev)[None, :]
    return case


def spec_verify_checks(spec_case, gen, dev) -> float:
    """K4 (pool "fp") or K4q at the verify shape of ``spec_case``
    (spec_verify_case), in both rescale modes: the linear and the tree
    verify against their plain versions at the bf16 tolerance (bf16 q);
    linear verify == prefill, and
    a row alone == the same row in its batch, bitwise; over codes also
    fp32 q against the plain version (f32_close) and its RMSE against the
    fp64 oracle on the rows the codes stand for (k4q_rmse: the reference's
    gate, or within 1% of the reference's route).  Returns the max abs
    error against the plain versions."""
    import torch
    from repro_torch.kernels.etap import etap as K
    kvd = spec_case[0]
    c = spec_verify_case(spec_case, gen, dev)
    sfx = "" if kvd == "fp" else "_quant"
    verify = getattr(K, f"etap_verify_mla_paged{sfx}")
    plain = getattr(K, f"etap_verify_mla_paged{sfx}_plain")
    prefill = getattr(K, f"etap_prefill_mla_paged{sfx}")
    ops_ = (c["pool"], *c["extra"], DV)
    B, tbl, start = c["B"], c["table"], c["start"]
    err = 0.0
    qs = (c["q"],) if kvd == "fp" else (c["q"], c["q"].float())
    for q in qs:
        fp32_q = q.dtype == torch.float32
        qt = "fp32 q" if fp32_q else "bf16 q"
        for mode in ("amla", "mul"):
            kw = dict(scale=SCALE, rescale=mode)
            tag = f"{'K4' if kvd == 'fp' else 'K4q'} verify {kvd} {qt} " \
                  f"{c['tag']} {mode}"
            out = verify(q, *ops_, tbl, start, c["linear"], **kw)
            for qpos, what in ((c["linear"], "linear"), (c["tree"], "tree")):
                o = out if what == "linear" else \
                    verify(q, *ops_, tbl, start, qpos, **kw)
                err = max(err, sepv_out_close(
                    o, plain(q, *ops_, tbl, start, qpos, **kw),
                    f"{tag} ({what})"))
            bitwise(out, prefill(q, *ops_, tbl, start, **kw),
                    f"{tag}: linear verify vs prefill")
            alone = (0, B - c["idle"] - 1, B - 1)   # live rows, an idle one
            for b in alone:
                bitwise(verify(q[b:b + 1], *ops_, tbl[b:b + 1],
                               start[b:b + 1], c["linear"][b:b + 1], **kw),
                        out[b:b + 1], f"{tag}: row {b} alone vs in batch")
            log(f"[spec-verify] {tag}: linear and tree verify within "
                "tolerance of the plain version; bitwise: linear verify == "
                f"prefill, rows {alone} alone == in the batch")
        if fp32_q:
            k4q_rmse(q, (c["pool"], c["extra"][0],
                         *latent_v(c["pool"], c["extra"][0])), tbl, start,
                     (c["rows"], c["rows"][..., :DV]), kvd,
                     f"verify shape {c['tag']}",
                     fused=(c["pool"], c["extra"][0]))
    return err


def spec_verify_timing(spec_case, gen, dev, iters: int, piters: int):
    """The verify launch at ``spec_case``'s shape: CUDA-event time,
    torch.profiler device time, the plain version's time, the bound (q,
    each pool row under a live horizon read once, the output written once;
    the products those horizons need) and, over bf16 rows, SDPA's time
    with the horizon mask on the gathered rows (sdpa_chunk); over codes
    SDPA on the dequantized bf16 rows is logged as a yardstick (it reads
    other inputs).  Returns (ms, plain ms, bound ms, bound by, library ms,
    device ms)."""
    import torch
    from repro_torch.kernels.etap import etap as K
    from repro_torch.runtime import paged_cache
    kvd = spec_case[0]
    c = spec_verify_case(spec_case, gen, dev)
    sfx = "" if kvd == "fp" else "_quant"
    B, tbl, start, nb = c["B"], c["table"], c["start"], c["nb"]
    args = (c["q"], c["pool"], *c["extra"], DV, tbl, start, c["linear"])
    verify = getattr(K, f"etap_verify_mla_paged{sfx}")
    plain = getattr(K, f"etap_verify_mla_paged{sfx}_plain")
    keys = sum(int(s) + j + 1 for s in start.tolist() for j in range(SPEC_K))
    rows = sum(int(s) + SPEC_K for s in start.tolist())
    row_b = DK * 2 if kvd == "fp" else DK + 8
    nbytes = (c["q"].numel() * 2 + rows * row_b
              + B * SPEC_K * 128 * DV * 2)
    flops = 2 * keys * 128 * (DK + DV)
    tb, by = bound_ms(nbytes, flops)
    t = cuda_time_ms(lambda: verify(*args, scale=SCALE), iters)
    td = device_ms(lambda: verify(*args, scale=SCALE), "etap_prefill_kernel",
                   iters)
    tp = cuda_time_ms(lambda: plain(*args, scale=SCALE), piters, warmup=1)
    kd = c["pool"] if kvd == "fp" else paged_cache.dequantize_rows(
        c["pool"], c["extra"][0]).to(torch.bfloat16)
    kd = kd[tbl.long()].reshape(B, nb * PAGE, DK)
    tl = cuda_time_ms(sdpa_chunk(c["q"], kd, kd[..., :DV], start, SCALE),
                      iters)
    del kd
    name = "K4" if kvd == "fp" else f"K4q {kvd}"
    dev_s = "not measured" if td is None else f"{td:.4f} ms"
    log(f"[timing] {name} verify {c['tag']} ({spec_case[4]}): {t:.4f} ms ({flops / t / 1e9:.1f} TFLOP/s), device "
        f"{dev_s}, plain {tp:.4f} ms, bound {tb:.4f} ms ({by}), SDPA "
        f"{tl:.4f} ms" + ("" if kvd == "fp" else
                          " (on the dequantized bf16 rows: a yardstick)"))
    return t, tp, tb, by, (tl if kvd == "fp" else None), td


def phase_spec_verify(quick: bool, report: dict) -> None:
    """K4 / K4q at the spec serve phases' verify shapes
    (SPEC_VERIFY_CASES): the checks of spec_verify_checks over bf16, int8
    and e4m3 pools at the short and the long contexts, then their times
    (the first case of each pool type gives the kernels line's
    etap_verify_mla_paged entry)."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(28)
    iters, piters = (1, 1) if quick else (20, 3)
    for spec_case in SPEC_VERIFY_CASES:
        kvd = spec_case[0]
        err = spec_verify_checks(spec_case, gen, dev)
        t, tp, tb, by, tl, td = spec_verify_timing(spec_case, gen, dev,
                                                   iters, piters)
        key = "etap_verify_mla_paged" if kvd == "fp" else \
            f"etap_verify_mla_paged_quant[{kvd}]"
        log(f"[spec-verify] {key} ({spec_case[4]}): max abs err {err:.4e}, "
            "device ms " + ("not measured" if td is None else f"{td:.4f}"))
        report.setdefault(key, {"max_abs_err": err, "ms": t, "plain_ms": tp,
                                "bound_ms": tb, "bound_by": by,
                                "library_ms": tl})


# ------------------------------------------------------- phases 3 - 5
SHORT = ["--batch", "8", "--requests", "16", "--prompt", "512", "--gen", "32"]
LONG = ["--batch", "4", "--requests", "4", "--prompt", "4096", "--gen", "32",
        "--prefill-chunk", "256"]
DENSE = ["--cache-layout", "dense", "--gen", "32"]
# serve-short-int8 and serve-long-fp8 run at the fp phases' depth;
# serve-short-fp8 and serve-long-int8 are cut to a few requests and tokens,
# only so that each quantized body launches on a serve path for each code
# type (each is its own entry of the kernels line)
SHORT_CUT = ["--batch", "8", "--requests", "4", "--prompt", "512", "--gen",
             "8"]
LONG_CUT = ["--batch", "4", "--requests", "2", "--prompt", "4096", "--gen",
            "8", "--prefill-chunk", "256"]
# (phase, serve flags, kernels that must launch in it)
SERVE_PHASES = [
    ("serve-short", SHORT, ("etap_decode_mla_paged",
                            "etap_prefill_mla_paged")),
    ("serve-long", LONG, ("etap_paged_partial", "combine_splits",
                          "etap_prefill_mla_paged")),
    ("serve-short-std", SHORT + ["--mode", "standard"],
     ("flash_decode", "etap_prefill_mla_paged")),
    ("serve-long-std", LONG + ["--mode", "standard"],
     ("flash_decode_partial", "combine_splits_std",
      "etap_prefill_mla_paged")),
    ("serve-short-int8", SHORT + ["--kv-dtype", "int8"],
     ("etap_decode_mla_paged_quant", "etap_prefill_mla_paged_quant")),
    ("serve-long-fp8", LONG + ["--kv-dtype", "fp8"],
     ("etap_paged_partial_quant", "combine_splits",
      "etap_prefill_mla_paged_quant")),
    ("serve-short-fp8", SHORT_CUT + ["--kv-dtype", "fp8"],
     ("etap_decode_mla_paged_quant", "etap_prefill_mla_paged_quant")),
    ("serve-long-int8", LONG_CUT + ["--kv-dtype", "int8"],
     ("etap_paged_partial_quant", "combine_splits",
      "etap_prefill_mla_paged_quant")),
    # --mode standard over the quantized pools (K7q / K8q at the latent on
    # the gathered codes), cut as serve-short-fp8 and serve-long-int8 are
    ("serve-short-std-int8", SHORT_CUT + ["--mode", "standard", "--kv-dtype",
                                          "int8"],
     ("flash_decode_quant", "etap_prefill_mla_paged_quant")),
    ("serve-long-std-fp8", LONG_CUT + ["--mode", "standard", "--kv-dtype",
                                       "fp8"],
     ("flash_decode_partial_quant", "combine_splits_std",
      "etap_prefill_mla_paged_quant")),
    ("dense-short", DENSE + ["--batch", "8", "--prompt", "512"],
     ("etap_decode_dense", "flash_prefill")),
    ("dense-long", DENSE + ["--batch", "4", "--prompt", "4096"],
     ("etap_partial_dense", "combine_splits", "flash_prefill")),
    ("dense-long-std", DENSE + ["--batch", "4", "--prompt", "4096",
                                "--mode", "standard"],
     ("flash_decode_partial", "combine_splits_std", "flash_prefill")),
]


# The spec serve phases (--spec-tokens 4): every decoding slot with 4 or
# more tokens left is verified through K4 / K4q (Cq 4 a slot, the others
# masked to the null block), the rest take the one-token step (K3, K8 + K2,
# K3q, K1q + K2).  (phase, serve flags, kernels that must launch in it,
# its spec-off run: an earlier phase, or a run of the same flags without
# --spec-tokens made beside it under that name).  The cut quantized phases
# are cut as serve-short-fp8 and serve-long-int8 are.
SPEC = ["--spec-tokens", str(SPEC_K)]
SPEC_PHASES = [
    ("serve-short-spec", SHORT + SPEC,
     ("etap_verify_mla_paged", "etap_decode_mla_paged"), "serve-short"),
    ("serve-long-std-spec", LONG + ["--mode", "standard"] + SPEC,
     ("etap_verify_mla_paged", "flash_decode_partial", "combine_splits_std"),
     "serve-long-std"),
    ("serve-short-int8-spec-head", SHORT_CUT + ["--kv-dtype", "int8"] + SPEC
     + ["--spec-draft", "head"],
     ("etap_verify_mla_paged_quant", "etap_decode_mla_paged_quant"),
     "serve-short-int8-cut"),
    ("serve-long-fp8-spec", LONG_CUT + ["--kv-dtype", "fp8"] + SPEC,
     ("etap_verify_mla_paged_quant", "etap_paged_partial_quant",
      "combine_splits"), "serve-long-fp8-cut"),
]


# The fault-drill phases: (phase, serve flags, its drill-free twin, an
# earlier phase of the same call).  At 0.02 a fault falls every 50 ticks,
# longer than a serve-long victim's re-prefill (16 chunks) and replay (at
# most 31 tokens), so no victim is failed again before it is restored.
FAULT = ["--fault-rate", "0.02"]
FAULT_PHASES = [
    ("serve-short-fault", SHORT + FAULT, "serve-short"),
    ("serve-long-fault", LONG + FAULT, "serve-long"),
    ("serve-short-int8-fault", SHORT + ["--kv-dtype", "int8"] + FAULT,
     "serve-short-int8"),
]


def serve_expect(name: str) -> tuple:
    """The kernels SERVE_PHASES says must launch in phase ``name``."""
    return next(e for n, _, e in SERVE_PHASES if n == name)


def phase_serve_obs(params, runs: dict) -> dict:
    """serve-short again with every telemetry export on (--trace-out,
    --metrics-out, --profile-kernels 1), beside serve-short's run in
    ``runs``: the outputs and every wrapper's launch count must equal
    serve-short's, the trace must parse and hold the prefill and decode
    spans and the lifecycle instants, the metrics file's snapshot must
    equal the returned one, and the kernel report must hold one launch of
    the paged decode entry a layer a decode step and one of the prefill
    entry a layer a prefill chunk (the serve loop prints its [serve]
    kernel profile lines).  Returns the run's launch counts."""
    from repro_torch.launch import serve
    name, twin = "serve-short-obs", runs["serve-short"]
    with tempfile.TemporaryDirectory() as tmp:
        trace, metrics = Path(tmp) / "trace.json", Path(tmp) / "metrics.json"
        flags = twin["flags"] + ["--trace-out", str(trace), "--metrics-out",
                                 str(metrics), "--profile-kernels", "1"]
        got = phase_serve(name, flags, params, serve_expect("serve-short"),
                          runs)
        events = json.loads(trace.read_text())["traceEvents"]
        doc = json.loads(metrics.read_text())
    run = runs[name]
    if run["outputs"] != twin["outputs"]:
        raise AssertionError(f"{name}: outputs differ from serve-short's")
    if run["launched"] != twin["launched"]:
        diff = {k: (v, twin["launched"][k]) for k, v in run["launched"].items()
                if v != twin["launched"][k]}
        raise AssertionError(f"{name}: launches differ from serve-short's "
                             f"(this run, serve-short): {diff}")
    names = {e["name"] for e in events}
    need = {"prefill_chunk", "decode_step", "enqueued", "admitted",
            "finished"}
    if not need <= names:
        raise AssertionError(f"{name}: trace lacks {sorted(need - names)}")
    if doc["metrics"] != run["metrics"]:
        raise AssertionError(f"{name}: the metrics file's snapshot is not "
                             "the returned one")
    layers = serve.config_for(serve.parse_args(flags)).num_layers
    rows = run["kernel_report"] or []
    for entry, want in (("etap_decode_mla_paged_splitkv",
                         layers * run["steps"]),
                        ("etap_prefill_mla_paged",
                         layers * run["prefill_chunks"])):
        n = sum(r["launches"] for r in rows if r["entry"] == entry)
        if n != want:
            raise AssertionError(f"{name}: kernel report has {n} launches "
                                 f"of {entry}, not {want}")
    log(f"[{name}] bitwise serve-short's outputs and launches; trace "
        f"{len(events)} events ({sorted(need)} present), metrics file == "
        f"snapshot, kernel report {len(rows)} rows; {gpu_line()}")
    return got


def phase_fault_serve(name, flags, params, twin, runs) -> dict:
    """One fault-drill serve phase (phase_serve) beside its drill-free twin
    in ``runs``: every injected fault must be one scheduler failure and
    one worker restart (and there must be one), tokens must have been
    replayed through the recompute restore (the serve loop asserts that
    the kernels re-derive each delivered token), every tick must have
    beaten its heartbeat, and the outputs must equal the twin's.  Returns
    the run's launch counts."""
    got = phase_serve(name, flags, params, serve_expect(twin), runs)
    c = runs[name]["metrics"]["counters"]
    faults = c.get("ft/injected_faults", 0)
    if not faults or not (faults == c.get("sched/failures")
                          == c.get("serve/worker_restarts")):
        raise AssertionError(
            f"{name}: faults {faults}, scheduler failures "
            f"{c.get('sched/failures')}, worker restarts "
            f"{c.get('serve/worker_restarts')}")
    if c.get("serve/replayed_tokens", 0) <= 0:
        raise AssertionError(f"{name}: no token was replayed")
    if c.get("ft/heartbeats") != c.get("serve/ticks"):
        raise AssertionError(f"{name}: {c.get('ft/heartbeats')} heartbeats "
                             f"in {c.get('serve/ticks')} ticks")
    out, ref = runs[name]["outputs"], runs[twin]["outputs"]
    if out != ref:
        first = next(((rid, i) for rid in ref for i, (a, b) in enumerate(
            zip(out.get(rid, []), ref[rid])) if a != b), "a length")
        raise AssertionError(f"{name}: outputs differ from {twin}'s "
                             f"(first at (request, token) {first})")
    log(f"[{name}] drill: {faults} faults injected = scheduler failures = "
        f"worker restarts, {c['serve/replayed_tokens']} tokens replayed, "
        f"{c['serve/ticks']} ticks = heartbeats, outputs == {twin}'s; "
        f"{runs[name]['tok_s']:.1f} tok/s against {runs[twin]['tok_s']:.1f}")
    return got


RESUME_S, RESUME_CHUNK, RESUME_AT = 2048, 256, 1984


def phase_resume_chunk(params, cfg) -> None:
    """Why a chunk after a prefix-cache hit or restore runs from its chunk
    grid point (``prefill_chunk(n_cached=...)``): a 2048-token prompt
    prefilled in chunks of 256, then its last chunk again from 1984, where
    serve-long's restore resumes.  Run from the grid point with the 192
    rows the pool holds recomputed (the serve loop's route), every layer's
    latent rows and the logits must be bitwise the uncached chunk's; run as
    a 64-row chunk (the reference's route), whether they are is logged
    ([resume] lines), with whether layer 0's GEMMs give a row other bits
    in a product of 256 rows than of 64 ([gemm rows] lines)."""
    import torch
    from repro_torch.core.attn_spec import AttnSpec
    from repro_torch.models import model
    from repro_torch.runtime import paged_cache
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(11)
    layout = paged_cache.layout_for(1, RESUME_S, PAGE)
    table = torch.arange(1, layout.max_blocks + 1, dtype=torch.int32,
                         device=dev)[None]
    toks = torch.randint(0, cfg.vocab_size, (1, RESUME_S), generator=gen,
                         device=dev, dtype=torch.int32)
    cache = model.init_paged_cache(cfg, layout, device=dev)
    spec = AttnSpec()

    def chunk(start, stop, n_cached=0):
        nonlocal cache
        lg, cache = model.prefill_chunk(
            params, cfg, cache, toks[:, start:stop], table,
            torch.tensor([start], dtype=torch.int32, device=dev), spec=spec,
            n_cached=n_cached)
        rows = [paged_cache.gather_blocks(lc["c"], table)[0, RESUME_AT:]
                .clone() for lc in cache]
        return lg[:, -(RESUME_S - RESUME_AT):], rows

    for s in range(0, RESUME_S, RESUME_CHUNK):
        want, want_rows = chunk(s, s + RESUME_CHUNK)
    grid = RESUME_S - RESUME_CHUNK
    got, got_rows = chunk(grid, RESUME_S, n_cached=RESUME_AT - grid)
    for i, (a, b) in enumerate(zip(got_rows, want_rows, strict=True)):
        bitwise(a, b, f"resume: layer {i} latent rows, grid chunk")
    bitwise(got, want, "resume: logits, grid chunk")
    short, short_rows = chunk(RESUME_AT, RESUME_S)
    diffs = [(a.float() - b.float()).abs().max().item()
             for a, b in zip(short_rows, want_rows, strict=True)]
    log(f"[resume] rows {RESUME_AT}..{RESUME_S - 1} from the grid chunk "
        f"(n_cached {RESUME_AT - grid}): bitwise the uncached chunk's in "
        f"every layer and the logits; as a {RESUME_S - RESUME_AT}-row chunk: "
        f"latent max |diff| by layer {[f'{d:.3e}' for d in diffs]}, logits "
        f"{(short - want).abs().max().item():.3e}")
    lp = params["layers"][0]
    rows = RESUME_S - RESUME_AT
    for name, w in (("w_dq", lp["mix"]["w_dq"]), ("w_dkv", lp["mix"]["w_dkv"]),
                    ("w_o", lp["mix"]["w_o"]),
                    ("w_down", lp["ffn"]["w_down"])):
        x = torch.randn(RESUME_CHUNK, w.shape[0], generator=gen,
                        device=dev).to(w.dtype)
        a, b = (x @ w)[-rows:], x[-rows:] @ w
        log(f"[gemm rows] layer 0 {name} {tuple(w.shape)}: the last {rows} "
            f"rows of a {RESUME_CHUNK}-row product "
            f"{'==' if torch.equal(a, b) else '!='} a {rows}-row product "
            f"(max |diff| {(a.float() - b.float()).abs().max().item():.3e})")


def head_table_check(params) -> None:
    """The head drafter's table at DeepSeek-R1's full vocabulary, built on
    the card as serve-short-int8-spec-head builds it (spec_decode.HeadDraft
    over the same embedding: fp32 products with TF32 off, blocks of 2048
    rows, the last one padded), against an fp64 argmax over the same
    embedding on the card (DGEMM, another route than the fp32 product):
    4096 rows, those of the first and of the last (padded) block and
    the rest drawn from a seed.  A row passes where the table holds the
    fp64 argmax (ties to the lowest index), or where the fp64 similarity of
    the table's token is within 64 u |E[t]| max |E[t']| (u = 2^-24) of the
    best: a near tie that fp32 rounding may break either way.  Anything
    else fails."""
    import torch
    from repro_torch.runtime import spec_decode
    emb = params.get("embed_f32", params["embed"])
    V = emb.shape[0]
    t0 = time.perf_counter()
    table = torch.as_tensor(spec_decode.HeadDraft(emb).table)
    t_build = time.perf_counter() - t0
    block, rows = 2048, 4096
    last = (V - 1) // block * block
    gen = torch.Generator().manual_seed(28)
    pick = torch.unique(torch.cat([
        torch.arange(block), torch.arange(last, V),
        torch.randint(block, last, (rows - block - (V - last),),
                      generator=gen)]))
    dev = emb.device
    idx = pick.to(dev)
    x = emb[idx].double()                               # [R, D]
    best_v = torch.full((len(idx),), float("-inf"), dtype=torch.float64,
                        device=dev)
    best_i = torch.zeros(len(idx), dtype=torch.int64, device=dev)
    norm_max = 0.0
    step = 8192
    for lo in range(0, V, step):
        y = emb[lo:lo + step].double()
        norm_max = max(norm_max, float(y.norm(dim=1).max()))
        sim = x @ y.T
        own = (idx >= lo) & (idx < lo + y.shape[0])
        sim[own.nonzero()[:, 0], idx[own] - lo] = float("-inf")
        v, i = sim.max(dim=1)                 # first of equal maxima
        better = v > best_v                   # an earlier block wins ties
        best_v = torch.where(better, v, best_v)
        best_i = torch.where(better, i + lo, best_i)
        del y, sim
    got = table[pick].to(dev)
    got_v = (x * emb[got].double()).sum(dim=1)
    tol = 64 * 2.0 ** -24 * x.norm(dim=1) * norm_max
    gap = best_v - got_v
    exact = got == best_i
    near = ~exact & (gap <= tol)
    bad = ~exact & ~near
    log(f"[head-table] V={V}: built on the card in {t_build:.2f} s; "
        f"{len(pick)} rows (first block, last block {last}-{V - 1} padded "
        f"to {block}, the rest drawn) against an fp64 argmax: "
        f"{int(exact.sum())} equal, {int(near.sum())} near ties (fp64 gap "
        f"<= 64 u |E[t]| max|E|), {int(bad.sum())} wrong; largest gap "
        f"relative to its tolerance {float((gap / tol).max()):.3e}")
    if bool(bad.any()):
        b = int(bad.nonzero()[0, 0])
        raise AssertionError(
            f"head table row {int(pick[b])}: {int(got[b])}, fp64 argmax "
            f"{int(best_i[b])} (gap {float(gap[b]):.4e} > "
            f"{float(tol[b]):.4e})")


def spec_off_flags(flags) -> list:
    """A spec phase's flags without --spec-tokens and --spec-draft."""
    out, skip = [], False
    for f in flags:
        if skip:
            skip = False
        elif f in ("--spec-tokens", "--spec-draft"):
            skip = True
        else:
            out.append(f)
    return out


# Falcon-Mamba-7B at full width and full depth (64 layers), dense cache:
# each prefill runs K10 once a layer
MAMBA = ["--arch", "falcon_mamba_7b", "--cache-layout", "dense"]
MAMBA_PHASES = [
    ("mamba-short", MAMBA + ["--batch", "8", "--prompt", "512", "--gen",
                             "32"]),
    # 6144 tokens, left-padded to 8192: two scan chunks of 4096
    ("mamba-long", MAMBA + ["--batch", "1", "--prompt", "6144", "--gen",
                            "16"]),
]


# Qwen3-8B at full width and full depth (36 layers), bf16: the GQA path.
# The port's scheduler plans splits on the card's 132 SMs as the
# reference's does on its cores: the paged GQA decode walks the gathered
# rows in page-sized blocks, so qwen-short's 64 grouped rows x 9 pages get
# 3 splits and qwen-long's 8 x 65 pages 22; qwen-short and its standard
# twin pin one split (--kv-splits 1) so that the single-pass K5 and K7 run
# on a serve path, qwen-dense's auto plan (block 512) picks one split too.
# qwen-short's prompts run in chunks of 128: a GQA chunk is the plain
# masked product (no kernel), so the chunk moves nothing the kernels see,
# and it keeps the eager chunk loop (36 layers a chunk) short
QWEN = ["--arch", "qwen3_8b"]
QWEN_SHORT = QWEN + ["--batch", "8", "--requests", "8", "--prompt", "512",
                     "--gen", "32", "--kv-splits", "1", "--prefill-chunk",
                     "128"]
QWEN_LONG = QWEN + ["--batch", "1", "--requests", "2", "--prompt", "4096",
                    "--gen", "32", "--prefill-chunk", "256"]
# the quantized pools' standard twins are cut to a few requests and tokens,
# only so that K7q and K8q at 128 launch on a serve path
QWEN_SHORT_CUT = QWEN + ["--batch", "8", "--requests", "4", "--prompt",
                         "512", "--gen", "8", "--kv-splits", "1"]
QWEN_LONG_CUT = QWEN + ["--batch", "1", "--requests", "1", "--prompt", "4096",
                        "--gen", "8", "--prefill-chunk", "256"]
QWEN_PHASES = [
    ("qwen-short", QWEN_SHORT, ("etap_decode_dense",)),
    ("qwen-short-std", QWEN_SHORT + ["--mode", "standard"], ("flash_decode",)),
    ("qwen-long", QWEN_LONG, ("etap_partial_dense", "combine_splits")),
    ("qwen-long-std", QWEN_LONG + ["--mode", "standard"],
     ("flash_decode_partial", "combine_splits_std")),
    ("qwen-dense", QWEN + ["--cache-layout", "dense", "--batch", "8",
                           "--prompt", "512", "--gen", "32"],
     ("etap_decode_dense", "flash_prefill")),
    # int8 / fp8 pools at the fp pool's bytes: 15 slots for qwen-short's 8,
    # one for qwen-long's one; decode over the gathered codes and pairs
    ("qwen-short-int8", QWEN_SHORT + ["--kv-dtype", "int8"],
     ("etap_decode_dense_quant",)),
    ("qwen-long-fp8", QWEN_LONG + ["--kv-dtype", "fp8"],
     ("etap_partial_dense_quant", "combine_splits")),
    ("qwen-short-std-fp8", QWEN_SHORT_CUT + ["--mode", "standard",
                                             "--kv-dtype", "fp8"],
     ("flash_decode_quant",)),
    ("qwen-long-std-int8", QWEN_LONG_CUT + ["--mode", "standard",
                                            "--kv-dtype", "int8"],
     ("flash_decode_partial_quant", "combine_splits_std")),
]
# Qwen3-8B's spec phase, cut to 4 requests of 16 tokens: the GQA verify is
# the reference's masked product on the gathered rows (no kernel), the
# fallback slots run K5 (one split); its spec-off run is made beside it
QWEN_SPEC_PHASES = [
    ("qwen-short-spec", QWEN + ["--batch", "8", "--requests", "4", "--prompt",
                                "512", "--gen", "16", "--kv-splits", "1"]
     + SPEC, ("etap_decode_dense",), "qwen-short-cut"),
]


# The last dense-decode widths, each model at full width (bf16, random
# weights from a seed), the one before freed first.  SmolLM-360M (32
# layers, 15 heads over 5 kv heads: G = 3, head_dim 64) on the paged
# layout: smol-short pins one split (K5 / K7 [64]; the auto plan gives 3),
# smol-long's one slot of 65 pages gets 22 (K6 / K8 + K2 [64]), and over
# int8 / fp8 pools sized to the fp pool's bytes (14 slots for 8) K5q-K8q
# [64], the standard twins cut to a few requests and tokens.  Prompts run
# in chunks of 128 (512 for the long ones): the chunk size moves nothing
# the kernels see, and it keeps the eager chunk loop short.
SMOL = ["--arch", "smollm_360m"]
SMOL_SHORT = SMOL + ["--batch", "8", "--requests", "8", "--prompt", "512",
                     "--gen", "32", "--kv-splits", "1", "--prefill-chunk",
                     "128"]
SMOL_LONG = SMOL + ["--batch", "1", "--requests", "1", "--prompt", "4096",
                    "--gen", "32", "--prefill-chunk", "512"]
SMOL_SHORT_CUT = SMOL + ["--batch", "8", "--requests", "4", "--prompt", "512",
                         "--gen", "8", "--kv-splits", "1", "--prefill-chunk",
                         "128"]
SMOL_LONG_CUT = SMOL + ["--batch", "1", "--requests", "1", "--prompt",
                        "4096", "--gen", "8", "--prefill-chunk", "512"]
# model -> [(phase, serve flags, kernels that must launch in it)]
WIDTH_PHASES = {
    "smollm_360m": [
        ("smol-short", SMOL_SHORT, ("etap_decode_dense",)),
        ("smol-short-std", SMOL_SHORT + ["--mode", "standard"],
         ("flash_decode",)),
        ("smol-long", SMOL_LONG, ("etap_partial_dense", "combine_splits")),
        ("smol-long-std", SMOL_LONG_CUT + ["--mode", "standard"],
         ("flash_decode_partial", "combine_splits_std")),
        ("smol-short-int8", SMOL_SHORT + ["--kv-dtype", "int8"],
         ("etap_decode_dense_quant",)),
        ("smol-long-fp8", SMOL_LONG + ["--kv-dtype", "fp8"],
         ("etap_partial_dense_quant", "combine_splits")),
        ("smol-short-std-fp8", SMOL_SHORT_CUT + ["--mode", "standard",
                                                 "--kv-dtype", "fp8"],
         ("flash_decode_quant",)),
        ("smol-long-std-int8", SMOL_LONG_CUT + ["--mode", "standard",
                                                "--kv-dtype", "int8"],
         ("flash_decode_partial_quant", "combine_splits_std")),
    ],
    # StableLM-1.6B (24 layers, MHA: 32 heads, G = 1, head_dim 64), dense
    # layout: B 8 x 544 rows is one split (K5 / K7 [64])
    "stablelm_1_6b": [
        ("stablelm-dense", ["--arch", "stablelm_1_6b", "--cache-layout",
                            "dense", "--batch", "8", "--prompt", "512",
                            "--gen", "32"],
         ("etap_decode_dense", "flash_prefill")),
        ("stablelm-dense-std", ["--arch", "stablelm_1_6b", "--cache-layout",
                                "dense", "--batch", "8", "--prompt", "512",
                                "--gen", "32", "--mode", "standard"],
         ("flash_decode", "flash_prefill")),
    ],
    # MusicGen-large's decoder (48 layers, MHA: 32 heads, head_dim 64),
    # paged, in token space: 256 grouped rows of 9 pages get 2 splits
    "musicgen_large": [
        ("musicgen-short", ["--arch", "musicgen_large", "--batch", "8",
                            "--requests", "8", "--prompt", "512", "--gen",
                            "32", "--prefill-chunk", "128"],
         ("etap_partial_dense", "combine_splits")),
    ],
    # RecurrentGemma-9B (38 layers: 26 RG-LRU, 12 local attention with 16
    # heads over one kv head, head_dim 256, window 2048), dense layout:
    # rgemma-short pins one split (K5 [256]); rgemma-long's 4096-token
    # prompt fills the 2048-row ring, so every decode step writes a wrapped
    # slot, and its auto plan cuts the ring in 2 splits (K6 / K8 + K2)
    "recurrentgemma_9b": [
        ("rgemma-short", ["--arch", "recurrentgemma_9b", "--cache-layout",
                          "dense", "--batch", "8", "--prompt", "512",
                          "--gen", "32", "--kv-splits", "1"],
         ("etap_decode_dense",)),
        ("rgemma-long", ["--arch", "recurrentgemma_9b", "--cache-layout",
                         "dense", "--batch", "1", "--prompt", "4096",
                         "--gen", "32"],
         ("etap_partial_dense", "combine_splits")),
        ("rgemma-long-std", ["--arch", "recurrentgemma_9b", "--cache-layout",
                             "dense", "--batch", "1", "--prompt", "4096",
                             "--gen", "32", "--mode", "standard"],
         ("flash_decode_partial", "combine_splits_std")),
    ],
    # LLaVA-NeXT-34B at full width (56 heads over 8 kv heads: G = 7,
    # head_dim 128), cut to 8 of its 60 layers (its bf16 weights are about
    # 68 GB), dense, in token space: K5 [128] at a group no phase had
    "llava_next_34b": [
        ("llava-dense", ["--arch", "llava_next_34b", "--layers", "8",
                         "--cache-layout", "dense", "--batch", "4",
                         "--prompt", "512", "--gen", "16"],
         ("etap_decode_dense", "flash_prefill")),
    ],
}


# DeepSeek-R1 at 5 layers: its 3 dense layers and its first 2 MoE layers
# (256 experts of 3 x 7168 x 2048, top-8, a shared expert), served with
# serve-short's, serve-long's and dense-short's flags
MOE_LAYERS = 5
MOE_SERVE_PHASES = [
    ("serve-short-moe", SHORT, ("etap_decode_mla_paged",
                                "etap_prefill_mla_paged")),
    ("serve-long-moe", LONG, ("etap_paged_partial", "combine_splits",
                              "etap_prefill_mla_paged")),
    ("dense-short-moe", DENSE + ["--batch", "8", "--prompt", "512"],
     ("etap_decode_dense", "flash_prefill")),
]
# DBRX-132B (GQA, 48 heads over 8 kv heads: G = 6; every layer MoE, 16
# experts of 3 x 6144 x 10752, top-4, no shared expert) at full width, cut
# to 4 of its 40 layers: qwen-short-spec's flags without the spec ones,
# K5 [128] over the gathered pools
DBRX_LAYERS = 4
DBRX_PHASES = [
    ("dbrx-short", ["--arch", "dbrx_132b", "--layers", str(DBRX_LAYERS),
                    "--batch", "8", "--requests", "4", "--prompt", "512",
                    "--gen", "16", "--kv-splits", "1"],
     ("etap_decode_dense",)),
]
# the MoE unit check at DeepSeek's full width: (case, G, S, dropless,
# router skewed); decode's one group of 8 tokens (C = 8 = S), a prompt
# chunk's 8 rows of 32 (C = 8 < S: with the skew, pairs are dropped), the
# capacity rule of a dense prefill (C = 20)
MOE_UNIT_CASES = (("decode", 1, 8, True, False),
                  ("prefill-chunk", 8, 32, True, True),
                  ("capacity", 2, 512, False, False))
# the skew: this much added to these experts' router columns, which moves
# a token's logits for them by 0.1 x sum(x) (sum(x) ~ N(0, 7168))
MOE_SKEWED, MOE_SKEW = (3, 200), 0.1
# a card route may differ from the fp64 top-k only where the fp64 gates at
# the first differing choice and the next are this close (relative)
ROUTE_RTOL = 1e-6


def full_config(layers: int = 3):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("deepseek_r1_671b"),
                               num_layers=layers)


def wrapper_names() -> list:
    """Every kernel wrapper the kernels line reports on."""
    return list(KERNELS) + sorted(
        {w for _, _, w, _ in QUANT_KERNELS.values()}
        | {w for _, _, w, _, _ in QDENSE_KERNELS.values()}
        | {w for _, _, w, _ in PREFILL_KERNELS.values()}
        | {w for _, _, w, _, _ in SEPV_KERNELS.values()})


def kv_dtype_of(flags) -> str:
    """The --kv-dtype a phase's flags set (fp by default)."""
    return flags[flags.index("--kv-dtype") + 1] if "--kv-dtype" in flags \
        else "fp"


def add_qdense(launches: dict, got: dict, width: int, kvd: str) -> None:
    """Credit a main-path call's launches of the quantized dense wrappers
    (``got``: wrapper -> launches) to their (width, code type) entries."""
    for k, (_, _, wrapper, w, code) in QDENSE_KERNELS.items():
        if (w, code) == (width, kvd):
            launches[k] += got.get(wrapper, 0)


def wrapper_module(name: str):
    from repro_torch.kernels.etap import combine as C
    from repro_torch.kernels.etap import etap as K
    from repro_torch.kernels.flash_decode import flash_decode as FD
    from repro_torch.kernels.flash_prefill import flash_prefill as FP
    from repro_torch.kernels.selective_scan import scan as S
    return next(m for m in (K, C, FD, FP, S) if hasattr(m, name))


def counters():
    """Kernel wrapper name -> wrapper (each carries its launch count)."""
    return {name: getattr(wrapper_module(name), name)
            for name in wrapper_names()}


def phase_serve(name: str, flags: list, params, expect: tuple,
                runs: dict | None = None) -> dict:
    """One serve run through the entry points a user calls (``run_paged``
    or ``run_dense`` as ``--cache-layout`` says), with every launch count
    zeroed just before it and read just after; each kernel in ``expect``
    must have launched.  Peak memory is this phase's own.  ``runs``: keeps
    the run's flags, outputs, launches and spec counters under ``name``.
    Returns the run's launch counts."""
    import torch
    from repro_torch.launch import serve
    t_wall = time.perf_counter()
    args = serve.parse_args(flags)
    cfg = serve.config_for(args)
    torch.cuda.reset_peak_memory_stats()
    for fn in counters().values():
        fn.launches = 0
    if args.cache_layout == "dense":
        res = serve.run_dense(args, cfg, params=params, device="cuda")
        outputs = {b: row.tolist() for b, row in enumerate(res["tokens"])}
        n_req, t_total = args.batch, res["t_prefill"] + res["t_decode"]
    else:
        res = serve.run_paged(args, cfg, params=params, device="cuda")
        outputs, n_req, t_total = res["outputs"], args.requests, \
            res["t_total"]
    launched = {k: fn.launches for k, fn in counters().items()}
    t_wall = time.perf_counter() - t_wall
    # K9 runs once a full-attention layer of a dense prefill, never on the
    # paged layout's chunked prefill
    want = cfg.layer_kinds().count("attn") if args.cache_layout == "dense" \
        and prefill_kernel_width(cfg) else 0
    if launched["flash_prefill"] != want:
        raise AssertionError(f"{name}: K9 launched "
                             f"{launched['flash_prefill']} times, not {want}")
    if len(outputs) != n_req:
        raise AssertionError(f"{name}: {len(outputs)} of {n_req} "
                             "requests finished")
    for rid, toks in outputs.items():
        if not toks or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"{name}: request {rid} tokens {toks}")
    tps = res["tokens_served"] / t_total
    slots = res.get("batch_slots", args.batch)
    log(f"[{name}] {' '.join(flags)}: {cfg.num_layers} layers, "
        f"{res['tokens_served']} tokens, batch_slots {slots}, "
        f"{tps:.1f} tok/s, "
        f"t_prefill {res['t_prefill']:.3f} s, "
        f"t_decode {res['t_decode']:.3f} s, phase wall {t_wall:.1f} s, "
        f"launches "
        f"{ {k: v for k, v in launched.items() if v} }, "
        f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    for k in expect:
        if launched[k] == 0:
            raise AssertionError(f"{name}: {k} did not launch")
    if runs is not None:
        runs[name] = {"flags": flags, "outputs": outputs,
                      "launched": launched, "tok_s": tps,
                      **{k: res.get(k) for k in ("spec", "t_drafter",
                                                 "prefill_chunks",
                                                 "batch_slots", "steps",
                                                 "metrics",
                                                 "kernel_report", "prefix",
                                                 "prefill_tokens",
                                                 "prefill_tokens_saved",
                                                 "sched")}}
    return launched


def phase_spec_serve(name, flags, params, expect, off, runs) -> tuple:
    """A spec serve phase (phase_serve), then its spec-off run ``off`` when
    no earlier phase of that name ran: prints k, the verify steps, the
    drafts proposed and accepted and the acceptance rate (with the head
    drafter, the seconds its table took), and fails unless verify steps
    ran and, through K4 / K4q, each of them (and the warm-up verify)
    launched the verify kernel once a layer.  Returns the spec run's
    launch counts and, when it was made here, the spec-off run's (a
    tuple)."""
    from repro_torch.launch import serve
    got = phase_serve(name, flags, params, expect, runs)
    cfg = serve.config_for(serve.parse_args(flags))
    sp, run = runs[name]["spec"], runs[name]
    log(f"[{name}] spec: k {sp['k']}, draft {sp['draft']}, verify steps "
        f"{sp['steps']}, proposed {sp['proposed']}, accepted "
        f"{sp['accepted']}, acceptance rate {sp['acceptance_rate']:.2%}, "
        f"{run['tok_s']:.1f} tok/s"
        + (f"; head table built in {run['t_drafter']:.2f} s"
           if sp["draft"] == "head" else ""))
    if sp["steps"] == 0:
        raise AssertionError(f"{name}: no verify step ran")
    if cfg.attention_kind == "mla":
        wrapper = "etap_verify_mla_paged" + (
            "" if kv_dtype_of(flags) == "fp" else "_quant")
        want = cfg.num_layers * (sp["steps"] + 1)
        if got[wrapper] != want:
            raise AssertionError(f"{name}: {wrapper} launched {got[wrapper]} "
                                 f"times, not {want} (once a layer a verify "
                                 "step and the warm-up)")
    if off in runs:
        return (got,)
    return got, phase_serve(off, spec_off_flags(flags), params,
                            tuple(k for k in expect
                                  if not k.startswith("etap_verify")), runs)


@contextlib.contextmanager
def plain_kernels():
    """Route the model's kernels through their plain versions (on CUDA
    tensors) for the kernel-vs-plain comparisons of phases 5 and 7."""
    saved = []
    for name in wrapper_names():
        mod = wrapper_module(name)
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, getattr(mod, name + "_plain"))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def kernel_p_precision():
    """softmax_state.update with P entering the P·V product as the bf16
    kernels carry it, two bf16 terms hi + lo (about 16 significant bits; l
    still sums the fp32 p).  That rounding is where a bf16 kernel's
    attention output departs from its plain version's: on the card the
    kernels flip 0.2-0.3% of a layer's bf16 outputs by one ulp against
    the plain versions, a reordered sum with fp32 P far fewer (the
    per-layer check prints both shares)."""
    import torch
    from repro_torch.kernels import softmax_state
    update = softmax_state.update

    def update16(state, s, pv, **kw):
        def pv16(p):
            hi = p.to(torch.bfloat16).float()
            return pv(hi + (p - hi).to(torch.bfloat16).float())
        return update(state, s, pv16, **kw)

    softmax_state.update = update16
    try:
        yield
    finally:
        softmax_state.update = update


def _p16(fn):
    """fn under kernel_p_precision()."""
    def run(*a, **kw):
        with kernel_p_precision():
            return fn(*a, **kw)
    return run


@contextlib.contextmanager
def reordered_plain(kernel_p: bool = True):
    """plain_kernels(), with the dense decode kernels' plain versions
    walking blocks of half their size (the same split boundaries) and, for
    bf16 rows with ``kernel_p``, with the kernels' P precision
    (kernel_p_precision; the quantized kernels carry P * scale in three
    terms, the fp32 product's 24 bits): the same arithmetic with another
    fp32 summation order and the kernels' rounding of P, whose distance
    from plain_kernels() is the noise floor of a kernel-vs-plain
    comparison."""
    with plain_kernels():
        saved = []
        for name in ("etap_decode_dense", "flash_decode",
                     "etap_decode_dense_quant", "flash_decode_quant"):
            mod = wrapper_module(name)
            saved.append((mod, name, getattr(mod, name)))
            fn = getattr(mod, name)
            if kernel_p and not name.endswith("_quant"):
                fn = _p16(fn)
            setattr(mod, name, lambda *a, block, _p=fn, **kw:
                    _p(*a, block=max(1, block // 2), **kw))
        for name in ("etap_partial_dense", "flash_decode_partial",
                     "etap_partial_dense_quant",
                     "flash_decode_partial_quant"):
            mod = wrapper_module(name)
            saved.append((mod, name, getattr(mod, name)))
            fn = getattr(mod, name)
            if kernel_p and not name.endswith("_quant"):
                fn = _p16(fn)
            setattr(mod, name, lambda *a, plan, _p=fn, **kw:
                    _p(*a, plan=dataclasses.replace(
                        plan, block=plan.block // 2,
                        nb_per_split=2 * plan.nb_per_split), **kw))
        try:
            yield
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)


# The share of attention-output elements ulp_noise moves by one bf16 ulp:
# above the shares by which the bf16 kernels differ from their plain
# versions on a layer's own inputs (on the H100: 0.24% SmolLM-360M and
# Qwen3-8B, 0.30-0.34% StableLM-1.6B, 0.28-0.34% RecurrentGemma-9B; the
# per-layer check prints them)
NOISE_RATE = 5e-3


def one_ulp(o, gen):
    """o with NOISE_RATE of its elements moved one bf16 ulp up or down,
    chosen by ``gen``."""
    import torch
    x = o.float()
    _, e = torch.frexp(x)
    ulp = torch.where(x == 0, torch.zeros_like(x),
                      torch.ldexp(torch.ones_like(x), e - 8))
    pick = torch.rand(x.shape, generator=gen, device=x.device) < NOISE_RATE
    sign = torch.rand(x.shape, generator=gen, device=x.device) < 0.5
    return (x + torch.where(sign, ulp, -ulp) * pick).to(o.dtype)


@contextlib.contextmanager
def ulp_noise(seed: int = 0):
    """plain_kernels(), with every attention output moved by one bf16 ulp
    (up or down) at NOISE_RATE of its elements, chosen by a seeded
    generator: the logit difference that one-ulp disagreements at that
    share, carried through a deep stack of random layers, give.  A fixed
    rate, not one measured on the kernel, so that a kernel far off its
    plain version cannot raise its own gate."""
    import torch
    from repro_torch.models import attention
    gqa = attention.gqa_decode
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def noisy(*a, **kw):
        return one_ulp(gqa(*a, **kw), gen)

    with plain_kernels():
        attention.gqa_decode = noisy
        try:
            yield
        finally:
            attention.gqa_decode = gqa


def check_step(lk, lp, what: str, tag: str = "decode-step",
               floor: float | None = None) -> None:
    """Kernel-path logits lk against plain-path logits lp: within
    LOGIT_RTOL of the largest logit, and the same greedy token wherever the
    plain path's top-two margin exceeds the largest logit difference (a
    closer call is a tie at this tolerance).  ``floor``: the largest logit
    difference between the plain path and a perturbed plain path on the
    same inputs (reordered_plain; for the 64- and 256-wide models also
    ulp_noise); a deep stack of random layers carries one-ulp differences
    in the attention outputs past LOGIT_RTOL however they arise, so the
    gate is then the larger of LOGIT_RTOL of the largest logit and twice
    the floor."""
    import torch
    d = float((lk - lp).abs().max())
    scale = float(lp.abs().max())
    gate = LOGIT_RTOL * scale
    if floor is not None:
        gate = max(gate, 2 * floor)
    top2 = lp.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > d
    agree = lk.argmax(-1) == lp.argmax(-1)
    log(f"[{tag}] {what}: max |dlogit| {d:.4e} ({d / scale:.2%} of the max "
        f"|logit| {scale:.3f}"
        + ("" if floor is None else
           f"; floor, plain vs a perturbed plain, {floor:.4e}, "
           f"{floor / scale:.2%}")
        + f"), gate {gate:.4e}, greedy agreement "
        f"{int(agree.sum())}/{len(agree)} ({int(decided.sum())} rows "
        "decided beyond the difference)")
    if not torch.isfinite(lk).all() or d > gate:
        raise AssertionError(f"{tag} ({what}): kernel path disagrees with "
                             "the plain path")
    if not bool(agree[decided].all()):
        raise AssertionError(f"{tag} ({what}): greedy tokens differ")


def device_busy(prof) -> tuple[float, float, int]:
    """From one torch.profiler run, the device's timeline: the ms in which
    a kernel or copy ran (the union of their intervals, so an overlap is
    counted once), the ms from the first one's start to the last one's end,
    and their number."""
    import torch
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.time_range.end > e.time_range.start)
    if not spans:
        raise AssertionError("torch.profiler recorded no device activity")
    busy, (lo, hi) = 0.0, spans[0]
    first, last = spans[0][0], max(end for _, end in spans)
    for start, end in spans[1:]:
        if start > hi:
            busy += hi - lo
            lo = start
        hi = max(hi, end)
    busy += hi - lo
    return busy / 1e3, (last - first) / 1e3, len(spans)


def timeline_line(wall, busy, span, n, unprofiled) -> str:
    """The device's busy and idle share of one profiled run's wall time."""
    return (f"profiled run: wall {wall:.3f} ms (host clock, to the sync), "
            f"device busy {busy:.3f} ms ({n} kernels and copies, union of "
            f"their intervals), idle {100 * (1 - busy / wall):.1f}% of the "
            f"wall, {100 * (1 - busy / span):.1f}% of the {span:.3f} ms from "
            f"the first kernel's start to the last's end; unprofiled wall "
            f"{unprofiled:.3f} ms")


def profile_decode_step(params, cfg, cache, toks, *, spec=None,
                        tag="decode-step", **layout) -> None:
    """Where one full-width decode step spends its time, from one step
    under torch.profiler: its wall time (host clock, synchronised), the
    device's busy and idle share of it and the device time by kernel;
    beside them an unprofiled step's wall (median of 5) and the step's byte
    bound (its weights, the fp32 unembedding table, the live cache rows of
    its attention layers and the recurrent states of the others, read
    once).  ``layout``: decode_step's cache keywords (paged: block_table
    and lengths; dense: pos).  Returns the device's busy ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model
    layout.setdefault("cache_layout", "paged")

    def step():
        model.decode_step(params, cfg, cache, toks, spec=spec, **layout)
        torch.cuda.synchronize()

    step()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        walls.append((time.perf_counter() - t0) * 1e3)
    unprofiled = sorted(walls)[len(walls) // 2]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        wall = (time.perf_counter() - t0) * 1e3
    busy, span, n = device_busy(prof)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    layer_bytes = sum(t.numel() * t.element_size() for lp in params["layers"]
                      for t in _leaves(lp))
    kinds = cfg.layer_kinds()
    att = cache[kinds.index("attn")] if "attn" in kinds else {}
    row = sum(t.numel() // (t.shape[0] * t.shape[1]) * t.element_size()
              for t in att.values())
    if layout["cache_layout"] == "paged":
        live = int((layout["lengths"] + 1).sum())
    else:
        S = next(iter(att.values())).shape[1] if att else 0
        live = toks.shape[0] * min(layout["pos"] + 1, S)
    states = sum(t.numel() * t.element_size()
                 for layer, kind in zip(cache, kinds, strict=True)
                 if kind != "attn" for t in layer.values())
    need = (layer_bytes + params["embed_f32"].numel() * 4
            + live * row * kinds.count("attn") + states)
    log(f"[{tag}] " + timeline_line(wall, busy, span, n, unprofiled)
        + " (median of 5)")
    log(f"[{tag}] byte bound {need / HBM_BYTES_PER_S * 1e3:.3f} ms, "
        f"{sum(e.count for e in kernels)} kernel launches "
        f"({len(kernels)} kernel names)")
    groups = {"attention": 0.0, "gemm": 0.0, "other": 0.0}
    attn = ("etap_kernel", "flash_decode_kernel", "combine_kernel",
            "combine_rows_kernel")
    groups["gather"] = 0.0
    gather = ("index", "gather", "catarray")
    for e in kernels:
        name = e.key.lower()
        key = ("attention" if any(x in name for x in attn)
               else "gemm" if any(x in name for x in ("gemm", "xmma",
                                                       "cutlass", "nvjet"))
               else "gather" if any(x in name for x in gather)
               else "other")
        groups[key] += e.self_device_time_total / 1e3
    log(f"[{tag}] device ms by group: " + ", ".join(
        f"{k} {v:.3f}" for k, v in groups.items()))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[{tag}]   {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<4d} {e.key[:90]}")
    return busy


GEMM_NAMES = ("gemm", "xmma", "cutlass", "nvjet")
ELEMENTWISE_NAMES = ("elementwise", "vectorized", "unrolled", "reduce")


def profile_prefill(params, cfg, B: int, S: int, *, tag: str,
                    kernel: tuple) -> None:
    """Where one full-width prefill (B x S) spends its device time, from
    one torch.profiler run: the run's wall time and the device's busy and
    idle share of it; device time in the kernel ``kernel`` = (label, a
    substring of its name), in the GEMMs, in the elementwise passes and in
    the rest, and the kernel's share of the busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device="cuda")

    def run():
        model.prefill(params, cfg, toks, S + 1)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    unprofiled = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = (time.perf_counter() - t0) * 1e3
    busy, span, n = device_busy(prof)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    label, name_part = kernel
    groups = {label: 0.0, "gemm": 0.0, "elementwise": 0.0, "other": 0.0}
    for e in kernels:
        name = e.key.lower()
        key = (label if name_part in name
               else "gemm" if any(x in name for x in GEMM_NAMES)
               else "elementwise" if any(x in name for x in ELEMENTWISE_NAMES)
               else "other")
        groups[key] += e.self_device_time_total / 1e3
    log(f"[{tag}] B={B} S={S}, {cfg.num_layers} layers, "
        + timeline_line(wall, busy, span, n, unprofiled)
        + f"; {sum(e.count for e in kernels)} kernel launches")
    log(f"[{tag}] device ms by group: " + ", ".join(
        f"{k} {v:.2f}" for k, v in groups.items())
        + f"; {label} {100 * groups[label] / busy:.1f}% of the busy time")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[{tag}]   {e.self_device_time_total / 1e3:8.2f} ms "
            f"x{e.count:<5d} {e.key[:90]}")


def profile_mamba_prefill(params, cfg, B: int, S: int) -> None:
    """Where one full-width falcon prefill (B x S, mamba-short's) spends
    its device time: K10, the eager ``_ssm_inputs`` and conv (elementwise
    kernels over [B, S, 8192(, 16)]), the projections (GEMMs), and the
    rest (profile_prefill)."""
    profile_prefill(params, cfg, B, S, tag="mamba-prefill",
                    kernel=("selective_scan (K10)", "scan_kernel"))


# (B, prompt, layers) of the falcon prefill check: the B 2 x 128 case at
# full depth; mamba-short's prefill at full depth; mamba-long's (6144 tokens
# left-padded to 8192, two scan chunks) at full width, cut to its first 8
# layers so that the plain scan's 8192 eager steps a layer stay a few seconds
MAMBA_CHECKS = [(2, 128, None), (8, 512, None), (1, 6144, 8)]


def phase_mamba_check(params, cfg) -> None:
    """Falcon's prefill at full width through K10 and through the plain
    scan on the same weights, at each of MAMBA_CHECKS: the last position's
    logits agree as decode steps must (check_step); then 4 decode steps
    from each path's cache, fed the same tokens, compared the same way."""
    import torch
    from repro_torch.kernels.selective_scan import scan as S
    from repro_torch.models import model
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    steps = 4
    for B, P, layers in MAMBA_CHECKS:
        c, p = cfg, params
        if layers is not None:
            c = dataclasses.replace(cfg, num_layers=layers)
            p = dict(params, layers=params["layers"][:layers])
        what = (f"falcon prefill, full width, {c.num_layers} layers, B={B} "
                f"S={P}")
        toks = torch.randint(0, c.vocab_size, (B, P + steps), generator=gen,
                             device="cuda", dtype=torch.int32)
        before = S.selective_scan.launches
        lk, ck, pos = model.prefill(p, c, toks[:, :P], P + steps)
        if S.selective_scan.launches - before != c.num_layers:
            raise AssertionError(f"{what}: K10 did not launch once a layer")
        with plain_kernels():
            lp, cp, _ = model.prefill(p, c, toks[:, :P], P + steps)
        log(f"[mamba-prefill] {what}: last-position logits bitwise equal: "
            f"{torch.equal(lk, lp)}")
        check_step(lk, lp, what, tag="mamba-prefill")
        for i in range(steps):
            lk, ck = model.decode_step(p, c, ck, toks[:, P + i], pos + i)
            lp, cp = model.decode_step(p, c, cp, toks[:, P + i], pos + i)
            check_step(lk, lp, f"decode step {i + 1} after the {what}",
                       tag="mamba-prefill")
        del lk, lp, ck, cp
        torch.cuda.empty_cache()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def quant_pools(cache, kv_dtype, gen):
    """Fill a quantized paged cache's pools with the codes and (scale, zp)
    rows of random fp32 rows (every pool and its "*_sz" pool).  Returns
    the cache."""
    import torch
    from repro_torch.runtime import paged_cache
    for layer in cache:
        for key in [k for k in layer if not k.endswith("_sz")]:
            codes, sz = paged_cache.quantize_pool(
                torch.randn(layer[key].shape, generator=gen,
                            device=layer[key].device), kv_dtype)
            paged_cache.raw(layer[key]).copy_(paged_cache.raw(codes))
            layer[key + "_sz"].copy_(sz)
    return cache


def phase_decode_step(params, launches: dict) -> None:
    """Full-width decode steps, each through the kernels and through the
    plain versions on the same weights and cache: over the paged cache
    (one split), over int8 pools (one split; and four, at serve-long-int8's
    7 slots and 65-page rows), in the standard mode over an fp8 pool (one
    split: K7q) and an int8 pool (four splits at serve-long-int8's rows:
    K8q + K2), and over the dense cache in both modes with one split and
    with two.  The kernel paths' K7q / K8q launches are credited to
    ``launches``."""
    import torch
    from repro_torch.core.attn_spec import AttnSpec
    from repro_torch.models import model
    from repro_torch.runtime import paged_cache
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
        return model.decode_step(params, cfg, c, toks, cache_layout="paged",
                                 block_table=table, lengths=lengths)[0]

    lk = step()
    with plain_kernels():
        lp = step()
    profile_decode_step(params, cfg, cache, toks, block_table=table,
                        lengths=lengths)
    check_step(lk, lp, f"paged, full width, B={B} ctx<={ctx}")
    del cache

    # the same step over an int8 pool holding the codes of random rows
    qcache = model.init_paged_cache(cfg, layout, kv_dtype="int8", device=dev)
    for layer in qcache:
        codes, sz = paged_cache.quantize_pool(
            torch.randn(layer["c"].shape, generator=gen, device=dev), "int8")
        layer["c"].copy_(codes)
        layer["c_sz"].copy_(sz)

    def qstep():
        c = [{k: v.clone() for k, v in layer.items()} for layer in qcache]
        return model.decode_step(params, cfg, c, toks, cache_layout="paged",
                                 block_table=table, lengths=lengths)[0]

    from repro_torch.kernels.etap import etap as K
    before = K.etap_decode_mla_paged_quant.launches
    lk = qstep()
    if K.etap_decode_mla_paged_quant.launches == before:
        raise AssertionError("the int8 decode step did not launch K3q")
    with plain_kernels():
        lp = qstep()
    check_step(lk, lp, f"paged int8, full width, B={B} ctx<={ctx}")
    del qcache

    # --mode standard over an fp8 pool: the gathered codes through K7q
    from repro_torch.kernels.flash_decode import flash_decode as FD
    fcache = quant_pools(model.init_paged_cache(cfg, layout, kv_dtype="fp8",
                                                device=dev), "fp8", gen)
    sspec = AttnSpec(mode="standard", kv_splits=1)

    def fstep():
        c = [{k: v.clone() for k, v in layer.items()} for layer in fcache]
        return model.decode_step(params, cfg, c, toks, spec=sspec,
                                 cache_layout="paged", block_table=table,
                                 lengths=lengths)[0]

    before = FD.flash_decode_quant.launches
    lk = fstep()
    got = FD.flash_decode_quant.launches - before
    if got != cfg.num_layers:
        raise AssertionError("the fp8 standard step did not launch K7q once "
                             "a layer")
    add_qdense(launches, {"flash_decode_quant": got}, DK, "fp8")
    with plain_kernels():
        lp = fstep()
    check_step(lk, lp, f"paged fp8 standard kv_splits=1, full width, B={B} "
               f"ctx<={ctx}")
    del fcache

    # the split-KV int8 step of serve-long-int8: 7 slots over 65-page
    # rows (4 splits of 17 after padding to 68), three of them idle.  The
    # idle slots' writes race for row 0 of the null block, which each of
    # them then reads, so their logits depend on which write won (the
    # serve loop drops them): only the live rows are compared, and every
    # row must be finite
    lctx, lens = 4128, [4127, 4096, 1088, 64]
    llayout = layout_for(7, lctx, block_size=PAGE)
    lbp = BlockPool(llayout, 7)
    for n in lens:
        lbp.extend(lbp.admit(0, lctx), n)
    ltable, llengths = lbp.device_views(dev)
    lcache = model.init_paged_cache(cfg, llayout, kv_dtype="int8", device=dev)
    for layer in lcache:
        codes, sz = paged_cache.quantize_pool(
            torch.randn(layer["c"].shape, generator=gen, device=dev), "int8")
        layer["c"].copy_(codes)
        layer["c_sz"].copy_(sz)
    ltoks = torch.randint(0, cfg.vocab_size, (7,), generator=gen, device=dev)
    lspec = AttnSpec(kv_splits=4)

    def lstep():
        c = [{k: v.clone() for k, v in layer.items()} for layer in lcache]
        return model.decode_step(params, cfg, c, ltoks, spec=lspec,
                                 cache_layout="paged", block_table=ltable,
                                 lengths=llengths)[0]

    before = K.etap_paged_partial_quant.launches
    lk = lstep()
    if K.etap_paged_partial_quant.launches == before:
        raise AssertionError("the int8 split decode step did not launch K1q")
    with plain_kernels():
        lp = lstep()
    if not bool(torch.isfinite(lk).all()):
        raise AssertionError("the int8 split decode step gave non-finite "
                             "logits")
    log(f"[decode-step] int8 kv_splits=4: idle rows' max |dlogit| "
        f"{float((lk[len(lens):] - lp[len(lens):]).abs().max()):.4e} "
        f"(not compared)")
    check_step(lk[:len(lens)], lp[:len(lens)], f"paged int8 kv_splits=4, "
               f"full width, {len(lens)} live of B=7, ctx<={lctx}")

    # the same rows in the standard mode: K8q + K2 [n,H,Dv] over the
    # gathered codes (the idle rows as above)
    lsspec = AttnSpec(mode="standard", kv_splits=4)

    def lsstep():
        c = [{k: v.clone() for k, v in layer.items()} for layer in lcache]
        return model.decode_step(params, cfg, c, ltoks, spec=lsspec,
                                 cache_layout="paged", block_table=ltable,
                                 lengths=llengths)[0]

    before = FD.flash_decode_partial_quant.launches
    lk = lsstep()
    got = FD.flash_decode_partial_quant.launches - before
    if got != cfg.num_layers:
        raise AssertionError("the int8 standard split step did not launch "
                             "K8q once a layer")
    add_qdense(launches, {"flash_decode_partial_quant": got}, DK, "int8")
    with plain_kernels():
        lp = lsstep()
    if not bool(torch.isfinite(lk).all()):
        raise AssertionError("the int8 standard split step gave non-finite "
                             "logits")
    check_step(lk[:len(lens)], lp[:len(lens)], f"paged int8 standard "
               f"kv_splits=4, full width, {len(lens)} live of B=7, "
               f"ctx<={lctx}")
    del lcache

    # dense: S 2080 ends in a 32-row tile; two splits of 1536 rows pad it
    # to 3072, the second split holding the tile and the padding
    dctx, pos = 2080, 2070               # every row: 2071 live positions
    dense = model.init_cache(cfg, B, dctx, device=dev)
    for layer in dense:
        layer["c"].copy_(torch.randn(layer["c"].shape, generator=gen,
                                     device=dev).to(torch.bfloat16))
    for mode in ("etap", "standard"):
        for kv_splits in (1, 2):
            spec = AttnSpec(mode=mode, kv_splits=kv_splits)

            def dstep(spec=spec):
                c = [{k: v.clone() for k, v in layer.items()}
                     for layer in dense]
                return model.decode_step(params, cfg, c, toks, pos, spec=spec,
                                         cache_layout="dense")[0]

            lk = dstep()
            with plain_kernels():
                lp = dstep()
            check_step(lk, lp, f"dense {mode} kv_splits={kv_splits}, full "
                       f"width, B={B} S={dctx} pos={pos}")


# ------------------------------------------- phase 5: the verify step
def clone_cache(cache):
    return [{k: v.clone() for k, v in layer.items()} for layer in cache]


def verify_setup(cfg, kvd: str, gen):
    """A full-width paged cache for the verify-step checks: 8 slots of
    phase_decode_step's ragged lengths (up to 2047 tokens) with room for
    SPEC_K more, the pools random rows (bf16, or the codes and pairs of
    fp32 rows).  Returns (cache, table, lengths)."""
    from repro_torch.models import model
    from repro_torch.runtime.paged_cache import BlockPool, layout_for
    dev = gen.device
    B, ctx = 8, 2048 + SPEC_K
    layout = layout_for(B, ctx, block_size=PAGE)
    bp = BlockPool(layout, B)
    for n in [2047, 1500, 1, 700, 2000, 64, 1999, 1024]:
        bp.extend(bp.admit(0, ctx), n)
    cache = model.init_paged_cache(cfg, layout, kv_dtype=kvd, device=dev)
    cache = fill_random(cache, gen) if kvd == "fp" else \
        quant_pools(cache, kvd, gen)
    table, lengths = bp.device_views(dev)
    return cache, table, lengths


def verify_vs_decode(params, cfg, kvd: str, spec, gen, tag: str,
                     floor: bool = False) -> float:
    """verify_step at k 1 against decode_step on the same cache and token,
    both through the kernels (K4 / K4q against the decode kernels the
    spec picks; a GQA model: the plain masked product against K5-K8):
    check_step's gate with decode as the reference, greedy tokens equal on
    decided rows; with ``floor``, the gate of the GQA decode-step checks
    (phase_gqa_decode_steps: the larger of the decode step's reordered
    plain path and one-ulp noise, each against its plain path: a deep
    stack of random layers carries one-ulp differences past 2%).  Returns
    the largest logit difference."""
    import torch
    from repro_torch.models import model
    cache, table, lengths = verify_setup(cfg, kvd, gen)
    toks = torch.randint(0, cfg.vocab_size, (8,), generator=gen,
                         device=gen.device, dtype=torch.int32)

    def decode():
        return model.decode_step(params, cfg, clone_cache(cache), toks,
                                 spec=spec, cache_layout="paged",
                                 block_table=table, lengths=lengths)[0]

    ld = decode()
    lv = model.verify_step(params, cfg, clone_cache(cache), toks[:, None],
                           table, lengths, spec=spec)[0][:, 0]
    gate_floor = None
    if floor:
        with plain_kernels():
            lp = decode()
        with reordered_plain():
            gate_floor = float((decode() - lp).abs().max())
        with ulp_noise():
            gate_floor = max(gate_floor, float((decode() - lp).abs().max()))
    check_step(lv, ld, f"{tag}: verify (k 1) vs decode step, {kvd} pool, "
               f"mode {spec.mode}, full width, B=8 ctx<=2047",
               tag="verify-step", floor=gate_floor)
    return float((lv - ld).abs().max())


def phase_verify_steps(params, cfg, diffs: dict) -> None:
    """Full-width DeepSeek verify steps (k = SPEC_K, linear) over bf16, int8
    and fp8 pools: through the kernels (K4 / K4q, once a layer) against
    the plain versions, under check_step's gate (over bf16 with the floor
    of a plain path with the kernels' P precision); linear verify_step ==
    prefill_chunk bitwise, logits and every pool (codes and pairs); then
    verify at k 1 against the decode step (verify_vs_decode) per pool and
    mode, whose largest logit difference goes to ``diffs[(kvd, mode)]``:
    the spec serve phases' streams may part only where the spec-off step's
    top-two gap is below it."""
    import torch
    from repro_torch.core.attn_spec import AttnSpec
    from repro_torch.kernels.etap import etap as K
    from repro_torch.models import model
    gen = torch.Generator(device=params["embed"].device)
    gen.manual_seed(5)
    V = cfg.vocab_size
    for kvd in ("fp", "int8", "fp8"):
        cache, table, lengths = verify_setup(cfg, kvd, gen)
        toks = torch.randint(0, V, (8, SPEC_K), generator=gen,
                             device=gen.device, dtype=torch.int32)
        wrapper = getattr(K, "etap_verify_mla_paged" + (
            "" if kvd == "fp" else "_quant"))

        def verify(c=cache, t=toks, tb=table, ln=lengths):
            return model.verify_step(params, cfg, clone_cache(c), t, tb,
                                     ln)[0].reshape(-1, V)

        before = wrapper.launches
        lk = verify()
        if wrapper.launches - before != cfg.num_layers:
            raise AssertionError(f"verify step {kvd}: the verify kernel did "
                                 "not launch once a layer")
        with plain_kernels():
            lp = verify()
            floor = None
            if kvd == "fp":
                with kernel_p_precision():
                    floor = float((verify() - lp).abs().max())
        check_step(lk, lp, f"verify step k={SPEC_K} {kvd}, full width, "
                   f"B=8 ctx<=2047, kernels vs plain", tag="verify-step",
                   floor=floor)
        ca, cb = clone_cache(cache), clone_cache(cache)
        lpf, ca = model.prefill_chunk(params, cfg, ca, toks, table, lengths)
        lv, cb = model.verify_step(params, cfg, cb, toks, table, lengths)
        bitwise(lv, lpf, f"verify step {kvd}: linear verify logits vs "
                "prefill_chunk's")
        for i, (a, b) in enumerate(zip(ca, cb, strict=True)):
            for key in a:
                bitwise(b[key], a[key], f"verify step {kvd}: layer {i} "
                        f"{key} vs prefill_chunk's")
        log(f"[verify-step] {kvd}: linear verify_step == prefill_chunk "
            f"bitwise (logits and every pool: {sorted(cache[0])})")
        del cache, ca, cb
    for kvd, mode in (("fp", "etap"), ("fp", "standard"), ("int8", "etap"),
                      ("fp8", "etap")):
        diffs[(kvd, mode)] = verify_vs_decode(params, cfg, kvd,
                                              AttnSpec(mode=mode), gen,
                                              "deepseek")
    log(f"[verify-step] decode-vs-verify differences: {diffs}")


def replay_logits(params, flags, rid: int, stream: list, p: int):
    """The logits of the spec-off decode step that chose ``stream[p]`` of
    request ``rid`` of a run of ``flags``: the request alone in a pool of
    the run's layout and batch slots (the others masked to the null block,
    as a serve step leaves idle slots), its prompt prefilled in the run's
    chunks, then ``stream[:p]`` fed one step at a time."""
    import torch
    from repro_torch.core.attn_spec import AttnSpec
    from repro_torch.launch import serve
    from repro_torch.models import model
    from repro_torch.runtime.paged_cache import BlockPool
    dev = params["embed"].device
    args = serve.parse_args(flags)
    cfg = serve.config_for(args)
    req = serve._make_requests(args, cfg.vocab_size)[rid]
    layout, B = serve.paged_layout(args, cfg)
    spec = AttnSpec(mode=args.mode, kv_splits=args.kv_splits,
                    kv_dtype=args.kv_dtype)
    cache = model.init_paged_cache(cfg, layout, kv_dtype=args.kv_dtype,
                                   device=dev)
    bp = BlockPool(layout, B)
    prompt = torch.as_tensor(req["prompt"], device=dev)
    slot = bp.admit(0, len(prompt) + req["gen"])
    pos, chunk = 0, args.prefill_chunk
    while pos < len(prompt):
        c = min(chunk - pos % chunk, len(prompt) - pos)
        logits, cache = model.prefill_chunk(
            params, cfg, cache, prompt[None, pos:pos + c],
            torch.tensor(bp.table[slot:slot + 1], device=dev),
            torch.tensor(bp.lengths[slot:slot + 1], device=dev), spec=spec)
        bp.extend(slot, c)
        pos += c
    last = logits[0, -1]
    for i in range(p):
        toks = torch.zeros(B, dtype=torch.int32, device=dev)
        toks[slot] = stream[i]
        table = torch.zeros_like(torch.as_tensor(bp.table), device=dev)
        table[slot] = torch.as_tensor(bp.table[slot], device=dev)
        lens = torch.zeros(B, dtype=torch.int32, device=dev)
        lens[slot] = int(bp.lengths[slot])
        logits, cache = model.decode_step(params, cfg, cache, toks, spec=spec,
                                          cache_layout="paged",
                                          block_table=table, lengths=lens)
        last = logits[slot]
        bp.append(slot)
    return last.float()


def spec_stream_check(name: str, off: str, runs: dict, params,
                      diff: float) -> None:
    """Phase ``name``'s streams against its spec-off run ``off``, request by
    request: equal, or parting first at a position where the spec-off
    decode step's top-two logit gap (replay_logits) is below ``diff``, the
    decode-vs-verify difference verify_vs_decode measured.  Anything else
    fails."""
    on, ref = runs[name]["outputs"], runs[off]["outputs"]
    if sorted(on) != sorted(ref):
        raise AssertionError(f"{name}: requests {sorted(on)} against "
                             f"{off}'s {sorted(ref)}")
    parted = []
    for rid in sorted(on):
        a, b = on[rid], ref[rid]
        if a == b:
            continue
        if len(a) != len(b):
            raise AssertionError(f"{name}: request {rid} delivered {len(a)} "
                                 f"tokens, {off} {len(b)}")
        p = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        lg = replay_logits(params, runs[off]["flags"], rid, b, p)
        top2 = lg.topk(2).values
        gap = float(top2[0] - top2[1])
        same = int(lg.argmax()) == b[p]
        log(f"[{name}] request {rid} parts from {off} at token {p} of "
            f"{len(b)} ({a[p]} against {b[p]}): the spec-off step's top-two "
            f"gap {gap:.4e}, the decode-vs-verify difference {diff:.4e}; "
            f"the replayed step picks {off}'s token: {same}")
        if not gap < diff:
            raise AssertionError(f"{name}: request {rid} parts from {off} at "
                                 f"a decided position (gap {gap:.4e} >= "
                                 f"{diff:.4e})")
        parted.append(rid)
    log(f"[{name}] streams against {off}: {len(on) - len(parted)} of "
        f"{len(on)} equal, {len(parted)} part at an undecided position "
        f"{parted}")


# ------------------------------------------------ the GQA models' checks
# the single-pass and split phase-1 wrappers of the dense decode (bf16 rows
# and code rows): one of them runs once an attention layer a decode step
DECODE_WRAPPERS = ("etap_decode_dense", "etap_partial_dense", "flash_decode",
                   "flash_decode_partial", "etap_decode_dense_quant",
                   "etap_partial_dense_quant", "flash_decode_quant",
                   "flash_decode_partial_quant")


def credit(launches: dict, got: dict, width: int, kvd: str) -> None:
    """Credit a main-path call's launches (``got``: wrapper -> launches) of
    a GQA model at head width ``width`` to that width's entries, the bf16
    ``[width]`` ones (GQA_KERNELS) and the quantized ``[width,code]`` ones
    for its pool's code type ``kvd``."""
    for k, (_, _, wrapper, hd) in GQA_KERNELS.items():
        if hd == width:
            launches[k] += got.get(wrapper, 0)
    add_qdense(launches, got, width, kvd)


def fill_random(cache, gen):
    """Every tensor of a cache (pools, or a dense cache and its recurrent
    states) as unit normals in its own dtype: rows of a realistic scale."""
    import torch
    for layer in cache:
        for t in layer.values():
            t.copy_(torch.randn(t.shape, generator=gen, device=t.device).to(
                t.dtype))
    return cache


def step_setup(cfg, layout: str, kvd: str, gen):
    """The pre-step cache and the decode_step keywords of the width checks:
    paged, smol-short's shapes (8 slots of up to 544 tokens, ragged), fp
    pools or code pools; dense, B 8 x S 2080 at pos 2070 (the last tile
    32 rows), or for local attention a ring of 2048 rows at pos 4100 (B 4:
    every row live, the new row at the wrapped slot 4)."""
    import torch
    from repro_torch.models import model
    from repro_torch.runtime.paged_cache import BlockPool, layout_for
    dev = torch.device("cuda")
    if layout == "paged":
        B, ctx = 8, 544
        lay = layout_for(B, ctx, block_size=PAGE)
        bp = BlockPool(lay, B)
        for n in [543, 500, 1, 290, 511, 64, 300, 520]:
            bp.extend(bp.admit(0, ctx), n)
        table, lengths = bp.device_views(dev)
        cache = model.init_paged_cache(cfg, lay, kv_dtype=kvd, device=dev)
        cache = fill_random(cache, gen) if kvd == "fp" else \
            quant_pools(cache, kvd, gen)
        return B, cache, dict(cache_layout="paged", block_table=table,
                              lengths=lengths), f"B={B} ctx<={ctx}"
    if cfg.attention_kind == "local":
        B, max_len, pos = 4, 4128, 4100
    else:
        B, max_len, pos = 8, 2080, 2070
    cache = fill_random(model.init_cache(cfg, B, max_len, device=dev), gen)
    rows = next(c["k"].shape[1] for c in cache if "k" in c)
    return B, cache, dict(cache_layout="dense", pos=pos), \
        f"B={B} rows={rows} pos={pos}"


def phase_gqa_decode_steps(params, cfg, launches: dict, *, layout: str,
                             kvds=("fp",)) -> None:
    """Full-width decode steps of a GQA model (every layer), each through
    the kernels, the plain versions, the reordered plain versions and the
    plain versions under ulp_noise on the same weights and cache
    (check_step's floor: the larger of the two), in both modes, with one
    split and with the auto plan, over step_setup's cache (paged: fp, int8
    and fp8 pools as ``kvds`` says; dense: B 8 x 2080 rows, or local
    attention's wrapped ring).  Each step's kernel path must launch one
    dense decode kernel an attention layer; its launches are credited to
    ``launches``.  Then one etap step (auto plan) over the first cache
    under torch.profiler (profile_decode_step)."""
    import torch
    from repro_torch.core.attn_spec import AttnSpec
    from repro_torch.models import model
    dev = torch.device("cuda")
    width = cfg.resolved_head_dim
    n_attn = cfg.layer_kinds().count("attn")
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    for kvd in kvds:
        B, cache, kw, shape = step_setup(cfg, layout, kvd, gen)
        toks = torch.randint(0, cfg.vocab_size, (B,), generator=gen,
                             device=dev)
        for mode in ("etap", "standard"):
            for kv_splits in (1, None):
                spec = AttnSpec(mode=mode, kv_splits=kv_splits)

                def step(spec=spec, cache=cache, toks=toks, kw=kw):
                    c = [{k: v.clone() for k, v in layer.items()}
                         for layer in cache]
                    return model.decode_step(params, cfg, c, toks, spec=spec,
                                             **kw)[0]

                before = {k: fn.launches for k, fn in counters().items()}
                lk = step()
                got = {k: fn.launches - before[k]
                       for k, fn in counters().items()}
                if sum(got[w] for w in DECODE_WRAPPERS) != n_attn:
                    raise AssertionError(
                        f"{cfg.name} {layout} {kvd} {mode} step: "
                        f"{ {w: got[w] for w in DECODE_WRAPPERS} } dense "
                        f"decode launches for {n_attn} attention layers")
                credit(launches, got, width, kvd)
                with plain_kernels():
                    lp = step()
                with reordered_plain():
                    floor = float((step() - lp).abs().max())
                with ulp_noise():
                    noise = float((step() - lp).abs().max())
                ran = sorted(w for w in DECODE_WRAPPERS if got[w])
                check_step(lk, lp, f"{cfg.name} {layout} {kvd} {mode} "
                           f"kv_splits={kv_splits or 'auto'} ({ran[0]}), "
                           f"full width, {cfg.num_layers} layers, {shape}; "
                           f"floor: the larger of reordered plain "
                           f"{floor:.4e} and one-ulp noise at "
                           f"{NOISE_RATE:.1%} {noise:.4e}",
                           tag="gqa-decode-step", floor=max(floor, noise))
        if kvd == kvds[0]:                # where an fp step's time goes
            profile_decode_step(
                params, cfg, [{k: v.clone() for k, v in layer.items()}
                              for layer in cache], toks, spec=AttnSpec(),
                tag=f"{cfg.name}-decode-step", **kw)
        del cache


def phase_layer_check(params, cfg, *, layout: str, kvds=("fp",),
                      splits=(1, None)) -> None:
    """The per-layer check on teacher-forced inputs, at full width and every
    attention layer, over step_setup's cache: one decode step down the
    plain path records each attention layer's input and its attention
    output before w_o; then each attention layer is fed that same input on
    the kernel path, over the same pre-step cache, and its attention output
    is held to the plain path's at the per-kernel tolerance: one bf16 ulp
    plus 1e-3 (bf16_close) over bf16 rows, f32_close's over int8 / fp8
    pools (fp32 outputs).  Over the pools ``kvds`` says, with each split
    count of ``splits`` (None: the auto plan).  The whole-step logit checks
    cannot see a wiring fault this small under a deep stack of random
    layers; this check sees each layer's."""
    import torch
    from repro_torch.core.attn_spec import AttnSpec
    from repro_torch.models import attention, model
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    entry = "attention_decode_paged" if layout == "paged" else \
        "attention_decode"
    decode, gqa = getattr(attention, entry), attention.gqa_decode
    att = [i for i, k in enumerate(cfg.layer_kinds()) if k == "attn"]

    def clone(layer):
        return {k: v.clone() for k, v in layer.items()}

    for kvd in kvds:
        B, cache, kw, shape = step_setup(cfg, layout, kvd, gen)
        toks = torch.randint(0, cfg.vocab_size, (B,), generator=gen,
                             device=dev)
        for kv_splits in splits:
            spec = AttnSpec(kv_splits=kv_splits)
            inputs, outputs = [], []

            def record_in(lp, cfg_, x, *a, **k):
                inputs.append(x.clone())
                return decode(lp, cfg_, x, *a, **k)

            def record_out(*a, **k):
                o = gqa(*a, **k)
                outputs.append(o.clone())
                return o

            def layers():                 # each attention layer, recorded
                for i, x in zip(att, inputs, strict=True):
                    lp = params["layers"][i]["mix"]
                    if layout == "paged":
                        decode(lp, cfg, x, clone(cache[i]), kw["block_table"],
                               kw["lengths"], spec=spec)
                    else:
                        decode(lp, cfg, x, clone(cache[i]), kw["pos"],
                               spec=spec)
                got = outputs[:]
                outputs.clear()
                return got

            setattr(attention, entry, record_in)
            attention.gqa_decode = record_out
            try:
                with plain_kernels():
                    model.decode_step(params, cfg, [clone(x) for x in cache],
                                      toks, spec=spec, **kw)
                plain_out = outputs[:]
                outputs.clear()
                with reordered_plain():
                    reordered = layers()
                with reordered_plain(kernel_p=False):
                    reordered32 = layers()
                before = {w: counters()[w].launches for w in DECODE_WRAPPERS}
                outputs = layers()
                ran = {w: counters()[w].launches - n
                       for w, n in before.items()}
                if sum(ran.values()) != len(att):
                    raise AssertionError(f"per-layer check: {ran} for "
                                         f"{len(att)} attention layers")
            finally:
                setattr(attention, entry, decode)
                attention.gqa_decode = gqa
            if len(plain_out) != len(att) or len(outputs) != len(att):
                raise AssertionError("per-layer check: not one attention "
                                     "output a layer")
            worst, where = 0.0, att[0]
            for i, ok, op in zip(att, outputs, plain_out, strict=True):
                what = (f"{cfg.name} layer {i} attention output, {kvd}, "
                        f"kv_splits={kv_splits or 'auto'}")
                e = (bf16_close(ok, op, what) if ok.dtype == torch.bfloat16
                     else f32_close(ok, op, what))
                if e >= worst:
                    worst, where = e, i
            def differ(outs):             # share of elements off plain's
                return sum(int((a != b).sum()) for a, b in zip(
                    outs, plain_out, strict=True)) / sum(
                    a.numel() for a in plain_out)
            log(f"[layer-check] {cfg.name} {layout} {kvd} kv_splits="
                f"{kv_splits or 'auto'} ({shape}; "
                f"{sorted(w for w, n in ran.items() if n)}): {len(att)} "
                f"attention layers on teacher-forced inputs, attention output "
                f"({outputs[0].dtype}) kernel vs plain within the per-kernel "
                f"tolerance at every layer; worst max abs err {worst:.3e} "
                f"(layer {where}); elements that differ from the plain "
                f"path's: kernel {differ(outputs):.4%}, reordered plain "
                f"{differ(reordered):.4%} (with fp32 P: "
                f"{differ(reordered32):.4%})")
        del cache


def phase_rgemma_prefill_check(params, cfg) -> None:
    """RecurrentGemma's prefill at full width and all 38 layers (RG-LRU's
    log-depth scan, local attention, the ring cut) runs no kernel: B 2 x
    512 tokens on the kernel path and under plain_kernels() give the same
    logits and caches, bitwise, finite, and launch nothing.  Then the same
    last position through a 511-token prefill and one decode step (K5
    [256] on the ring, RG-LRU's single step): its gap to the prefill's
    logits is printed (the two paths round in other places; a 38-layer
    random stack carries that far, so it is no gate)."""
    import torch
    from repro_torch.core.attn_spec import AttnSpec
    from repro_torch.models import model
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    B, S = 2, 512
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=dev)
    before = {k: fn.launches for k, fn in counters().items()}
    lk, ck, pos = model.prefill(params, cfg, toks, S + 8)
    if any(fn.launches != before[k] for k, fn in counters().items()):
        raise AssertionError("rgemma prefill launched a kernel")
    with plain_kernels():
        lp, cp, _ = model.prefill(params, cfg, toks, S + 8)
    bitwise(lk, lp, "rgemma prefill logits, kernel path vs plain path")
    for i, (a, b) in enumerate(zip(ck, cp, strict=True)):
        for key in a:
            bitwise(a[key], b[key], f"rgemma prefill layer {i} {key}")
    if lk.shape != (B, cfg.vocab_size) or not bool(torch.isfinite(lk).all()):
        raise AssertionError(f"rgemma prefill logits {tuple(lk.shape)}")
    _, c1, p1 = model.prefill(params, cfg, toks[:, :-1], S + 8)
    ld, _ = model.decode_step(params, cfg, c1, toks[:, -1], p1,
                              spec=AttnSpec(kv_splits=1))
    d = float((ld - lk).abs().max())
    scale = float(lk.abs().max())
    agree = int((ld.argmax(-1) == lk.argmax(-1)).sum())
    log(f"[rgemma-prefill] {cfg.num_layers} layers, B={B} S={S}: kernel "
        f"path == plain path bitwise (logits and every layer's cache; no "
        f"launch); prefill(511) + one decode step vs prefill(512) at the "
        f"last position: max |dlogit| {d:.4e} ({d / scale:.2%} of "
        f"{scale:.3f}), greedy agreement {agree}/{B}")


# ------------------------------------------------ the dense prefill's checks
def prefill_kernel_width(cfg):
    """The (D, Dv) K9 runs at in cfg's dense prefill, or None when the
    stack has no full-attention block (a Mamba stack; RecurrentGemma's
    local attention never takes K9)."""
    if "attn" not in cfg.layer_kinds() or \
            cfg.attention_kind not in ("full", "mla"):
        return None
    m = cfg.mla
    return (m.qk_head_dim, m.v_head_dim) if m is not None else \
        (cfg.resolved_head_dim,) * 2


def credit_prefill(launches: dict, got: dict, cfg) -> None:
    """Credit a main-path call's K9 launches to cfg's width entry."""
    if got.get("flash_prefill"):
        d, dv = prefill_kernel_width(cfg)
        launches[f"flash_prefill[{d},{dv}]"] += got["flash_prefill"]


@contextlib.contextmanager
def prefill_wrapped(wrap):
    """plain_kernels(), with K9's plain version replaced by ``wrap(plain)``
    (the entry reaches it through the module's attribute)."""
    from repro_torch.kernels.flash_prefill import flash_prefill as FP
    with plain_kernels():
        plain = FP.flash_prefill
        FP.flash_prefill = wrap(plain)
        try:
            yield
        finally:
            FP.flash_prefill = plain


def phase_prefill_check(params, cfg, B: int, S: int) -> None:
    """A whole prefill at full width through K9 and through its plain
    version on the same weights and tokens: K9 launches once a
    full-attention layer, and the last position's logits agree as
    check_step says, its floor the larger of the plain version reordered
    (blocks of 128 query and 64 KV rows instead of 256, P rounded as the
    kernel carries it) and the plain path with one-ulp noise on
    NOISE_RATE of each layer's attention output."""
    import torch
    from repro_torch.kernels.flash_prefill import flash_prefill as FP
    from repro_torch.models import model
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device="cuda", dtype=torch.int32)
    n = cfg.layer_kinds().count("attn")
    what = (f"{cfg.name} prefill, full width, {cfg.num_layers} layers, "
            f"B={B} S={S}")
    before = FP.flash_prefill.launches
    lk = model.prefill(params, cfg, toks, S + 1)[0]
    if FP.flash_prefill.launches - before != n:
        raise AssertionError(f"{what}: K9 launched "
                             f"{FP.flash_prefill.launches - before} times "
                             f"for {n} attention layers")
    with plain_kernels():
        lp = model.prefill(params, cfg, toks, S + 1)[0]
    with prefill_wrapped(lambda plain: _p16(
            lambda *a, **kw: plain(*a, **dict(kw, bq=128, bkv=64)))):
        floor = float((model.prefill(params, cfg, toks, S + 1)[0]
                       - lp).abs().max())
    noise_gen = torch.Generator(device="cuda")
    noise_gen.manual_seed(0)
    with prefill_wrapped(lambda plain: lambda *a, **kw: one_ulp(
            plain(*a, **kw), noise_gen)):
        noise = float((model.prefill(params, cfg, toks, S + 1)[0]
                       - lp).abs().max())
    log(f"[prefill-check] {what}: K9 x {n}; last-position logits bitwise "
        f"equal to the plain path's: {torch.equal(lk, lp)}")
    check_step(lk, lp, f"{what}; floor: the larger of reordered plain "
               f"{floor:.4e} and one-ulp noise at {NOISE_RATE:.1%} "
               f"{noise:.4e}", tag="prefill-check", floor=max(floor, noise))
    del lk, lp
    torch.cuda.empty_cache()


def phase_prefill_layer_check(params, cfg, B: int, S: int) -> None:
    """The per-layer check of the prefill's attention: one prefill down the
    plain path records each layer's causal-attention inputs (q, k, v) and
    output; then K9 runs on each layer's recorded inputs and its output is
    held to the plain path's at the per-kernel tolerance (bf16_close).  A
    deep stack of random layers hides a small wiring fault from the logit
    check; this one sees each layer's."""
    import torch
    from repro_torch.core import mla
    from repro_torch.kernels.flash_prefill import flash_prefill as FP
    from repro_torch.models import attention, model
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device="cuda", dtype=torch.int32)
    causal = attention.causal_attention
    seen = []

    def record(q, k, v, *, scale, **kw):
        o = causal(q, k, v, scale=scale, **kw)
        seen.append((q, k, v, scale, o))
        return o

    attention.causal_attention = mla.causal_attention = record
    try:
        with plain_kernels():
            model.prefill(params, cfg, toks, S + 1)
    finally:
        attention.causal_attention = mla.causal_attention = causal
    n = cfg.layer_kinds().count("attn")
    if len(seen) != n:
        raise AssertionError(f"per-layer prefill check: {len(seen)} causal "
                             f"attention calls for {n} layers")
    before = FP.flash_prefill.launches
    worst, where, differ, total = 0.0, 0, 0, 0
    for i, (q, k, v, scale, op) in enumerate(seen):
        ok = FP.flash_prefill(q, k, v, scale=scale)
        e = bf16_close(ok, op, f"{cfg.name} layer {i} prefill attention "
                       "output")
        if e >= worst:
            worst, where = e, i
        differ += int((ok != op).sum())
        total += op.numel()
    if FP.flash_prefill.launches - before != n:
        raise AssertionError("per-layer prefill check: K9 did not launch "
                             "once a layer")
    log(f"[prefill-layer-check] {cfg.name} B={B} S={S}: {n} attention "
        f"layers on teacher-forced inputs, K9's output within the "
        f"per-kernel tolerance of the plain path's at every layer; worst "
        f"max abs err {worst:.3e} (layer {where}); {differ / total:.4%} of "
        f"the elements differ")
    del seen
    torch.cuda.empty_cache()


# ------------------------------------------------ the DeepSeek-MoE block
def np_assign_slots(idx, E: int, C: int):
    """numpy's slot assignment of choices idx [G, S, k]: per group a stable
    argsort of the flat expert ids, a pair's place within its expert's run
    (its index less the run's first, np.searchsorted), dropped at C or
    more.  Returns (slot [G, S*k] in [0, E*C], token_of_slot [G, E*C] in
    [0, S]), int64."""
    import numpy as np
    G, S, k = idx.shape
    T = S * k
    flat = idx.reshape(G, T).astype(np.int64)
    slot = np.empty((G, T), np.int64)
    tos = np.full((G, E * C), S, np.int64)
    for g in range(G):
        order = np.argsort(flat[g], kind="stable")
        run = flat[g][order]
        pos = np.empty(T, np.int64)
        pos[order] = np.arange(T) - np.searchsorted(run, run, side="left")
        keep = pos < C
        slot[g] = np.where(keep, flat[g] * C + np.minimum(pos, C - 1), E * C)
        tos[g, slot[g][keep]] = np.arange(T)[keep] // k
    return slot, tos


def moe_loop_reference(p, cfg, x, gate_k, slot, C: int, dtype):
    """The reference test's ``_dense_reference`` on given routes: every
    kept (token, choice) runs its expert on its own, its products in
    ``dtype`` (fp32 upcasts x and the weights; the model's dtype is
    ``_dense_reference`` on a bf16 model), weighted by its gate in an fp32
    sum (a dropped pair adds nothing), the shared expert added in the same
    dtype.  Returns fp32 [G, S, D]."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import layers
    G, S, D = x.shape
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    out = torch.zeros(G, S, D, dtype=torch.float32, device=x.device)
    s = slot.long()
    g_idx, t_idx = (s < E * C).nonzero(as_tuple=True)
    e_idx = s[g_idx, t_idx] // C
    tok, choice = t_idx // k, t_idx % k
    for e in torch.unique(e_idx).tolist():
        sel = e_idx == e
        g, t, c = g_idx[sel], tok[sel], choice[sel]
        xs = x[g, t].to(dtype)
        h = F.silu(xs @ p["w_gate"][e].to(dtype)) * \
            (xs @ p["w_up"][e].to(dtype))
        y = h @ p["w_down"][e].to(dtype)
        out.index_put_((g, t), y.float() * gate_k[g, t, c][:, None],
                       accumulate=True)
    if "shared" in p:
        shared = {k_: w.to(dtype) for k_, w in p["shared"].items()}
        out += layers.mlp(shared, x.to(dtype)).float()
    return out


def moe_close(out, ref32, ref16, what: str) -> tuple[float, float]:
    """``out`` against the fp32 loop ``ref32``: each element within the
    bf16 tolerance (bf16_close's) or within twice the floor, the largest
    gap between the loop in the model's dtype ``ref16`` and ``ref32`` (an
    independent bf16 computation of the same function: its roundings of
    the products, the expert outputs and the sum), as check_step's floor
    does for logits.  Returns (max abs err, floor)."""
    import torch
    o = out.float()
    d = (o - ref32).abs()
    floor = float((ref16 - ref32).abs().max())
    ok = bool((d <= torch.clamp(BF16_RTOL * ref32.abs() + BF16_ATOL,
                                min=2 * floor)).all()) and \
        bool(torch.isfinite(o).all())
    err = float(d.max())
    if not ok:
        raise AssertionError(f"{what}: max abs err {err:.3e} against the "
                             f"fp32 loop, beyond the bf16 tolerance and "
                             f"twice the floor {floor:.3e}")
    return err, floor


def phase_moe_unit(params, cfg) -> None:
    """moe_ffn at DeepSeek-R1's full width (E 256, k 8, D 7168, F 2048, a
    shared expert) on the card, over the first MoE layer's weights, at
    MOE_UNIT_CASES: the card's routes (fp32 router, TF32 off) against an
    fp64 top-k on the CPU from the same inputs (where they differ, the
    fp64 gates at the first differing choice and the next must be within
    ROUTE_RTOL, and the token is printed); _assign_slots on the card,
    given those routes, bitwise numpy's stable-argsort version; the output
    against moe_loop_reference in fp32 on the same routes and drops, within
    moe_close's gate (the bf16 tolerance, or twice the gap of the same loop
    in bf16);
    the aux losses finite with load_balance >= 1 - 1e-3.  Prints each
    case's capacity and dropped pairs."""
    import numpy as np
    import torch
    from repro_torch.models import model, moe
    dev = torch.device("cuda")
    layer = next(i for i, (_, m) in enumerate(model.signatures(cfg)) if m)
    p = params["layers"][layer]["ffn"]
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    for name, G, S, dropless, skewed in MOE_UNIT_CASES:
        pc = p
        if skewed:
            router = p["router"].clone()
            router[:, list(MOE_SKEWED)] += MOE_SKEW
            pc = dict(p, router=router)
        x = torch.randn(G, S, cfg.d_model, generator=gen, device=dev).to(
            cfg.torch_dtype)
        C = moe.capacity(cfg, S, dropless)
        _, _, gate_k, idx_k = moe.route(pc, cfg, x)
        g64, i64 = torch.sort(torch.softmax(
            x.cpu().double() @ pc["router"].cpu().double(), dim=-1),
            dim=-1, descending=True, stable=True)
        card = idx_k.cpu()
        for g, t in (card != i64[..., :k]).any(-1).nonzero().tolist():
            j = int((card[g, t] != i64[g, t, :k]).nonzero()[0])
            gap = float((g64[g, t, j] - g64[g, t, j + 1]) / g64[g, t, j])
            log(f"[moe-unit] {name}: token ({g}, {t}) is routed "
                f"{card[g, t].tolist()} on the card, "
                f"{i64[g, t, :k].tolist()} by the fp64 top-k; the fp64 "
                f"gates at choice {j} and the next differ by {gap:.3e} "
                "(relative)")
            if not gap < ROUTE_RTOL:
                raise AssertionError(f"moe unit {name}: the card's routes "
                                     "differ from the fp64 top-k at a "
                                     "decided token")
        flips = int((card != i64[..., :k]).any(-1).sum())
        slot, tos = moe._assign_slots(idx_k, E, C)
        nslot, ntos = np_assign_slots(card.numpy(), E, C)
        if not (np.array_equal(slot.cpu().numpy(), nslot)
                and np.array_equal(tos.cpu().numpy(), ntos)):
            raise AssertionError(f"moe unit {name}: _assign_slots on the "
                                 "card differs from numpy's")
        drops = int((slot == E * C).sum())
        if skewed and drops == 0:
            raise AssertionError(f"moe unit {name}: the skewed router "
                                 "dropped no pair")
        out, aux = moe.moe_ffn(pc, cfg, x, dropless=dropless)
        ref16 = moe_loop_reference(pc, cfg, x, gate_k, slot, C, x.dtype)
        err, floor = moe_close(
            out, moe_loop_reference(pc, cfg, x, gate_k, slot, C,
                                    torch.float32), ref16,
            f"moe unit {name}: moe_ffn against the per-token loop")
        err16 = float((out.float() - ref16).abs().max())
        lb, rz = float(aux["load_balance"]), float(aux["router_z"])
        if not (np.isfinite(lb) and np.isfinite(rz) and lb >= 1 - 1e-3):
            raise AssertionError(f"moe unit {name}: aux {lb}, {rz}")
        log(f"[moe-unit] {name}: G {G} x S {S}, "
            f"{'dropless' if dropless else 'capacity'} C {C}"
            + (f", router skewed toward experts {list(MOE_SKEWED)}"
               if skewed else "")
            + f": routes equal the fp64 top-k at {G * S - flips} of "
            f"{G * S} tokens ({flips} at near-ties); slots bitwise "
            f"numpy's; {drops} of {G * S * k} pairs dropped; output against "
            f"the per-token loop in fp32: max abs err {err:.3e}, floor (the "
            f"loop in {str(x.dtype).split('.')[-1]} against it) "
            f"{floor:.3e}; against the loop in "
            f"{str(x.dtype).split('.')[-1]}, not gated: {err16:.3e}; "
            f"load_balance {lb:.4f}, router_z {rz:.4f}")


@contextlib.contextmanager
def moe_recording(rec: dict):
    """Record, for the decode steps run inside, each block's input (x),
    each MLA layer's attention output before W_uv (o) and each MoE FFN's
    input (h2), in call order."""
    from repro_torch.core import mla
    from repro_torch.models import model, moe
    block, attn, ffn = (model._block_decode, mla.decode_attention_paged,
                        moe.moe_ffn)

    def rec_block(lp, cfg, sig, x, *a, **kw):
        rec["x"].append(x.clone())
        return block(lp, cfg, sig, x, *a, **kw)

    def rec_attn(*a, **kw):
        o = attn(*a, **kw)
        rec["o"].append(o.clone())
        return o

    def rec_ffn(p, cfg, h, **kw):
        rec["h2"].append(h.clone())
        return ffn(p, cfg, h, **kw)

    model._block_decode, mla.decode_attention_paged, moe.moe_ffn = \
        rec_block, rec_attn, rec_ffn
    try:
        yield rec
    finally:
        model._block_decode, mla.decode_attention_paged, moe.moe_ffn = \
            block, attn, ffn


def route_flips(params, cfg, moe_layers, h_kernel, h_plain,
                what: str) -> set:
    """The routing rule: the rows (tokens) whose routes differ between two
    paths' FFN inputs (h_kernel, h_plain: [1, B, D] each, one dropless
    group), MoE layer by layer.  Routes differ where the chosen experts
    differ, or, where the capacity C is under B (so a pair can be dropped
    and the choices' order decides which), where their order differs.  At
    the first layer where a row's routes differ, the plain path's
    router-logit gap between its k-th and (k+1)-th expert (with C < B: at
    the first differing choice and the next; the gate order is the logit
    order) must be under twice the largest difference between the two
    paths' router logits at that row: two experts each moving by at most
    that much, an undecided router.  The gap and the difference are
    printed.  A row's later layers follow from its flip and are not
    compared.  Returns the rows that flipped."""
    import torch
    from repro_torch.models import moe
    k = cfg.moe.top_k
    ordered = moe.capacity(cfg, h_kernel[0].shape[1], True) < \
        h_kernel[0].shape[1]
    flipped = set()
    for li, hk, hp in zip(moe_layers, h_kernel, h_plain, strict=True):
        p = params["layers"][li]["ffn"]
        lk, _, _, ik = moe.route(p, cfg, hk)
        lp, _, _, ip = moe.route(p, cfg, hp)
        lk, lp = lk.reshape(-1, lk.shape[-1]), lp.reshape(-1, lp.shape[-1])
        ik, ip = ik.reshape(-1, k), ip.reshape(-1, k)
        if ordered:
            differ = (ik != ip).any(-1)
        else:
            differ = (ik.sort(-1).values != ip.sort(-1).values).any(-1)
        for row in differ.nonzero().flatten().tolist():
            if row in flipped:
                continue
            j = int((ik[row] != ip[row]).nonzero()[0]) if ordered else k - 1
            ranked = torch.sort(lp[row], descending=True, stable=True).values
            gap = float(ranked[j] - ranked[j + 1])
            diff = float((lk[row] - lp[row]).abs().max())
            log(f"[moe-route] {what}: layer {li} token {row} routes "
                f"{ik[row].tolist()} (kernel path) against "
                f"{ip[row].tolist()} (plain): the plain router-logit gap "
                f"between choice {j} and the next {gap:.4e}, the largest "
                f"router-logit difference {diff:.4e}")
            if not gap < 2 * diff:
                raise AssertionError(f"{what}: layer {li} token {row} routes "
                                     "differ at a decided router")
            flipped.add(row)
    return flipped


def phase_moe_decode_step(params, cfg) -> None:
    """A paged decode step of DeepSeek-R1 at 5 layers (3 dense, 2 MoE) at
    full width, B 8 over ctx <= 2048 (phase_decode_step's rows, one
    split: K3), through the kernels and through the plain versions on the
    same weights and cache.  Per layer, teacher-forced: every layer is fed
    the kernel path's input to it on the plain path, and its attention
    output (before W_uv) is held to the kernel path's at bf16_close; at a
    MoE layer the FFN then sees the same input on both paths, so its
    routes and output are the same by construction, which is checked
    bitwise, and the routes of the two paths' own FFN inputs are held to
    the routing rule (route_flips).  Whole step: the rows whose routes
    agree at every MoE layer have logits within check_step's gate
    (LOGIT_RTOL of the largest logit); a row whose routes differ passes
    only under the routing rule.  Then one step under torch.profiler
    (profile_decode_step) and the two MoE layers' FFN alone on the kernel
    path's inputs: the MoE share of the step's device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.attn_spec import AttnSpec
    from repro_torch.models import model, moe
    from repro_torch.runtime.paged_cache import BlockPool, layout_for
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
    for n in [2047, 1500, 1, 700, 2000, 64, 1999, 1024]:
        bp.extend(bp.admit(0, ctx), n)
    table, lengths = bp.device_views(dev)
    toks = torch.randint(0, cfg.vocab_size, (B,), generator=gen, device=dev)
    sigs = model.signatures(cfg)
    moe_layers = [i for i, (_, m) in enumerate(sigs) if m]
    spec = AttnSpec(kv_splits=1)

    def fresh():
        return {"x": [], "o": [], "h2": []}

    def step(rec):
        with moe_recording(rec):
            return model.decode_step(params, cfg, clone_cache(cache), toks,
                                     spec=spec, cache_layout="paged",
                                     block_table=table, lengths=lengths)[0]

    rk = fresh()
    lk = step(rk)
    with plain_kernels():
        rp = fresh()
        lp = step(rp)
    worst, forced_flips = 0.0, set()
    for i, sig in enumerate(sigs):
        rec = fresh()
        with plain_kernels(), moe_recording(rec):
            model._block_decode(params["layers"][i], cfg, sig, rk["x"][i],
                                {k: v.clone() for k, v in cache[i].items()},
                                None, spec, "paged", table, lengths)
        worst = max(worst, bf16_close(
            rk["o"][i], rec["o"][0], f"moe decode step, layer {i} attention "
            "output on the kernel path's input"))
        if sig[1]:
            j = moe_layers.index(i)
            h = rk["h2"][j]
            f = moe.moe_ffn(params["layers"][i]["ffn"], cfg, h,
                            dropless=True)[0]
            with plain_kernels():
                fp = moe.moe_ffn(params["layers"][i]["ffn"], cfg, h,
                                 dropless=True)[0]
            bitwise(f, fp, f"moe decode step, layer {i}: the FFN on one "
                    "input, kernel and plain paths")
            forced_flips |= route_flips(
                params, cfg, [i], [h], rec["h2"],
                f"moe decode step (teacher-forced, layer {i})")
    log(f"[moe-decode-step] per layer, teacher-forced: {len(sigs)} layers' "
        f"attention output (K3, one split) within bf16 of the plain path "
        f"on the kernel path's input, worst max abs err {worst:.3e}; the "
        f"{len(moe_layers)} MoE layers' FFN bitwise on one input on both "
        f"paths; {len(forced_flips)} tokens route differently from the "
        "plain attention output, each at an undecided router")
    flips = route_flips(params, cfg, moe_layers, rk["h2"], rp["h2"],
                        "moe decode step (whole step)")
    agree = [b for b in range(B) if b not in flips]
    log(f"[moe-decode-step] whole step: routes agree at every MoE layer "
        f"for {len(agree)} of {B} tokens; {sorted(flips)} flip at an "
        "undecided router")
    if agree:
        check_step(lk[agree], lp[agree], f"paged, 5 layers (3 dense, 2 MoE), "
                   f"full width, tokens {agree} of B={B}, ctx<={ctx}",
                   tag="moe-decode-step")
    busy = profile_decode_step(params, cfg, cache, toks, spec=spec,
                               tag="moe-decode-step", block_table=table,
                               lengths=lengths)

    def ffn_only():
        for i, h in zip(moe_layers, rk["h2"], strict=True):
            moe.moe_ffn(params["layers"][i]["ffn"], cfg, h, dropless=True)
        torch.cuda.synchronize()

    ffn_only()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ffn_only()
    moe_busy, _, n = device_busy(prof)
    nbytes = sum(t.numel() * t.element_size() for i in moe_layers
                 for t in _leaves(params["layers"][i]["ffn"]))
    log(f"[moe-decode-step] MoE FFN alone ({len(moe_layers)} layers, the "
        f"{B} tokens one dropless group, every expert over C "
        f"{moe.capacity(cfg, B, True)} slots): device busy {moe_busy:.3f} ms "
        f"({n} kernels and copies), {100 * moe_busy / busy:.1f}% of the "
        f"step's {busy:.3f} ms; its byte bound {nbytes / 1e9:.2f} GB of "
        f"weights read once, {nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms")


# ------------------------------------------- owed card checks (C1, C2)
# C1: every prompt starts with the same 200 tokens, so a prefix-cache hit
# covers its 3 whole pages, 192 tokens, off the 256-token chunk grid; the
# ragged prompts (300, 450, 600) end off it too.  More requests than slots
# (int8 pools hold about twice the fp slots), so that later ones hit.
C1 = ["--batch", "2", "--requests", "12", "--prompt", "600", "--gen", "16",
      "--prefill-chunk", "256", "--shared-prefix", "200", "--layers", "3"]
C1_CHUNK = 256
# C2: the reference's contended trace (benchmarks/run.py:476-503) at the
# card's page of 64: 6 requests in bursts of 3, three priority classes
C2 = ["--prompt", "256", "--gen", "16", "--requests", "6", "--prefill-chunk",
      "64", "--arrival-rate", "0.25", "--trace", "burst", "--burst-size",
      "3", "--retry-backoff", "4", "--paranoia", "4", "--layers", "3"]
C2_RUNS = (
    ("c2-calm", ["--batch", "8", "--priority-classes", "3"]),
    ("c2-calm-b2", ["--batch", "2"]),
    ("c2-swap", ["--batch", "2", "--priority-classes", "3", "--preemption",
                 "swap"]),
    ("c2-recompute", ["--batch", "2", "--priority-classes", "3",
                      "--preemption", "recompute"]))


def first_diff(out: dict, ref: dict):
    """The first (request, token) at which two runs' outputs part."""
    for rid in ref:
        got = out.get(rid, [])
        for i, (a, b) in enumerate(zip(got, ref[rid])):
            if a != b:
                return rid, i
        if len(got) != len(ref[rid]):
            return rid, min(len(got), len(ref[rid]))
    return "a request set"


def phase_prefix_check(params, credit) -> None:
    """C1 (ROADMAP section C): the prefix cache on against
    ``--no-prefix-cache`` at the same requests, bf16 and int8 pools."""
    for kvd in ("fp", "int8"):
        flags = C1 + ([] if kvd == "fp" else ["--kv-dtype", kvd])
        expect = ("etap_prefill_mla_paged" + ("" if kvd == "fp"
                                              else "_quant"),)
        runs: dict = {}
        on, off = f"c1-{kvd}-prefix-on", f"c1-{kvd}-prefix-off"
        credit(phase_serve(on, flags, params, expect, runs), flags)
        credit(phase_serve(off, flags + ["--no-prefix-cache"], params,
                           expect, runs), flags)
        r_on, r_off = runs[on], runs[off]
        hits, saved = r_on["prefix"]["hits"], r_on["prefill_tokens_saved"]
        if not hits or not saved:
            raise AssertionError(f"{on}: no prefix-cache hit")
        if r_on["prefill_tokens"] + saved != r_off["prefill_tokens"]:
            raise AssertionError(f"{on}: prefill tokens "
                                 f"{r_on['prefill_tokens']} + saved {saved} "
                                 f"!= {r_off['prefill_tokens']}")
        if (saved // hits) % C1_CHUNK == 0:
            raise AssertionError(f"{on}: hits of {saved // hits} tokens, on "
                                 "the chunk grid")
        if r_on["outputs"] != r_off["outputs"]:
            raise AssertionError(
                f"C1 {kvd}: prefix cache on parts from off at (request, "
                f"token) {first_diff(r_on['outputs'], r_off['outputs'])}")
        log(f"[C1 {kvd}] prefix cache on == off bitwise over "
            f"{len(r_on['outputs'])} requests; {hits} hits saving {saved} "
            f"prompt tokens ({saved // hits} a hit, off the {C1_CHUNK}-token "
            f"chunk grid); "
            f"{r_on['tok_s']:.1f} tok/s on, {r_off['tok_s']:.1f} off; "
            f"{gpu_line()}")


ROW_COUNTS = (1, 2, 3, 4, 6, 8, 12, 16)


def phase_row_bits(params, cfg) -> None:
    """C2's repair (ROADMAP section C): a decode step's products keep a
    row's bits at every batch.  For layer 0's decode products, the W_uk /
    W_uv absorptions and the unembedding, row 0 of a product over M rows
    (M in ROW_COUNTS) against a product over ``layers.ROW_TILE`` rows: a
    bare product's are logged (where cuBLAS's kernel changes with M), the
    port's (``layers.dense`` / ``unembed`` / ``fixed_rows``) gated
    bitwise, with the row placed last too."""
    import torch
    from repro_torch.models import layers
    lp, m, H = params["layers"][0], cfg.mla, cfg.num_heads
    mix, ffn, table = lp["mix"], lp["ffn"], params["embed_f32"]
    w_uk = mix["w_uk"].reshape(m.kv_lora_rank, H, m.qk_nope_head_dim).float()
    w_uv = mix["w_uv"].reshape(m.kv_lora_rank, H, m.v_head_dim).float()

    def uk(a):
        return torch.einsum("bhd,chd->bhc", a, w_uk)

    def uv(a):
        return torch.einsum("bhc,chd->bhd", a, w_uv)

    cases = [(f"{name} {tuple(w.shape)}", (w.shape[0],), w.dtype,
              lambda a, w=w: a @ w, lambda a, w=w: layers.dense(a, w))
             for name, w in (("w_dq", mix["w_dq"]), ("w_uq", mix["w_uq"]),
                             ("w_dkv", mix["w_dkv"]), ("w_o", mix["w_o"]),
                             ("w_gate", ffn["w_gate"]), ("w_up", ffn["w_up"]),
                             ("w_down", ffn["w_down"]))]
    cases += [
        (f"unembed fp32 {tuple(table.shape)}", (cfg.d_model,),
         cfg.torch_dtype, lambda a: a.float() @ table.T,
         lambda a: layers.unembed(table, a)),
        ("W_uk absorption fp32", (H, m.qk_nope_head_dim), torch.float32, uk,
         lambda a: layers.fixed_rows(a, uk)),
        ("W_uv absorption fp32", (H, m.kv_lora_rank), torch.float32, uv,
         lambda a: layers.fixed_rows(a, uv))]
    gen = torch.Generator(device="cuda").manual_seed(23)
    for name, shape, dtype, bare, port in cases:
        x = torch.randn(layers.ROW_TILE, *shape, generator=gen,
                        device="cuda").to(dtype)
        want_bare, want = bare(x)[0], port(x)[0]
        parts = [n for n in ROW_COUNTS
                 if not torch.equal(bare(x[:n])[0], want_bare)]
        for n in ROW_COUNTS:
            bitwise(port(x[:n])[0], want, f"row bits {name}: row 0 of {n}")
            bitwise(port(torch.cat([x[1:n], x[:1]]))[-1], want,
                    f"row bits {name}: row {n - 1} of {n}")
        log(f"[row bits] layer 0 {name}: a bare product's row 0 has other "
            f"bits than at {layers.ROW_TILE} rows at M {parts or 'none'} of "
            f"{list(ROW_COUNTS)}; the port's keeps them at every M, first "
            f"row or last")


def phase_preemption_check(params, credit) -> None:
    """C2 (ROADMAP section C): swap and recompute restores under the
    contended trace, and the unpreempted run at their batch, against the
    reference's calm run at batch 8, bitwise."""
    runs: dict = {}
    for name, extra in C2_RUNS:
        flags = C2 + extra
        credit(phase_serve(name, flags, params, ("etap_prefill_mla_paged",),
                           runs), flags)
        pre = runs[name]["sched"]["preemptions"]
        busy = "--preemption" in extra
        if bool(pre) != busy:
            raise AssertionError(f"{name}: {pre} preemptions")
    calm = runs["c2-calm"]["outputs"]
    for name in ("c2-calm-b2", "c2-swap", "c2-recompute"):
        if runs[name]["outputs"] != calm:
            raise AssertionError(
                f"C2: {name} parts from the calm batch-8 run at (request, "
                f"token) {first_diff(runs[name]['outputs'], calm)}")
    log(f"[C2] swap ({runs['c2-swap']['sched']['preemptions']} preemptions)"
        f", recompute ({runs['c2-recompute']['sched']['preemptions']}) and "
        f"the unpreempted batch-2 run == the calm batch-8 run bitwise over "
        f"{len(calm)} requests; {gpu_line()}")


# ------------------------------------------------------------- training
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 2048, 6
# K9's autograd Function against autograd through the plain route
# (masked_attention), on one layer's q, k, v: both backwards are fp32
# products of the same bf16 inputs summed in other orders, each gradient
# rounded to bf16 once, so an element may sit a bf16 ulp or two (2^-7 of
# its magnitude each) off; allowed: 2^-6 of each gradient's max |value|
K9_GRAD_RTOL = 2 ** -6
# the reference's drill (tests/test_runtime.py) runs 12 steps and fails at
# step 7; cut to 8 steps failing at 6 (the same checkpoint, step 4,
# restored) since the sharded train step's phase joined the script
SMOL_TRAIN = ["--arch", "smollm_360m", "--steps", "8", "--batch", "8",
              "--seq", "512", "--ckpt-every", "4", "--log-every", "0",
              "--device", "cuda"]


def k9_backward_bytes_ops(B, S, H, K, D, Dv) -> tuple[float, float]:
    """Bytes the causal-attention backward must move (q, k, v and dO read
    once, dq, dk, dv written once, bf16) and its operations: five products
    (S recomputed, dV, dP, dQ, dK) over the S (S + 1) / 2 live pairs."""
    nbytes = 2 * B * S * (2 * H * D + 2 * K * D + 2 * K * Dv + H * Dv)
    flops = 2 * B * H * (S * (S + 1) / 2) * (3 * D + 2 * Dv)
    return nbytes, flops


def record_attention(params, cfg, batch) -> tuple:
    """Layer 0's q, k, v at ``causal_attention`` on ``batch`` (no grad)."""
    import torch
    from repro_torch.core import mla
    from repro_torch.models import model
    got = []
    real = mla.causal_attention

    def rec(q, k, v, **kw):
        if not got:
            got.append((q.detach().clone(), k.detach().clone(),
                        v.detach().clone()))
        return real(q, k, v, **kw)
    mla.causal_attention = rec
    try:
        with torch.no_grad():
            model.loss_fn(params, cfg, batch)
    finally:
        mla.causal_attention = real
    return got[0]


def k9_grad_check(params, cfg, batch) -> None:
    """K9's autograd Function on layer 0's q, k, v: output bitwise the
    wrapper's, dQ / dK / dV within K9_GRAD_RTOL of autograd through the
    plain route, and the backward's time beside that route's, SDPA's and
    its bound."""
    import torch
    from repro_torch.kernels.flash_prefill import flash_prefill as FP
    from repro_torch.models.attention import masked_attention
    q, k, v = record_attention(params, cfg, batch)
    scale = cfg.mla.qk_head_dim ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(31)
    dout = (torch.randn(q.shape[:3] + v.shape[-1:], generator=gen,
                        device="cuda") * 1e-3).to(v.dtype)
    with torch.no_grad():
        want = FP.flash_prefill(q, k, v, scale=scale)
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    out = FP.flash_prefill_grad(*qkv, scale=scale)
    bitwise(out.detach(), want, "K9 Function forward vs the wrapper")
    got = torch.autograd.grad(out, qkv, dout)
    ref_out = masked_attention(*qkv, scale=scale)
    ref = torch.autograd.grad(ref_out, qkv, dout, retain_graph=True)
    errs = []
    for name, a, b in zip(("dQ", "dK", "dV"), got, ref, strict=True):
        a, b = a.float(), b.float()
        scale_b = float(b.abs().max())
        err = float((a - b).abs().max())
        rel_rmse = float((a - b).square().mean().sqrt()
                         / b.square().mean().sqrt())
        if not torch.isfinite(a).all() or err > K9_GRAD_RTOL * scale_b:
            raise AssertionError(
                f"K9 backward {name}: max abs err {err:.3e} beyond "
                f"{K9_GRAD_RTOL:.3e} x max |ref| {scale_b:.3e}")
        errs.append(f"{name} max abs {err:.3e} ({err / scale_b:.2e} of max "
                    f"|ref| {scale_b:.3e}), rel RMSE {rel_rmse:.2e}")
    B, S, H, D = q.shape
    K, Dv = k.shape[2], v.shape[-1]
    log(f"[k9-grad] B {B} x S {S} x H {H}, (D, Dv) ({D}, {Dv}), layer 0's "
        f"q, k, v: Function forward bitwise K9's; against the plain route "
        f"(gate {K9_GRAD_RTOL:.3e} of max |ref|): " + "; ".join(errs))
    nbytes, flops = k9_backward_bytes_ops(B, S, H, K, D, Dv)
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    bound, by = (t_b, "bytes") if t_b >= t_f else (t_f, "operations")
    plain_q = [x.detach() for x in qkv]
    t_bwd = cuda_time_ms(lambda: FP.flash_prefill_backward(
        *plain_q, dout, scale=scale), 3, warmup=1)
    t_ref = cuda_time_ms(lambda: torch.autograd.grad(
        ref_out, qkv, dout, retain_graph=True), 3, warmup=1)
    del ref_out, ref
    sd = [x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v)]
    sd_out = torch.nn.functional.scaled_dot_product_attention(
        *sd, is_causal=True, scale=scale)
    dsd = dout.transpose(1, 2)
    t_sdpa = cuda_time_ms(lambda: torch.autograd.grad(
        sd_out, sd, dsd, retain_graph=True), 3, warmup=1)
    log(f"[timing] K9 backward (plain PyTorch, fp32 without TF32) B {B} x "
        f"S {S} x H {H} ({D}, {Dv}): {t_bwd:.3f} ms; the plain route's "
        f"autograd backward {t_ref:.3f} ms; SDPA's backward (bf16) "
        f"{t_sdpa:.3f} ms; bound {bound:.3f} ms ({by}: fp32 products at "
        f"{FP32_FLOP_PER_S / 1e12:.0f} TFLOP/s, {flops / 1e12:.3f} TFLOP); "
        f"{gpu_line()}")


def unembed_ms(params, cfg, B: int, S: int) -> float:
    """The fp32 unembedding with the cross-entropy, forward and backward
    (the gradients of the hidden states and of the table), on the train
    step's shapes, timed alone: CUDA events over 3 calls."""
    import torch
    from repro_torch.models import layers
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(B, S, cfg.d_model, generator=gen, device="cuda").to(
        cfg.torch_dtype).requires_grad_()
    emb = params["embed"].detach().clone().requires_grad_()
    tgt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                        device="cuda")

    def step():
        logits = layers.unembed(layers.unembed_table(emb), x)
        lp = torch.log_softmax(logits[:, :-1], dim=-1)
        nll = -torch.gather(lp, -1, tgt[:, 1:, None])[..., 0].mean()
        torch.autograd.grad(nll, (x, emb))
    t = cuda_time_ms(step, 3, warmup=1)
    del x, emb
    torch.cuda.empty_cache()
    return t


GEMM_OPS = ("aten::mm", "aten::addmm", "aten::bmm")
CE_OPS = ("aten::_log_softmax", "aten::_log_softmax_backward_data",
          "aten::gather", "aten::gather_backward")


def unembed_device_ms(prof, vocab: int) -> float:
    """From a train step profiled with its shapes, the device ms of the
    kernels that the unembedding and its cross-entropy launch, forward and
    backward: those of a product with an operand ``vocab`` wide (the
    logits, their gradient, the table's gradient) and those under a
    log-softmax or a gather (the ops that launch them, or one of their
    callers)."""
    import torch

    def ours(e):
        while e is not None:
            if e.name in CE_OPS or (e.name in GEMM_OPS and any(
                    vocab in shape for shape in e.input_shapes
                    if isinstance(shape, list))):
                return True
            e = e.cpu_parent
        return False
    return sum(e.self_device_time_total for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CPU
               and e.self_device_time_total > 0 and ours(e)) / 1e3


def phase_train_deepseek(cfg, launches: dict) -> None:
    """train-deepseek: DeepSeek-R1 at full width, 3 dense layers, trained
    for TRAIN_STEPS steps of B TRAIN_B x S TRAIN_S through make_train_step
    (AdamW with bf16 moments, remat on)."""
    import torch
    from repro_torch.data.pipeline import DataConfig, make_batch, to_device
    from repro_torch.kernels.flash_prefill import flash_prefill as FP
    from repro_torch.launch import train
    from repro_torch.launch.steps import TrainConfig, make_train_step
    from repro_torch.optim import optimizers as opt
    t0 = time.perf_counter()
    tcfg = TrainConfig(optimizer=opt.OptimizerConfig(
        warmup_steps=2, total_steps=TRAIN_STEPS + 1))
    params, state = train.build_state(cfg, tcfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in opt.tree_leaves(params))
    log(f"[train-deepseek] {cfg.num_layers} dense layers, "
        f"{n_params / 1e9:.3f} B {cfg.dtype} params, AdamW with "
        f"{tcfg.optimizer.m_dtype} moments, remat {cfg.remat}: built in "
        f"{time.perf_counter() - t0:.2f} s")
    data = DataConfig(seed=17, global_batch=TRAIN_B, seq_len=TRAIN_S)
    batch = to_device(cfg, make_batch(cfg, data, 0), "cuda")
    k9_grad_check(params, cfg, batch)
    step_fn = make_train_step(cfg, tcfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    FP.flash_prefill.launches = FP.flash_prefill_grad.backwards = 0
    walls = []
    for step in range(TRAIN_STEPS):
        batch = to_device(cfg, make_batch(cfg, data, step), "cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, m = step_fn(params, state, batch, step)
        nll, gn = float(m["nll"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        if not (math.isfinite(nll) and math.isfinite(gn)):
            raise AssertionError(f"train-deepseek step {step}: nll {nll}, "
                                 f"grad norm {gn}")
        log(f"[train-deepseek] step {step}: nll {nll:.4f}, grad norm "
            f"{gn:.4f}, {walls[-1] * 1e3:.1f} ms, "
            f"{TRAIN_B * TRAIN_S / walls[-1]:.1f} tok/s")
    k9, k9_bwd = FP.flash_prefill.launches, FP.flash_prefill_grad.backwards
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not k9 or not k9_bwd:
        raise AssertionError(f"train-deepseek: K9 launched {k9} times, its "
                             f"Function's backward ran {k9_bwd} times")
    credit_prefill(launches, {"flash_prefill": k9}, cfg)
    steady = sorted(walls[1:])[len(walls[1:]) // 2]
    batch = to_device(cfg, make_batch(cfg, data, TRAIN_STEPS), "cuda")
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t = time.perf_counter()
        params, state, m = step_fn(params, state, batch, TRAIN_STEPS)
        float(m["nll"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    busy, span, n = device_busy(prof)
    in_step = unembed_device_ms(prof, cfg.vocab_size)
    if not in_step:
        raise AssertionError("train-deepseek: no unembedding kernel in the "
                             "profiled step")
    t_unembed = unembed_ms(params, cfg, TRAIN_B, TRAIN_S)
    log(f"[train-deepseek] {TRAIN_STEPS} steps of B {TRAIN_B} x S "
        f"{TRAIN_S}: K9 launched {k9} times ({cfg.num_layers} layers x 2 "
        f"with remat x {TRAIN_STEPS} steps), its Function's backward ran "
        f"{k9_bwd} times; median step after the first "
        f"{steady * 1e3:.1f} ms = {TRAIN_B * TRAIN_S / steady:.1f} tok/s "
        f"(first {walls[0] * 1e3:.1f} ms); peak mem {peak:.1f} GiB; "
        f"{timeline_line(wall, busy, span, n, steady * 1e3)}; busy "
        f"{100 * busy / wall:.1f}% of the profiled step; fp32 unembedding "
        f"+ cross-entropy fwd+bwd in the profiled step: device "
        f"{in_step:.1f} ms = {100 * in_step / busy:.1f}% of its busy time; "
        f"timed alone on the step's shapes {t_unembed:.1f} ms = "
        f"{100 * t_unembed / (steady * 1e3):.1f}% of the median step; "
        f"{gpu_line()}")
    del params, state
    torch.cuda.empty_cache()


def phase_train_smollm(launches: dict) -> None:
    """train-smollm: the reference's restart drill through
    ``launch.train.run`` on SmolLM-360M at full width and depth."""
    import torch
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_prefill import flash_prefill as FP
    from repro_torch.launch import train
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    from repro_torch.runtime.fault_tolerance import WorkerFailure
    cfg = get_config("smollm_360m")
    saved: dict = {}
    save = ckpt.save

    def keep(path, step, tree, **kw):
        """``checkpoint.save`` for the drill: a host copy of the state
        the trainer hands it at step 4, then the save itself."""
        if step == 4:
            saved[4] = tree_map(lambda t: t.detach().to("cpu", copy=True),
                                tree)
        return save(path, step, tree, **kw)

    with tempfile.TemporaryDirectory() as tmp:
        FP.flash_prefill.launches = 0
        t = time.perf_counter()
        a = train.run(train.parse_args(SMOL_TRAIN + ["--ckpt-dir",
                                                     f"{tmp}/a"]))
        t_a = time.perf_counter() - t
        k9 = FP.flash_prefill.launches
        if not k9:
            raise AssertionError("train-smollm: K9 never launched")
        credit_prefill(launches, {"flash_prefill": k9}, cfg)
        b = SMOL_TRAIN + ["--ckpt-dir", f"{tmp}/b"]
        ckpt.save = keep
        try:
            train.run(train.parse_args(b + ["--fail-at", "6"]))
        except WorkerFailure:
            pass
        else:
            raise AssertionError("train-smollm: no failure at step 6")
        finally:
            ckpt.save = save
        if ckpt.latest_step(f"{tmp}/b") != 4:
            raise AssertionError("train-smollm: the drill's last checkpoint "
                                 "is not step 4")
        template = tree_map(lambda x: x.to("cuda"), saved[4])
        restored, step = ckpt.restore(f"{tmp}/b", 4, template)
        for x, y in zip(tree_leaves(restored), tree_leaves(saved[4]),
                        strict=True):
            bitwise(x.cpu().reshape(-1), y.reshape(-1),
                    "train-smollm: restored step-4 state")
        n_leaves = len(tree_leaves(restored))
        del restored, template
        r = train.run(train.parse_args(b + ["--restart"]))
        if r["start_step"] != 4 or ckpt.latest_step(f"{tmp}/b") != 8:
            raise AssertionError(f"train-smollm: restart from "
                                 f"{r['start_step']}, last checkpoint "
                                 f"{ckpt.latest_step(f'{tmp}/b')}")
    la, lb = a["losses"][-1], r["losses"][-1]
    if not math.isfinite(la) or abs(la - lb) > 1e-5 * abs(la):
        raise AssertionError(f"train-smollm: final loss {lb} after the "
                             f"restart against {la} uninterrupted")
    tail = a["losses"][4:] == r["losses"]
    log(f"[train-smollm] {cfg.num_layers} layers, B 8 x S 512, 8 steps "
        f"({t_a:.1f} s, K9 launched {k9} times); failure at step 6, "
        f"restored step 4 ({n_leaves} leaves bitwise the saved state), "
        f"final loss {lb!r} against {la!r} uninterrupted: "
        + ("bitwise, steps 4-7 too" if tail and la == lb else
           f"within rtol 1e-5 (diff {abs(la - lb):.3e}), not bitwise")
        + f"; {gpu_line()}")
    del saved
    torch.cuda.empty_cache()


# ------------------------------- sequence-sharded decode (ROADMAP A10a)
# phase_seq_sharded: a single-process reference first, then SHARD_RANKS
# ranks (gloo with every rank on cuda:0 on a one-card machine, nccl with a
# card a rank where there are 4) on each mesh of SHARD_MESHES
SHARD_RANKS = 4
SHARD_MESHES = ((1, 4), (2, 2))               # (data, model)
# name -> (arch, layers kept, batch, prompt, generated tokens): the cache
# holds prompt + generated rows, >= SEQ_SHARD_MIN_S and a multiple of 4
SHARD_MODELS = {"deepseek": ("deepseek_r1_671b", 3, 4, 8192, 16),
                "qwen": ("qwen3_8b", 4, 2, 8192, 8)}
# the unsharded branch under the (2, 2) mesh (S < SEQ_SHARD_MIN_S: K5):
# DeepSeek, batch, prompt, steps
SHARD_SHORT = (4, 512, 4)
SHARD_EMPTY_POS = 100          # a position only the first slice holds
SHARD_SPAWN_S = 600            # the ranks' wall limit
# the layer-0 row the owner writes against the reference's, relative to
# the row's largest value: the ranks compute it from their column pieces
# of W_dkv (W_k, W_v), the reference from the whole product, so it may
# differ by a bf16 ulp; a row written at the wrong position is off by
# the row's own scale
LAYER0_ROW_RTOL = 2 ** -6
SHARD_COLLECTIVE_S = 300       # init_process_group's timeout


def shard_config(name: str):
    from repro_torch.configs import get_config
    arch, layers, *_ = SHARD_MODELS[name]
    return dataclasses.replace(get_config(arch), num_layers=layers)


def weights_digest(params) -> int:
    """A checksum of every bit of a parameter tree: the sum of each leaf's
    16-bit words (fp32 leaves as two words each), in int64."""
    import torch
    total = 0
    stack = [params]
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, list):
            stack.extend(t)
        else:
            words = t.contiguous().view(torch.int16).reshape(-1)
            for chunk in words.split(1 << 26):
                total += int(chunk.to(torch.int64).sum())
    return total


def shard_reference(name: str, work: Path, launches: dict,
                    dev="cuda") -> dict:
    """The single-process reference of one SHARD_MODELS entry, on the card
    alone: seed-0 weights, a seeded prompt through ``model.prefill`` (K9),
    then greedy ``decode_step`` over the whole cache (K6 + K2 at the auto
    plan).  Saves to ``work/<name>.pt`` the tokens, each step's logits,
    the prefill cache and the rows the steps wrote (host copies), the
    weights' digest, the floor (the largest logit difference between step
    0 at the auto plan and at one split, K5) and the step's wall ms; frees
    the card.  Credits the launches to ``launches``."""
    import torch
    from repro_torch.core.attn_spec import AttnSpec
    from repro_torch.models import model
    cfg = shard_config(name)
    _, _, B, P, G = SHARD_MODELS[name]
    params = model.init(cfg, seed=0, device=dev)
    gen = torch.Generator().manual_seed(7)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                           dtype=torch.int32).to(dev)
    for fn in counters().values():
        fn.launches = 0
    logits, cache, pos = model.prefill(params, cfg, prompt, P + G)
    torch.cuda.synchronize()
    host = [{k: v.cpu() for k, v in layer.items()} for layer in cache]
    tokens, steps, walls = [logits.argmax(-1).to(torch.int32)], [], []
    for i in range(G):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, cfg, cache, tokens[-1],
                                          pos + i)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        steps.append(logits.cpu())
        tokens.append(logits.argmax(-1).to(torch.int32))
    got = {k: fn.launches for k, fn in counters().items()}
    rows = [{k: v[:, P:P + G].cpu() for k, v in layer.items()}
            for layer in cache]
    del cache
    one, _ = model.decode_step(params, cfg, _on(host, dev), tokens[0], pos,
                               spec=AttnSpec(kv_splits=1))
    floor = float((one.cpu() - steps[0]).abs().max())
    ref = {"tokens": torch.stack(tokens, 1).cpu(),
           "logits": torch.stack(steps), "cache": host, "rows": rows,
           "digest": weights_digest(params), "floor": floor,
           "step_ms": sorted(walls[1:])[(G - 1) // 2]}
    if name == "deepseek":
        ref["short"] = greedy_reference(params, cfg, *SHARD_SHORT, seed=9)
        del ref["short"]["launches"]
    torch.save(ref, work / f"{name}.pt")
    log(f"[seq-sharded] {name} reference (one process, the card alone): "
        f"{cfg.num_layers} layers, B {B} x prompt {P} + {G} greedy steps "
        f"over S {P + G}: step {ref['step_ms']:.3f} ms (median), floor "
        f"(auto plan vs one split) {floor:.4e}, launches "
        f"{ {k: v for k, v in got.items() if v} }")
    credit_shard(launches, got, cfg)
    del params, logits, one
    torch.cuda.empty_cache()
    return ref


def credit_shard(launches: dict, got: dict, cfg) -> None:
    """Credit one model's launches (wrapper -> count) to the kernels
    line: DeepSeek's to the latent entries, Qwen3's to the [128] ones, K9
    to the prefill width."""
    if cfg.attention_kind == "mla":
        for k in KERNELS:
            launches[k] += got.get(k, 0)
    else:
        credit(launches, got, HD, "fp")
    credit_prefill(launches, got, cfg)


def k6_slice_check(cache, q, dv: int, start: int, pos: int, mesh,
                   spec) -> dict:
    """K6 on this rank's slice against its plain version at the main
    path's plan: q [BG, G, Dk] and the slice (the latent [B, S/n, 576], V
    its first ``dv`` columns, or a GQA slice {"k", "v"} [B, S/n, K, hd]) at
    the length ``pos`` gives the slice.  A slice that holds no position
    yet must give m <= NEG_INF, l = 0 and accᵀ = 0 on both, and weight 0
    once merged with the other ranks' (the all-reduce MAX over `model`;
    every rank calls this).  Returns {"err", "empty"}."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import softmax_state
    from repro_torch.kernels.etap import etap as K
    from repro_torch.kernels.splitkv import split_plan
    from repro_torch.launch import mesh as M
    k = cache["c"] if "c" in cache else cache["k"]
    v = k[..., :dv] if "c" in cache else cache["v"]
    n = k.shape[1]
    length = torch.full((q.shape[0],), min(max(pos + 1 - start, 0), n),
                        dtype=torch.int32, device=q.device)
    plan = split_plan(q, k, v, spec=spec)
    kw = dict(scale=spec.scale, plan=plan)
    st = K.etap_partial_dense(q, k, v, length, **kw)
    rs = K.etap_partial_dense_plain(q, k, v, length, **kw)
    empty = int(length[0]) == 0
    if empty:
        for what, (m, l, acc) in (("K6", st), ("its plain version", rs)):
            if not (bool((m <= softmax_state.NEG_INF).all())
                    and not l.any() and not acc.any()):
                raise AssertionError(f"{what} on an empty slice: stats not "
                                     "(m <= NEG_INF, 0, 0)")
        err = 0.0
    else:
        err = finalized_close(st, rs, f"K6 on slice [{start}, {start + n})")
    m = softmax_state.merge_splits(*st, axis=1, mode=softmax_state.resolve(),
                                   expand=lambda w: w[:, :, None, :])[0]
    m_g = M.all_reduce(m.clone(), dist.ReduceOp.MAX, mesh, "model")
    w = softmax_state.merge_weights(m, m_g, mode=softmax_state.resolve())
    if empty and w.any():
        raise AssertionError("an empty slice's merge weight is not 0")
    return {"err": err, "empty": empty}


def _on(cache, dev):
    return [{k: v.to(dev) if hasattr(v, "to") else v for k, v in
             layer.items()} for layer in cache]


def shard_run(name: str, params, cfg, ref: dict, mesh) -> dict:
    """One model on one mesh, on this rank: K6 on the rank's slice against
    its plain version (the main path's length and a length-0 slice), then
    the main path (``make_serve_step`` under ``use_mesh`` over the rank's
    piece of the reference's prefill cache, ``shard_cache``), teacher-forced
    with the reference's tokens, every launch count zeroed just before it
    and read just after: each step's gathered logits within check_step's
    gate of the reference's (floor: the reference's), the layer-0 row the
    owner writes within LAYER0_ROW_RTOL of the reference's (``params``
    are this rank's pieces; whether bitwise is returned); then a
    free-running greedy run
    whose tokens equal the reference's or part first where the
    reference's top-two gap is below the teacher-forced run's largest
    logit difference."""
    import torch

    from repro_torch.core import etap
    from repro_torch.core.attn_spec import AttnSpec
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps as S
    from repro_torch.models import model
    _, _, B, P, G = SHARD_MODELS[name]
    dev = mesh.device
    tag = f"{name} {mesh.shape['data']}x{mesh.shape['model']}"
    tokens = ref["tokens"].to(dev)
    with M.use_mesh(mesh):
        piece = _on(model.shard_cache(ref["cache"]), dev)
        if any("seq_rows" not in layer for layer in piece):
            raise AssertionError(f"{tag}: the cache is not sequence-sharded")
        n = next(iter(piece[0].values())).shape[1]
        start = mesh.coord("model") * n
        b0 = mesh.coord("data") * (B // mesh.shape["data"])
        rows = slice(b0, b0 + B // mesh.shape["data"])
        gen = torch.Generator(device=dev).manual_seed(5)
        if cfg.attention_kind == "mla":
            m = cfg.mla
            shape = (B // mesh.shape["data"], cfg.num_heads, m.latent_dim)
            dv, scale = m.kv_lora_rank, m.qk_head_dim ** -0.5
        else:
            Kh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
            shape = (B // mesh.shape["data"] * Kh, cfg.num_heads // Kh, hd)
            dv, scale = hd, hd ** -0.5
        q = torch.randn(shape, generator=gen, device=dev).to(cfg.torch_dtype)
        spec = AttnSpec(scale=scale)
        k6 = [k6_slice_check(piece[0], q, dv, start, p, mesh, spec)
              for p in (P, SHARD_EMPTY_POS)]

        step = S.make_serve_step(cfg)
        for fn in counters().values():
            fn.launches = 0
        etap.seq_sharded_decode.reduced_bytes = 0
        diffs, walls, row0, same0 = [], [], 0.0, True
        for i in range(G):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, piece = step(params, piece, tokens[:, i], P + i)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            full = S.gather_rows(logits, mesh, B)
            lr = ref["logits"][i].to(dev)
            diffs.append(float((full - lr).abs().max()))
            check_step(full, lr, f"{tag} step {i}", tag="seq-sharded",
                       floor=ref["floor"])
            if start <= P + i < start + n:
                for key, want in ref["rows"][0].items():
                    got_row = piece[0][key][:, P + i - start]
                    want_row = want[rows, i].to(dev)
                    d = float((got_row.float() - want_row.float()).abs()
                              .max())
                    row0 = max(row0, d)
                    same0 = same0 and torch.equal(got_row, want_row)
                    if d > LAYER0_ROW_RTOL * float(want_row.float().abs()
                                                   .max()):
                        raise AssertionError(
                            f"{tag} step {i}: layer 0 {key!r} row written "
                            f"{d:.3e} from the reference's")
        got = {k: fn.launches for k, fn in counters().items()}
        reduced = etap.seq_sharded_decode.reduced_bytes
        deep = max((float((piece[li][key][:, P + i - start].float()
                           - ref["rows"][li][key][rows, i].to(dev).float())
                          .abs().max())
                    for li in range(1, len(piece)) for key in ref["rows"][li]
                    for i in range(G) if start <= P + i < start + n),
                   default=0.0)

        piece = _on(model.shard_cache(ref["cache"]), dev)
        tok, run = tokens[:, 0], []
        for i in range(G):
            logits, piece = step(params, piece, tok, P + i)
            tok = S.gather_rows(logits, mesh, B).argmax(-1).to(torch.int32)
            run.append(tok.cpu())
    run = torch.stack(run, 1)
    diff = max(diffs)
    parted = []
    for b in range(B):
        want = ref["tokens"][b, 1:]
        p = next((i for i in range(G) if run[b, i] != want[i]), None)
        if p is None:
            continue
        top2 = ref["logits"][p][b].topk(2).values
        gap = float(top2[0] - top2[1])
        if not gap < diff:
            raise AssertionError(f"{tag}: free-running row {b} parts from "
                                 f"the reference at token {p} (gap {gap:.4e}"
                                 f" >= {diff:.4e})")
        parted.append((b, p, gap))
    return {"launches": got, "diffs": diffs, "step_ms": walls,
            "bytes_per_step": reduced / G, "k6": k6, "parted": parted,
            "row0_diff": row0, "row0_bitwise": same0,
            "deep_row_diff": deep, "free_equal": B - len(parted)}


def greedy_reference(params, cfg, B: int, P: int, G: int, *,
                     seed: int) -> dict:
    """A seeded B x P prompt through ``model.prefill`` and G greedy
    ``decode_step`` calls (each timed) in this process over whole
    weights, every launch count zeroed just before and read just after:
    host copies of the prompt, the tokens [B, G + 1] (the prefill's
    first), the prefill's logits and each step's; the launches; the
    step's median wall ms; and the floor (``tp_floor``, from a copy of
    the prefill's cache, after the counts are read)."""
    import torch
    from repro_torch.models import model
    dev = params["embed"].device
    gen = torch.Generator().manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                           dtype=torch.int32)
    for fn in counters().values():
        fn.launches = 0
    logits, cache, pos = model.prefill(params, cfg, prompt.to(dev), P + G)
    first = logits.cpu()
    start = [{k: v.clone() for k, v in layer.items()} for layer in cache]
    tokens, steps, walls = [logits.argmax(-1).to(torch.int32)], [], []
    for i in range(G):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, cfg, cache, tokens[-1],
                                          pos + i)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        steps.append(logits.cpu())
        tokens.append(logits.argmax(-1).to(torch.int32))
    got = {k: fn.launches for k, fn in counters().items()}
    del cache
    floor = tp_floor(params, cfg, start, tokens[0], pos, steps[0])
    return {"prompt": prompt, "tokens": torch.stack(tokens, 1).cpu(),
            "prefill": first, "logits": torch.stack(steps), "launches": got,
            "step_ms": _median(walls), "floor": floor}


def shard_short_check(params, cfg, mesh, ref: dict, floor: float) -> dict:
    """The unsharded branch under the (2, 2) mesh: the reference's
    SHARD_SHORT prompt through ``make_prefill_step`` under the mesh on the
    weights placed for it (K9 on the rank's heads and batch rows; S below
    SEQ_SHARD_MIN_S stays whole), then ``make_serve_step`` teacher-forced
    with the reference's tokens (K5), every launch count zeroed just
    before and read just after: the prefill's and each step's gathered
    logits within check_step's gate of the single-process reference's
    (``greedy_reference``; floor: the long reference's)."""
    import torch

    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps as S
    B, P, G = SHARD_SHORT
    dev = mesh.device
    tokens = ref["tokens"].to(dev)
    step = S.make_serve_step(cfg)
    for fn in counters().values():
        fn.launches = 0
    with M.use_mesh(mesh):
        logits, piece, pos = S.make_prefill_step(cfg, P + G)(
            params, ref["prompt"].to(dev))
        if any("seq_rows" in layer for layer in piece):
            raise AssertionError("a short cache was sequence-sharded")
        outs = [S.gather_rows(logits, mesh, B)]
        for i in range(G):
            lg, piece = step(params, piece, tokens[:, i], pos + i)
            outs.append(S.gather_rows(lg, mesh, B))
    got = {k: fn.launches for k, fn in counters().items()}
    for i, (lk, lp) in enumerate(zip(outs, [ref["prefill"],
                                             *ref["logits"]])):
        check_step(lk, lp.to(dev), f"short {B}x{P} "
                   + ("prefill" if i == 0 else f"step {i - 1}"),
                   tag="seq-sharded-unsharded-branch", floor=floor)
    return {"launches": got, "bitwise": all(
        torch.equal(lk.cpu(), lp) for lk, lp in zip(
            outs, [ref["prefill"], *ref["logits"]]))}


def piece_digests(params, mesh) -> tuple[int, int]:
    """(the weights_digest of the leaves the placement cut, of those it
    kept whole) of a tree placed for ``mesh`` (``rules.Placed``, whose
    ``specs`` say which).  Over one data row's `model` ranks the cut
    digests and one rank's whole digest sum to the whole tree's."""
    from repro_torch.sharding import rules
    cut = whole = 0
    for path, t in rules._leaves_with_path(params):
        spec = params.specs
        for k in path.split("/"):
            spec = spec[int(k)] if isinstance(spec, list) else spec[k]
        if rules.cuts(spec, mesh):
            cut += weights_digest(t)
        else:
            whole += weights_digest(t)
    return cut, whole


def check_piece_digests(params, mesh, want: int, what: str) -> None:
    """Every rank's piece digests (a collective over the world): for each
    data row, the `model` ranks' cut digests plus the whole leaves'
    (equal on every rank) sum to ``want``, the whole tree's."""
    import torch.distributed as dist
    mine = (mesh.coord("data"), *piece_digests(params, mesh))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    rows = {}
    for d, cut, whole in every:
        rows.setdefault(d, [0, set()])
        rows[d][0] += cut
        rows[d][1].add(whole)
    for d, (cut, whole) in rows.items():
        if len(whole) != 1 or cut + whole.pop() != want:
            raise AssertionError(f"{what}: data row {d}'s piece digests "
                                 f"{every} do not sum to the whole "
                                 f"weights' {want}")


def shard_rank_main(rank: int, world: int, work: str, backend: str,
                    device: str) -> None:
    """One rank of phase_seq_sharded: join the group (FileStore in
    ``work``), build the meshes, then per model and mesh: the seed-0
    weights placed for the mesh by ``model.init`` under it (the pieces'
    digests summing to the reference's whole digest), and shard_run;
    DeepSeek on (2, 2) also runs shard_short_check.  Writes its report to
    ``work/rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as M
    from repro_torch.models import model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = Path(work)
    # rank 0 prints; every rank checks (and raises)
    with (open(os.devnull, "w") if rank else
          contextlib.nullcontext(sys.stdout)) as out, \
            contextlib.redirect_stdout(out):
        dev = M.init_ranks(rank, world, backend=backend,
                           init_method=f"file://{work / 'store'}",
                           device=device, timeout_s=SHARD_COLLECTIVE_S)
        try:
            meshes = [M.make_host_mesh(dev, shape)
                      for shape in SHARD_MESHES]
            report = {}
            for name in SHARD_MODELS:
                ref = torch.load(work / f"{name}.pt", weights_only=False)
                cfg = shard_config(name)
                for mesh in meshes:
                    # this rank's pieces, placed as they are drawn
                    with M.use_mesh(mesh):
                        params = model.init(cfg, seed=0, device=dev)
                    torch.cuda.empty_cache()   # init's temporaries
                    check_piece_digests(params, mesh, ref["digest"], name)
                    key = (name, mesh.shape["data"], mesh.shape["model"])
                    report[key] = shard_run(name, params, cfg, ref, mesh)
                    if name == "deepseek" and mesh is meshes[1]:
                        report["short"] = shard_short_check(
                            params, cfg, mesh, ref["short"], ref["floor"])
                    del params
                    torch.cuda.empty_cache()
                del ref
            torch.save(report, work / f"rank{rank}.pt")
        finally:
            dist.destroy_process_group()


def shard_backend(ranks: int = SHARD_RANKS) -> tuple[str, str, str]:
    """(backend, device, what to print): nccl with a card a rank where the
    machine has ``ranks`` cards, else gloo with every rank on cuda:0."""
    import torch
    n = torch.cuda.device_count()
    if n >= ranks:
        return "nccl", "cuda", f"nccl, one card a rank ({n} cards)"
    return "gloo", "cuda:0", (
        "gloo, every rank on cuda:0: the ranks share one card, so the "
        "multi-rank step's wall measures no multi-GPU speedup")


def phase_seq_sharded(launches: dict) -> None:
    """Sequence-sharded decode across SHARD_RANKS ranks (ROADMAP A10a):
    each model's single-process reference (shard_reference), the card
    then freed; then the ranks (shard_rank_main), on one card over gloo
    (every rank on cuda:0) or, with 4 cards, over nccl with a card a rank.
    Prints each rank's K6 launches (summed into ``launches``), the bytes a
    step all-reduces, the sharded step's wall ms beside the unsharded
    one's, and the free-running streams."""
    import torch

    from repro_torch.launch import mesh as M
    backend, device, where = shard_backend()
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        refs = {name: shard_reference(name, work, launches)
                for name in SHARD_MODELS}
        torch.cuda.empty_cache()
        log(f"[seq-sharded] {SHARD_RANKS} ranks, backend {where}; meshes "
            f"(data, model) {list(SHARD_MESHES)}")
        t0 = time.perf_counter()
        M.spawn(shard_rank_main, SHARD_RANKS, (str(work), backend, device),
                timeout_s=SHARD_SPAWN_S)
        reports = [torch.load(work / f"rank{r}.pt", weights_only=False)
                   for r in range(SHARD_RANKS)]
    log(f"[seq-sharded] ranks done in {time.perf_counter() - t0:.1f} s "
        "(their start, weights and both models)")
    for name in SHARD_MODELS:
        cfg = shard_config(name)
        ref = refs[name]
        for data, mdl in SHARD_MESHES:
            key = (name, data, mdl)
            per = [rep[key] for rep in reports]
            k6 = [rep["launches"]["etap_partial_dense"] for rep in per]
            if not all(k6):
                raise AssertionError(f"{key}: K6 launches by rank {k6}")
            for rep in per:
                credit_shard(launches, rep["launches"], cfg)
            ms = sorted(per[0]["step_ms"][1:])[(len(per[0]["step_ms"]) - 1)
                                              // 2]
            log(f"[seq-sharded] {name} ({data}, {mdl}): K6 "
                f"launches by rank {k6} (sum {sum(k6)}), K5 "
                f"{[rep['launches']['etap_decode_dense'] for rep in per]}, "
                f"K2 {[rep['launches']['combine_splits'] for rep in per]}; "
                f"max |dlogit| over the steps {max(per[0]['diffs']):.4e} "
                f"(floor {ref['floor']:.4e}); K6 vs plain on each slice, max "
                f"err {max(c['err'] for rep in per for c in rep['k6']):.3e},"
                f" empty slices checked on ranks "
                f"{[r for r, rep in enumerate(per) if rep['k6'][1]['empty']]}"
                f"; written rows max diff: layer 0 "
                f"{max(rep['row0_diff'] for rep in per):.3e} (bitwise on "
                f"every owner: {all(rep['row0_bitwise'] for rep in per)}), "
                f"deeper {max(rep['deep_row_diff'] for rep in per):.3e}; "
                f"all-reduced {per[0]['bytes_per_step']:.0f} bytes "
                f"a step a rank; step {ms:.3f} ms sharded (rank 0, median) "
                f"against {ref['step_ms']:.3f} ms unsharded (one process, "
                f"the card alone); free-running rows equal "
                f"{per[0]['free_equal']}/{SHARD_MODELS[name][2]}, parted "
                f"{per[0]['parted']}")
    short = [rep["short"] for rep in reports]
    k5 = [s["launches"]["etap_decode_dense"] for s in short]
    if not all(k5):
        raise AssertionError(f"unsharded branch under the mesh: K5 by rank "
                             f"{k5}")
    for s in short:
        credit_shard(launches, s["launches"], shard_config("deepseek"))
    log(f"[seq-sharded] unsharded branch under the (2, 2) mesh (DeepSeek B "
        f"{SHARD_SHORT[0]} x {SHARD_SHORT[1]}, prefilled under the mesh): K5 "
        f"launches by rank {k5}, K9 "
        f"{[s['launches']['flash_prefill'] for s in short]}; bitwise the "
        "single-process reference on every rank: "
        f"{all(s['bitwise'] for s in short)}")
    log(f"[seq-sharded] {where}; {gpu_line()}")


# ---------------------------- tensor-parallel serving (ROADMAP A10b.1)
# phase_tensor_parallel: single-process references with whole weights
# first, then TP_RANKS ranks, each holding only its pieces of the weights
# as param_specs(profile="serve") places them (gloo with every rank on
# cuda:0 on a one-card machine, nccl with a card a rank where there are 8)
TP_RANKS = 8
TP_MESHES = ((1, 8), (2, 4))                  # (data, model)
# name -> (arch, layers kept, batch, prompt, greedy steps): tp-short.
# Qwen3-8B is cut to 6 of its 36 layers: each of its TP steps makes 2
# collectives a layer through the host, and at full depth the phase took
# 179-205 s of the script's 1200 s (12 layers until the sharded train
# step's phase joined the script)
TP_MODELS = {"deepseek": ("deepseek_r1_671b", 3, 16, 512, 16),
             "qwen": ("qwen3_8b", 6, 8, 512, 8)}
# tp-long, DeepSeek on (1, 8): batch, prompt, steps; S = 8208 rows is
# sequence-sharded (S/8 = 1026 a rank), the paper's batch of 16
TP_LONG = (16, 8192, 16)
TP_LONG_CHUNK = 4              # the reference prefills 4 rows at a time
TP_SPAWN_S = 900               # the ranks' wall limit


def tp_config(name: str):
    from repro_torch.configs import get_config
    arch, layers, *_ = TP_MODELS[name]
    return dataclasses.replace(get_config(arch), num_layers=layers)


def tp_floor(params, cfg, cache, token, pos: int, step0) -> float:
    """The reference's floor: the largest logit difference between its
    step 0 at the auto split plan (``step0``) and the same step at one
    split (K5) and at two (K6 + K2), each from a copy of the same cache:
    the plans sum the same attention in other orders (at a short cache
    the auto plan is one split, so two splits are its perturbation)."""
    from repro_torch.core.attn_spec import AttnSpec
    from repro_torch.models import model
    diffs = []
    for n in (1, 2):
        copy = [{k: v.clone() for k, v in layer.items()} for layer in cache]
        other, _ = model.decode_step(params, cfg, copy, token, pos,
                                     spec=AttnSpec(kv_splits=n))
        diffs.append(float((other.cpu() - step0).abs().max()))
    return max(diffs)


def tp_reference(name: str, work: Path, launches: dict) -> dict:
    """The single-process references of one TP_MODELS entry, whole seed-0
    weights on the card alone: tp-short (``greedy_reference``: a seeded
    prompt through ``model.prefill``, K9, and greedy ``decode_step``s,
    timed) and for DeepSeek tp-long (TP_LONG: the prompt prefilled
    TP_LONG_CHUNK rows at a time, the cache kept on the host, greedy
    steps over the whole cache: K6 + K2).  Each with its floor
    (``tp_floor``).  Saves them with the weights' digest to
    ``work/tp-<name>.pt``, frees the card; credits the launches."""
    import torch
    from repro_torch.models import model
    from repro_torch.sharding import rules
    cfg = tp_config(name)
    _, _, B, P, G = TP_MODELS[name]
    params = model.init(cfg, seed=0, device="cuda")
    ref = {"digest": weights_digest(params)}
    short = greedy_reference(params, cfg, B, P, G, seed=11)
    got = short.pop("launches")
    ref["short"] = short
    log(f"[tp] {name} reference tp-short (one process, whole weights, the "
        f"card alone): {cfg.num_layers} layers, B {B} x prompt {P} + {G} "
        f"greedy steps: step {short['step_ms']:.3f} ms (median), floor "
        f"{short['floor']:.4e}, launches "
        f"{ {k: v for k, v in got.items() if v} }")
    credit_shard(launches, got, cfg)
    if name == "deepseek":
        ref["long"] = tp_long_reference(params, cfg, launches)
    ref["params_bytes"] = sum(t.numel() * t.element_size()
                              for _, t in rules._leaves_with_path(params))
    torch.save(ref, work / f"tp-{name}.pt")
    del params
    torch.cuda.empty_cache()
    return ref


def tp_long_reference(params, cfg, launches: dict) -> dict:
    """TP_LONG's reference: the prompt prefilled TP_LONG_CHUNK rows at a
    time (the batch's activations at 8192 rows would crowd the card), the
    padded caches joined on the host, then greedy steps over the whole
    cache on the card.  Host copies of the cache, tokens, logits."""
    import torch
    from repro_torch.models import model
    B, P, G = TP_LONG
    gen = torch.Generator().manual_seed(13)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                           dtype=torch.int32)
    for fn in counters().values():
        fn.launches = 0
    first, parts = [], []
    for r in range(0, B, TP_LONG_CHUNK):
        lg, cache, pos = model.prefill(
            params, cfg, prompt[r:r + TP_LONG_CHUNK].cuda(), P + G)
        first.append(lg)
        parts.append([{k: v.cpu() for k, v in layer.items()}
                      for layer in cache])
        del cache
    host = [{k: torch.cat([p[li][k] for p in parts]) for k in parts[0][li]}
            for li in range(len(parts[0]))]
    del parts
    cache = _on(host, "cuda")
    tokens = [torch.cat(first).argmax(-1).to(torch.int32)]
    steps, walls = [], []
    for i in range(G):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = model.decode_step(params, cfg, cache, tokens[-1], pos + i)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        steps.append(lg.cpu())
        tokens.append(lg.argmax(-1).to(torch.int32))
    got = {k: fn.launches for k, fn in counters().items()}
    del cache
    floor = tp_floor(params, cfg, _on(host, "cuda"), tokens[0], pos,
                     steps[0])
    torch.cuda.empty_cache()
    log(f"[tp] deepseek reference tp-long: B {B} x prompt {P} + {G} greedy "
        f"steps over S {P + G}: step {sorted(walls[1:])[(G - 1) // 2]:.3f} "
        f"ms (median), floor {floor:.4e}, launches "
        f"{ {k: v for k, v in got.items() if v} }")
    credit_shard(launches, got, cfg)
    return {"cache": host, "tokens": torch.stack(tokens, 1).cpu(),
            "logits": torch.stack(steps), "floor": floor,
            "step_ms": sorted(walls[1:])[(G - 1) // 2]}


@contextlib.contextmanager
def recorded_heads(seen: dict):
    """Record the shapes of q that the attention entries of the serve
    path receive (``seen``: entry -> set of shapes): the dense decode
    entry (K5 / K6 + K2; a GQA q is [B·K, G, hd]), the sequence-sharded
    ones (K6 on the slice) and the prefill's causal attention (K9, q [B,
    S, H, D])."""
    from repro_torch.core import mla
    from repro_torch.models import attention
    slots = [(mla, "decode_attention"), (attention, "decode_attention"),
             (mla, "seq_sharded_decode"),
             (attention, "seq_sharded_gqa_decode"),
             (mla, "causal_attention"), (attention, "causal_attention")]
    saved = [getattr(m, n) for m, n in slots]

    def wrap(name, fn):
        def rec(q, *a, **kw):
            seen.setdefault(name, set()).add(tuple(q.shape))
            return fn(q, *a, **kw)
        return rec
    for (m, n), fn in zip(slots, saved):
        setattr(m, n, wrap(n, fn))
    try:
        yield seen
    finally:
        for (m, n), fn in zip(slots, saved):
            setattr(m, n, fn)


def tp_teacher_forced(params, cfg, piece, pos: int, tokens, ref_logits,
                      floor: float, mesh, tag: str) -> dict:
    """``make_serve_step`` under the mesh from ``piece`` (this rank's
    cache), fed the reference's tokens: each step's gathered logits
    within check_step's gate of the reference's.  Returns the largest
    difference and each step's wall ms."""
    import torch

    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps as S
    B = tokens.shape[0]
    step = S.make_serve_step(cfg)
    diffs, walls = [], []
    with M.use_mesh(mesh):
        for i in range(ref_logits.shape[0]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, piece = step(params, piece, tokens[:, i], pos + i)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            full = S.gather_rows(logits, mesh, B)
            lr = ref_logits[i].to(full.device)
            diffs.append(float((full - lr).abs().max()))
            check_step(full, lr, f"{tag} step {i}", tag="tp", floor=floor)
    return {"diffs": diffs, "step_ms": walls}


def tp_free_running(params, cfg, piece, pos: int, first, ref: dict,
                    diff: float, mesh) -> dict:
    """Greedy steps under the mesh from ``first`` (the tokens the prefill
    chose): the rows whose stream equals the reference's (``ref``'s
    tokens [B, G + 1], the prefill's first), and where the others part
    (position 0 the prefill's token, i > 0 step i - 1's), with the
    reference's top-two gap there beside the teacher-forced run's largest
    difference ``diff``.  Reported, not gated."""
    import torch

    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps as S
    ref_tokens = ref["tokens"]
    B, G = ref_tokens.shape[0], ref["logits"].shape[0]
    step = S.make_serve_step(cfg)
    tok, run = first, [first.cpu()]
    with M.use_mesh(mesh):
        for i in range(G):
            logits, piece = step(params, piece, tok, pos + i)
            tok = S.gather_rows(logits, mesh, B).argmax(-1).to(torch.int32)
            run.append(tok.cpu())
    run = torch.stack(run, 1)
    chosen = [ref.get("prefill"), *ref["logits"]]
    parted = []
    for b in range(B):
        p = next((i for i in range(G + 1) if run[b, i] != ref_tokens[b, i]),
                 None)
        if p is not None:
            top2 = chosen[p][b].topk(2).values
            parted.append((b, p, round(float(top2[0] - top2[1]), 6),
                           round(diff, 6)))
    return {"free_equal": B - len(parted), "parted": parted}


def kv_view_check(params, cfg, mesh, B: int, S: int) -> float:
    """K5 on this rank's kv heads of a random [B, S, K, hd] cache, read in
    place at their offset (the view ``attention_decode`` hands it under
    tensor parallelism), against its plain version (bf16 tolerance) and
    bitwise the kernel on a contiguous copy of those heads.  Returns the
    max abs error."""
    import torch

    from repro_torch.core.etap import gqa_grouped_view
    from repro_torch.kernels.etap import etap as K
    from repro_torch.launch import mesh as M
    from repro_torch.models import attention, layers
    dev = mesh.device
    Hl, Kl = attention.local_heads(params["layers"][0]["mix"], cfg)
    Kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device=dev).manual_seed(17)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            cfg.torch_dtype)
    kc, vc, q = rand(B, S, Kv, hd), rand(B, S, Kv, hd), rand(B, Hl, hd)
    with M.use_mesh(mesh):
        k0 = layers.model_offset(Kl, Kv)
    kv, vv = kc[:, :, k0:k0 + Kl], vc[:, :, k0:k0 + Kl]
    qg = gqa_grouped_view(q, kv, vv)[0]
    length = torch.full((B * Kl,), S, dtype=torch.int32, device=dev)
    kw = dict(scale=hd ** -0.5)
    out = K.etap_decode_dense(qg, kv, vv, length, **kw)
    what = f"K5 [{hd}] on kv heads [{k0}, {k0 + Kl}) of {Kv} in place"
    bitwise(out, K.etap_decode_dense(qg, kv.contiguous(), vv.contiguous(),
                                     length, **kw), what + " vs a copy")
    return bf16_close(out, K.etap_decode_dense_plain(qg, kv, vv, length,
                                                     **kw), what)


def tp_short(params, cfg, ref: dict, mesh, name: str,
             bpg: tuple | None = None) -> dict:
    """tp-short on this rank (``bpg``: its batch, prompt and steps,
    default TP_MODELS[name]'s): the reference's prompt through
    ``make_prefill_step`` under the mesh (K9 on the rank's heads and
    batch rows), its gathered last-row logits within check_step's gate of
    the reference's, then the teacher-forced steps (``tp_teacher_forced``:
    K5, or K6 + K2, on the rank's heads), every launch count, the
    recorded head shapes and the collectives' bytes zeroed just before
    the prefill and read after the steps; then a free-running run from a
    copy of the prefill's cache."""
    import torch

    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps as S
    B, P, G = bpg or TP_MODELS[name][2:]
    tag = f"{name} {mesh.shape['data']}x{mesh.shape['model']}"
    dev = mesh.device
    view_err = None if cfg.attention_kind == "mla" else \
        kv_view_check(params, cfg, mesh, B, P + G)
    for fn in counters().values():
        fn.launches = 0
    seen: dict = {}
    M.moved.clear()
    with recorded_heads(seen), M.use_mesh(mesh):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, piece, pos = S.make_prefill_step(cfg, P + G)(
            params, ref["prompt"].to(dev))
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        full = S.gather_rows(logits, mesh, B)
        check_step(full, ref["prefill"].to(dev), f"{tag} prefill", tag="tp",
                   floor=ref["floor"])
        prefill_bytes = dict(M.moved)
        M.moved.clear()
        keep = [{k: v.clone() if torch.is_tensor(v) else v
                 for k, v in layer.items()} for layer in piece]
        tf = tp_teacher_forced(params, cfg, piece, pos,
                               ref["tokens"].to(dev), ref["logits"],
                               ref["floor"], mesh, tag)
    got = {k: fn.launches for k, fn in counters().items()}
    step_bytes = {k: v / G for k, v in M.moved.items()}
    free = tp_free_running(params, cfg, keep, pos,
                           full.argmax(-1).to(torch.int32), ref,
                           max(tf["diffs"]), mesh)
    return {"launches": got, "heads": seen, "prefill_ms": prefill_ms,
            "view_err": view_err,
            "prefill_bytes": prefill_bytes, "step_bytes": step_bytes,
            "sharded": any("seq_rows" in layer for layer in keep),
            **tf, **free}


def tp_long(params, cfg, ref: dict, mesh) -> dict:
    """tp-long on this rank: ``shard_cache`` of the reference's B 16 x
    8192 prefill cache under the mesh (S 8208 sequence-sharded: the
    rank's 1026 rows), then the teacher-forced steps (q gathered over its
    heads, K6 on the slice over every head, the stats combined, the
    rank's heads kept), counted as tp_short counts; then a free-running
    run from a fresh piece."""
    import torch

    from repro_torch.launch import mesh as M
    from repro_torch.models import model
    dev = mesh.device
    with M.use_mesh(mesh):
        piece = _on(model.shard_cache(ref["cache"]), dev)
    if any("seq_rows" not in layer for layer in piece):
        raise AssertionError("tp-long: the cache is not sequence-sharded")
    P = TP_LONG[1]
    for fn in counters().values():
        fn.launches = 0
    seen: dict = {}
    M.moved.clear()
    with recorded_heads(seen):
        tf = tp_teacher_forced(params, cfg, piece, P, ref["tokens"].to(dev),
                               ref["logits"], ref["floor"], mesh,
                               "deepseek long")
    got = {k: fn.launches for k, fn in counters().items()}
    step_bytes = {k: v / TP_LONG[2] for k, v in M.moved.items()}
    del piece
    with M.use_mesh(mesh):
        piece = _on(model.shard_cache(ref["cache"]), dev)
    free = tp_free_running(params, cfg, piece, P,
                           ref["tokens"][:, 0].to(dev), ref,
                           max(tf["diffs"]), mesh)
    del piece
    torch.cuda.empty_cache()
    return {"launches": got, "heads": seen, "step_bytes": step_bytes,
            "slice_rows": 8208 // mesh.shape["model"], **tf, **free}


def tp_rank_main(rank: int, world: int, work: str, backend: str,
                 device: str) -> None:
    """One rank of phase_tensor_parallel: join the group (FileStore in
    ``work``), then per model and mesh: the seed-0 weights placed for the
    mesh as they are drawn (``model.init`` under it; the pieces' digests
    summing to the reference's whole digest), their bytes counted and as
    ``torch.cuda.memory_allocated`` shows them, tp-short, and for
    DeepSeek on (1, 8) tp-long.  Writes its report to
    ``work/tp-rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import mla
    from repro_torch.launch import mesh as M
    from repro_torch.models import attention, model
    from repro_torch.sharding import rules
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = Path(work)
    with (open(os.devnull, "w") if rank else
          contextlib.nullcontext(sys.stdout)) as out, \
            contextlib.redirect_stdout(out):
        dev = M.init_ranks(rank, world, backend=backend,
                           init_method=f"file://{work / 'store'}",
                           device=device, timeout_s=SHARD_COLLECTIVE_S)
        try:
            report = {}
            for name in TP_MODELS:
                ref = torch.load(work / f"tp-{name}.pt", weights_only=False)
                cfg = tp_config(name)
                for shape in TP_MESHES:
                    mesh = M.make_host_mesh(dev, shape)
                    base = torch.cuda.memory_allocated()
                    t0 = time.perf_counter()
                    with M.use_mesh(mesh):
                        params = model.init(cfg, seed=0, device=dev)
                    torch.cuda.synchronize()
                    init_s = time.perf_counter() - t0
                    torch.cuda.empty_cache()
                    check_piece_digests(params, mesh, ref["digest"], name)
                    mix = params["layers"][0]["mix"]
                    heads = (mla.local_heads(mix, cfg),) \
                        if cfg.attention_kind == "mla" else \
                        attention.local_heads(mix, cfg)
                    del mix     # else it outlives params into the next base
                    rep = {"heads": heads, "init_s": init_s,
                           "bytes": sum(t.numel() * t.element_size()
                                        for _, t in
                                        rules._leaves_with_path(params)),
                           "allocated": torch.cuda.memory_allocated() - base}
                    rep["short"] = tp_short(params, cfg, ref["short"], mesh,
                                            name)
                    if name == "deepseek" and shape == TP_MESHES[0]:
                        rep["long"] = tp_long(params, cfg, ref["long"], mesh)
                    report[(name, shape)] = rep
                    del params
                    torch.cuda.empty_cache()
                del ref
            torch.save(report, work / f"tp-rank{rank}.pt")
        finally:
            dist.destroy_process_group()


def _median(xs) -> float:
    xs = sorted(xs[1:] or xs)
    return xs[(len(xs) - 1) // 2]


def phase_tensor_parallel(launches: dict) -> None:
    """Tensor-parallel serving across TP_RANKS ranks (ROADMAP A10b.1):
    each model's single-process references (tp_reference), the card then
    freed; then the ranks (tp_rank_main), each holding only its pieces of
    the weights.  Prints, per model and mesh: the weight bytes a rank
    (counted, and allocated), the K5 / K6 / K9 launches by rank (summed
    into ``launches``) with the q shapes the attention entries received,
    the bytes the collectives returned a step a rank, the step's wall
    beside the reference's, and the free-running streams."""
    import torch

    from repro_torch.launch import mesh as M
    backend, device, where = shard_backend(TP_RANKS)
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        refs = {}
        for name in TP_MODELS:
            ref = tp_reference(name, work, launches)
            refs[name] = {"short": {k: ref["short"][k] for k in
                                    ("floor", "step_ms")},
                          "long": ref.get("long", {}).get("step_ms"),
                          "params_bytes": ref["params_bytes"]}
            del ref
        torch.cuda.empty_cache()
        log(f"[tp] {TP_RANKS} ranks, backend {where}; meshes (data, model) "
            f"{list(TP_MESHES)}")
        t0 = time.perf_counter()
        M.spawn(tp_rank_main, TP_RANKS, (str(work), backend, device),
                timeout_s=TP_SPAWN_S)
        reports = [torch.load(work / f"tp-rank{r}.pt", weights_only=False)
                   for r in range(TP_RANKS)]
    log(f"[tp] ranks done in {time.perf_counter() - t0:.1f} s (their start, "
        "placed inits and both models)")
    for name in TP_MODELS:
        cfg = tp_config(name)
        for shape in TP_MESHES:
            per = [rep[(name, shape)] for rep in reports]
            legs = [("short", refs[name]["short"]["step_ms"])]
            if "long" in per[0]:
                legs.append(("long", refs[name]["long"]))
            log(f"[tp] {name} {shape}: heads a rank {per[0]['heads']} (of "
                f"{cfg.num_heads}"
                + ("" if cfg.attention_kind == "mla" else
                   f", {cfg.num_kv_heads} kv")
                + f"); weight bytes a rank {per[0]['bytes']:,} counted, "
                f"{[p['allocated'] for p in per]} allocated (whole "
                f"{refs[name]['params_bytes']:,}); placed init "
                f"{max(p['init_s'] for p in per):.1f} s")
            for leg, ref_ms in legs:
                runs = [p[leg] for p in per]
                k9 = [r["launches"]["flash_prefill"] for r in runs]
                k5 = [r["launches"]["etap_decode_dense"] for r in runs]
                k6 = [r["launches"]["etap_partial_dense"] for r in runs]
                k2 = [r["launches"]["combine_splits"] for r in runs]
                if not all(a + b for a, b in zip(k5, k6)) or (
                        leg == "short" and not all(k9)):
                    raise AssertionError(f"{name} {shape} {leg}: launches by "
                                         f"rank K9 {k9} K5 {k5} K6 {k6}")
                for r in runs:
                    credit_shard(launches, r["launches"], cfg)
                r0 = runs[0]
                log(f"[tp] {name} {shape} tp-{leg}: launches by rank K9 {k9}"
                    f", K5 {k5}, K6 {k6}, K2 {k2}; q shapes at the entries "
                    f"{ {k: sorted(v) for k, v in r0['heads'].items()} }; "
                    f"max |dlogit| over the steps "
                    f"{max(max(r['diffs']) for r in runs):.4e}; bytes a step "
                    f"a rank {r0['step_bytes']}"
                    + (f", prefill {r0['prefill_bytes']} in "
                       f"{r0['prefill_ms']:.1f} ms" if leg == "short" else
                       f"; S/n {r0['slice_rows']} rows a rank")
                    + ("" if r0.get("view_err") is None else
                       f"; K5 on each rank's kv-head view vs plain, max err "
                       f"{max(r['view_err'] for r in runs):.3e} (bitwise "
                       "the kernel on a copy)")
                    + f"; step {_median(r0['step_ms']):.3f} ms (rank 0, "
                    f"median) against {ref_ms:.3f} ms whole (one process, "
                    f"the card alone); free-running rows equal "
                    f"{r0['free_equal']}, parted (row, position: 0 the "
                    "prefill's token, top-two gap, largest difference) "
                    f"{r0['parted']}")
    log(f"[tp] {where}; {gpu_line()}")


# ---------------------- expert parallelism over `data` (ROADMAP A10b.3)
# phase_expert_parallel: DeepSeek-R1 with its first MoE layer, whole
# weights in this process first, then EP_RANKS ranks on EP_MESH, each
# holding E/2 = 128 of the 256 experts with 512 of each one's 2048 F
# columns and 32 of the 128 MLA heads (param_specs(profile="serve"))
EP_RANKS = 8
EP_MESH = (2, 4)                              # (data, model)
# DeepSeek's 3 dense layers and its first MoE layer: 14.4 B parameters,
# 29 GB in bf16 beside the 3.7 GB fp32 unembedding for the reference; the
# ranks together hold the experts once (22.5 GB) and the rest cut over
# `model` twice over `data` (about 19 GB): 5 layers would put them near
# 68 GB of the card's 80
EP_LAYERS = 4
EP_SHORT = (16, 256, 16)                      # batch, prompt, greedy steps
EP_SPAWN_S = 600                              # the ranks' wall limit


@contextlib.contextmanager
def recorded_routes(rec: list):
    """Record each ``moe.route`` call's router logits and chosen experts
    (host copies), in call order."""
    from repro_torch.models import moe
    route = moe.route

    def wrap(params, cfg, x):
        out = route(params, cfg, x)
        rec.append((out[0].cpu(), out[3].cpu()))
        return out
    moe.route = wrap
    try:
        yield rec
    finally:
        moe.route = route


def ep_route_flips(ref, got, ordered: bool, what: str) -> list:
    """The routing rule of route_flips on recorded routes: ``ref`` and
    ``got`` are (router logits [..., E], chosen experts [..., k]) of the
    same tokens.  A token whose routes differ (the chosen experts, or
    where ``ordered``, since the capacity C is under the group's tokens,
    their order) needs the reference's router-logit gap between its
    first differing choice (unordered: the k-th) and the next under twice
    the largest router-logit difference at that token: an undecided
    router.  Returns [(token, gap, difference)]."""
    import torch
    lr, ir = ref
    lg, ig = got
    E, k = lr.shape[-1], ir.shape[-1]
    lr, lg = lr.reshape(-1, E), lg.reshape(-1, E)
    ir, ig = ir.reshape(-1, k), ig.reshape(-1, k)
    if ordered:
        differ = (ir != ig).any(-1)
    else:
        differ = (ir.sort(-1).values != ig.sort(-1).values).any(-1)
    flips = []
    for row in differ.nonzero().flatten().tolist():
        j = int((ir[row] != ig[row]).nonzero()[0]) if ordered else k - 1
        ranked = torch.sort(lr[row], descending=True, stable=True).values
        gap = float(ranked[j] - ranked[j + 1])
        diff = float((lg[row] - lr[row]).abs().max())
        if not gap < 2 * diff:
            raise AssertionError(
                f"{what}: token {row} routes {ig[row].tolist()} against the "
                f"reference's {ir[row].tolist()} at a decided router (gap "
                f"{gap:.4e}, router-logit difference {diff:.4e})")
        flips.append((row, round(gap, 6), round(diff, 6)))
    return flips


def ep_reference(cfg, work: Path, launches: dict) -> dict:
    """The whole-weight reference, seed-0 weights on the card alone:
    EP_SHORT through ``greedy_reference`` (the prefill, K9, and greedy
    ``decode_step``s, timed, with its floor), the MoE layer's routes
    recorded, saved with the weights' digest to ``work/ep.pt``; the card
    then freed.  Credits the launches."""
    import torch
    from repro_torch.models import model
    from repro_torch.sharding import rules
    B, P, G = EP_SHORT
    t0 = time.perf_counter()
    params = model.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ref = {"digest": weights_digest(params)}
    routes: list = []
    with recorded_routes(routes):
        short = greedy_reference(params, cfg, B, P, G, seed=19)
    got = short.pop("launches")
    ref.update(short=short, routes=routes[:1 + G])
    ref["params_bytes"] = sum(t.numel() * t.element_size()
                              for _, t in rules._leaves_with_path(params))
    log(f"[expert-parallel] reference (one process, whole weights, the card "
        f"alone): DeepSeek-R1 full width, {cfg.num_layers} layers (3 dense, "
        f"1 MoE: {cfg.moe.num_experts} experts, top-{cfg.moe.top_k}, F "
        f"{cfg.moe.d_ff_expert}, a shared expert), "
        f"{model.param_count(params) / 1e9:.3f} B params, "
        f"{ref['params_bytes']:,} B with the fp32 unembedding, drawn in "
        f"{init_s:.1f} s; B {B} x prompt {P} + {G} greedy steps: step "
        f"{short['step_ms']:.3f} ms (median), floor {short['floor']:.4e}, "
        f"launches { {k: v for k, v in got.items() if v} }")
    credit_shard(launches, got, cfg)
    torch.save(ref, work / "ep.pt")
    del params
    torch.cuda.empty_cache()
    return ref


def check_placed_digest(params, mesh, want: int, what: str) -> None:
    """Every rank's leaf digests (a collective over the world): each
    leaf's digests summed over the ranks and divided by the ranks that
    hold the same piece (``rules.replicas`` of its spec), summed over the
    leaves, equal ``want``, the whole tree's digest."""
    import torch.distributed as dist
    from repro_torch.sharding import rules
    mine = {path: weights_digest(t)
            for path, t in rules._leaves_with_path(params)}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    total = 0
    for path in mine:
        s = sum(e[path] for e in every)
        n = rules.replicas(params.spec_at(path), mesh)
        if s % n:
            raise AssertionError(f"{what}: {path}'s pieces differ between "
                                 "the ranks that should hold them alike")
        total += s // n
    if total != want:
        raise AssertionError(f"{what}: the pieces' digests sum to {total}, "
                             f"the whole weights' to {want}")


def ep_rank_main(rank: int, world: int, work: str, backend: str,
                 device: str, cfg) -> None:
    """One rank of phase_expert_parallel: join the group (FileStore in
    ``work``), draw its pieces of the seed-0 weights on EP_MESH
    (``model.init`` under the mesh: its 128 experts with 512 of their F
    columns each, drawn 16 experts at a time), their digests summed over
    the ranks against the reference's, their bytes counted and
    allocated; then tp_short at EP_SHORT with the MoE layer's routes
    recorded and held to the reference's (ep_route_flips: the prefill's
    on the rank's groups, every teacher-forced step's).  Writes its report
    to ``work/ep-rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import mla
    from repro_torch.launch import mesh as M
    from repro_torch.models import model, moe
    from repro_torch.sharding import rules
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = Path(work)
    with (open(os.devnull, "w") if rank else
          contextlib.nullcontext(sys.stdout)) as out, \
            contextlib.redirect_stdout(out):
        dev = M.init_ranks(rank, world, backend=backend,
                           init_method=f"file://{work / 'store'}",
                           device=device, timeout_s=SHARD_COLLECTIVE_S)
        try:
            ref = torch.load(work / "ep.pt", weights_only=False)
            mesh = M.make_host_mesh(dev, EP_MESH)
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            with M.use_mesh(mesh):
                params = model.init(cfg, seed=0, device=dev)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            torch.cuda.empty_cache()
            check_placed_digest(params, mesh, ref["digest"], "ep")
            ffn = params["layers"][cfg.moe.first_dense_layers]["ffn"]
            rep = {"init_s": init_s,
                   "experts": tuple(ffn["w_gate"].shape),
                   "heads": mla.local_heads(params["layers"][0]["mix"], cfg),
                   "bytes": sum(t.numel() * t.element_size() for _, t in
                                rules._leaves_with_path(params)),
                   "allocated": torch.cuda.memory_allocated() - base}
            del ffn
            routes: list = []
            B, P, G = EP_SHORT
            with recorded_routes(routes):
                rep["short"] = tp_short(params, cfg, ref["short"], mesh,
                                        "deepseek", EP_SHORT)
            rows = rules.local_slices((B,), rules.P("data"), mesh)[0]
            prefill = ep_route_flips(
                tuple(t[rows] for t in ref["routes"][0]), routes[0],
                moe.capacity(cfg, P, False) < P, "ep prefill")
            steps = [f for i in range(G) for f in ep_route_flips(
                ref["routes"][1 + i], routes[1 + i],
                moe.capacity(cfg, B, True) < B, f"ep step {i}")]
            rep["flips"] = {
                "prefill": (len(prefill), routes[0][1].shape[:-1].numel()),
                "steps": (len(steps), G * B),
                "closest": max((g / (2 * d) for _, g, d in prefill + steps),
                               default=0.0)}
            rep["peak"] = torch.cuda.max_memory_allocated()
            del params
            torch.cuda.empty_cache()
            torch.save(rep, work / f"ep-rank{rank}.pt")
        finally:
            dist.destroy_process_group()


def phase_expert_parallel(launches: dict) -> None:
    """Expert parallelism over `data` in serving (ROADMAP A10b.3) across
    EP_RANKS ranks on EP_MESH: the whole-weight reference (ep_reference),
    the card then freed; then the ranks (ep_rank_main), each holding only
    its pieces.  Fails unless every gate of tp_short holds (the prefill's
    and each teacher-forced step's gathered logits within check_step's
    gate of the reference's), the free-running rows equal the reference's
    or part where its top-two gap is below the teacher-forced difference,
    every route that differs from the reference's is at an undecided
    router, and K9 and K5 ran on every rank with q at 32 heads.  Prints
    the ``[expert-parallel]`` lines: launches by rank, the bytes each
    collective moved a rank by op in the prefill and a step, the weight
    bytes a rank (counted and allocated), and the step's wall beside the
    whole-weight one."""
    import torch

    from repro_torch.launch import mesh as M
    cfg = full_config(EP_LAYERS)
    backend, device, where = shard_backend(EP_RANKS)
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        ref = ep_reference(cfg, work, launches)
        short = ref["short"]
        del ref["routes"]
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        M.spawn(ep_rank_main, EP_RANKS, (str(work), backend, device, cfg),
                timeout_s=EP_SPAWN_S)
        reps = [torch.load(work / f"ep-rank{r}.pt", weights_only=False)
                for r in range(EP_RANKS)]
    log(f"[expert-parallel] {EP_RANKS} ranks on (data, model) {EP_MESH}, "
        f"backend {where}: done in {time.perf_counter() - t0:.1f} s (their "
        "start, placed inits and the serve run)")
    runs = [r["short"] for r in reps]
    k9 = [r["launches"]["flash_prefill"] for r in runs]
    k5 = [r["launches"]["etap_decode_dense"] for r in runs]
    k6 = [r["launches"]["etap_partial_dense"] for r in runs]
    want_h = cfg.num_heads // EP_MESH[1]
    shapes = {q for r in runs for qs in r["heads"].values() for q in qs}
    prefill_q = {q for r in runs for q in r["heads"].get(
        "causal_attention", ())}
    decode_q = {q for r in runs for q in r["heads"].get(
        "decode_attention", ())}
    if not (all(k9) and all(k5)) or any(
            q[2] != want_h for q in prefill_q) or any(
            q[1] != want_h for q in decode_q) or not (prefill_q and decode_q):
        raise AssertionError(f"expert-parallel: launches by rank K9 {k9} K5 "
                             f"{k5}, q shapes at the entries {shapes}")
    for r in runs:
        credit_shard(launches, r["launches"], cfg)
    bad = [(r, p) for r, rep in enumerate(runs) for p in rep["parted"]
           if not p[2] < p[3]]
    r0 = runs[0]
    B, P, G = EP_SHORT
    log(f"[expert-parallel] DeepSeek-R1 {cfg.num_layers} layers on "
        f"{EP_MESH}: experts a rank {reps[0]['experts']} (w_gate: E/2 "
        f"experts x D x F/4), heads a rank {reps[0]['heads']} of "
        f"{cfg.num_heads}; weight bytes a rank "
        f"{[r['bytes'] for r in reps]} counted, "
        f"{[r['allocated'] for r in reps]} allocated (whole "
        f"{ref['params_bytes']:,}); placed init "
        f"{max(r['init_s'] for r in reps):.1f} s; peak memory a rank "
        f"{[round(r['peak'] / 2**30, 2) for r in reps]} GiB")
    log(f"[expert-parallel] launches by rank K9 {k9}, K5 {k5}, K6 {k6}; q "
        f"shapes at the entries "
        f"{ {k: sorted(v) for k, v in r0['heads'].items()} }; max |dlogit| "
        f"prefill and steps {max(max(r['diffs']) for r in runs):.4e} "
        f"(floor {short['floor']:.4e}); bytes a rank, prefill "
        f"{r0['prefill_bytes']} in {r0['prefill_ms']:.1f} ms, a step "
        f"{r0['step_bytes']}; step {_median(r0['step_ms']):.3f} ms (rank 0, "
        f"median) against {short['step_ms']:.3f} ms whole (one process, the "
        f"card alone; the ranks share one card through the host, so this "
        f"is no multi-GPU speedup); free-running rows equal "
        f"{[r['free_equal'] for r in runs]} of {B}, parted (row, position, "
        f"top-two gap, largest difference) {r0['parted']}; tokens whose "
        f"routes differ from the reference's, of those routed, by rank: "
        f"prefill {[r['flips']['prefill'] for r in reps]}, steps "
        f"{[r['flips']['steps'] for r in reps]}, each at an undecided "
        f"router (the largest gap / (2 x router-logit difference) "
        f"{max(r['flips']['closest'] for r in reps):.3f}); {gpu_line()}")
    if bad:
        raise AssertionError(f"expert-parallel: free-running rows part from "
                             f"the reference at a decided step: {bad}")

# ------------------------------- the sharded train step (ROADMAP A10b.2)
# phase_sharded_train: the whole step in this process, then ST_RANKS
# ranks on ST_MESH, each its row of the batch and its pieces
ST_RANKS = 8
ST_MESH = (2, 4)                              # (data, model)
ST_LAYERS = 3                                 # DeepSeek's dense layers
ST_SPAWN_S = 420                              # the ranks' wall limit
# the gates (PERF.md §6): a rank's gradient pieces and its update p' - p0
# against the reference's, per leaf over the whole leaf, and the step's
# metrics, each within the larger of its limit and twice its floor (the
# larger distance from the whole step of the same step at n_micro 2 and
# under split_rows: orders of summation the reference allows)
ST_GRAD_REL = 1e-2
ST_UPDATE_REL = 1e-2
ST_METRIC_REL = 1e-3


def st_tcfg(n_micro: int = 1):
    from repro_torch.launch.steps import TrainConfig
    from repro_torch.optim import optimizers as opt
    return TrainConfig(optimizer=opt.OptimizerConfig(
        warmup_steps=2, total_steps=TRAIN_STEPS + 1), n_micro=n_micro)


def st_batch(cfg, device, bs):
    """The train-deepseek batch of step 0, B x S = ``bs``."""
    from repro_torch.data.pipeline import DataConfig, make_batch, to_device
    data = DataConfig(seed=17, global_batch=bs[0], seq_len=bs[1])
    return to_device(cfg, make_batch(cfg, data, 0), device)


@contextlib.contextmanager
def clipped_grads(seen: list, host: bool = False):
    """Record the gradient tree each train step clips (the step's
    gradients, before clipping) in ``seen`` (``host``: as host copies,
    the seconds the copies took appended to ``seen`` after the tree)."""
    import torch
    from repro_torch.optim import optimizers as opt
    clip = opt.clip_by_global_norm

    def rec(grads, *a, **kw):
        if host:
            t = time.perf_counter()
            seen.append(opt.tree_map(lambda g: g.to("cpu"), grads))
            torch.cuda.synchronize()
            seen.append(time.perf_counter() - t)
        else:
            seen.append(grads)
        return clip(grads, *a, **kw)
    opt.clip_by_global_norm = rec
    try:
        yield seen
    finally:
        opt.clip_by_global_norm = clip


def tree_bytes(tree) -> int:
    from repro_torch.sharding import rules
    return sum(t.numel() * t.element_size()
               for _, t in rules._leaves_with_path(tree))


def st_step(cfg, tcfg, device, bs, params=None, state=None,
            host: bool = False):
    """One make_train_step step from build_state's seed-0 state (or the
    given one) on the st_batch of ``bs``: (params, state, metrics, grads
    (``host``: host copies, whose copying the wall leaves out), wall s,
    K9 launches)."""
    import torch
    from repro_torch.kernels.flash_prefill import flash_prefill as FP
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    if params is None:
        params, state = train.build_state(cfg, tcfg, seed=0, device=device)
    batch = st_batch(cfg, device, bs)
    seen: list = []
    FP.flash_prefill.launches = 0
    with clipped_grads(seen, host):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, m = make_train_step(cfg, tcfg)(params, state, batch,
                                                      0)
        m = {k: float(v) for k, v in m.items()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t - (seen[1] if host else 0.0)
    return params, state, m, seen[0], wall, FP.flash_prefill.launches


def rel_l2(a, b, base=None) -> float:
    """|a - b| / |b - base| (``base`` None: |b|) in fp64, 16M elements at
    a time."""
    a, b = a.reshape(-1), b.reshape(-1)
    base = None if base is None else base.reshape(-1)
    num = den = 0.0
    for i in range(0, a.numel(), 1 << 24):
        x, y = a[i:i + (1 << 24)].double(), b[i:i + (1 << 24)].double()
        num += float((x - y).square().sum())
        den += float((y if base is None else y - base[
            i:i + (1 << 24)].double()).square().sum())
    return math.sqrt(num / max(den, 1e-300))


@contextlib.contextmanager
def split_rows(n: int):
    """Within the block, each row product of a whole weight
    (``layers.dense_row``) is computed as ``n`` `model` ranks compute it:
    the products of n pieces of its K dim, each rounded to its dtype,
    summed in fp32 and rounded once (``launch.mesh.all_reduce_sum``)."""
    from repro_torch.models import layers
    row = layers.dense_row

    def parts(x, w, whole):
        if w.shape[0] != whole or whole % n:
            return row(x, w, whole)
        k = whole // n
        return sum(layers.dense(x[..., i * k:(i + 1) * k],
                                w[i * k:(i + 1) * k]).float()
                   for i in range(n)).to(x.dtype)
    layers.dense_row = parts
    try:
        yield
    finally:
        layers.dense_row = row


def st_reference(cfg, work: Path, device, bs) -> dict:
    """The whole step from the seed-0 state, with the card to itself: at
    n_micro 1 (its gradients and updated params saved to
    ``work/st-ref.pt`` as {path: host tensor}), then at n_micro 2 and
    under split_rows(model), whose larger distances from the first are
    the floors: per leaf of the gradients and of the update p' - p0, and
    of nll and the grad norm."""
    import torch
    from repro_torch.launch import train
    from repro_torch.sharding import rules
    p0 = dict(rules._leaves_with_path(train.build_state(
        cfg, st_tcfg(1), seed=0, device=device)[0]))
    torch.cuda.empty_cache()
    params, state, m1, g1, wall, k9 = st_step(cfg, st_tcfg(1), device, bs)
    whole = {"params": tree_bytes(params), "state": tree_bytes(state)}
    p1, g1 = dict(rules._leaves_with_path(params)), dict(
        rules._leaves_with_path(g1))
    del state
    torch.save({"grads": {p: t.cpu() for p, t in g1.items()},
                "params": {p: t.cpu() for p, t in p1.items()}},
               work / "st-ref.pt")
    torch.cuda.empty_cache()
    floor = {"grads": dict.fromkeys(g1, 0.0),
             "update": dict.fromkeys(p1, 0.0),
             "metrics": {"nll": 0.0, "grad_norm": 0.0}}
    walls = {}
    for name, n_micro, ctx in (
            ("n_micro 2", 2, contextlib.nullcontext()),
            ("split rows", 1, split_rows(ST_MESH[1]))):
        with ctx:
            pv, sv, mv, gv, walls[name], _ = st_step(
                cfg, st_tcfg(n_micro), device, bs)
        del sv
        gv = dict(rules._leaves_with_path(gv))
        for path, g in g1.items():
            floor["grads"][path] = max(floor["grads"][path],
                                       rel_l2(gv[path], g))
        del gv
        for path, p in rules._leaves_with_path(pv):
            floor["update"][path] = max(floor["update"][path], rel_l2(
                p, p1[path], p0[path]))
        del pv
        for k in floor["metrics"]:
            floor["metrics"][k] = max(floor["metrics"][k],
                                      abs(mv[k] - m1[k]) / abs(m1[k]))
        torch.cuda.empty_cache()
    del p0, p1, g1
    torch.cuda.empty_cache()
    return {"metrics": m1, "wall": wall, "walls": walls, "k9": k9,
            "floor": floor, "whole": whole}


def st_compare(paths, got, want, spec_at, mesh, dev, base=None) -> dict:
    """Per leaf, |got - want| over |want - base| (``base`` None: |want|)
    for the whole leaf, summed from every rank's piece (a piece r ranks
    hold alike weighs 1/r); ``got(path)``, ``want(path, spec)`` and
    ``base(path)`` give this rank's pieces, on any device, taken to
    ``dev`` 16M elements at a time: {path: relative L2}."""
    import torch
    from repro_torch.launch import mesh as M
    from repro_torch.sharding import rules
    chunk = 1 << 24
    parts = []
    for path in paths:
        spec = spec_at(path)
        ts = [got(path), want(path, spec)] + ([] if base is None else
                                             [base(path)])
        ts = [t.reshape(-1) for t in ts]
        num = torch.zeros((), dtype=torch.float64, device=dev)
        den = torch.zeros((), dtype=torch.float64, device=dev)
        for i in range(0, ts[0].numel(), chunk):
            a, b, *c = (t[i:i + chunk].to(dev).double() for t in ts)
            num += (a - b).square().sum()
            den += (b - c[0] if c else b).square().sum()
            del a, b, c
        rep = rules.replicas(spec, mesh)
        parts += [num / rep, den / rep]
    tot = M.all_reduce_world(torch.stack(parts), mesh).cpu()
    return {p: math.sqrt(float(tot[2 * i]) / max(float(tot[2 * i + 1]),
                                                 1e-300))
            for i, p in enumerate(paths)}


def st_rank_main(rank: int, world: int, work: str, backend: str,
                 device: str, cfg, bs) -> None:
    """One rank of phase_sharded_train: join the group (FileStore in
    ``work``), build this rank's pieces of the seed-0 state under the
    mesh, run one step on its row, and compare its gradient and param
    pieces with the reference's (``work/st-ref.pt``, mapped, each rank
    reading only its pieces).  Writes its report to
    ``work/st-rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as M
    from repro_torch.launch import train
    from repro_torch.optim import optimizers as opt
    from repro_torch.sharding import rules
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = Path(work)
    # 8 ranks share the card: let each allocator's segments grow in place
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    with (open(os.devnull, "w") if rank else
          contextlib.nullcontext(sys.stdout)) as out, \
            contextlib.redirect_stdout(out):
        dev = M.init_ranks(rank, world, backend=backend,
                           init_method=f"file://{work / 'store'}",
                           device=device, timeout_s=SHARD_COLLECTIVE_S)
        try:
            mesh = M.make_host_mesh(dev, ST_MESH)
            base = torch.cuda.memory_allocated()
            tcfg = st_tcfg(1)
            with M.use_mesh(mesh):
                t0 = time.perf_counter()
                params, state = train.build_state(cfg, tcfg, seed=0,
                                                  device=dev)
                torch.cuda.synchronize()
                init_s = time.perf_counter() - t0
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                rep = {"bytes": {"params": tree_bytes(params),
                                 "state": tree_bytes(state)},
                       "allocated": torch.cuda.memory_allocated() - base,
                       "init_s": init_s}
                start = opt.tree_map(lambda t: t.to("cpu"), params)
                spec_at = params.spec_at
                seen: dict = {}
                M.moved.clear()
                with recorded_heads(seen):
                    params, state, m, grads, wall, k9 = st_step(
                        cfg, tcfg, dev, bs, params, state, host=True)
                rep.update(metrics=m, wall=wall, k9=k9, heads=seen,
                           moved=dict(M.moved),
                           peak=torch.cuda.max_memory_allocated())
                ref = torch.load(work / "st-ref.pt", mmap=True,
                                 weights_only=True)

                def cut(tree):
                    return lambda path, spec: rules.local_rows(
                        tree[path], spec, mesh)
                del state
                torch.cuda.empty_cache()
                g = dict(rules._leaves_with_path(grads))
                p1 = dict(rules._leaves_with_path(params))
                p0 = dict(rules._leaves_with_path(start))
                rep["grads"] = st_compare(list(g), g.get, cut(ref["grads"]),
                                          spec_at, mesh, dev)
                # the update p' - p0 against the reference's (p0: the
                # rank's pieces before the step, bitwise the whole init's)
                rep["update"] = st_compare(list(p1), p1.get,
                                           cut(ref["params"]), spec_at, mesh,
                                           dev, base=p0.get)
                del ref, start, g, p0, p1
            torch.save(rep, work / f"st-rank{rank}.pt")
        finally:
            dist.destroy_process_group()


def st_moved(moved: dict) -> dict:
    """A rank's collective bytes summed by phase: forward, remat,
    backward, and the gradients' sums and norm ("grads")."""
    out: dict = {}
    for k, v in moved.items():
        phase = k.split(":")[1] if ":" in k else "forward"
        out[phase] = out.get(phase, 0) + v
    return out


def phase_sharded_train(launches: dict) -> None:
    """The sharded train step across ST_RANKS ranks on ST_MESH (ROADMAP
    A10b.2): the whole-weight reference and its floors (st_reference),
    the card then freed; then the ranks (st_rank_main), each holding only
    its pieces.  Fails unless every leaf's gradient and update and the
    step's nll and grad norm meet their gates and K9 ran on every rank."""
    import torch

    from repro_torch.launch import mesh as M
    cfg = full_config(ST_LAYERS)
    bs = (TRAIN_B, TRAIN_S)
    backend, rank_dev, where = shard_backend(ST_RANKS)
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        t0 = time.perf_counter()
        ref = st_reference(cfg, work, "cuda", bs)
        credit_prefill(launches, {"flash_prefill": ref["k9"]}, cfg)
        floor = ref["floor"]
        fg, fu, fm = floor["grads"], floor["update"], floor["metrics"]
        log(f"[sharded-train] reference (one process, whole weights, the "
            f"card alone): DeepSeek-R1 full width, {cfg.num_layers} dense "
            f"layers, B {bs[0]} x S {bs[1]}, AdamW with bf16 moments, "
            f"remat {cfg.remat}: step {ref['wall'] * 1e3:.1f} ms (n_micro "
            f"1; "
            + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in
                        ref["walls"].items())
            + f"), nll {ref['metrics']['nll']!r}, grad norm "
            f"{ref['metrics']['grad_norm']!r}, K9 launched {ref['k9']} "
            f"times; floors (the larger of n_micro 2 and split rows "
            f"against n_micro 1): gradients per leaf "
            f"{min(fg.values()):.3e}-{max(fg.values()):.3e} relative L2, "
            f"updates p' - p0 {min(fu.values()):.3e}-"
            f"{max(fu.values()):.3e}, nll {fm['nll']:.3e}, grad norm "
            f"{fm['grad_norm']:.3e}; weights {ref['whole']['params']:,} B, "
            f"AdamW state {ref['whole']['state']:,} B; "
            f"{time.perf_counter() - t0:.1f} s with the host file")
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        M.spawn(st_rank_main, ST_RANKS, (str(work), backend, rank_dev, cfg,
                                         bs), timeout_s=ST_SPAWN_S)
        reps = [torch.load(work / f"st-rank{r}.pt", weights_only=False)
                for r in range(ST_RANKS)]
    log(f"[sharded-train] {ST_RANKS} ranks on (data, model) {ST_MESH}, "
        f"backend {where}: done in {time.perf_counter() - t1:.1f} s (their "
        f"start, placed states, the step and the comparisons)")
    k9 = [r["k9"] for r in reps]
    if not all(k9):
        raise AssertionError(f"sharded-train: K9 launches by rank {k9}")
    for r in reps:
        credit_prefill(launches, {"flash_prefill": r["k9"]}, cfg)
    heads = sorted({q for r in reps for qs in r["heads"].values()
                    for q in qs})
    want_h = cfg.num_heads // ST_MESH[1]
    if any(q[2] != want_h for q in heads):
        raise AssertionError(f"sharded-train: q shapes at the causal "
                             f"attention {heads}, not {want_h} heads")
    r0 = reps[0]

    def gated(reading: dict, fl: dict, limit: float):
        """(the leaves over their gates, the leaf closest to its gate)."""
        bad = {p: (v, fl[p]) for p, v in reading.items()
               if not v <= max(limit, 2 * fl[p])}
        return bad, max(reading, key=lambda p: reading[p] / max(
            limit, 2 * fl[p]))
    bad, worst = gated(r0["grads"], fg, ST_GRAD_REL)
    ubad, uworst = gated(r0["update"], fu, ST_UPDATE_REL)
    mdiff = {k: abs(r0["metrics"][k] - ref["metrics"][k])
             / abs(ref["metrics"][k]) for k in ("nll", "grad_norm")}
    mbad, _ = gated(mdiff, fm, ST_METRIC_REL)
    same = all(r["metrics"] == r0["metrics"] for r in reps)
    walls = [r["wall"] for r in reps]
    log(f"[sharded-train] K9 launches by rank {k9} (q shapes at the entry "
        f"{heads}); weights a rank {[r['bytes']['params'] for r in reps]} "
        f"B counted (whole {ref['whole']['params']:,}), AdamW state "
        f"{[r['bytes']['state'] for r in reps]} B (whole "
        f"{ref['whole']['state']:,}), allocated by both "
        f"{[r['allocated'] for r in reps]}; placed build "
        f"{max(r['init_s'] for r in reps):.1f} s; peak memory a rank "
        f"{[round(r['peak'] / 2**30, 2) for r in reps]} GiB")
    log(f"[sharded-train] bytes the collectives moved in the step, rank 0 "
        f"by kind {r0['moved']}, by phase {st_moved(r0['moved'])}; step "
        f"wall by rank {[round(w * 1e3, 1) for w in walls]} ms against "
        f"the whole step's {ref['wall'] * 1e3:.1f} ms: the ranks share one "
        "card through the host, so this is no multi-GPU speedup")
    log(f"[sharded-train] nll {r0['metrics']['nll']!r} (reference "
        f"{ref['metrics']['nll']!r}: {mdiff['nll']:.3e} relative, gate "
        f"{max(ST_METRIC_REL, 2 * fm['nll']):.3e}), grad "
        f"norm {r0['metrics']['grad_norm']!r} (reference "
        f"{ref['metrics']['grad_norm']!r}: {mdiff['grad_norm']:.3e}, gate "
        f"{max(ST_METRIC_REL, 2 * fm['grad_norm']):.3e}); "
        f"equal on every rank {same}; gradients per leaf "
        f"{min(r0['grads'].values()):.3e}-{max(r0['grads'].values()):.3e} "
        f"relative L2 (closest to its gate: {worst} "
        f"{r0['grads'][worst]:.3e} against floor {fg[worst]:.3e}); "
        f"updates p' - p0 {min(r0['update'].values()):.3e}-"
        f"{max(r0['update'].values()):.3e} relative L2 (closest to its "
        f"gate: {uworst} {r0['update'][uworst]:.3e} against floor "
        f"{fu[uworst]:.3e}); {gpu_line()}")
    if bad or ubad or mbad or not same:
        raise AssertionError(f"sharded-train: gates failed: gradients "
                             f"{bad}, updates {ubad}, metrics {mbad}, "
                             f"ranks agree {same}")


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
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(gpu_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t_run = t0 = time.perf_counter()
    lib_path, nvlog = build.build()
    build.library()
    for line in nvlog.splitlines():
        if line.startswith("==") or any(
                x in line for x in ("Compiling entry", "registers", "spill")):
            log(f"[build] {line.strip()}")
    log(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s")

    def timed(phase, fn, *a, **kw):
        t = time.perf_counter()
        fn(*a, **kw)
        log(f"[time] {phase}: {time.perf_counter() - t:.1f} s")

    report: dict = {}
    timed("kernels", phase_kernels, args.quick, report)
    timed("dense kernels", phase_dense_kernels, args.quick, report)
    timed("quantized kernels", phase_quant_kernels, args.quick, report)
    sepv_launches: dict = {}
    timed("separate-V paged kernels", phase_sepv_kernels, args.quick,
          report, sepv_launches)
    timed("GQA kernels (128, 64, 256)", phase_gqa_kernels, args.quick,
          report)
    timed("quantized dense kernels", phase_quant_dense_kernels, args.quick,
          report)
    timed("selective scan", phase_scan, args.quick, report)
    timed("causal prefill kernel (K9)", phase_prefill_kernels, args.quick,
          report)
    timed("spec verify kernels", phase_spec_verify, args.quick, report)
    if args.quick:
        log(json.dumps({"kernels": [
            dict(name=k, **v, **({"launches": sepv_launches[k]}
                                 if k in sepv_launches else {}))
            for k, v in report.items()]}))
        return 0

    from repro_torch.configs import get_config
    from repro_torch.core.attn_spec import AttnSpec
    from repro_torch.models import model
    cfg = full_config()
    t0 = time.perf_counter()
    params = model.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[init] DeepSeek-R1 full width, {cfg.num_layers} dense layers: "
        f"{model.param_count(params) / 1e9:.3f} B params bf16 in "
        f"{time.perf_counter() - t0:.1f} s")

    launches = {k: 0 for k in [*KERNELS, *QUANT_KERNELS, *GQA_KERNELS,
                               *QDENSE_KERNELS, *PREFILL_KERNELS]}
    launches.update(sepv_launches)          # the paged entries' own path
    served = {k: 0 for k in QDENSE_KERNELS}      # on the serve phases only
    runs: dict = {}                   # the serve runs' outputs, by phase

    def credit_deepseek(got, flags):
        kvd = kv_dtype_of(flags)
        for k in KERNELS:
            launches[k] += got.get(k, 0)
        for k, (_, _, wrapper, code) in QUANT_KERNELS.items():
            if code == kvd:
                launches[k] += got.get(wrapper, 0)
        add_qdense(launches, got, DK, kvd)
        add_qdense(served, got, DK, kvd)
        credit_prefill(launches, got, cfg)

    t_serve = time.perf_counter()
    for name, flags, expect in SERVE_PHASES:
        got = phase_serve(name, flags + ["--layers", "3"], params, expect,
                          runs)
        credit_deepseek(got, flags)
    log(f"[time] serve phases: {time.perf_counter() - t_serve:.1f} s")
    t_serve = time.perf_counter()
    credit_deepseek(phase_serve_obs(params, runs), SHORT)
    for name, flags, twin in FAULT_PHASES:
        credit_deepseek(phase_fault_serve(name, flags + ["--layers", "3"],
                                          params, twin, runs), flags)
    log(f"[time] telemetry and fault-drill phases: "
        f"{time.perf_counter() - t_serve:.1f} s")
    timed("resumed chunk", phase_resume_chunk, params, cfg)
    timed("C1 prefix cache on / off", phase_prefix_check, params,
          credit_deepseek)
    timed("row bits", phase_row_bits, params, cfg)
    timed("C2 preemption restores", phase_preemption_check, params,
          credit_deepseek)
    t_serve = time.perf_counter()
    for name, flags, expect, off in SPEC_PHASES:
        for got in phase_spec_serve(name, flags + ["--layers", "3"], params,
                                    expect, off, runs):
            credit_deepseek(got, flags)
    log(f"[time] spec serve phases: {time.perf_counter() - t_serve:.1f} s")
    timed("head table check", head_table_check, params)
    timed("decode steps", phase_decode_step, params, launches)
    diffs: dict = {}
    timed("verify steps", phase_verify_steps, params, cfg, diffs)

    def spec_streams(phases, weights, diff_of):
        for name, flags, _, off in phases:
            mode = flags[flags.index("--mode") + 1] if "--mode" in flags \
                else "etap"
            spec_stream_check(name, off, runs, weights,
                              diff_of(kv_dtype_of(flags), mode))

    timed("spec streams", spec_streams, SPEC_PHASES, params,
          lambda kvd, mode: diffs[(kvd, mode)])
    timed("deepseek prefill check", phase_prefill_check, params, cfg, 4,
          4096)
    timed("deepseek prefill profile", profile_prefill, params, cfg, 4, 4096,
          tag="deepseek-prefill",
          kernel=("flash_prefill (K9)", "flash_prefill_kernel"))
    del params
    torch.cuda.empty_cache()
    timed("train-deepseek", phase_train_deepseek, cfg, launches)
    timed("train-smollm", phase_train_smollm, launches)

    # DeepSeek-R1 with its first two MoE layers
    cfg = full_config(MOE_LAYERS)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[init] DeepSeek-R1 full width, {cfg.num_layers} layers (3 dense, "
        f"{cfg.num_layers - 3} MoE): {model.param_count(params) / 1e9:.3f} "
        f"B params bf16 in {time.perf_counter() - t0:.1f} s, peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    timed("moe unit check", phase_moe_unit, params, cfg)
    t_serve = time.perf_counter()
    for name, flags, expect in MOE_SERVE_PHASES:
        got = phase_serve(name, flags + ["--layers", str(MOE_LAYERS)],
                          params, expect, runs)
        credit_deepseek(got, flags)
    log(f"[time] moe serve phases: {time.perf_counter() - t_serve:.1f} s")
    timed("moe decode steps", phase_moe_decode_step, params, cfg)
    del params
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(get_config("dbrx_132b"), num_layers=DBRX_LAYERS)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[init] DBRX-132B full width, {cfg.num_layers} of "
        f"{get_config('dbrx_132b').num_layers} layers (every one MoE): "
        f"{model.param_count(params) / 1e9:.3f} B params bf16 in "
        f"{time.perf_counter() - t0:.1f} s, peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    t_serve = time.perf_counter()
    for name, flags, expect in DBRX_PHASES:
        got = phase_serve(name, flags, params, expect)
        credit(launches, got, HD, kv_dtype_of(flags))
        credit_prefill(launches, got, cfg)
    log(f"[time] dbrx serve phases: {time.perf_counter() - t_serve:.1f} s")
    del params
    torch.cuda.empty_cache()

    cfg = get_config("falcon_mamba_7b")
    t0 = time.perf_counter()
    params = model.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[init] Falcon-Mamba-7B full width, all {cfg.num_layers} layers: "
        f"{model.param_count(params) / 1e9:.3f} B params bf16 in "
        f"{time.perf_counter() - t0:.1f} s")
    t_serve = time.perf_counter()
    for name, flags in MAMBA_PHASES:
        got = phase_serve(name, flags, params, ("selective_scan",))
        if got["selective_scan"] != cfg.num_layers:
            raise AssertionError(f"{name}: K10 launched "
                                 f"{got['selective_scan']} times, not once a "
                                 "layer of the prefill")
        for k in KERNELS:
            launches[k] += got[k]
    log(f"[time] falcon serve phases: {time.perf_counter() - t_serve:.1f} s")
    timed("falcon prefill check", phase_mamba_check, params, cfg)
    timed("falcon prefill profile", profile_mamba_prefill, params, cfg, 8,
          512)
    del params
    torch.cuda.empty_cache()

    cfg = get_config("qwen3_8b")
    t0 = time.perf_counter()
    params = model.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[init] Qwen3-8B full width, all {cfg.num_layers} layers: "
        f"{model.param_count(params) / 1e9:.3f} B params bf16 in "
        f"{time.perf_counter() - t0:.1f} s")
    t_serve = time.perf_counter()
    for name, flags, expect in QWEN_PHASES:
        got = phase_serve(name, flags, params, expect)
        credit(launches, got, HD, kv_dtype_of(flags))
        add_qdense(served, got, HD, kv_dtype_of(flags))
        credit_prefill(launches, got, cfg)
    for name, flags, expect, off in QWEN_SPEC_PHASES:
        for got in phase_spec_serve(name, flags, params, expect, off, runs):
            credit(launches, got, HD, kv_dtype_of(flags))
            add_qdense(served, got, HD, kv_dtype_of(flags))
            credit_prefill(launches, got, cfg)
    log(f"[time] qwen serve phases: {time.perf_counter() - t_serve:.1f} s")
    qwen_diff = verify_vs_decode(
        params, cfg, "fp", AttnSpec(kv_splits=1),
        torch.Generator(device="cuda").manual_seed(6), "qwen", floor=True)
    timed("qwen spec streams", spec_streams, QWEN_SPEC_PHASES, params,
          lambda kvd, mode: qwen_diff)
    timed("qwen prefill check", phase_prefill_check, params, cfg, 8, 512)
    timed("qwen per-layer prefill check", phase_prefill_layer_check, params,
          cfg, 8, 512)
    timed("qwen decode steps", phase_gqa_decode_steps, params, cfg,
          launches, layout="paged", kvds=("fp", "int8", "fp8"))
    timed("qwen dense decode steps", phase_gqa_decode_steps, params, cfg,
          launches, layout="dense")
    timed("qwen per-layer check", phase_layer_check, params, cfg,
          layout="paged", kvds=("fp", "int8", "fp8"), splits=(1, None))
    del params
    torch.cuda.empty_cache()

    # the last dense-decode widths: SmolLM, StableLM, MusicGen at 64,
    # RecurrentGemma at 256, LLaVA-NeXT at 128 with G = 7 (cut in depth)
    for arch, phases in WIDTH_PHASES.items():
        cfg = get_config(arch)
        if arch == "llava_next_34b":
            cfg = dataclasses.replace(cfg, num_layers=8)
        t0 = time.perf_counter()
        params = model.init(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        log(f"[init] {arch} full width, {cfg.num_layers} of "
            f"{get_config(arch).num_layers} layers: "
            f"{model.param_count(params) / 1e9:.3f} B params bf16 in "
            f"{time.perf_counter() - t0:.1f} s")
        width = cfg.resolved_head_dim
        t_serve = time.perf_counter()
        for name, flags, expect in phases:
            got = phase_serve(name, flags, params, expect)
            credit(launches, got, width, kv_dtype_of(flags))
            add_qdense(served, got, width, kv_dtype_of(flags))
            credit_prefill(launches, got, cfg)
        log(f"[time] {arch} serve phases: "
            f"{time.perf_counter() - t_serve:.1f} s")
        if arch == "smollm_360m":
            timed("smollm decode steps", phase_gqa_decode_steps, params,
                  cfg, launches, layout="paged", kvds=("fp", "int8", "fp8"))
            timed("smollm per-layer check", phase_layer_check, params, cfg,
                  layout="paged", kvds=("fp", "int8"), splits=(1, 3))
        elif arch == "stablelm_1_6b":
            timed("stablelm decode steps", phase_gqa_decode_steps, params,
                  cfg, launches, layout="dense")
            timed("stablelm per-layer check", phase_layer_check, params,
                  cfg, layout="dense")
        elif arch == "recurrentgemma_9b":
            timed("rgemma prefill check", phase_rgemma_prefill_check, params,
                  cfg)
            timed("rgemma decode steps", phase_gqa_decode_steps, params,
                  cfg, launches, layout="dense")
            timed("rgemma per-layer check", phase_layer_check, params, cfg,
                  layout="dense")
        del params
        torch.cuda.empty_cache()

    timed("sequence-sharded decode", phase_seq_sharded, launches)
    timed("tensor-parallel serving", phase_tensor_parallel, launches)
    timed("expert-parallel serving", phase_expert_parallel, launches)
    timed("sharded train step", phase_sharded_train, launches)

    for wrapper, w in {v[2:4] for v in QDENSE_KERNELS.values()}:
        if not any(n for k, n in served.items()
                   if QDENSE_KERNELS[k][2:4] == (wrapper, w)):
            raise AssertionError(f"{wrapper} at {w} launched on no serve "
                                 "phase")
    log(f"[launches] serve paths and decode-step checks: {launches}")
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f"{k} never launched on a main-path call")
    log(f"[time] build to here: {time.perf_counter() - t_run:.1f} s")
    log(gpu_line())               # again beside the results, for the record

    kernels = [dict(name=k, route="cuda", source=src, replaces=tpu,
                    launches=launches[k], **report[k])
               for k, (tpu, src) in KERNELS.items()]
    kernels += [dict(name=k, route="cuda", source=src, replaces=tpu,
                     launches=launches[k], **report[k])
                for k, (tpu, src, _, _) in QUANT_KERNELS.items()]
    kernels += [dict(name=k, route="cuda", source=src, replaces=tpu,
                     launches=launches[k], **report[k])
                for k, (tpu, src, *_) in GQA_KERNELS.items()]
    kernels += [dict(name=k, route="cuda", source=src, replaces=tpu,
                     launches=launches[k], **report[k])
                for k, (tpu, src, *_) in QDENSE_KERNELS.items()]
    kernels += [dict(name=k, route="cuda", source=src, replaces=tpu,
                     launches=launches[k], **report[k])
                for k, (tpu, src, *_) in PREFILL_KERNELS.items()]
    kernels += [dict(name=k, route="cuda", source=src, replaces=tpu,
                     launches=launches[k], **report[k])
                for k, (tpu, src, *_) in SEPV_KERNELS.items()]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
