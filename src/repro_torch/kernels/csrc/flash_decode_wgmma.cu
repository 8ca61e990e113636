// The untransposed decode baseline for Hopper (sm_90a), over bf16 rows and
// over int8 / e4m3 code rows: FlashMLA without ETAP, on wgmma, TMA and warp
// specialisation.
//
//   K7  single-pass decode         replaces repro/kernels/flash_decode/
//       (flash_decode_pallas :58)  flash_decode.py:83 (_body :26)
//   K8  split-KV phase 1           replaces repro/kernels/flash_decode/
//       (flash_decode_partial_pallas :136)  flash_decode.py:168
//                                  (_partial_body :95)
//   K7q, K8q  K7 and K8 over dense code rows with per-row (scale, zp): the
//       reference gathers a quantized pool, dequantizes it to fp32 and runs
//       K7 / K8 on the fp32 rows (repro/core/etap.py:311-327, :391-394 for
//       DeepSeek's latent in --mode standard; repro/models/attention.py:
//       249-260 for a GQA pool), the same two pallas_call sites.
//
// Built over bf16 rows at each (Dk, Dv) of mma_tile.cuh's DenseWidths: the
// MLA latent (576, 512), fused (V = the K rows' first 512 columns, read
// from K's boxes) or with V rows of its own, and the GQA heads (128, 128),
// (64, 64) and (256, 256), whose cache [B, S, K, hd] is read in place (a V
// that is K itself is read through a second map over K's rows).  Over codes
// (K7q / K8q) at each pair of QuantDenseWidths: the latent, fused or with V
// code rows of its own, and the GQA heads at 128 and 64; with bf16 or fp32
// q; the code type (int8 or e4m3) a run-time argument.
//
// What it computes.  Batch row b has H query heads (a decode step's
// heads: H for the MLA latent, a GQA group's G), all with the horizon
// lengths[b] - 1, and a split s of n_splits walks the row's 64-row pages
// [s npb, (s + 1) npb):
//     S = Q K^T * scale       [64, 64]   the heads on wgmma's M
//     mask kpos > horizon to -1e30
//     online-softmax update per head row (m, l), softmax_state.update in
//     both rescale modes (softmax_state.cuh: amla's 2^d is exact)
//     O = O * corr + P V      [64, Dv]   P as bf16 hi + lo
// K7 ends with out [B, H, Dv] = O / l in bf16; K8 writes the raw fp32 (m,
// l, O) of its split [B, n, H], [B, n, H, Dv] for combine.cu's
// combine_splits_std.  This is the orientation the paper measures ETAP
// against: the thin head axis rides wgmma's M side of both products, 64
// rows a warpgroup, so a GQA group of G = 4 heads leaves 60 of the 64 M
// rows idle (nothing packs other rows' heads into M: they read other K).
// Heads past H load as TMA's zeros and are never written.  The walk ends
// after the page holding the row's last live position (past it a page is
// masked whole, an exact no-op of the recurrence); a split with no live
// position walks all of its pages, as the reference does, so its stats are
// the reference's.
//
// Over codes (QUANT: K7q, K8q).  A row holds int8 or e4m3 codes and one fp32
// (scale, zp) pair; every int8 and every e4m3 code is exact in bf16, so the
// codes feed the bf16 wgmma as they are and the affine goes around the
// products.  A KV row is a column of S here:
//     S_hr = scale_r (q_h . codes_r) + zp_r sum(q_h)
//     O_h += sum_r codes_r (scale_r p_hr) + sum_r zp_r p_hr
// The page's 64 pairs (and a separate V's) are read by 64 threads of the
// page's consumer at the top of its step (a row past S takes (1, 0) and is
// not read) and stored, while the score product runs, into shared memory,
// two buffers a consumer, where each thread reads its 16 columns' pairs.
// sum(q) is one fp32 sum a head of q as given.  scale_r p enters P V as
// three bf16 terms (hi, mid, lo: its 24 bits, as in the ETAP kernels), so P
// V is three RS wgmmas a k16 step and V box, and l sums the plain p.  The
// page's zp term Z = sum_r zp_r p_r of a head (its thread's 16 columns, then
// the quad) joins every column of the head's O row with the page's rescale,
// O = O corr + Z (one FMA where the bf16 rows take a multiply), so no state
// beside (m, l, O) is carried or merged, and no registers: out = O / l in
// fp32 (the reference's K7 / K8 write V's fp32 type after its
// dequantization), and a split writes O as its Acc.  An fp32 q (the GQA
// paths, which cast q to fp32 as the reference does, and the accuracy gates)
// enters as three bf16 Q terms (hi, mid, lo: its 24 bits), split by the
// consumers at the unit's start (no Q map), three score wgmmas a k-step, the
// lo terms over the whole page first, then mid, then hi (the small ones
// first, so that the tensor cores' adds round the hi products' sum, not the
// small terms, against the running sum).  Three Q terms of 64 heads at the
// latent take 216 KB, which leaves no room for a page's boxes, so there a
// unit holds HQ = 32 heads: each term's 32 rows lie one after another, the
// score product's A operand still spans wgmma's 64 rows (its upper 32 rows
// read the next term's, or past the last one the merge buffer's, rows), and
// S rows 32-63 are masked whole and never written; and a unit computes a
// quarter of Dv (O [64, 128]), whose registers leave room for the three
// terms' score product (a build with halves spilled 144-152 B a thread on an
// H100).  The 128 heads of a DeepSeek row take 16 units, each reading the
// row's pages; the instance serves the accuracy gates, not a serve path
// (DeepSeek's q is bf16).  Elsewhere a unit holds 64 heads.  Over codes the
// producer loads each box's 4 KB of codes into the upper half of its ring
// slot, and the first warpgroup's other three warps (the converters) widen
// them in place, box m by warp m % 3 (the ring a multiple of 3 slots, so
// that a slot is always the same warp's), into the slot's swizzled bf16 box
// on the integer and fp32 / bf16 pipes (hopper.cuh: widen_box), and arrive
// on the slot's ready barrier, which the consumers wait on instead of full.
// Codes past a row's length hold finite values, so V never carries a NaN
// into a masked p = 0.
//
// The design (hopper.cuh holds the building blocks; K9, flash_prefill.cu, is
// the same consumer with query rows in place of a decode row's heads;
// etap_decode.cuh the same producer, converters and ring).  A work unit is
// (row b, a tile of HQ heads, split s) and, at the latent, one of Dv's two
// halves of 256 columns (with fp32 q one of its quarters); units run on a
// persistent grid of min(units, SMs) CTAs, CTA i taking units i, i + grid,
// ...  A CTA is three warpgroups.  One warp of the first (the producer;
// setmaxnreg 40) issues every load with TMA into a ring of RING boxes of 64
// rows x 128 bytes (128-byte swizzle, 1024-byte aligned), each with a full
// barrier (the bytes landed, in LOOK copies: see Cfg; over codes also a
// ready one, the box widened) and an empty one (its consumer done with it):
// each page's K boxes (fused, the boxes outside the unit's V columns first,
// then its V boxes) and, with a V of its own, the unit's V boxes after them;
// with bf16 q the unit's Q tile (64 heads, rows past H read as zero) behind
// the first page's K boxes, never behind its V boxes (a ring of one page's
// boxes holds those only once the score product has released K's).  The two
// consumer warpgroups (setmaxnreg 232) split the unit's pages, not its
// columns (as the ETAP decode kernels do: a wgmma costs about the same at
// any N <= 64, so two consumers on one page pay it twice): each takes every
// other page, with an online-softmax state of its own:
//   S [64, 64]: Dk / 16 SS wgmmas m64n64k16 (three a k-step with fp32 q),
//     A = the Q tile, B = the K box, both K-major, the K boxes in k order
//     whatever the load order (so the two Dv halves compute the same bits);
//     the first k-step writes S only (scale-d false);
//   a head row's max over the page: its thread's 16 values, then a quad
//     shuffle, with no shared-memory exchange (the one step the standard
//     orientation does more cheaply than ETAP); l stays a per-thread
//     partial sum until the unit's end;
//   P: S's fp32 fragment is, n8 pair by n8 pair, the register A fragment
//     of P V's k16 steps, split in place into bf16 hi + lo (over codes
//     scale p into hi + mid + lo);
//   O += P V: per k16 step and 64-column V box, two (over codes three) RS
//     wgmmas m64n64k16, V read MN-major through the transpose bit.
// At the unit's end the second consumer's (m, l, O) is merged into the
// first's thread by thread (both hold the same fragments), as the combine
// kernel merges two splits (softmax_state.cuh: stat_weight), and the first
// writes the unit.  The page split and the units depend on the shapes
// alone, never on other rows, so a row's bits do not depend on the rest of
// the batch; K8 at n = 1 runs K7's units (n = 1 + K2 is bitwise K7, and
// K8q's n = 1 + K2 K7q).
//
// Dv 512 does not fit one warpgroup: O [64, 512] in fp32 is 256 registers
// a thread against a cap of 232.  So at the latent a unit computes one
// half of Dv (O [64, 256]: 128 registers), and both halves compute S
// themselves (Dk / 16 = 36 S wgmmas a page in each): the units double,
// which the decode shapes want (K7 at B 8, H 128 has 16 (row, head tile)
// pairs for 132 SMs).  Two other arrangements were built and timed
// against this one on an H100 (PERF.md, section 6): FlashMLA's (one unit,
// S once a page, the consumers taking alternate pages and handing P and the
// rows' rescale to each other through shared memory, each running P V on
// its half as SS wgmmas) took about twice as long at K7's and K8's B 8,
// H 128; a CTA holding both halves of a unit on its two consumers, each
// walking every page of the one ring, took 1.5-1.6x as long there and
// 0.8x at the paper's geometry (B 16, H 16, 65,536 rows), where this one's 256
// units make two waves of the grid and read every page into two SMs.  At
// Dv <= 256 a consumer holds O [64, Dv] (128 registers at 256).
//
// Numerics against the mma.sync bodies this kernel replaced: the same
// arithmetic in another order (S's k-steps, l summed per thread and
// then across the quad, the two consumers' states merged), so outputs agree
// within the bf16 (over codes, the fp32) tolerance, not bitwise.
//
// What bounds it on the H100.  The K and V bytes over 3.35 TB/s: 1152 B a
// fused latent row, 2176 B with a separate V, 512 B a row at 128; over
// codes 584 B a fused latent row with its pair, 272 B at 128 with both
// pairs; the multiply-adds are 2 H (Dk + Dv) per row, and the tensor cores
// do 64 (or for P's two or three terms 2 or 3 x 64) rows' worth of them
// whatever H is.  A single pass brings a row's whole page stream into each
// of the row's units (one SM's intake, not the device's bandwidth, then
// sets its time); the split plans are the route to the byte bound.
#include <atomic>
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "mma_tile.cuh"

namespace {

using namespace etap;
using namespace hopper;

constexpr int BOX = 64;                    // columns a TMA box (128 bytes)
constexpr int HT = 64;                     // wgmma's M: a Q tile's rows
constexpr int BOX_ELEMS = PAGE * BOX;      // a page box: 64 rows x 64
constexpr int BOX_BYTES = BOX_ELEMS * 2;   // 8,192
constexpr int CODE_BOX_BYTES = BOX_ELEMS;  // its codes: 4,096
constexpr int NCONS = 2;                   // consumer warpgroups
constexpr int NCONV = 3;                   // converter warps (codes)
constexpr int NTHREAD = 128 * (NCONS + 1);
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int SMEM_LIMIT = 232448;         // a CTA's shared memory on the H100
constexpr int MAX_RING = 24;
static_assert(128 * PRODUCER_REGS + 128 * NCONS * CONSUMER_REGS <= 65536,
              "the register file");

// SEPV: V rows of their own (else the latent's V, K's first 512 columns);
// QUANT: int8 / e4m3 code rows; QF32: fp32 q (over codes only).
template <int DK, int DV, bool SEPV, bool QUANT = false, bool QF32 = false>
struct Cfg {
  static_assert(DK % BOX == 0 && DV % BOX == 0 && DV <= DK, "whole boxes");
  static_assert(SEPV || DK == LATENT_DK, "V in K's columns: the latent");
  static_assert(QUANT || !QF32, "fp32 q is taken over codes only");
  static constexpr int NBK = DK / BOX;     // K boxes a page
  // Dv's parts a unit computes one of: two halves of the latent's 512,
  // four quarters with fp32 q (see the header)
  static constexpr int NH = DV > 256 ? (QF32 ? 4 : 2) : 1;
  static constexpr int DVU = DV / NH;
  static constexpr int NBV = DVU / BOX;    // V boxes a unit reads a page
  // a page's boxes: K's, then a separate V's; the first KREL go back
  // after the score product, the rest (V box v at KREL + v) after P V
  static constexpr int BPP = NBK + (SEPV ? NBV : 0);
  static constexpr int KREL = SEPV ? NBK : NBK - NBV;
  static constexpr int NQ = QF32 ? 3 : 1;  // Q terms (hi[, mid, lo])
  // heads a unit: 64, or 32 with fp32 q at the latent (see the header)
  static constexpr int HQ = QF32 && DK > 256 ? 32 : HT;
  // the Q tile: box x of term xi at rows (x NQ + xi) HQ, 64 columns each
  static constexpr int QBYTES = NBK * NQ * HQ * BOX * 2;
  // the merge of the two consumers' O: MCH floats a thread a round
  static constexpr int MCH = DK > 256 ? 16 : 32;
  static constexpr int MBYTES = 128 * MCH * 4;
  // the last Q term's A operand reads HT - HQ rows past the tile, into
  // the merge buffer
  static_assert(MBYTES >= (HT - HQ) * BOX * 2, "the A operand's overhang");
  // over codes with bf16 q at the latent the merge buffer lies in the Q
  // tile, which the next unit's Q load then waits for, so that the ring
  // holds two pages' boxes (18, not 15: 7% less device time at the serve
  // phases' latent shapes on an H100, PERF.md)
  static constexpr bool MQ = QUANT && !QF32 && DK > 256;
  static constexpr int MOWN = MQ ? 0 : MBYTES;   // the merge buffer's own
  // the rescale mode a run-time flag (one consumer loop) where a loop for
  // each mode spilled (8 B a thread on an H100: the latent with V code rows
  // of its own and bf16 q); elsewhere each mode has its own loop (7-18%
  // less device time over codes on an H100, PERF.md)
  static constexpr bool MODE_FLAG = QUANT && SEPV && !QF32 && DK > 256;
  // the barriers (Q's two, a slot's free one and LOOK copies of its landed
  // one and, over codes, of its widened one: LOOK RING is less than 2 BPP
  // + RING) and, over codes, the pair buffers and sum(q)
  static constexpr int STATIC =
      (2 + MAX_RING + (QUANT ? 2 : 1) * (2 * BPP + MAX_RING)) * 8 +
      (QUANT ? (SEPV ? 2 : 1) * NCONS * 2 * PAGE * 8 + HT * 4 : 0);
  static constexpr int FIT =
      (SMEM_LIMIT - 1024 - STATIC - QBYTES - MOWN) / BOX_BYTES;
  // over codes a multiple of NCONV, so that each ring slot is always the
  // same converter's
  static constexpr int RING = (FIT < MAX_RING ? FIT : MAX_RING) /
                              (QUANT ? NCONV : 1) * (QUANT ? NCONV : 1);
  // a page's score product holds its K boxes at once, its P V its V boxes
  // (a separate V's come after K's, into slots the score product frees)
  static_assert(RING >= NBK && RING >= NBV, "a page's K boxes fit the ring");
  // A consumer waits on its page's boxes while the other consumer's page
  // before it may not have landed yet: up to 2 BPP boxes ahead of the
  // last box it knows landed.  A slot's barrier tells two fills apart by
  // its phase's parity only, so each slot has LOOK copies of its landed
  // (and widened) barrier, fill f on copy f % LOOK.
  static constexpr int LOOK = (2 * BPP + RING - 1) / RING;
  static constexpr int SMEM = 1024 + QBYTES + MOWN + RING * BOX_BYTES;
};

struct Params {
  const int* lengths;  // [B]: every head attends to rows < lengths[b]
  void* out;           // single pass: [B, H, DV] bf16 (over codes fp32)
  float* m_out;        // split partial: [B, n_splits, H]
  float* l_out;        // [B, n_splits, H]
  float* acc_out;      // [B, n_splits, H, DV]
  int H;               // heads a batch row
  int nbt;             // pages a batch row (n_splits npb)
  int npb;             // pages a split
  int n_splits;
  int kvh;             // kv heads a cache row (row b = bo kvh + kh)
  int ntile;           // head tiles a row: ceil(H / HQ)
  int units;           // B n_splits ntile NH
  float scale;
  int amla;
  // over codes
  int code;            // 0 int8, 1 e4m3
  int S;               // rows a cache row (pairs past S: (1, 0))
  int ldz, ldvz;
  const float* q32;    // fp32 q [B, H, DK] (split by the consumers)
  const float* ksz;    // K's (scale, zp) rows at bo zb + kh zh + s ldz
  const float* vsz;    // a separate V's, addressed alike (vzb, vzh, ldvz)
  long long zb, zh, vzb, vzh;
};

// Unit u: batch row b, split s, first head h0, Dv part vh, and the pages
// [j0, j0 + np) it walks: up to the page holding the row's last live
// position, or every page of the split when none of them holds one.
struct Unit {
  int b, s, h0, vh, j0, np;
};

template <int NH, int HQ>
__device__ __forceinline__ Unit unit_of(const Params& P, int u) {
  Unit U;
  U.vh = u % NH;
  int r = u / NH;
  const int t = r % P.ntile;
  r /= P.ntile;
  U.h0 = t * HQ;
  U.b = r / P.n_splits;
  U.s = r - U.b * P.n_splits;
  U.j0 = U.s * P.npb;
  const int j1 = min(U.j0 + P.npb, P.nbt);
  const int h = P.lengths[U.b] - 1;
  U.np = (h >= U.j0 * PAGE ? min(j1, h / PAGE + 1) : j1) - U.j0;
  return U;
}

// The rescale mode a consumer runs: a run-time flag, or a compile-time
// constant (std::bool_constant) that the compiler folds into the loop.
__device__ __forceinline__ bool amla_of(bool amla) { return amla; }
template <bool AMLA>
__device__ __forceinline__ constexpr bool amla_of(std::bool_constant<AMLA>) {
  return AMLA;
}

// The (scale, zp) pair at p, or (1, 0) where there is no row to read.
__device__ __forceinline__ float2 pair_at(const float* p, bool read) {
  return read ? __ldg(reinterpret_cast<const float2*>(p))
              : make_float2(1.f, 0.f);
}

template <bool STATS, int DK, int DV, bool SEPV, bool QUANT, bool QF32>
__global__ void __launch_bounds__(NTHREAD, 1) flash_decode_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const Params P) {
  using Cf = Cfg<DK, DV, SEPV, QUANT, QF32>;
  constexpr int NBK = Cf::NBK, NBV = Cf::NBV, NH = Cf::NH, DVU = Cf::DVU;
  constexpr int BPP = Cf::BPP, KREL = Cf::KREL, RING = Cf::RING;
  constexpr int LOOK = Cf::LOOK, MCH = Cf::MCH, NQ = Cf::NQ, HQ = Cf::HQ;
  extern __shared__ unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // the merge buffer [MCH][128] (in Q's with MQ), then the ring
  // [RING][64][64]
  float* sm = reinterpret_cast<float*>(Cf::MQ ? sq : sq + NBK * NQ * HQ * BOX);
  bf16* ring = sq + NBK * NQ * HQ * BOX + Cf::MOWN / 2;
  __shared__ uint64_t q_full, q_empty;
  // a slot's barriers: its box landed (full), over codes its box widened
  // (ready, after full's), each in LOOK copies (bar), and its consumer done
  // with it (empty)
  __shared__ uint64_t full[(QUANT ? 2 : 1) * LOOK * RING], empty[RING];
  constexpr int READY = QUANT ? LOOK * RING : 0;   // ready: full[READY + ..]
  // over codes: each consumer's two buffers of a page's K pairs (and a
  // separate V's), and sum(q) a head
  [[maybe_unused]] __shared__ float2 zk[QUANT ? NCONS * 2 * PAGE : 1];
  [[maybe_unused]] __shared__ float2 zv[QUANT && SEPV ? NCONS * 2 * PAGE : 1];
  [[maybe_unused]] __shared__ float qs[QUANT ? HT : 1];
  // box nb's copy of its slot's landed barrier (its ready one at READY +),
  // and the parity of the phase that box completes
  auto bar = [](uint32_t nb) { return nb / RING % LOOK * RING + nb % RING; };
  auto par = [](uint32_t nb) { return nb / RING / LOOK & 1; };
  // K box x's place among its page's boxes: fused, the boxes outside the
  // unit's V columns [vb0, vb0 + NBV) come first, in order, then V's
  auto kpos = [](int x, int vb0) {
    if constexpr (SEPV) return x;
    return x < vb0 ? x : x < vb0 + NBV ? KREL + x - vb0 : x - NBV;
  };

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&q_full, 1);
    mbar_init(&q_empty, NCONS * 4);        // each consumer warp arrives
    for (int s = 0; s < LOOK * RING; ++s) {
      mbar_init(&full[s], 1);              // the producer's TMA
      if constexpr (QUANT) mbar_init(&full[READY + s], 1);   // a converter
    }
    for (int s = 0; s < RING; ++s)
      mbar_init(&empty[s], 4);             // the page's consumer's warps
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {
    // -------------------------------------------------------- producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 0) {
      if constexpr (!QF32) tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      if constexpr (SEPV) tma_prefetch_map(&tv);
      uint32_t box = 0;                    // boxes issued, all units
      uint32_t n = 0;                      // units begun
      for (int u = blockIdx.x; u < P.units; u += gridDim.x, ++n) {
        const Unit U = unit_of<NH, HQ>(P, u);
        const int c3 = U.b / P.kvh, c1 = U.b - c3 * P.kvh;   // (bo, kh)
        const int vb0 = U.vh * NBV;        // the unit's first V box
#pragma unroll 1
        for (int j = 0; j < U.np; ++j) {
          const int c2 = (U.j0 + j) * PAGE;
#pragma unroll 1
          for (int p = 0; p < BPP; ++p, ++box) {
            const uint32_t slot = box % RING;
            mbar_wait(&empty[slot], ((box / RING) & 1) ^ 1);
            // fused: the K boxes outside V, then V's; else K box p, then V
            // box p - NBK of the unit's columns
            int x;
            if constexpr (SEPV)
              x = p < NBK ? p : vb0 + p - NBK;
            else
              x = p < KREL ? (p < vb0 ? p : p + NBV) : vb0 + p - KREL;
            // over codes the codes, into the slot's upper 4 KB
            mbar_expect_tx(&full[bar(box)],
                           QUANT ? CODE_BOX_BYTES : BOX_BYTES);
            tma_load_4d(reinterpret_cast<unsigned char*>(
                            ring + slot * BOX_ELEMS) +
                            (QUANT ? CODE_BOX_BYTES : 0),
                        p < NBK ? &tk : &tv, &full[bar(box)], x * BOX, c1,
                        c2, c3);
            // Q behind the first page's K boxes, before its V boxes (an
            // fp32 q is split by the consumers instead)
            if (!QF32 && j == 0 && p == NBK - 1) {
              mbar_wait(&q_empty, (n & 1) ^ 1);
              mbar_expect_tx(&q_full, Cf::QBYTES);
#pragma unroll 1
              for (int y = 0; y < NBK; ++y)
                tma_load_4d(sq + y * HT * BOX, &tq, &q_full, y * BOX, 0,
                            U.h0, U.b);
            }
          }
        }
      }
    } else if constexpr (QUANT) {
      // ------------------------------------------------ converters (codes)
      const int warp = tid >> 5, lane = tid & 31;
      if (warp > 0) {
        const int cv = warp - 1;
        uint32_t box = 0;
        for (int u = blockIdx.x; u < P.units; u += gridDim.x) {
          const Unit U = unit_of<NH, HQ>(P, u);
          const uint32_t end = box + U.np * BPP;
          // this warp's boxes of the unit: box % NCONV == cv
          for (box += (cv + NCONV - static_cast<int>(box % NCONV)) % NCONV;
               box < end; box += NCONV) {
            const uint32_t slot = box % RING;
            mbar_wait(&full[bar(box)], par(box));
            if (P.code)
              widen_box<true>(ring + slot * BOX_ELEMS, lane);
            else
              widen_box<false>(ring + slot * BOX_ELEMS, lane);
            fence_proxy_async();           // for the consumers' wgmma
            __syncwarp();
            if (lane == 0) mbar_arrive(&full[READY + bar(box)]);
          }
          box = end;
        }
      }
    }
    return;
  }

  // ----------------------------------------------------------- consumers
  setmaxnreg_inc<CONSUMER_REGS>();
  // The rescale mode: a compile-time constant, each mode its own loop with
  // no branch on it inside, or a run-time flag (Cfg::MODE_FLAG).
  auto consume = [&](auto mode) {
    const bool amla = amla_of(mode);
    const int cw = tid / 128 - 1;          // pages cw, cw + 2, ... of a unit
    const int t = tid % 128;
    const int w = t >> 5, lane = t & 31;
    const int g = lane >> 2, tq4 = lane & 3;   // fragment coordinates
    const int row = 16 * w + g;            // the tile's head rows row, row + 8
    // a masked logit: -1e30, times log2(e) in amla mode
    const float masked = amla ? NEG_INF * LOG2E : NEG_INF;
    // a head row of the unit: every one of the 64, or the first HQ
    auto live_row = [&](int r) { return HQ == HT || row + 8 * r < HQ; };

    uint32_t ubox = 0;                     // the unit's first box
    uint32_t n = 0;
    for (int u = blockIdx.x; u < P.units; u += gridDim.x, ++n) {
      const Unit U = unit_of<NH, HQ>(P, u);
      const uint32_t box0 = ubox;
      ubox += U.np * BPP;
      const int vb0 = U.vh * NBV;
      const int hb = P.lengths[U.b] - 1;   // every head's horizon
      float m[2] = {NEG_INF, NEG_INF};     // rows row, row + 8
      float l[2] = {0.f, 0.f};             // this thread's partial sums
      float o[NBV][32];                    // [V box][n8 tile nd: 4 nd + e]
#pragma unroll
      for (int mt = 0; mt < NBV; ++mt)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[mt][e] = 0.f;
      // the 8 consumer warps, heads w8, w8 + 8, ... (over codes)
      [[maybe_unused]] const int w8 = 4 * cw + w;
      if constexpr (QF32) {
        // ---- q's three bf16 terms into the Q tile, and sum(q) in fp32;
        //      every reader of the last unit's Q and sums is past the merge
        for (int i = w8; i < HQ; i += 8) {
          const int h = U.h0 + i;
          const float4* src = reinterpret_cast<const float4*>(
              P.q32 + ((size_t)U.b * P.H + (h < P.H ? h : 0)) * DK);
          float acc = 0.f;
          for (int f = lane; f < DK / 4; f += 32) {
            const float4 v = h < P.H ? __ldg(src + f)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
            const float x[4] = {v.x, v.y, v.z, v.w};
            bf16 hi[4], mid[4], lo[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc += x[e];
              hi[e] = __float2bfloat16_rn(x[e]);
              const float rem = x[e] - __bfloat162float(hi[e]);   // exact
              mid[e] = __float2bfloat16_rn(rem);
              lo[e] = __float2bfloat16_rn(rem - __bfloat162float(mid[e]));
            }
            // term xi of box d / 64 at rows ((d / 64) NQ + xi) HQ
            const int d = 4 * f;
            const int at = (d >> 6) * NQ * HQ * BOX + i * BOX +
                           ((((d & 63) >> 3) ^ (i & 7)) << 3) + (d & 7);
            constexpr int TB = HQ * BOX;
            *reinterpret_cast<uint2*>(sq + at) =
                make_uint2(pack(hi[0], hi[1]), pack(hi[2], hi[3]));
            *reinterpret_cast<uint2*>(sq + TB + at) =
                make_uint2(pack(mid[0], mid[1]), pack(mid[2], mid[3]));
            *reinterpret_cast<uint2*>(sq + 2 * TB + at) =
                make_uint2(pack(lo[0], lo[1]), pack(lo[2], lo[3]));
          }
#pragma unroll
          for (int off = 16; off; off >>= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, off);
          if (lane == 0) qs[i] = acc;
        }
        fence_proxy_async();               // for the score product
        named_bar_sync(1, 256);
      } else {
        mbar_wait(&q_full, n & 1);
        if constexpr (QUANT) {
          // ---- sum(q) in fp32 of the bf16 Q rows, 16-byte chunks of the
          //      swizzled tile
          for (int i = w8; i < HT; i += 8) {
            float acc = 0.f;
            for (int ch = lane; ch < NBK * 8; ch += 32) {
              const uint4 v =
                  *reinterpret_cast<const uint4*>(sq + q_at<HT>(i, 8 * ch));
              const uint32_t x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 f = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(&x[e]));
                acc += f.x;
                acc += f.y;
              }
            }
#pragma unroll
            for (int off = 16; off; off >>= 1)
              acc += __shfl_xor_sync(0xffffffffu, acc, off);
            if (lane == 0) qs[i] = acc;
          }
          named_bar_sync(1, 256);
        }
        // a unit of one page leaves the second consumer none: its Q read
        // ends here (with MQ, Q is released after the merge)
        if (!Cf::MQ && cw >= U.np) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&q_empty);
        }
      }
      // over codes: the pair rows of the unit's cache row (bo, kh)
      [[maybe_unused]] const float* kzr = P.ksz;
      [[maybe_unused]] const float* vzr = P.vsz;
      if constexpr (QUANT) {
        const int bo = U.b / P.kvh, kh = U.b - bo * P.kvh;
        kzr += (size_t)bo * P.zb + (size_t)kh * P.zh;
        vzr += (size_t)bo * P.vzb + (size_t)kh * P.vzh;
      }

      for (int jp = cw; jp < U.np; jp += 2) {
        const uint32_t box = box0 + jp * BPP;
        // over codes: the page's pairs, read by its first 64 threads now
        // and stored while the score product runs (buffer zo, one of two)
        [[maybe_unused]] const int zo = (cw * 2 + ((jp >> 1) & 1)) * PAGE;
        [[maybe_unused]] float2 kz2, vz2;
        if constexpr (QUANT) {
          if (t < PAGE) {
            const int r = (U.j0 + jp) * PAGE + t;
            const bool in = r < P.S;
            kz2 = pair_at(kzr + (size_t)(in ? r : 0) * P.ldz, in);
            if constexpr (SEPV)
              vz2 = pair_at(vzr + (size_t)(in ? r : 0) * P.ldvz, in);
          }
        }
        // ---- S = Q K^T: Dk / 16 k16 steps, 4 to a box, in k order, NQ Q
        //      terms each (fp32 q's terms lo, mid, then hi over the whole
        //      page)
        float s[32];
        wgmma_fence();
#pragma unroll
        for (int xi = 0; xi < NQ; ++xi)
#pragma unroll
          for (int x = 0; x < NBK; ++x) {
            const uint32_t nb = box + kpos(x, vb0);
            if (xi == 0) mbar_wait(&full[READY + bar(nb)], par(nb));
            const bf16* kt = ring + (nb % RING) * BOX_ELEMS;
            const bf16* qt = sq + (x * NQ + NQ - 1 - xi) * HQ * BOX;
            uint32_t ka = smem_u32(kt), qa = smem_u32(qt);
            // with three Q terms a K box's descriptors are made again for
            // each, not held in registers across the terms
            if constexpr (NQ > 1) asm volatile("" : "+r"(ka), "+r"(qa));
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              uint64_t da, db;
              if constexpr (NQ > 1) {
                da = desc_sw128(qa + 32 * kk, 16, 1024);
                db = desc_sw128(ka + 32 * kk, 16, 1024);
              } else {
                da = desc_sw128(qt + 16 * kk, 16, 1024);
                db = desc_sw128(kt + 16 * kk, 16, 1024);
              }
              if (xi == 0 && x == 0 && kk == 0)
                wgmma_ss_m64n64k16<true, false>(s, da, db);
              else
                wgmma_ss_m64n64k16<false, false>(s, da, db);
            }
          }
        wgmma_commit();
        if constexpr (QUANT) {
          if (t < PAGE) {
            zk[zo + t] = kz2;
            if constexpr (SEPV) zv[zo + t] = vz2;
          }
        }
        wgmma_wait<0>();
        fence_regs(s);
        __syncwarp();
        if (lane == 0) {                   // the K boxes outside V
#pragma unroll 1
          for (int p = 0; p < KREL; ++p)
            mbar_arrive(&empty[(box + p) % RING]);
          if (!QF32 && !Cf::MQ && jp + 2 >= U.np)   // its last S
            mbar_arrive(&q_empty);
        }
        if constexpr (QUANT) named_bar_sync(2 + cw, 128);   // the pairs

        // ---- (codes: each row's affine,) scale and mask (column 8 nt +
        //      2 tq4 + (e & 1) is row kp0 + that of the page), each head
        //      row's max over the page
        const int kp0 = (U.j0 + jp) * PAGE + 2 * tq4;
        float mx[2] = {masked, masked};
        // over codes sum(q) of the thread's two head rows (rows past HQ
        // hold another term's sums: masked below)
        [[maybe_unused]] float qsr[2];
        if constexpr (QUANT) {
          qsr[0] = qs[row];
          qsr[1] = qs[row + 8];
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[4 * nt + e];
            if constexpr (QUANT) {
              const float2 z2 = zk[zo + 8 * nt + 2 * tq4 + (e & 1)];
              x = z2.x * x + z2.y * qsr[e >> 1];
            }
            // softmax_state's logits: S * scale, times log2(e) in amla mode
            x *= P.scale;
            if (amla) x *= LOG2E;
            x = kp0 + 8 * nt + (e & 1) <= hb && live_row(e >> 1) ? x
                                                                 : masked;
            s[4 * nt + e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int off = 1; off < 4; off <<= 1)
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
          const float m_new = fmaxf(m[r], amla ? ceilf(mx[r]) : mx[r]);
          corr[r] = stat_weight(m[r] - m_new, amla);
          m[r] = m_new;
        }
        // ---- p = exp(x - m), l's partial sums, O's rescale; over codes s
        //      keeps scale_r p for P V, and the page's Z (over the quad)
        //      joins every column of the head's O row with the rescale
        float sum[2] = {0.f, 0.f};
        [[maybe_unused]] float zs[2] = {0.f, 0.f};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = prob_exp(s[4 * nt + e] - m[e >> 1], amla);
            sum[e >> 1] += p;
            if constexpr (QUANT) {
              const float2 z2 =
                  (SEPV ? zv : zk)[zo + 8 * nt + 2 * tq4 + (e & 1)];
              s[4 * nt + e] = p * z2.x;
              zs[e >> 1] += p * z2.y;
            } else {
              s[4 * nt + e] = p;
            }
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] = l[r] * corr[r] + sum[r];
          if constexpr (QUANT) {
            zs[r] += __shfl_xor_sync(0xffffffffu, zs[r], 1);
            zs[r] += __shfl_xor_sync(0xffffffffu, zs[r], 2);
          }
        }
#pragma unroll
        for (int mt = 0; mt < NBV; ++mt)
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            if constexpr (QUANT)
              o[mt][e] = o[mt][e] * corr[(e >> 1) & 1] + zs[(e >> 1) & 1];
            else
              o[mt][e] *= corr[(e >> 1) & 1];
          }

        // ---- P as the A fragments of P V's k16 steps: n8 tiles 2 kk and
        //      2 kk + 1 of S are step kk, split into bf16 hi + lo (over
        //      codes hi + mid + lo)
        uint32_t hi[4][4], lo[4][4];
        [[maybe_unused]] uint32_t mid[QUANT ? 4 : 1][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const float* f = &s[4 * (2 * kk + (x >> 1)) + 2 * (x & 1)];
            const __nv_bfloat162 h2 = __floats2bfloat162_rn(f[0], f[1]);
            const float2 back = __bfloat1622float2(h2);
            float r0 = f[0] - back.x, r1 = f[1] - back.y;   // exact
            if constexpr (QUANT) {
              const __nv_bfloat162 m2 = __floats2bfloat162_rn(r0, r1);
              const float2 mb = __bfloat1622float2(m2);
              mid[kk][x] = *reinterpret_cast<const uint32_t*>(&m2);
              r0 -= mb.x;
              r1 -= mb.y;
            }
            const __nv_bfloat162 l2 = __floats2bfloat162_rn(r0, r1);
            hi[kk][x] = *reinterpret_cast<const uint32_t*>(&h2);
            lo[kk][x] = *reinterpret_cast<const uint32_t*>(&l2);
          }

        // ---- O += P V: V box mt at position KREL + mt, MN-major
        if constexpr (SEPV) {
#pragma unroll
          for (int mt = 0; mt < NBV; ++mt) {
            const uint32_t nb = box + KREL + mt;
            mbar_wait(&full[READY + bar(nb)], par(nb));
          }
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int mt = 0; mt < NBV; ++mt) {
            const bf16* vt = ring + ((box + KREL + mt) % RING) * BOX_ELEMS;
            const uint64_t dv =
                desc_sw128(vt + 16 * kk * BOX, BOX_BYTES, 1024);
            wgmma_rs_m64n64k16(o[mt], hi[kk], dv);
            if constexpr (QUANT) wgmma_rs_m64n64k16(o[mt], mid[kk], dv);
            wgmma_rs_m64n64k16(o[mt], lo[kk], dv);
          }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int mt = 0; mt < NBV; ++mt) fence_regs(o[mt]);
        fence_regs(hi);
        if constexpr (QUANT) fence_regs(mid);
        fence_regs(lo);
        __syncwarp();
        if (lane == 0) {                   // the V boxes
#pragma unroll 1
          for (int p = KREL; p < BPP; ++p)
            mbar_arrive(&empty[(box + p) % RING]);
        }
      }

      // ---- merge the second consumer's state into the first's, thread by
      //      thread (both hold the same fragments): m and l's partial
      //      sums, then O, MCH floats a thread a round (with MQ through Q's
      //      tile, once both consumers' last S is done)
      if constexpr (Cf::MQ) named_bar_sync(1, 256);
      if (cw == 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          sm[r * 128 + t] = m[r];
          sm[(2 + r) * 128 + t] = l[r];
        }
      }
      named_bar_sync(1, 256);
      float w0[2], w1[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m1 = sm[r * 128 + t], l1 = sm[(2 + r) * 128 + t];
        const float mm = fmaxf(m[r], m1);
        w0[r] = stat_weight(m[r] - mm, amla);
        w1[r] = stat_weight(m1 - mm, amla);
        l[r] = l[r] * w0[r] + l1 * w1[r];
        m[r] = mm;
      }
      named_bar_sync(1, 256);
#pragma unroll
      for (int mt = 0; mt < NBV; ++mt)
#pragma unroll
        for (int c0 = 0; c0 < 32; c0 += MCH) {
          if (cw == 1) {
#pragma unroll
            for (int e = 0; e < MCH; ++e) sm[e * 128 + t] = o[mt][c0 + e];
          }
          named_bar_sync(1, 256);
          if (cw == 0) {
#pragma unroll
            for (int e = 0; e < MCH; ++e) {
              const int r = ((c0 + e) >> 1) & 1;
              o[mt][c0 + e] = o[mt][c0 + e] * w0[r] + sm[e * 128 + t] * w1[r];
            }
          }
          named_bar_sync(1, 256);
        }
      if constexpr (Cf::MQ) {              // Q's tile is free for the next Q
        __syncwarp();
        if (lane == 0) mbar_arrive(&q_empty);
      }
      if (cw == 1) continue;               // the first consumer writes

      // ---- epilogue: l over the quad, then O / l or the split's raw (m,
      //      l, O), heads below H, this unit's Dv columns
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      const int dv0 = U.vh * DVU;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int h = U.h0 + row + 8 * r;
        if (!live_row(r) || h >= P.H) continue;
        if constexpr (STATS) {
          const size_t sr = (size_t)U.b * P.n_splits + U.s;
          if (tq4 == 0 && U.vh == 0) {     // one writer a head
            P.m_out[sr * P.H + h] = m[r];
            P.l_out[sr * P.H + h] = l[r];
          }
          float* a = P.acc_out + (sr * P.H + h) * DV + dv0;
#pragma unroll
          for (int mt = 0; mt < NBV; ++mt)
#pragma unroll
            for (int nd = 0; nd < 8; ++nd)
              *reinterpret_cast<float2*>(&a[64 * mt + 8 * nd + 2 * tq4]) =
                  make_float2(o[mt][4 * nd + 2 * r],
                              o[mt][4 * nd + 2 * r + 1]);
        } else if constexpr (QUANT) {
          float* op = static_cast<float*>(P.out) +
                      ((size_t)U.b * P.H + h) * DV + dv0;
#pragma unroll
          for (int mt = 0; mt < NBV; ++mt)
#pragma unroll
            for (int nd = 0; nd < 8; ++nd)
              *reinterpret_cast<float2*>(&op[64 * mt + 8 * nd + 2 * tq4]) =
                  make_float2(o[mt][4 * nd + 2 * r] / l[r],
                              o[mt][4 * nd + 2 * r + 1] / l[r]);
        } else {
          bf16* op = static_cast<bf16*>(P.out) +
                     ((size_t)U.b * P.H + h) * DV + dv0;
#pragma unroll
          for (int mt = 0; mt < NBV; ++mt)
#pragma unroll
            for (int nd = 0; nd < 8; ++nd)
              *reinterpret_cast<__nv_bfloat162*>(
                  &op[64 * mt + 8 * nd + 2 * tq4]) =
                  __halves2bfloat162(
                      __float2bfloat16_rn(o[mt][4 * nd + 2 * r] / l[r]),
                      __float2bfloat16_rn(o[mt][4 * nd + 2 * r + 1] / l[r]));
        }
      }
    }
  };
  if constexpr (Cf::MODE_FLAG)
    consume(P.amla != 0);
  else if (P.amla)
    consume(std::true_type{});
  else
    consume(std::false_type{});
}

// The operands of one launch: q [B, H, DK] (bf16, or fp32 with QF32) and
// the dense K and V rows of a cache read through its strides (elements:
// bf16 values or 1-byte codes), kvh kv heads a cache row; v null when V is
// K's first DV columns (fused at the latent) or K itself.
struct Operands {
  const void* q;
  const void* k;
  const void* v;
  long long kb, kh, vb, vh;
  int ldk, ldv, S, kvh;
};

template <bool STATS, int DK, int DV, bool SEPV, bool QUANT, bool QF32>
int launch_inst(const Operands& a, Params p, int B, void* stream) {
  using Cf = Cfg<DK, DV, SEPV, QUANT, QF32>;
  if (B <= 0 || p.H <= 0 || a.S <= 0 || p.nbt <= 0 || p.n_splits <= 0 ||
      p.npb <= 0 || a.kvh <= 0 || B % a.kvh != 0 ||
      (QUANT && p.code != 0 && p.code != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int dev = current_device();
  const int sms = dev < 0 ? 0 : sm_count(dev);
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  p.ntile = (p.H + Cf::HQ - 1) / Cf::HQ;
  const long long units =
      static_cast<long long>(B) * p.n_splits * p.ntile * Cf::NH;
  if (units > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  p.units = static_cast<int>(units);
  p.kvh = a.kvh;
  p.S = a.S;
  const int Bo = B / a.kvh;
  const auto rows = QUANT ? code_rows_map : bf16_rows_map;
  CUtensorMap tq, tk, tv;
  int err = rows(&tk, a.k, DK, a.kvh, a.S, Bo, a.kh, a.ldk, a.kb, PAGE);
  // a V of its own, or K's rows read again at DV (V is K at this width)
  if (err == 0 && SEPV)
    err = a.v ? rows(&tv, a.v, DV, a.kvh, a.S, Bo, a.vh, a.ldv, a.vb, PAGE)
              : rows(&tv, a.k, DV, a.kvh, a.S, Bo, a.kh, a.ldk, a.kb, PAGE);
  if (err == 0 && !QF32)
    err = bf16_rows_map(&tq, a.q, DK, 1, p.H, B, DK, DK,
                        static_cast<long long>(p.H) * DK, HT);
  if (err != 0) return err;
  if (QF32) {                              // no Q map: the consumers split q
    tq = tk;
    p.q32 = static_cast<const float*>(a.q);
  }
  if (!SEPV) tv = tk;                      // the fused kernel reads no tv
  auto kernel = flash_decode_kernel<STATS, DK, DV, SEPV, QUANT, QF32>;
  // the shared-memory opt-in, once a device for each instance
  static std::atomic<uint64_t> opted{0};
  const uint64_t bit = uint64_t(1) << dev;
  if (!(opted.load(std::memory_order_relaxed) & bit)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cf::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted.fetch_or(bit, std::memory_order_relaxed);
  }
  const int grid = p.units < sms ? p.units : sms;
  kernel<<<grid, NTHREAD, Cf::SMEM, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

// The instance at (dk, dv) of width list L: fused at the latent when V is
// null.
template <bool STATS, class L, bool QUANT, bool QF32>
int launch(const Operands& a, const Params& p, int dk, int dv, int B,
           void* stream) {
  return with_widths<L>(dk, dv, [&](auto DK, auto DV) {
    constexpr int K = decltype(DK)::value, V = decltype(DV)::value;
    if constexpr (K == LATENT_DK) {
      if (a.v == nullptr)
        return launch_inst<STATS, K, V, false, QUANT, QF32>(a, p, B, stream);
    }
    return launch_inst<STATS, K, V, true, QUANT, QF32>(a, p, B, stream);
  });
}

template <bool STATS, int DK, int DV, bool SEPV, bool QUANT, bool QF32>
int attrs_inst(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, flash_decode_kernel<STATS, DK, DV, SEPV, QUANT, QF32>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = Cfg<DK, DV, SEPV, QUANT, QF32>::SMEM;
  out[2] = static_cast<int>(a.localSizeBytes);
  return 0;
}

template <bool STATS, class L, bool QUANT, bool QF32>
int attrs(int dk, int dv, int sepv, int* out) {
  return with_widths<L>(dk, dv, [&](auto DK, auto DV) {
    constexpr int K = decltype(DK)::value, V = decltype(DV)::value;
    if constexpr (K == LATENT_DK) {
      if (!sepv) return attrs_inst<STATS, K, V, false, QUANT, QF32>(out);
    }
    if (!sepv) return static_cast<int>(cudaErrorInvalidValue);
    return attrs_inst<STATS, K, V, true, QUANT, QF32>(out);
  });
}

// The instance over codes at (dk, dv) with bf16 or fp32 q.
template <bool STATS>
int launch_quant(const Operands& a, const Params& p, int qf32, int dk,
                 int dv, int B, void* stream) {
  return qf32 ? launch<STATS, QuantDenseWidths, true, true>(a, p, dk, dv, B,
                                                            stream)
              : launch<STATS, QuantDenseWidths, true, false>(a, p, dk, dv, B,
                                                             stream);
}

Operands operands(const void* q, const void* k, long long kb, int ldk,
                  const void* v, long long vb, int ldv, int S, int kvh,
                  long long kh, long long vh) {
  Operands a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.kb = kb;
  a.kh = kh;
  a.ldk = ldk;
  a.vb = vb;
  a.vh = vh;
  a.ldv = ldv;
  a.S = S;
  a.kvh = kvh;
  return a;
}

Params params(const int* lengths, int H, int nbt, int n_splits, int npb,
              float scale, int amla) {
  Params p{};
  p.lengths = lengths;
  p.H = H;
  p.nbt = nbt;
  p.n_splits = n_splits;
  p.npb = npb;
  p.scale = scale;
  p.amla = amla;
  return p;
}

// The code rows' parameters beyond the bf16 ones: the code type and K's
// and V's (scale, zp) rows (strides in floats; vz null when V is K's
// columns or K itself, which then take K's pairs).
void quant_params(Params& p, int code, const float* kz, long long zb,
                  long long zh, int ldz, const float* vz, long long vzb,
                  long long vzh, int ldvz) {
  p.code = code;
  p.ksz = kz;
  p.zb = zb;
  p.zh = zh;
  p.ldz = ldz;
  if (vz == nullptr) {
    vz = kz;
    vzb = zb;
    vzh = zh;
    ldvz = ldz;
  }
  p.vsz = vz;
  p.vzb = vzb;
  p.vzh = vzh;
  p.ldvz = ldvz;
}

}  // namespace

extern "C" {

// The (Dk, Dv) pairs K7 / K8 take (written to out as dk, dv, ...; returns
// their number).
int flash_decode_widths(int* out, int cap) {
  return write_widths<DenseWidths>(out, cap);
}

// The registers, dynamic shared memory and local memory (spills) of K7
// (stats 0) or K8 (stats 1) at (dk, dv) into out[0..2]: the instance with
// V rows of its own (sepv 1), or fused (sepv 0: the latent only).  The
// registers are the launch's (168 a thread for 384 threads); setmaxnreg
// moves them to 40 in the producer and 232 in the consumers.
int flash_decode_sepv_attrs(int dk, int dv, int sepv, int stats, int* out) {
  return stats ? attrs<true, DenseWidths, false, false>(dk, dv, sepv, out)
               : attrs<false, DenseWidths, false, false>(dk, dv, sepv, out);
}

// The same for the instance the serve paths launch: fused at the latent,
// V of its own elsewhere.
int flash_decode_attrs(int dk, int dv, int stats, int* out) {
  return flash_decode_sepv_attrs(dk, dv, dk == LATENT_DK ? 0 : 1, stats, out);
}

// K7: q [B,H,dk]; K rows k + (b / kvh)*kb + (b % kvh)*kh + s*ldk for s < S
// (dk wide); V null (the first dv columns of K) or rows at v with strides
// vb, vh, ldv (dv wide); lengths [B]; out [B,H,dv] bf16.  Strides in
// elements, multiples of 8 (16 bytes); (dk, dv) one of
// flash_decode_widths.  kvh = K reads a GQA cache [B/K, S, K, hd] in place
// as its grouped [B, S, hd] form.
int flash_decode(const void* q, const void* k, long long kb, int ldk,
                 const void* v, long long vb, int ldv, int S,
                 const int* lengths, int kvh, long long kh, long long vh,
                 int dk, int dv, void* out, int B, int H, float scale,
                 int amla, void* stream) {
  const int nbt = (S + PAGE - 1) / PAGE;
  Params p = params(lengths, H, nbt, 1, nbt, scale, amla);
  p.out = out;
  return launch<false, DenseWidths, false, false>(
      operands(q, k, kb, ldk, v, vb, ldv, S, kvh, kh, vh), p, dk, dv, B,
      stream);
}

// K8: as K7, cut into n_splits splits of tps 64-row tiles (rows past S read
// as zero); writes fp32 m, l [B,n,H] and acc [B,n,H,dv].
int flash_decode_partial(const void* q, const void* k, long long kb, int ldk,
                         const void* v, long long vb, int ldv, int S,
                         const int* lengths, int kvh, long long kh,
                         long long vh, int dk, int dv, float* m_out,
                         float* l_out, float* acc_out, int B, int H,
                         int n_splits, int tps, float scale, int amla,
                         void* stream) {
  if (n_splits <= 0 || tps <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = params(lengths, H, n_splits * tps, n_splits, tps, scale, amla);
  p.m_out = m_out;
  p.l_out = l_out;
  p.acc_out = acc_out;
  return launch<true, DenseWidths, false, false>(
      operands(q, k, kb, ldk, v, vb, ldv, S, kvh, kh, vh), p, dk, dv, B,
      stream);
}

// The (Dk, Dv) pairs K7q / K8q take (written to out as dk, dv, ...;
// returns their number).
int flash_decode_quant_widths(int* out, int cap) {
  return write_widths<QuantDenseWidths>(out, cap);
}

// The registers, dynamic shared memory and local memory of K7q (stats 0)
// or K8q (stats 1) at (dk, dv) with bf16 q, or fp32 q when qf32 is set,
// into out[0..2]: the instance with V code rows of their own (sepv 1), or
// fused (sepv 0: the latent only).  One instance serves int8 (code 0) and
// e4m3 (code 1) codes: the converters read the code type.
int flash_decode_quant_sepv_attrs(int dk, int dv, int sepv, int stats,
                                  int code, int qf32, int* out) {
  if (code != 0 && code != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (stats)
    return qf32 ? attrs<true, QuantDenseWidths, true, true>(dk, dv, sepv, out)
                : attrs<true, QuantDenseWidths, true, false>(dk, dv, sepv,
                                                             out);
  return qf32 ? attrs<false, QuantDenseWidths, true, true>(dk, dv, sepv, out)
              : attrs<false, QuantDenseWidths, true, false>(dk, dv, sepv,
                                                            out);
}

// The same for the instance the serve paths launch: fused at the latent,
// V of its own elsewhere.
int flash_decode_quant_attrs(int dk, int dv, int stats, int code, int qf32,
                             int* out) {
  return flash_decode_quant_sepv_attrs(dk, dv, dk == LATENT_DK ? 0 : 1, stats,
                                       code, qf32, out);
}

// K7q: K7 over int8 (code 0) or e4m3 (code 1) rows addressed as K7's
// (strides in bytes), K's (scale, zp) pairs at kz + (b / kvh)*zb + (b %
// kvh)*zh + s*ldz (floats); V null (its codes and pairs are K's) or codes
// at v with pairs at vz.  q bf16, or fp32 with qf32 set; out [B,H,dv]
// fp32; (dk, dv) one of flash_decode_quant_widths.
int flash_decode_quant(const void* q, const void* k, long long kb, int ldk,
                       const void* v, long long vb, int ldv, int S,
                       const int* lengths, int kvh, long long kh,
                       long long vh, int dk, int dv, const float* kz,
                       long long zb, long long zh, int ldz, const float* vz,
                       long long vzb, long long vzh, int ldvz, int code,
                       int qf32, void* out, int B, int H, float scale,
                       int amla, void* stream) {
  const int nbt = (S + PAGE - 1) / PAGE;
  Params p = params(lengths, H, nbt, 1, nbt, scale, amla);
  quant_params(p, code, kz, zb, zh, ldz, vz, vzb, vzh, ldvz);
  p.out = out;
  return launch_quant<false>(
      operands(q, k, kb, ldk, v, vb, ldv, S, kvh, kh, vh), p, qf32, dk, dv,
      B, stream);
}

// K8q: as K7q, cut into n_splits splits of tps tiles; writes fp32 m, l
// [B,n,H] and acc [B,n,H,dv].
int flash_decode_partial_quant(const void* q, const void* k, long long kb,
                               int ldk, const void* v, long long vb, int ldv,
                               int S, const int* lengths, int kvh,
                               long long kh, long long vh, int dk, int dv,
                               const float* kz, long long zb, long long zh,
                               int ldz, const float* vz, long long vzb,
                               long long vzh, int ldvz, int code, int qf32,
                               float* m_out, float* l_out, float* acc_out,
                               int B, int H, int n_splits, int tps,
                               float scale, int amla, void* stream) {
  if (n_splits <= 0 || tps <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = params(lengths, H, n_splits * tps, n_splits, tps, scale, amla);
  quant_params(p, code, kz, zb, zh, ldz, vz, vzb, vzh, ldvz);
  p.m_out = m_out;
  p.l_out = l_out;
  p.acc_out = acc_out;
  return launch_quant<true>(
      operands(q, k, kb, ldk, v, vb, ldv, S, kvh, kh, vh), p, qf32, dk, dv,
      B, stream);
}

}  // extern "C"
