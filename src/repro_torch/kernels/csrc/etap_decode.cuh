// The ETAP decode kernels for Hopper (sm_90a), over bf16 rows and over
// int8 / e4m3 code rows: wgmma on the page's 64 rows, a TMA ring of 64 x 64
// boxes, one producer warp and two consumer warpgroups, a persistent grid.
// One template serves the single pass (STATS false: K3 / K3q paged, K5 /
// K5q dense) and the split-KV partial (STATS true: K1 / K1q paged, K6 /
// K6q dense) at every width, address mode and element type they are built
// at; etap_decode.cu instantiates the paged bf16 kernels, etap.cu the
// dense bf16 ones, etap_quant.cu the fused paged and the dense ones over
// codes and etap_sepv.cu the paged ones over separate code pools
// (separate sources, so that they compile in parallel).  Each source's
// header says which pallas_call bodies it replaces.  K4 / K4q, the chunked
// prefill and verify, are etap_prefill.cu's kernel on the same design.
//
// What it computes.  Batch row b has C query columns (a decode step's
// heads: H for the MLA latent, a GQA group's G), all with the horizon
// lengths[b] - 1, and a split s of n_splits walks the row's pages [s npb,
// (s + 1) npb):
//     S^T = K Q^T * scale        [64, NC]   the page's rows on wgmma's M
//     mask kpos > horizon to -1e30
//     online-softmax update per column (m, l), softmax_state.update in
//     both rescale modes (softmax_state.cuh: amla's 2^d is exact)
//     O^T = O^T * corr + V^T P^T [Dv, NC]   Dv on M, P as bf16 hi + lo
// K3 / K5 end with out [B, C, Dv] = (O^T / l)^T in bf16; K1 / K6 write the
// raw fp32 (m, l, O^T) of their split [B, n, C], [B, n, Dv, C] for the
// combine kernel (combine.cu).  Scores, m, l and O^T are fp32; P enters
// the second product as p_hi = bf16(p) and p_lo = bf16(p - p_hi), as in
// every ETAP body.  The walk ends after the page holding the last live
// position (past it a page is masked whole, an exact no-op of the
// recurrence); it is cut by positions only, never by block ids: a padded
// table entry (the null block 0) inside the walk is read and masked like
// any other page.  A split with no live position walks all of its pages,
// as the reference does, so its stats are the reference's.
//
// Over codes (QUANT: K3q, K1q, K5q, K6q).  A row holds int8 or e4m3 codes
// and one fp32 (scale, zp) pair; the reference dequantizes each row to
// fp32 (codes scale + zp) and forms both products in fp32.  Every int8 and
// every e4m3 code is exact in bf16, so the codes feed the bf16 wgmma as
// they are and the affine goes around the products:
//     S_r  = scale_r (codes_r . q) + zp_r sum(q)
//     O^T += V^T (scale P)^T + (sum_r zp_r p_r) on every Dv row
// Each thread applies its two rows' affine to its S^T fragment, their K pairs
// read from L2 into registers at the top of the step, so that they land while
// the score product runs, a separate V's before the max exchange (a row past S,
// or a pad page, takes (1, 0) and is not read). sum(q) is one fp32 sum per
// column of q as given.  scale_r p_r enters P V as three bf16 terms (hi, mid,
// lo: its 24 bits; two left a Qwen3-8B layer 1.2e-5 off the fp32 route on an
// H100), and l sums the plain p.  The zp term Z = sum_r zp_r p_r is a
// per-column scalar that evolves as l does (rescaled by corr, a per-thread
// partial sum until the unit's end, merged between the consumers with l) and is
// added to every Dv row in the epilogue: out = ((O^T + Z) / l)^T, and a split
// writes O^T + Z as its Acc^T.  An fp32 q (the GQA paths, which cast q to fp32
// as the reference does, and the accuracy gates) enters as three bf16 Q tiles
// (hi, mid, lo: its 24 bits), three score wgmmas a k-step, the lo terms over
// the whole page first, then mid, then hi (so that the tensor cores round the
// hi products' sum, not the small terms, against the running sum: with the
// terms interleaved a split's output was 1.7e-5 off its plain version on an
// H100); the consumers split q themselves (no Q map).  K3q / K1q write in q's
// type, K5q fp32 (V's type in the reference).  Codes past a row's length hold
// finite values, so V never carries a NaN into a masked p = 0.  The code type
// is a run-time argument: only the converters read it.
//
// Address modes (template parameters DENSE and SEPV).  Paged: page j of
// row b is pool block table[b, j] (a 4-D map (width, 1, 64, blocks)); V is
// the block's first Dv columns (the MLA latent, fused: its V boxes are K
// boxes 0-7, its pairs K's) or the same block of a V pool of its own
// (SEPV; over codes with a pair pool of its own).  Dense: page j of row b
// is rows [64 j, 64 j + 64) of a [B, S, K, hd] cache read in place through
// its strides, row b = bo K + kh (the reference's gqa_to_grouped order) at
// coordinates (x, kh, 64 j, bo) of a map (width, K, S, B / K); rows at or
// past S read as TMA's zeros, so the caller never pads; over codes the
// pairs of row s are at bo zb + kh zh + s ldz floats.  A dense V is the
// latent's first 512 columns (fused) or rows of its own (SEPV; a V that is
// K itself at another width is read through a second map over K's rows,
// with K's pairs).  The paged and dense kernels at the same widths,
// columns and split count run the same units in the same order, so over
// the same rows they give the same bits (K3 == K5, K1 == K6).
//
// The design (hopper.cuh holds the building blocks).  A work unit is NC
// columns of one split of one batch row; units run on a persistent grid
// of min(units, SMs) CTAs, CTA i taking units i, i + grid, ...  A CTA is
// three warpgroups.  One warp of the first (the producer; setmaxnreg 40)
// issues every load with TMA: the pages' boxes, each page's K boxes in the
// score product's k order (the latent's rope box 8 first, then 0-7) and,
// with a separate V, its V boxes right after them (loaded beside K's, not
// after the score product), into a ring of RING boxes of 64 rows x 128
// bytes (128-byte swizzle, 1024-byte aligned), each with a full barrier
// (the bytes landed) and an empty one (its consumer done with it); the
// unit's Q tile (NC rows, rows past C read as zero) behind the first
// page's K boxes, never behind its V boxes (a ring smaller than a page
// holds those only once the score product has released K's).  Over codes
// the producer loads each box's 4 KB of codes into the upper half of its
// ring slot, and the first warpgroup's other three warps (the converters)
// widen them in place, box m by warp m % 3 (the ring a multiple of 3
// slots, so that a slot is always the same warp's), into the slot's
// swizzled bf16 box on the integer and fp32 / bf16 pipes (hopper.cuh:
// widen_box), and arrive on the slot's ready barrier, which the consumers
// wait on instead of full.  The two consumer warpgroups (setmaxnreg 232)
// split the unit's pages, not its columns: each holds all NC columns and
// takes every other step of PP pages (2 where Dk <= 128, 1 at the latent
// and 256), with an online softmax state of its own:
//   S^T [64, NC] a page: Dk / 16 SS wgmmas m64nNCk16 (three a k-step with
//     fp32 q), A = the K box, B = the Q tile, both K-major; the first
//     k-step writes S^T only;
//   the per-column max over the step's 64 PP rows: a thread's rows, a
//     shuffle over the warp's row groups, the 4 warps' maxima exchanged
//     through shared memory under a named barrier; l (and Z) stay
//     per-thread partial sums until the unit's end; a column's corr is in
//     the registers of the threads holding its O^T columns;
//   P^T: p_hi and p_lo (over codes scale p in three terms) stored
//     transposed (stmatrix) into 128-byte-swizzled K-major [NC][64] tiles,
//     a proxy fence and a named barrier;
//   O^T += V^T P^T: per page, k16 step and 64-row m-tile of Dv, an SS
//     wgmma with A = V's box read MN-major (the transpose-A bit) and B =
//     P^T, term by term.
// At the unit's end the second consumer's (m, l[, Z], O^T) is merged into
// the first's thread by thread (both hold the same fragments), as the
// combine kernel merges two splits (softmax_state.cuh: stat_weight), and
// the first writes the unit.  A step whose last page lies past the walk
// (an odd page count at PP 2) takes a pad page there (the null block, or
// the dense rows that follow), masked whole with -inf, so it adds exactly
// nothing.
//
// Why pages and not columns.  A page costs Dk / 16 + 8 Dv / 64 wgmmas (hi
// and lo), each reading its 2 KB A box from shared memory, and a wgmma's
// time hardly falls with N below 64 (PERF.md: units of 16 columns, two
// consumers of 8, took 5.0 µs a latent page; split by pages, 3.0).  Two
// consumers on one page's columns issue its wgmmas twice; split by pages,
// each page is issued once, and two pages' chains run side by side.  Over
// codes a page costs NQ Dk / 16 + 12 Dv / 64 wgmmas (NQ Q terms, three P
// terms).
//
// The unit width.  Chosen on the host from (B, C, n_splits), the widths
// and the SM count only (decode_unit_cols), so K3 and K5, and K1 at n = 1
// and K3, run the same units over the same rows and give the same bits
// (and so do their quantized twins): the narrowest of 16, 32 and 64
// columns whose units fit one wave of the grid, else the narrowest that
// holds C (at most 32 where Dk >= 256 and over codes, 16 over codes with
// fp32 q at the latent: unit_cap).  A unit's pages take longer at a wider
// N, so while SMs are idle, narrower units that each re-read the row's
// pages from L2 finish sooner (K3 at B 8, H 128: 64 units of 16); once
// units fill the card, the widest unit reads each page for the most
// columns.  A cluster multicasting each page to a row's units would cut
// the L2 reads, not a unit's own page time, and is not taken.
//
// Numerics against the mma.sync bodies this kernel replaced: the same
// arithmetic in another order (S^T k-steps, l and Z summed per thread and
// then across warps), so outputs agree within the bf16 (or, over codes
// with fp32 q, the fp32) tolerance, not bitwise.
//
// What bounds it on the H100.  The K and V bytes over 3.35 TB/s: 1152 B a
// fused latent row, 2176 B with a separate V, 512 B a row at 128; over
// codes 584 B a fused latent row with its pair, 1104 B with a separate V,
// 272 B at 128 with both pairs.  A single pass brings a row's whole page
// stream into every unit of the row (one SM's intake, not the device's
// bandwidth, then sets its time); the split plans are the route to the
// byte bound.
#pragma once

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
constexpr int BOX_ELEMS = PAGE * BOX;      // a page box: 64 rows x 64
constexpr int BOX_BYTES = BOX_ELEMS * 2;   // 8,192
constexpr int CODE_BOX_BYTES = BOX_ELEMS;  // its codes: 4,096
constexpr int NCONS = 2;                   // consumer warpgroups
constexpr int NCONV = 3;                   // converter warps (codes)
constexpr int NTHREAD = 128 * (NCONS + 1);
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int SMEM_LIMIT = 232448;         // a CTA's shared memory on the H100
constexpr int MAX_POOL_BLOCKS = INT_MAX;   // a pool map's block extent
static_assert(128 * PRODUCER_REGS + 128 * NCONS * CONSUMER_REGS <= 65536,
              "the register file");

// NC: the unit's columns, every one of them held by each consumer; QUANT:
// int8 / e4m3 code rows; QF32: fp32 q (over codes only).
template <int DK, int DV, bool SEPV, int NC, bool QUANT, bool QF32>
struct Cfg {
  static_assert(DK % BOX == 0 && DV % BOX == 0 && DV <= DK, "whole boxes");
  static_assert(NC == 64 || NC == 32 || NC == 16, "16, 32 or 64 columns");
  static_assert(QUANT || !QF32, "fp32 q is taken over codes only");
  static constexpr int NBK = DK / BOX;     // K boxes a page
  static constexpr int NBV = DV / BOX;     // V boxes a page
  static constexpr int NM = DV / 64;       // m-tiles of O^T
  static_assert(NM * NC <= 256, "O^T [DV, NC] fits a consumer's registers");
  // the page's boxes: K in k order (the boxes outside V first), then,
  // with a separate V, V's; the first KREL go back after the score
  // product, the rest (V box v at position KREL + v) after P V
  static constexpr int BPP = NBK + (SEPV ? NBV : 0);
  static constexpr int KREL = SEPV ? NBK : NBK - NBV;
  // pages a step: two where Dk <= 128, so that one max exchange and one
  // pair of barriers serve two pages; one at the latent and at 256
  static constexpr int PP = DK <= 128 ? 2 : 1;
  static constexpr int NQ = QF32 ? 3 : 1;  // Q terms (hi[, mid, lo])
  static constexpr int NPT = QUANT ? 3 : 2;  // P terms (hi, [mid,] lo)
  static constexpr int QBYTES = NQ * NBK * NC * BOX * 2;
  static constexpr int PBYTES = NCONS * PP * NPT * NC * BOX * 2;
  // the merge of the two consumers' states: NC / 2 floats a thread
  static constexpr int MBYTES = 128 * (NC / 2) * 4;
  // the exchange rows: the 4 warps' column values, over codes also their
  // Z at the end
  static constexpr int RROWS = QUANT ? 8 : 4;
  // the barriers (Q's two, a slot's free one and LOOK copies of its
  // landed one and, over codes, of its widened one: LOOK RING is less than
  // 2 PP BPP + RING), the exchange rows and, over codes, sum(q) a column
  static constexpr int MAX_RING = 24;
  static constexpr int STATIC =
      (2 + MAX_RING + (QUANT ? 2 : 1) * (2 * PP * BPP + MAX_RING)) * 8 +
      NCONS * RROWS * NC * 4 + (QUANT ? NC * 4 : 0);
  static constexpr int FIT =
      (SMEM_LIMIT - 1024 - STATIC - QBYTES - PBYTES - MBYTES) / BOX_BYTES;
  // over codes a multiple of NCONV, so that each ring slot is always the
  // same converter's
  static constexpr int RING = (FIT < MAX_RING ? FIT : MAX_RING) /
                              (QUANT ? NCONV : 1) * (QUANT ? NCONV : 1);
  // a step's score product holds its pages' K boxes (and the V boxes
  // issued between them), its P V their V boxes
  static_assert(RING >= (PP - 1) * BPP + NBK && RING >= PP * NBV &&
                    RING >= (PP - 1) * BPP + NBV,
                "a step's boxes fit the ring");
  // A consumer waits on its step's boxes while the other consumer's step
  // before it may not have landed yet: up to 2 PP BPP boxes ahead of the
  // last box it knows landed (its own step before).  A slot's barrier
  // tells two fills apart by its phase's parity only, so each slot has
  // LOOK copies of its landed (and widened) barrier, fill f on copy f %
  // LOOK, and a wait tells apart fills LOOK RING boxes apart.
  static constexpr int LOOK = (2 * PP * BPP + RING - 1) / RING;
  static constexpr int SMEM =
      1024 + QBYTES + PBYTES + MBYTES + RING * BOX_BYTES;
};

struct Params {
  const int* table;    // paged: [B, nbt] pool block ids; dense: null
  const int* lengths;  // [B]: every column attends to rows < lengths[b]
  void* out;           // single pass: [B, C, DV] bf16 (over codes q's
                       // type paged, fp32 dense)
  float* m_out;        // split partial: [B, n_splits, C]
  float* l_out;        // [B, n_splits, C]
  float* acc_out;      // [B, n_splits, DV, C]
  int C;               // columns a batch row
  int nbt;             // pages a batch row (n_splits npb, or fewer)
  int npb;             // pages a split
  int n_splits;
  int kvh;             // dense: kv heads a cache row (row b = bo kvh + kh)
  int ntile;           // units a split: ceil(C / NC)
  int units;           // B n_splits ntile
  float scale;
  int amla;
  // over codes
  int code;            // 0 int8, 1 e4m3
  int S;               // dense: rows a cache row (pairs past S: (1, 0))
  int ldz, ldvz;
  const float* q32;    // fp32 q [B, C, DK] (split by the consumers)
  const float* ksz;    // K's (scale, zp) pairs: paged a pool [N, 64, 2];
                       // dense rows at bo zb + kh zh + s ldz
  const float* vsz;    // a separate V's, addressed alike (vzb, vzh, ldvz)
  long long zb, zh, vzb, vzh;
};

// Unit u: batch row b, split s, first column c0, and the pages [j0, j0 +
// np) it walks: up to the page holding the row's last live position, or
// every page of the split when none of them holds one.
struct Unit {
  int b, s, c0, j0, np;
};

template <int NC>
__device__ __forceinline__ Unit unit_of(const Params& P, int u) {
  Unit U;
  const int r = u / P.ntile;
  U.c0 = (u - r * P.ntile) * NC;
  U.b = r / P.n_splits;
  U.s = r - U.b * P.n_splits;
  U.j0 = U.s * P.npb;
  const int j1 = min(U.j0 + P.npb, P.nbt);
  const int h = P.lengths[U.b] - 1;
  U.np = (h >= U.j0 * PAGE ? min(j1, h / PAGE + 1) : j1) - U.j0;
  return U;
}

template <int N, bool FIRST, bool TA>
__device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t da,
                                    uint64_t db) {
  if constexpr (N == 64)
    wgmma_ss_m64n64k16<FIRST, TA>(d, da, db);
  else if constexpr (N == 32)
    wgmma_ss_m64n32k16<FIRST, TA>(d, da, db);
  else
    wgmma_ss_m64n16k16<FIRST, TA>(d, da, db);
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

template <bool STATS, bool DENSE, int DK, int DV, bool SEPV, int NC,
          bool QUANT, bool QF32>
__global__ void __launch_bounds__(NTHREAD, 1) etap_decode_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const Params P) {
  using Cf = Cfg<DK, DV, SEPV, NC, QUANT, QF32>;
  constexpr int NBK = Cf::NBK, NBV = Cf::NBV, NM = Cf::NM;
  constexpr int BPP = Cf::BPP, KREL = Cf::KREL, RING = Cf::RING;
  constexpr int PP = Cf::PP, NQ = Cf::NQ, NPT = Cf::NPT;
  constexpr int NT = NC / 8;               // n8 tiles of the unit
  constexpr int NCOL = NC / 4;             // columns a thread holds
  constexpr int NST = NC / 16;             // stmatrix stores a page
  constexpr bool OUT_F32 = QUANT && (QF32 || DENSE);
  extern __shared__ unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* sp = sq + NQ * NBK * NC * BOX;     // [NCONS][PP][NPT][NC][64]
  float* sm = reinterpret_cast<float*>(sp + NCONS * PP * NPT * NC * BOX);
  bf16* ring = reinterpret_cast<bf16*>(sm + 128 * (NC / 2));  // [RING][64][64]
  __shared__ uint64_t q_full, q_empty;
  // a slot's barriers: its box landed (full), over codes its box widened
  // (ready, after full's), each in LOOK copies (bar), and its consumer done
  // with it (empty)
  constexpr int LOOK = Cf::LOOK;
  __shared__ uint64_t full[(QUANT ? 2 : 1) * LOOK * RING], empty[RING];
  constexpr int READY = QUANT ? LOOK * RING : 0;   // ready: full[READY + ..]
  // box nb's copy of its slot's landed barrier (its ready one at READY +),
  // and the parity of the phase that box completes
  auto bar = [](uint32_t nb) { return nb / RING % LOOK * RING + nb % RING; };
  auto par = [](uint32_t nb) { return nb / RING / LOOK & 1; };
  // rows 0-3: the 4 warps' column values; over codes 4-7 their Z
  __shared__ float red[NCONS][Cf::RROWS][NC];
  __shared__ float qs[QUANT ? NC : 1];     // over codes: sum(q) a column

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&q_full, 1);
    mbar_init(&q_empty, NCONS * 4);        // each consumer warp arrives
    for (int s = 0; s < LOOK * RING; ++s) {
      mbar_init(&full[s], 1);              // the producer's TMA
      if constexpr (QUANT) mbar_init(&full[READY + s], 1);   // a converter
    }
    for (int s = 0; s < RING; ++s)
      mbar_init(&empty[s], 4);             // the step's consumer's warps
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {
    // -------------------------------------------------------- producer
    setmaxnreg_dec<PRODUCER_REGS>();
    const int warp = tid >> 5, lane = tid & 31;
    if (warp == 0) {
      if (lane == 0) {
        if constexpr (!QF32) tma_prefetch_map(&tq);
        tma_prefetch_map(&tk);
        if constexpr (SEPV) tma_prefetch_map(&tv);
      }
      uint32_t box = 0;                    // boxes issued, all units
      uint32_t n = 0;                      // units begun
      for (int u = blockIdx.x; u < P.units; u += gridDim.x, ++n) {
        const Unit U = unit_of<NC>(P, u);
        // whole steps of PP pages: a last page past np is a pad page
        const int steps = (U.np + PP - 1) / PP;
        int c1 = 0, c3 = 0;                // dense: (kh, bo)
        if constexpr (DENSE) {
          c3 = U.b / P.kvh;
          c1 = U.b - c3 * P.kvh;
        }
        const int* trow = DENSE ? nullptr : P.table + (size_t)U.b * P.nbt;
        int ids = 0;
        for (int j = 0; j < steps * PP; ++j) {
          int c2 = 0;
          if constexpr (DENSE) {
            c2 = (U.j0 + j) * PAGE;
          } else {                         // the null block for a pad page
            if ((j & 31) == 0)
              ids = j + lane < U.np ? trow[U.j0 + j + lane] : 0;
            c3 = __shfl_sync(0xffffffffu, ids, j & 31);
          }
          if (lane == 0) {
#pragma unroll 1
            for (int p = 0; p < BPP; ++p, ++box) {
              const uint32_t slot = box % RING;
              mbar_wait(&empty[slot], ((box / RING) & 1) ^ 1);
              // K box (p + NBV) % NBK, or V box p - NBK
              const CUtensorMap* map = p < NBK ? &tk : &tv;
              const int x = (p < NBK ? (p + NBV) % NBK : p - NBK) * BOX;
              // over codes the codes, into the slot's upper 4 KB
              mbar_expect_tx(&full[bar(box)],
                             QUANT ? CODE_BOX_BYTES : BOX_BYTES);
              tma_load_4d(reinterpret_cast<unsigned char*>(
                              ring + slot * BOX_ELEMS) +
                              (QUANT ? CODE_BOX_BYTES : 0),
                          map, &full[bar(box)], x, c1, c2, c3);
              // Q behind the first page's K boxes, before its V boxes (an
              // fp32 q is split by the consumers instead)
              if (!QF32 && j == 0 && p == NBK - 1) {
                mbar_wait(&q_empty, (n & 1) ^ 1);
                mbar_expect_tx(&q_full, Cf::QBYTES);
#pragma unroll 1
                for (int y = 0; y < NBK; ++y)
                  tma_load_4d(sq + y * NC * BOX, &tq, &q_full, y * BOX, 0,
                              U.c0, U.b);
              }
            }
          }
          __syncwarp();
        }
      }
    } else if constexpr (QUANT) {
      // ------------------------------------------------ converters (codes)
      const int cv = warp - 1;
      uint32_t box = 0;
      for (int u = blockIdx.x; u < P.units; u += gridDim.x) {
        const Unit U = unit_of<NC>(P, u);
        const uint32_t end = box + (U.np + PP - 1) / PP * PP * BPP;
        // this warp's boxes of the unit: box % NCONV == cv
        for (box += (cv + NCONV - static_cast<int>(box % NCONV)) % NCONV;
             box < end; box += NCONV) {
          const uint32_t slot = box % RING;
          mbar_wait(&full[bar(box)], par(box));
          if (P.code)
            widen_box<true>(ring + slot * BOX_ELEMS, lane);
          else
            widen_box<false>(ring + slot * BOX_ELEMS, lane);
          fence_proxy_async();             // for the consumers' wgmma
          __syncwarp();
          if (lane == 0) mbar_arrive(&full[READY + bar(box)]);
        }
        box = end;
      }
    }
    return;
  }

  // ----------------------------------------------------------- consumers
  setmaxnreg_inc<CONSUMER_REGS>();
  // The rescale mode: over bf16 rows a compile-time constant, each mode
  // its own loop with no branch on it inside (on the H100 1-12% faster in
  // device time than one loop that branches); over codes a run-time flag
  // (two loops there spilled up to 660 B a thread).
  auto consume = [&](auto mode) {
    const bool amla = amla_of(mode);
    const int cw = tid / 128 - 1;            // steps cw, cw + 2, ... of a unit
    const int t = tid % 128;
    const int w = t >> 5, lane = t & 31;
    const int g = lane >> 2, tq4 = lane & 3;   // fragment coordinates
    const int row = 16 * w + g;              // page rows row, row + 8
    const float NEG_INFTY = __int_as_float(0xff800000);   // -inf
    // page pp of a step: term x at p_cw + (pp NPT + x) NC 64
    const bf16* p_cw = sp + cw * PP * NPT * NC * BOX;
    float (*rd)[NC] = red[cw];
    // stmatrix: lane gives the row (a P^T column) of matrix lane / 8 of
    // each x4 store k: n8 tile 2k + (lane >> 4), rows 8 (lane >> 3 & 1) ..
    // of the warp's 16, at 16-byte chunk 2w + that half (swizzled)
    uint32_t st_off[NST];
#pragma unroll
    for (int k = 0; k < NST; ++k) {
      const int col = 8 * (2 * k + (lane >> 4)) + (lane & 7);
      const int chunk = 2 * w + ((lane >> 3) & 1);
      st_off[k] = col * 128 + ((chunk ^ (col & 7)) << 4);
    }
    const uint32_t st_p = smem_u32(p_cw);

    uint32_t ubox = 0;                       // the unit's first box
    uint32_t n = 0;
    for (int u = blockIdx.x; u < P.units; u += gridDim.x, ++n) {
      const Unit U = unit_of<NC>(P, u);
      const int steps = (U.np + PP - 1) / PP;
      const uint32_t box0 = ubox;
      ubox += steps * PP * BPP;
      // this thread's columns: i = 2 nt + e is column 8 nt + 2 tq4 + e of
      // the unit
      const int cbase = U.c0 + 2 * tq4;
      const int hb = P.lengths[U.b] - 1;     // every live column's horizon
      float m[NCOL], l[NCOL];
      [[maybe_unused]] float z[QUANT ? NCOL : 1];   // over codes: Z
#pragma unroll
      for (int i = 0; i < NCOL; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
        if constexpr (QUANT) z[i] = 0.f;
      }
      float o[NM][NC / 2];
#pragma unroll
      for (int mt = 0; mt < NM; ++mt)
#pragma unroll
        for (int e = 0; e < NC / 2; ++e) o[mt][e] = 0.f;
      // the 8 consumer warps, columns w8, w8 + 8, ... (over codes)
      [[maybe_unused]] const int w8 = 4 * cw + w;
      if constexpr (QF32) {
        // ---- q's three bf16 terms into the Q tiles, and sum(q) in fp32;
        //      every reader of the last unit's Q and sums is past the merge
        for (int i = w8; i < NC; i += 8) {
          const int c = U.c0 + i;
          const float4* src = reinterpret_cast<const float4*>(
              P.q32 + ((size_t)U.b * P.C + (c < P.C ? c : 0)) * DK);
          float acc = 0.f;
          for (int f = lane; f < DK / 4; f += 32) {
            const float4 v = c < P.C ? __ldg(src + f)
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
            const int at = q_at<NC>(i, 4 * f);
            constexpr int TB = NBK * NC * BOX;
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
        fence_proxy_async();                 // for the score product
        named_bar_sync(3, 256);
      } else {
        mbar_wait(&q_full, n & 1);
        if constexpr (QUANT) {
          // ---- sum(q) in fp32 of the bf16 Q rows, 16-byte chunks of the
          //      swizzled tile
          for (int i = w8; i < NC; i += 8) {
            float acc = 0.f;
            for (int ch = lane; ch < NBK * 8; ch += 32) {
              const uint4 v =
                  *reinterpret_cast<const uint4*>(sq + q_at<NC>(i, 8 * ch));
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
          named_bar_sync(3, 256);
        }
        // a unit of one step leaves the second consumer no page: its Q read
        // ends here
        if (cw >= steps) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&q_empty);
        }
      }
      // over codes, the pairs of a step's rows row and row + 8 of each page
      // (a pad page past np: (1, 0)) from the pair pool or rows zr: K's
      // (V's too when V is K's columns), or a separate V's
      [[maybe_unused]] const float* kzr = P.ksz;
      [[maybe_unused]] const float* vzr = P.vsz;
      if constexpr (QUANT && DENSE) {
        const int bo = U.b / P.kvh, kh = U.b - bo * P.kvh;
        kzr += (size_t)bo * P.zb + (size_t)kh * P.zh;
        vzr += (size_t)bo * P.vzb + (size_t)kh * P.vzh;
      }
      [[maybe_unused]] const int* trow =
          DENSE ? nullptr : P.table + (size_t)U.b * P.nbt;
      auto pairs = [&](int js, const float* zr, int ldz, float2 (&z2)[PP][2]) {
#pragma unroll
        for (int pp = 0; pp < PP; ++pp) {
          const bool live = PP == 1 || js + pp < U.np;
          const int j = U.j0 + js + pp;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if constexpr (DENSE) {
              const int r = j * PAGE + row + 8 * h;
              const bool in = live && r < P.S;
              z2[pp][h] = pair_at(zr + (size_t)(in ? r : 0) * ldz, in);
            } else {
              z2[pp][h] = pair_at(
                  zr + ((size_t)(live ? trow[j] : 0) * PAGE + row + 8 * h) * 2,
                  live);
            }
          }
        }
      };

      for (int step = cw; step < steps; step += 2) {
        const int js = step * PP;            // the step's first page
        const uint32_t box = box0 + step * PP * BPP;
        [[maybe_unused]] float2 kz[PP][2], vz[PP][2];   // K's land in S
        if constexpr (QUANT) pairs(js, kzr, P.ldz, kz);
        // ---- S^T = K Q^T for each page of the step: Dk / 16 k16 steps, 4
        //      to a box, NQ Q terms each
        //      (fp32 q's terms lo, mid, then hi over the whole page: the
        //      small ones first, so that the tensor cores' adds round the hi
        //      products' sum, not the small terms, against the running sum)
        float s[PP][NC / 2];
        wgmma_fence();
#pragma unroll
        for (int pp = 0; pp < PP; ++pp)
#pragma unroll
          for (int xi = 0; xi < NQ; ++xi)
#pragma unroll
            for (int p = 0; p < NBK; ++p) {
              const uint32_t nb = box + pp * BPP + p;
              if (xi == 0) mbar_wait(&full[READY + bar(nb)], par(nb));
              const bf16* kt = ring + (nb % RING) * BOX_ELEMS;
              const bf16* qt = sq + (NQ - 1 - xi) * NBK * NC * BOX +
                               ((p + NBV) % NBK) * NC * BOX;
              uint32_t ka = smem_u32(kt), qa = smem_u32(qt);
              // with three Q terms a K box's descriptors are made again for
              // each, not held in registers across the terms
              if constexpr (NQ > 1) asm volatile("" : "+r"(ka), "+r"(qa));
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                uint64_t da, db;
                if constexpr (NQ > 1) {
                  da = desc_sw128(ka + 32 * kk, 16, 1024);
                  db = desc_sw128(qa + 32 * kk, 16, 1024);
                } else {
                  da = desc_sw128(kt + 16 * kk, 16, 1024);
                  db = desc_sw128(qt + 16 * kk, 16, 1024);
                }
                if (xi == 0 && p == 0 && kk == 0)
                  mma<NC, true, false>(s[pp], da, db);
                else
                  mma<NC, false, false>(s[pp], da, db);
              }
            }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int pp = 0; pp < PP; ++pp) fence_regs(s[pp]);
        __syncwarp();
        if (lane == 0) {                     // the K boxes outside V
#pragma unroll
          for (int pp = 0; pp < PP; ++pp)
#pragma unroll
            for (int p = 0; p < KREL; ++p)
              mbar_arrive(&empty[(box + pp * BPP + p) % RING]);
          // its last S
          if (!QF32 && step + 2 >= steps) mbar_arrive(&q_empty);
        }

        // ---- (codes: each row's affine,) scale, mask, the column max over
        //      the step's 64 PP rows (a pad page past np: -inf at every row,
        //      so that it adds nothing)
        // (over codes each column's max goes to rd at once, which frees its
        // register; the bf16 kernel writes them after the loop, and rescales
        // O^T after the next loop, which its split partials ran 8% faster
        // with on the H100)
        [[maybe_unused]] float mx[QUANT ? 1 : NCOL];
#pragma unroll
        for (int i = 0; i < NCOL; ++i) {
          const int nt = i >> 1, e = i & 1;
          float mi;
          // a padding column (past C) is masked whole
          const bool col = cbase + 8 * nt + e < P.C;
          [[maybe_unused]] float qsum = 0.f;
          if constexpr (QUANT) qsum = qs[8 * nt + 2 * tq4 + e];
#pragma unroll
          for (int pp = 0; pp < PP; ++pp) {
            const int kp = (U.j0 + js + pp) * PAGE + row;
            const bool live = PP == 1 || js + pp < U.np;
            const float masked = live ? NEG_INF : NEG_INFTY;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float x = s[pp][4 * nt + 2 * h + e];
              if constexpr (QUANT) x = kz[pp][h].x * x + kz[pp][h].y * qsum;
              x = live && col && kp + 8 * h <= hb ? x * P.scale : masked;
              if (amla) x *= LOG2E;          // log2 domain
              s[pp][4 * nt + 2 * h + e] = x;
            }
            const float m2 = fmaxf(s[pp][4 * nt + e], s[pp][4 * nt + 2 + e]);
            mi = pp == 0 ? m2 : fmaxf(mi, m2);
          }
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            mi = fmaxf(mi, __shfl_xor_sync(0xffffffffu, mi, off));
          if constexpr (QUANT) {
            if (g == 0) rd[w][8 * nt + 2 * tq4 + e] = mi;
          } else {
            mx[i] = mi;
          }
        }
        if constexpr (!QUANT) {
          if (g == 0) {
#pragma unroll
            for (int i = 0; i < NCOL; ++i)
              rd[w][8 * (i >> 1) + 2 * tq4 + (i & 1)] = mx[i];
          }
        }
        // over codes V's pairs, loaded while the max exchange runs
        if constexpr (QUANT) {
          if constexpr (SEPV) {
            pairs(js, vzr, P.ldvz, vz);
          } else {
#pragma unroll
            for (int pp = 0; pp < PP; ++pp) {
              vz[pp][0] = kz[pp][0];
              vz[pp][1] = kz[pp][1];
            }
          }
        }
        named_bar_sync(1 + cw, 128);

        // ---- the new stats, p = exp(x - m), l's (and Z's) partial sums,
        //      O^T's rescale (a column's corr is in the threads holding it);
        //      over codes s keeps scale_r p for P V
        float corr[NCOL];
#pragma unroll
        for (int i = 0; i < NCOL; ++i) {
          const int col = 8 * (i >> 1) + 2 * tq4 + (i & 1);
          const float bm = fmaxf(fmaxf(rd[0][col], rd[1][col]),
                                 fmaxf(rd[2][col], rd[3][col]));
          const float m_new = fmaxf(m[i], amla ? ceilf(bm) : bm);
          corr[i] = stat_weight(m[i] - m_new, amla);
          m[i] = m_new;
          const int nt = i >> 1, e = i & 1;
          float sum;
          [[maybe_unused]] float zs;
#pragma unroll
          for (int pp = 0; pp < PP; ++pp) {
            const float p0 = prob_exp(s[pp][4 * nt + e] - m_new, amla);
            const float p1 = prob_exp(s[pp][4 * nt + 2 + e] - m_new, amla);
            if constexpr (QUANT) {
              s[pp][4 * nt + e] = p0 * vz[pp][0].x;
              s[pp][4 * nt + 2 + e] = p1 * vz[pp][1].x;
              const float zp = p0 * vz[pp][0].y + p1 * vz[pp][1].y;
              zs = pp == 0 ? zp : zs + zp;
            } else {
              s[pp][4 * nt + e] = p0;
              s[pp][4 * nt + 2 + e] = p1;
            }
            sum = pp == 0 ? p0 + p1 : sum + (p0 + p1);
          }
          l[i] = l[i] * corr[i] + sum;
          if constexpr (QUANT) {
            z[i] = z[i] * corr[i] + zs;
#pragma unroll
            for (int mt = 0; mt < NM; ++mt) {
              o[mt][4 * nt + e] *= corr[i];
              o[mt][4 * nt + 2 + e] *= corr[i];
            }
          }
        }
        if constexpr (!QUANT) {
#pragma unroll
          for (int mt = 0; mt < NM; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                o[mt][4 * nt + e] *= corr[2 * nt + (e & 1)];
        }

        // ---- P^T in NPT bf16 terms (hi, [mid,] lo), stored transposed into
        //      each page's tiles
#pragma unroll
        for (int pp = 0; pp < PP; ++pp)
#pragma unroll
          for (int k = 0; k < NST; ++k) {
            uint32_t hi[4], mid[4], lo[4];
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const float* f = &s[pp][4 * (2 * k + (x >> 1)) + 2 * (x & 1)];
              const __nv_bfloat162 h2 = __floats2bfloat162_rn(f[0], f[1]);
              const float2 back = __bfloat1622float2(h2);
              float r0 = f[0] - back.x, r1 = f[1] - back.y;   // exact
              if constexpr (NPT == 3) {
                const __nv_bfloat162 m2 = __floats2bfloat162_rn(r0, r1);
                const float2 mb = __bfloat1622float2(m2);
                mid[x] = *reinterpret_cast<const uint32_t*>(&m2);
                r0 -= mb.x;
                r1 -= mb.y;
              }
              const __nv_bfloat162 l2 = __floats2bfloat162_rn(r0, r1);
              hi[x] = *reinterpret_cast<const uint32_t*>(&h2);
              lo[x] = *reinterpret_cast<const uint32_t*>(&l2);
            }
            const uint32_t tile = st_p + pp * NPT * NC * BOX * 2 + st_off[k];
            stmatrix_x4_trans(tile, hi);
            if constexpr (NPT == 3) {
              stmatrix_x4_trans(tile + NC * BOX * 2, mid);
              stmatrix_x4_trans(tile + 2 * NC * BOX * 2, lo);
            } else {
              stmatrix_x4_trans(tile + NC * BOX * 2, lo);
            }
          }
        fence_proxy_async();
        named_bar_sync(1 + cw, 128);

        // ---- O^T += V^T P^T: V box mt of page pp at position KREL + mt,
        //      MN-major, term by term
        if constexpr (SEPV) {
#pragma unroll
          for (int pp = 0; pp < PP; ++pp)
#pragma unroll
            for (int v = 0; v < NBV; ++v) {
              const uint32_t nb = box + pp * BPP + KREL + v;
              mbar_wait(&full[READY + bar(nb)], par(nb));
            }
        }
        wgmma_fence();
#pragma unroll
        for (int pp = 0; pp < PP; ++pp)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int x = 0; x < NPT; ++x) {
              const uint64_t dp = desc_sw128(
                  p_cw + (pp * NPT + x) * NC * BOX + 16 * kk, 16, 1024);
#pragma unroll
              for (int mt = 0; mt < NM; ++mt) {
                const bf16* vt =
                    ring + ((box + pp * BPP + KREL + mt) % RING) * BOX_ELEMS;
                mma<NC, false, true>(
                    o[mt], desc_sw128(vt + 16 * kk * BOX, BOX_BYTES, 1024), dp);
              }
            }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int mt = 0; mt < NM; ++mt) fence_regs(o[mt]);
        __syncwarp();
        if (lane == 0) {                     // the V boxes
#pragma unroll
          for (int pp = 0; pp < PP; ++pp)
#pragma unroll
            for (int p = KREL; p < BPP; ++p)
              mbar_arrive(&empty[(box + pp * BPP + p) % RING]);
        }
      }

      // ---- merge the second consumer's state into the first's, thread by
      //      thread (both hold the same fragments): m and l's partial sums
      //      (over codes then Z's), then O^T an m-tile at a time, through
      //      NC / 2 floats a thread
      if (cw == 1) {
#pragma unroll
        for (int i = 0; i < NCOL; ++i) {
          sm[i * 128 + t] = m[i];
          sm[(NCOL + i) * 128 + t] = l[i];
        }
      }
      named_bar_sync(3, 256);
      float w0[NCOL], w1[NCOL];
#pragma unroll
      for (int i = 0; i < NCOL; ++i) {
        const float m1 = sm[i * 128 + t], l1 = sm[(NCOL + i) * 128 + t];
        const float mm = fmaxf(m[i], m1);
        w0[i] = stat_weight(m[i] - mm, amla);
        w1[i] = stat_weight(m1 - mm, amla);
        l[i] = l[i] * w0[i] + l1 * w1[i];
        m[i] = mm;
      }
      named_bar_sync(3, 256);
      if constexpr (QUANT) {
        if (cw == 1) {
#pragma unroll
          for (int i = 0; i < NCOL; ++i) sm[i * 128 + t] = z[i];
        }
        named_bar_sync(3, 256);
        if (cw == 0) {
#pragma unroll
          for (int i = 0; i < NCOL; ++i)
            z[i] = z[i] * w0[i] + sm[i * 128 + t] * w1[i];
        }
        named_bar_sync(3, 256);
      }
#pragma unroll
      for (int mt = 0; mt < NM; ++mt) {
        if (cw == 1) {
#pragma unroll
          for (int e = 0; e < NC / 2; ++e) sm[e * 128 + t] = o[mt][e];
        }
        named_bar_sync(3, 256);
        if (cw == 0) {
#pragma unroll
          for (int e = 0; e < NC / 2; ++e) {
            const int i = 2 * (e >> 2) + (e & 1);
            o[mt][e] = o[mt][e] * w0[i] + sm[e * 128 + t] * w1[i];
          }
        }
        named_bar_sync(3, 256);
      }
      if (cw == 1) continue;                 // the first consumer writes

      // ---- epilogue: l (and Z) over the 64 rows, then out = (O^T [+ Z]) /
      //      l, or the split's raw (m, l, O^T [+ Z])
#pragma unroll
      for (int i = 0; i < NCOL; ++i) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
          if constexpr (QUANT)
            z[i] += __shfl_xor_sync(0xffffffffu, z[i], off);
        }
      }
      named_bar_sync(1, 128);                // rd's last readers are done
      if (g == 0) {
#pragma unroll
        for (int i = 0; i < NCOL; ++i) {
          rd[w][8 * (i >> 1) + 2 * tq4 + (i & 1)] = l[i];
          if constexpr (QUANT)
            rd[4 + w][8 * (i >> 1) + 2 * tq4 + (i & 1)] = z[i];
        }
      }
      named_bar_sync(1, 128);
#pragma unroll
      for (int i = 0; i < NCOL; ++i) {
        const int col = 8 * (i >> 1) + 2 * tq4 + (i & 1);
        l[i] = (rd[0][col] + rd[1][col]) + (rd[2][col] + rd[3][col]);
        if constexpr (QUANT)
          z[i] = (rd[4][col] + rd[5][col]) + (rd[6][col] + rd[7][col]);
      }
      named_bar_sync(1, 128);                // before the next unit's rd
      // over codes Z joins O^T: Z of column i on every Dv row
      if constexpr (QUANT) {
#pragma unroll
        for (int mt = 0; mt < NM; ++mt)
#pragma unroll
          for (int e = 0; e < NC / 2; ++e)
            o[mt][e] += z[2 * (e >> 2) + (e & 1)];
      }
      if constexpr (STATS) {
        const size_t srow = (size_t)U.b * P.n_splits + U.s;
        if (w == 0 && g == 0) {              // one writer per column
#pragma unroll
          for (int i = 0; i < NCOL; ++i) {
            const int col = cbase + 8 * (i >> 1) + (i & 1);
            if (col < P.C) {
              P.m_out[srow * P.C + col] = m[i];
              P.l_out[srow * P.C + col] = l[i];
            }
          }
        }
        float* a = P.acc_out + srow * DV * P.C;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = cbase + 8 * nt + e;
            if (col >= P.C) continue;
#pragma unroll
            for (int mt = 0; mt < NM; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                a[(size_t)(64 * mt + row + 8 * h) * P.C + col] =
                    o[mt][4 * nt + 2 * h + e];
          }
      } else {
        // a pair of adjacent Dv rows per store: the lanes of row groups g
        // and g ^ 1 trade one column's value each
        const bool odd = g & 1;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = cbase + 8 * nt + (odd ? 1 : 0);
#pragma unroll
          for (int mt = 0; mt < NM; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float v0 = o[mt][4 * nt + 2 * h] / l[2 * nt];
              const float v1 = o[mt][4 * nt + 2 * h + 1] / l[2 * nt + 1];
              const float y = __shfl_xor_sync(0xffffffffu, odd ? v0 : v1, 4);
              const int dv = 64 * mt + row + 8 * h - (odd ? 1 : 0);
              if (col < P.C) {
                const size_t at = ((size_t)U.b * P.C + col) * DV + dv;
                if constexpr (OUT_F32)
                  *reinterpret_cast<float2*>(static_cast<float*>(P.out) + at) =
                      odd ? make_float2(y, v1) : make_float2(v0, y);
                else
                  *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(P.out) +
                                                     at) =
                      odd ? __floats2bfloat162_rn(y, v1)
                          : __floats2bfloat162_rn(v0, y);
              }
            }
        }
      }
    }
  };
  if constexpr (QUANT)
    consume(P.amla != 0);
  else if (P.amla)
    consume(std::true_type{});
  else
    consume(std::false_type{});
}

// The unit width (columns) for `rows` = B n_splits row splits of C
// columns at Dk = dk on `sms` SMs: the narrowest of 16, 32 and 64 whose
// units fit one wave of the grid, else the narrowest that holds C; at most
// 32 where Dk >= 256, whose O^T [Dv, 64] would take more registers than a
// consumer thread has (see the header), and over codes (quant), whose Z,
// pairs and Q terms spilled at 64 (16-272 B of local memory a thread at
// (128, 128) and (64, 64)); at most 16 over codes with fp32 q (qf32) where
// Dk >= 256, whose three Q terms' score product spilled at 32 (224-232 B
// at the latent).  So a quantized instance's width is the smaller of the
// bf16 width and its cap, a function of the instance alone.
inline int unit_cap(int dk, bool quant, bool qf32) {
  return quant && qf32 && dk >= 256 ? 16 : dk >= 256 || quant ? 32 : 64;
}

inline int decode_unit_cols(int dk, long long rows, int C, int sms,
                            bool quant = false, bool qf32 = false) {
  const int cap = unit_cap(dk, quant, qf32);
  int nc = 16;
  while (nc < C && nc < cap && rows * ((C + nc - 1) / nc) > sms) nc *= 2;
  return nc;
}

// The operands of one launch: q [B, C, DK] (bf16, or fp32 with QF32) and
// the K and V rows (paged: pools [N, 64, D*]; dense: a cache read through
// its strides, in elements, with kvh kv heads a cache row; v null when V
// is K's first DV columns), bf16 or 1-byte codes.
struct Operands {
  const void* q;
  const void* k;
  const void* v;
  long long kb, kh, vb, vh;
  int ldk, ldv, S, kvh;
};

template <bool STATS, bool DENSE, int DK, int DV, bool SEPV, int NC,
          bool QUANT, bool QF32>
int launch_cols(const Operands& a, Params p, int B, int dev, int sms,
                void* stream) {
  using Cf = Cfg<DK, DV, SEPV, NC, QUANT, QF32>;
  p.ntile = (p.C + NC - 1) / NC;
  p.units = B * p.ntile * p.n_splits;
  const auto rows = QUANT ? code_rows_map : bf16_rows_map;
  CUtensorMap tq, tk, tv;
  int err;
  if constexpr (DENSE) {
    const int Bo = B / a.kvh;
    err = rows(&tk, a.k, DK, a.kvh, a.S, Bo, a.kh, a.ldk, a.kb, PAGE);
    // a V of its own, or K's rows read again at DV (V is K at this width)
    if (err == 0 && SEPV)
      err = a.v ? rows(&tv, a.v, DV, a.kvh, a.S, Bo, a.vh, a.ldv, a.vb, PAGE)
                : rows(&tv, a.k, DV, a.kvh, a.S, Bo, a.kh, a.ldk, a.kb, PAGE);
  } else {
    err = rows(&tk, a.k, DK, 1, PAGE, MAX_POOL_BLOCKS, DK, DK,
               static_cast<long long>(PAGE) * DK, PAGE);
    if (err == 0 && SEPV)
      err = rows(&tv, a.v, DV, 1, PAGE, MAX_POOL_BLOCKS, DV, DV,
                 static_cast<long long>(PAGE) * DV, PAGE);
  }
  if (err == 0 && !QF32)
    err = bf16_rows_map(&tq, a.q, DK, 1, p.C, B, DK, DK,
                        static_cast<long long>(p.C) * DK, NC);
  if (err != 0) return err;
  if (QF32) {                              // no Q map: the consumers split q
    tq = tk;
    p.q32 = static_cast<const float*>(a.q);
  }
  if (!SEPV) tv = tk;                      // the fused kernel reads no tv
  auto kernel = etap_decode_kernel<STATS, DENSE, DK, DV, SEPV, NC, QUANT,
                                   QF32>;
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

// Launch at the unit width decode_unit_cols picks.
template <bool STATS, bool DENSE, int DK, int DV, bool SEPV,
          bool QUANT = false, bool QF32 = false>
int launch_decode(const Operands& a, Params p, int B, void* stream) {
  if (B <= 0 || p.C <= 0 || p.nbt <= 0 || p.n_splits <= 0 || p.npb <= 0 ||
      a.kvh <= 0 || B % a.kvh != 0 || (QUANT && p.code != 0 && p.code != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int dev = current_device();
  const int sms = dev < 0 ? 0 : sm_count(dev);
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  switch (decode_unit_cols(DK, static_cast<long long>(B) * p.n_splits, p.C,
                           sms, QUANT, QF32)) {
    case 16:
      return launch_cols<STATS, DENSE, DK, DV, SEPV, 16, QUANT, QF32>(
          a, p, B, dev, sms, stream);
    case 32:
      if constexpr (QF32 && DK >= 256)
        return static_cast<int>(cudaErrorInvalidValue);
      else
        return launch_cols<STATS, DENSE, DK, DV, SEPV, 32, QUANT, QF32>(
            a, p, B, dev, sms, stream);
    default:
      if constexpr (DK >= 256 || QUANT)
        return static_cast<int>(cudaErrorInvalidValue);
      else
        return launch_cols<STATS, DENSE, DK, DV, SEPV, 64, QUANT, QF32>(
            a, p, B, dev, sms, stream);
  }
}

template <bool STATS, bool DENSE, int DK, int DV, bool SEPV, int NC,
          bool QUANT, bool QF32>
int attrs_cols(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, etap_decode_kernel<STATS, DENSE, DK, DV, SEPV, NC, QUANT, QF32>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = Cfg<DK, DV, SEPV, NC, QUANT, QF32>::SMEM;
  out[2] = static_cast<int>(a.localSizeBytes);
  return 0;
}

// The attributes of an instance at units of `cols` columns, up to its cap
// (unit_cap: 16, 32 or 64).
template <bool STATS, bool DENSE, int DK, int DV, bool SEPV,
          bool QUANT = false, bool QF32 = false>
int attrs_decode(int cols, int* out) {
  switch (cols) {
    case 16:
      return attrs_cols<STATS, DENSE, DK, DV, SEPV, 16, QUANT, QF32>(out);
    case 32:
      if constexpr (!(QF32 && DK >= 256))
        return attrs_cols<STATS, DENSE, DK, DV, SEPV, 32, QUANT, QF32>(out);
      return static_cast<int>(cudaErrorInvalidValue);
    case 64:
      if constexpr (DK < 256 && !QUANT)
        return attrs_cols<STATS, DENSE, DK, DV, SEPV, 64, QUANT, QF32>(out);
      [[fallthrough]];
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The parameters every launch shares.
inline Params decode_params(const int* table, const int* lengths, int C,
                            int nbt, int n_splits, float scale, int amla) {
  Params p{};
  p.table = table;
  p.lengths = lengths;
  p.C = C;
  p.nbt = nbt;
  p.n_splits = n_splits;
  p.npb = n_splits > 0 ? nbt / n_splits : 0;
  p.kvh = 1;
  p.scale = scale;
  p.amla = amla;
  return p;
}

// The code pools' parameters beyond the bf16 ones: the code type and K's
// and V's (scale, zp) pairs (dense: their strides in floats; v_sz null
// when V is K's columns, which then take K's pairs).
inline void quant_params(Params& p, int code, const float* k_sz,
                         long long zb, long long zh, int ldz,
                         const float* v_sz, long long vzb, long long vzh,
                         int ldvz) {
  p.code = code;
  p.ksz = k_sz;
  p.zb = zb;
  p.zh = zh;
  p.ldz = ldz;
  if (v_sz == nullptr) {
    v_sz = k_sz;
    vzb = zb;
    vzh = zh;
    ldvz = ldz;
  }
  p.vsz = v_sz;
  p.vzb = vzb;
  p.vzh = vzh;
  p.ldvz = ldvz;
}

}  // namespace
