// K4 and K4q, the chunked paged ETAP prefill and draft verify over bf16
// pools and over int8 / e4m3 code pools, for Hopper (sm_90a): wgmma on the
// page's 64 rows, a TMA ring of 64 x 64 boxes, one producer warp and two
// consumer warpgroups, a persistent grid.
//
//   K4  chunked paged prefill /    replaces repro/kernels/etap/etap.py:430
//       draft verify               (_prefill_call :373; bodies
//                                   _prefill_body_fused, _etap_prefill_body
//                                   :271, _verify_body_fused and
//                                   _verify_body :348; reached from
//                                   etap_prefill_mla_paged_pallas :456,
//                                   etap_verify_mla_paged_pallas :493,
//                                   etap_prefill_paged_pallas :440 and
//                                   etap_verify_paged_pallas :474)
//   K4q the same over int8 / e4m3  replaces the same call's quantized
//       code pools                 bodies _prefill_body_quant_fused :340,
//                                   _prefill_body_quant :334,
//                                   _verify_body_quant_fused :367 and
//                                   _verify_body_quant :360 (built on
//                                   _dequant :31)
//
// Built at three instances: DeepSeek's latent (576, 512) with V the page's
// first 512 columns (fused), the latent with V in a pool of its own, and
// Granite-20B's MQA head (128, 128) over separate K and V pools
// (mma_tile.cuh's PagedSepWidths), each over bf16 pools (K4) and over code
// pools (K4q, int8 or e4m3 a run-time choice, bf16 or fp32 q a template
// one).  The fused and separate-V instances are one template that differs
// only in where V's boxes (and, over codes, V's pairs) come from, so over a
// V pool that holds the fused pool's first 512 columns (and pairs) they
// give the fused kernel's bits.
//
// What it computes.  q [B, C, Dk] (C = Cq H columns), column c of batch
// row b attending over the pool pages of table[b] up to its horizon,
// start[b] + c / H (prefill) or qpos[b, c] (verify):
//     S^T = K Q^T * scale       [64, NC]   page rows on wgmma's M
//     mask kpos > horizon(column) to -1e30
//     online-softmax update per column (m, l), softmax_state.update in
//     both rescale modes (softmax_state.cuh: amla's 2^d is exact)
//     O^T = O^T * corr + V^T P^T [Dv, NC]  Dv on M, P as bf16 hi + lo
// and out [B, C, Dv] = (O^T / l)^T in bf16.  Scores, m, l and O^T are
// fp32; P enters the second product as p_hi = bf16(p) and p_lo = bf16(p -
// p_hi), as in every ETAP body.  A tile's walk ends after the page that
// holds its largest horizon: past a column's own horizon a page is masked
// whole, an exact no-op of the recurrence (p = 0, corr = 1), so each
// column sees what the reference's walk over every page gives it.  The
// walk is cut by positions only, never by block ids: a padded table entry
// (the null block 0) inside the walk is read and masked like any other
// page; a tile with no live position at all walks every page, as the
// reference does.  Verify with a linear qpos holds the prefill's
// horizons, so it is bitwise the prefill.
//
// Over codes (K4q).  A page holds int8 or e4m3 codes [64, Dk] and its
// (scale, zp) pool one fp32 pair per row [64, 2]; the reference
// dequantizes each row to fp32 (codes scale + zp) and forms both products
// in fp32.  Every int8 code and every e4m3 code is exact in bf16, so the
// codes feed the bf16 wgmma as they are and the affine goes around the
// products (as in etap_decode.cuh's "Over codes"):
//     S_r  = scale_r (codes_r . q) + zp_r sum(q)
//     O^T += V^T (scale P)^T + (sum_r zp_r p_r) on every Dv row
// sum(q) is one fp32 sum per column of q as given.  scale_r p_r enters P V
// as three bf16 terms (hi, mid, lo: its 24 bits; two leave a Qwen3-8B
// layer 1.2e-5 off the fp32 route on an H100); l sums the plain p.  The zp
// term rescales with O^T (corr), so each thread keeps it as a partial sum
// over its own rows beside l's, and the unit's epilogue adds it to every
// Dv row: out = ((O^T + Z) / l)^T, no exchange a page.  An fp32 q enters
// as three bf16 Q tiles (hi, mid, lo: its 24 bits), three S products into
// one fp32 accumulator, and out is fp32 (q's type).  Codes past a row's
// length hold finite values, so V never carries a NaN into a masked p = 0.
//
// The design (hopper.cuh holds the building blocks).  A work unit is NC
// columns of one batch row (NC = 64, or 32 where B ceil(C / 64) units
// would leave SMs idle, and always 32 with fp32 q); units run on a
// persistent grid of min(units, SMs) CTAs, CTA i taking units i, i + grid,
// ..., each row's tiles last first (in a prefill chunk the later columns
// walk further).  A CTA is three warpgroups.  One warp of the first (the
// producer; setmaxnreg 40) issues every load with TMA: the unit's Q tile
// (NC rows, one 64-column box per 64 of Dk, after the first page's K
// boxes; an fp32 q is split by the consumers instead) and the pages'
// boxes, each page's K boxes in the
// score product's k order (the latent's rope box 8 first, then 0-7) and,
// with a separate V, its V boxes after them, into a ring of RING boxes of
// 64 rows x 128 bytes, each with a full barrier (the bytes landed) and an
// empty one (both consumers done with it).  Over codes the producer loads
// each box's 4 KB of codes into the upper half of its ring slot, and the
// first warpgroup's other three warps (the converters) widen them in
// place, box m by warp m % 3 (the ring a multiple of 3 slots, so that a
// slot is always the same warp's), into the slot's swizzled bf16 box on
// the integer and fp32 / bf16 pipes (hopper.cuh: widen_box), and arrive
// on the slot's ready barrier: from there on the consumers run the bf16
// kernel's products on the widened boxes.  Each consumer warpgroup
// (setmaxnreg 232) owns CW = NC / 2 of the unit's columns outright and
// takes PP pages a step (2 at Granite's 128, whose ring holds several
// steps; 1 at the latent):
//   S^T [64, CW] a page: Dk / 16 SS wgmmas m64nCWk16 (three a k-step with
//     fp32 q), A = the K page, B = its Q columns, both K-major; the first
//     k-step writes S^T only; over codes each thread then applies its two
//     rows' affine, their pairs read from the pool (L2) into registers a
//     step ahead;
//   the per-column max over the step's 64 PP rows: a thread's rows, a
//     shuffle over the warp's 8 row groups, and the 4 warps' maxima
//     exchanged through 512 bytes of shared memory under a named barrier
//     (the transposed form's own cost); l (and Z) stay per-thread partial
//     sums until the unit's end; a column's corr is in the registers of the
//     threads that hold its O^T columns (S^T and O^T share the n layout);
//   P^T: the fragments of p_hi and p_lo (over codes, scale p in three
//     terms) stored transposed (stmatrix) into a 128-byte-swizzled K-major
//     [CW][64] tile each a page, a proxy fence and a named barrier;
//   O^T += V^T P^T: per page, k16 step and m-tile of Dv, an SS wgmma with
//     A = V's box read MN-major (the transpose-A bit) and B = P^T, term by
//     term.
// A step whose last page lies past the walk (an odd page count at PP 2)
// takes the null block there, masked whole with -inf whatever the
// horizons (a horizon may lie past the table), so it adds exactly
// nothing (its pairs are taken as (1, 0), not read).  The boxes a page is
// done with go back to the producer as soon as their product has
// finished: the K boxes outside V after the score product, the V boxes
// after P V.  So the latent's fused bf16 ring of 17 boxes
// holds the next page's 9 while P V reads this page's 8, and the
// separate-V latent's 17 boxes (one page, K then V) load the next page's K
// during this page's P V and its V during the next score product; the
// code ring holds 15 (P's third term takes the room of two), and the
// next page's last two boxes land once this page's P V is done.
//
// Shared memory (bytes) at NC = 64: Q NC x 1152 = 73,728 at the latent
// (16,384 at 128), P^T hi + lo 2 x 2 x 32 x 128 = 16,384 a page of a step
// (24,576 with the third term over codes), the ring 17 boxes (139,264) at
// the latent, fused or not, 22 at 128; with the barriers and the max
// exchange 231,792 of the 232,448 a CTA may use at the latent.  Over codes
// the ring is 15 boxes at the latent (18 at 128); with fp32 q (units of
// 32) the three Q tiles take 110,592 and the ring 12.  Registers: O^T
// [Dv, 32] fp32 is 128 a consumer thread at the latent (8 m-tiles of 16),
// S^T 16.
//
// What bounds it on the H100.  The bound chip_smoke.py states is the
// operations: a column c attends over horizon + 1 keys, 2 (Dk + Dv) FLOPs
// each.  The kernel's tensor work is whole pages for whole tiles, and P's
// lo term repeats the P V product once more (13.1 MFLOP a latent page of
// a 64-column unit, against 7.2 for the bound's count; over codes P's
// third term makes it 17.3, with fp32 q Q's two more terms 26.7); wgmma
// at N = 32 reads 3 KB of operands from shared memory for 65.5 KFLOP.
// What held it on the card (variant builds, PERF.md): a consumer's score
// product, softmax and P V run in series, the two consumers in phase, so
// the tensor cores wait out each page's softmax chain (the chain alone
// sets Granite's pace, hence its page pairs); and each unit reads its
// pages from L2 again, 72 KB a latent page for 64 columns (36 KB of codes
// over a code pool, which the converters widen each time).  A ring that
// lets the next page's score product run beside this page's softmax needs
// room for two pages beside Q and P, which the latent's 64-column Q tile
// leaves no room for.  Over codes (variant builds timed on the card, not
// kept; PERF.md): at Cq 256 the widening costs about 17% (a build that
// skips it), P's third term 14% (a build with two), and a staging ring of
// 6 code boxes beside a ring of 12 cost 13% against the in-place ring of
// 15.
#include <atomic>
#include <climits>
#include <cstdint>

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

// QUANT: code pools (K4q); QF32: fp32 q (over codes only).
template <int DK, int DV, bool SEPV, int CW, bool QUANT, bool QF32>
struct Cfg {
  static_assert(DK % BOX == 0 && DV % BOX == 0 && DV <= DK, "whole boxes");
  static_assert(CW == 32 || CW == 16, "32 or 16 columns a consumer");
  static_assert(QUANT || !QF32, "fp32 q is taken over codes only");
  static_assert(!QF32 || CW == 16, "fp32 q's three Q tiles: units of 32");
  static constexpr int NC = NCONS * CW;    // columns a unit
  static constexpr int NBK = DK / BOX;     // K boxes a page
  static constexpr int NBV = DV / BOX;     // V boxes a page
  static constexpr int NM = DV / 64;       // m-tiles of O^T
  // the page's boxes: K in k order (the boxes outside V first), then,
  // with a separate V, V's; the first KREL go back after the score
  // product, the rest (V box v at position KREL + v) after P V
  static constexpr int BPP = NBK + (SEPV ? NBV : 0);
  static constexpr int KREL = SEPV ? NBK : NBK - NBV;
  // pages a step: two at Granite's 128, whose ring holds several steps'
  // boxes beside Q and P, so that one max exchange, one pair of barriers
  // and twice the independent work serve two pages; one at the latent
  static constexpr int PP = DK <= 128 ? 2 : 1;
  static constexpr int NQ = QF32 ? 3 : 1;  // Q terms (hi, mid, lo)
  static constexpr int NPT = QUANT ? 3 : 2;  // P terms (hi, [mid,] lo)
  static constexpr int QBOX = NBK * NC * BOX * 2;  // one Q term's bytes
  static constexpr int QBYTES = NQ * QBOX;
  static constexpr int PBYTES = NCONS * PP * NPT * CW * BOX * 2;
  // the consumers' exchange rows: the 4 warps' column maxima (and l at
  // the end), over codes also their Z at the end and the columns' sum(q)
  static constexpr int RROWS = QUANT ? 9 : 4;
  // the static shared memory beside: the barriers (2 + 2 x at most
  // MAX_RING, over codes 3 x: TMA landed, widened, free) and the exchange
  static constexpr int MAX_RING = 24;
  static constexpr int STATIC = (2 + (QUANT ? 3 : 2) * MAX_RING) * 8 +
                                NCONS * RROWS * CW * 4;
  static constexpr int FIT =
      (SMEM_LIMIT - 1024 - STATIC - QBYTES - PBYTES) / BOX_BYTES;
  // over codes a multiple of NCONV, so that each ring slot is always the
  // same converter's
  static constexpr int RING = (FIT < MAX_RING ? FIT : MAX_RING) /
                              (QUANT ? NCONV : 1) * (QUANT ? NCONV : 1);
  // a step's score product holds its pages' K boxes (and the V boxes
  // issued between them), its P V their V boxes
  static_assert(RING >= (PP - 1) * BPP + NBK && RING >= PP * NBV,
                "a step's boxes fit the ring");
  static constexpr int SMEM = 1024 + QBYTES + PBYTES + RING * BOX_BYTES;
};

struct Params {
  const int* table;    // [B, nbt] pool block ids
  const int* start;    // [B] rows before the chunk
  const int* qpos;     // [B, C] explicit horizons (verify), or null
  void* out;           // [B, C, DV], contiguous: bf16, fp32 with fp32 q
  const float* q;      // fp32 q [B, C, DK] (split by the consumers)
  const float* ksz;    // codes: K's (scale, zp) pool [N, PAGE, 2]
  const float* vsz;    // a separate V's, or K's
  int code;            // codes: 0 int8, 1 e4m3
  int C;               // columns a batch row (Cq H)
  int H;               // column c is query row c / H
  int nbt;             // table columns
  int ntile;           // units a batch row: ceil(C / NC)
  int units;           // B ntile
  float scale;
  int amla;
};

__device__ __forceinline__ int horizon(const Params& P, int b, int c) {
  if (c >= P.C) return INT_MIN;            // padding column: all masked
  return P.qpos ? P.qpos[(size_t)b * P.C + c] : P.start[b] + c / P.H;
}

// Unit u: batch row b, first column c0 (a row's tiles last first).
template <int NC>
__device__ __forceinline__ void unit_of(const Params& P, int u, int& b,
                                        int& c0) {
  b = u / P.ntile;
  c0 = (P.ntile - 1 - u % P.ntile) * NC;
}

// The pages unit (b, c0) walks, computed by a whole warp: up to the page
// of the largest horizon of its NC columns, or every page when none is
// live.
template <int NC>
__device__ __forceinline__ int unit_pages(const Params& P, int b, int c0,
                                          int lane) {
  int h = INT_MIN;
#pragma unroll
  for (int i = lane; i < NC; i += 32) h = max(h, horizon(P, b, c0 + i));
#pragma unroll
  for (int off = 16; off; off >>= 1)
    h = max(h, __shfl_xor_sync(0xffffffffu, h, off));
  return h < 0 ? P.nbt : min(P.nbt, h / PAGE + 1);
}

template <int CW, bool FIRST, bool TA>
__device__ __forceinline__ void mma(float (&d)[CW / 2], uint64_t da,
                                    uint64_t db) {
  if constexpr (CW == 32)
    wgmma_ss_m64n32k16<FIRST, TA>(d, da, db);
  else
    wgmma_ss_m64n16k16<FIRST, TA>(d, da, db);
}

// The (scale, zp) pairs of rows r and r + 8 of pool block blk.
__device__ __forceinline__ void pairs_of(const float* sz, int blk, int r,
                                         float2 (&z)[2]) {
  const float2* p = reinterpret_cast<const float2*>(sz) +
                    (size_t)blk * PAGE + r;
  z[0] = __ldg(p);
  z[1] = __ldg(p + 8);
}

template <int DK, int DV, bool SEPV, int CW, bool QUANT, bool QF32>
__global__ void __launch_bounds__(NTHREAD, 1) etap_prefill_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const Params P) {
  using Cf = Cfg<DK, DV, SEPV, CW, QUANT, QF32>;
  constexpr int NC = Cf::NC, NBK = Cf::NBK, NBV = Cf::NBV, NM = Cf::NM;
  constexpr int BPP = Cf::BPP, KREL = Cf::KREL, RING = Cf::RING;
  constexpr int PP = Cf::PP, NQ = Cf::NQ, NPT = Cf::NPT;
  constexpr int NT = CW / 8;               // n8 tiles of a consumer
  constexpr int NCOL = CW / 4;             // columns a thread holds
  extern __shared__ unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* sp = sq + NQ * NBK * NC * BOX;     // [NCONS][PP][NPT][CW][64]
  bf16* ring = sp + NCONS * PP * NPT * CW * BOX;   // [RING][64][64]
  __shared__ uint64_t q_full, q_empty;
  // a slot's barriers: its box landed (full), over codes its box widened
  // (ready, after full's), and both consumers done with it (empty)
  __shared__ uint64_t full[QUANT ? 2 * RING : RING], empty[RING];
  constexpr int READY = QUANT ? RING : 0;   // ready[s] is full[READY + s]
  // rows 0-3: the 4 warps' column values; over codes 4-7 their Z at the
  // end and 8 each column's sum(q)
  __shared__ float red[NCONS][Cf::RROWS][CW];

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&q_full, 1);
    mbar_init(&q_empty, NCONS * 4);        // each consumer warp arrives
    for (int s = 0; s < RING; ++s) {
      mbar_init(&full[s], 1);              // the producer's TMA
      if constexpr (QUANT) mbar_init(&full[READY + s], 1);   // a converter
      mbar_init(&empty[s], NCONS * 4);
    }
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
        int b, c0;
        unit_of<NC>(P, u, b, c0);
        const int np = unit_pages<NC>(P, b, c0, lane);
        const int* trow = P.table + (size_t)b * P.nbt;
        int ids = 0;
        // whole steps of PP pages: a last page past np is the null block,
        // masked whole
        for (int j = 0; j < np + (PP - 1 - (np - 1) % PP); ++j) {
          if ((j & 31) == 0) ids = j + lane < np ? trow[j + lane] : 0;
          const int blk = __shfl_sync(0xffffffffu, ids, j & 31);
          if (lane == 0) {
#pragma unroll 1
            for (int p = 0; p < BPP; ++p, ++box) {
              const uint32_t slot = box % RING;
              mbar_wait(&empty[slot], ((box / RING) & 1) ^ 1);
              // K box (p + NBV) % NBK, or V box p - NBK
              const CUtensorMap* map = p < NBK ? &tk : &tv;
              const int x = (p < NBK ? (p + NBV) % NBK : p - NBK) * BOX;
              // over codes the codes, into the slot's upper 4 KB
              mbar_expect_tx(&full[slot], QUANT ? CODE_BOX_BYTES : BOX_BYTES);
              tma_load_4d(reinterpret_cast<unsigned char*>(
                              ring + slot * BOX_ELEMS) +
                              (QUANT ? CODE_BOX_BYTES : 0),
                          map, &full[slot], x, 0, 0, blk);
              // Q behind the first page's K boxes (before its V boxes,
              // which a ring smaller than a page holds only once the score
              // product has released K's)
              if (!QF32 && j == 0 && p == NBK - 1) {
                mbar_wait(&q_empty, (n & 1) ^ 1);
                mbar_expect_tx(&q_full, Cf::QBYTES);
#pragma unroll 1
                for (int y = 0; y < NBK; ++y)
                  tma_load_4d(sq + y * NC * BOX, &tq, &q_full, y * BOX, 0,
                              c0, b);
              }
            }
          }
          __syncwarp();
        }
      }
    } else if constexpr (QUANT) {
      // ---------------------------------------------- converters (codes)
      const int cv = warp - 1;
      uint32_t box = 0;
      for (int u = blockIdx.x; u < P.units; u += gridDim.x) {
        int b, c0;
        unit_of<NC>(P, u, b, c0);
        const int np = unit_pages<NC>(P, b, c0, lane);
        const uint32_t end = box + (np + (PP - 1 - (np - 1) % PP)) * BPP;
        // this warp's boxes of the unit: box % NCONV == cv
        for (box += (cv + NCONV - static_cast<int>(box % NCONV)) % NCONV;
             box < end; box += NCONV) {
          const uint32_t slot = box % RING;
          mbar_wait(&full[slot], (box / RING) & 1);
          if (P.code)
            widen_box<true>(ring + slot * BOX_ELEMS, lane);
          else
            widen_box<false>(ring + slot * BOX_ELEMS, lane);
          fence_proxy_async();             // for the consumers' wgmma
          __syncwarp();
          if (lane == 0) mbar_arrive(&full[READY + slot]);
        }
        box = end;
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    const int cw = tid / 128 - 1;          // columns CW cw .. + CW - 1
    const int t = tid % 128;
    const int w = t >> 5, lane = t & 31;
    const int g = lane >> 2, tq4 = lane & 3;   // fragment coordinates
    const int row = 16 * w + g;            // page rows row, row + 8
    const bool amla = P.amla != 0;
    const float NEG_INFTY = __int_as_float(0xff800000);   // -inf
    const bf16* qc = sq + cw * CW * BOX;   // this consumer's Q rows
    // page pp of a step: term x at p_hi + (pp NPT + x) CW 64
    const bf16* p_hi = sp + cw * PP * NPT * CW * BOX;
    float (*rd)[CW] = red[cw];
    float* qs = red[cw][Cf::RROWS - 1];    // over codes: sum(q) a column
    // stmatrix: lane gives the row (a P^T column) of matrix lane / 8 of
    // each x4 store k: n8 tile 2k + (lane >> 4), rows 8 (lane >> 3 & 1)
    // .. of the warp's 16, at 16-byte chunk 2w + that half (swizzled)
    uint32_t st_off[CW / 16];
#pragma unroll
    for (int k = 0; k < CW / 16; ++k) {
      const int col = 8 * (2 * k + (lane >> 4)) + (lane & 7);
      const int chunk = 2 * w + ((lane >> 3) & 1);
      st_off[k] = col * 128 + ((chunk ^ (col & 7)) << 4);
    }
    const uint32_t st_p = smem_u32(p_hi);

    uint32_t box = 0;
    uint32_t n = 0;
    for (int u = blockIdx.x; u < P.units; u += gridDim.x, ++n) {
      int b, c0;
      unit_of<NC>(P, u, b, c0);
      const int np = unit_pages<NC>(P, b, c0, lane);
      // this thread's columns: i = 2 nt + e is column 8 nt + 2 tq4 + e of
      // the consumer's CW
      const int cbase = c0 + cw * CW + 2 * tq4;
      int hz[NCOL];
      float m[NCOL], l[NCOL], z[NCOL];
#pragma unroll
      for (int i = 0; i < NCOL; ++i) {
        hz[i] = horizon(P, b, cbase + 8 * (i >> 1) + (i & 1));
        m[i] = NEG_INF;
        l[i] = 0.f;
        z[i] = 0.f;
      }
      float o[NM][CW / 2];
#pragma unroll
      for (int mt = 0; mt < NM; ++mt)
#pragma unroll
        for (int e = 0; e < CW / 2; ++e) o[mt][e] = 0.f;
      if constexpr (QF32) {
        // ---- q's three bf16 terms into this consumer's Q rows, and
        //      sum(q) in fp32 (warp w: columns w, w + 4, ...)
        bf16* qd = sq + cw * CW * BOX;
        for (int i = w; i < CW; i += 4) {
          const int c = c0 + cw * CW + i;
          const float4* src = reinterpret_cast<const float4*>(
              P.q + ((size_t)b * P.C + (c < P.C ? c : 0)) * DK);
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
              const float rem = x[e] - __bfloat162float(hi[e]);  // exact
              mid[e] = __float2bfloat16_rn(rem);
              lo[e] = __float2bfloat16_rn(rem - __bfloat162float(mid[e]));
            }
            const int at = q_at<NC>(i, 4 * f);
            const int tb = NBK * NC * BOX;
            *reinterpret_cast<uint2*>(qd + at) =
                make_uint2(pack(hi[0], hi[1]), pack(hi[2], hi[3]));
            *reinterpret_cast<uint2*>(qd + tb + at) =
                make_uint2(pack(mid[0], mid[1]), pack(mid[2], mid[3]));
            *reinterpret_cast<uint2*>(qd + 2 * tb + at) =
                make_uint2(pack(lo[0], lo[1]), pack(lo[2], lo[3]));
          }
#pragma unroll
          for (int off = 16; off; off >>= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, off);
          if (lane == 0) qs[i] = acc;
        }
        fence_proxy_async();               // for the score product
        named_bar_sync(1 + cw, 128);
      } else {
        mbar_wait(&q_full, n & 1);          // np >= 1: nbt > 0
        if constexpr (QUANT) {
          // ---- sum(q) in fp32 of the bf16 Q rows (warp w: columns w,
          //      w + 4, ...), 16-byte chunks of the swizzled tile
          for (int i = w; i < CW; i += 4) {
            const int r = cw * CW + i;
            float acc = 0.f;
            for (int ch = lane; ch < NBK * 8; ch += 32) {
              const uint4 v = *reinterpret_cast<const uint4*>(
                  sq + q_at<NC>(r, 8 * ch));
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
          named_bar_sync(1 + cw, 128);
        }
      }
      const int* trow = P.table + (size_t)b * P.nbt;
      // over codes, this step's pairs, each read a step ahead so that the
      // loads land during the step before (a pad page past np: (1, 0))
      float2 kz[PP][2], vz[PP][2];
      auto pairs = [&](int j0, float2 (&kp)[PP][2], float2 (&vp)[PP][2]) {
#pragma unroll
        for (int pp = 0; pp < PP; ++pp) {
          if (PP == 1 || j0 + pp < np) {
            const int blk = trow[j0 + pp];
            pairs_of(P.ksz, blk, row, kp[pp]);
            if constexpr (SEPV) pairs_of(P.vsz, blk, row, vp[pp]);
          } else {
            kp[pp][0] = kp[pp][1] = make_float2(1.f, 0.f);
            if constexpr (SEPV) vp[pp][0] = vp[pp][1] = kp[pp][0];
          }
        }
      };
      if constexpr (QUANT) pairs(0, kz, vz);

      for (int j = 0; j < np; j += PP, box += PP * BPP) {
        float2 kn[PP][2], vn[PP][2];       // the next step's pairs
        if constexpr (QUANT) {
          if (j + PP < np) pairs(j + PP, kn, vn);
          if constexpr (!SEPV) {           // V's pairs are K's
#pragma unroll
            for (int pp = 0; pp < PP; ++pp) {
              vz[pp][0] = kz[pp][0];
              vz[pp][1] = kz[pp][1];
            }
          }
        }
        // ---- S^T = K Q^T for each page of the step: Dk / 16 k16 steps,
        //      4 to a box, NQ Q terms each
        float s[PP][CW / 2];
        wgmma_fence();
#pragma unroll
        for (int pp = 0; pp < PP; ++pp)
#pragma unroll
          for (int p = 0; p < NBK; ++p) {
            const uint32_t nb = box + pp * BPP + p;
            mbar_wait(&full[READY + nb % RING], (nb / RING) & 1);
            const bf16* kt = ring + (nb % RING) * BOX_ELEMS;
            const bf16* qt = qc + ((p + NBV) % NBK) * NC * BOX;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const uint64_t da = desc_sw128(kt + 16 * kk, 16, 1024);
#pragma unroll
              for (int x = 0; x < NQ; ++x) {
                const uint64_t db =
                    desc_sw128(qt + x * NBK * NC * BOX + 16 * kk, 16, 1024);
                if (p == 0 && kk == 0 && x == 0)
                  mma<CW, true, false>(s[pp], da, db);
                else
                  mma<CW, false, false>(s[pp], da, db);
              }
            }
          }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int pp = 0; pp < PP; ++pp) fence_regs(s[pp]);
        __syncwarp();
        if (lane == 0) {                   // the K boxes outside V
#pragma unroll
          for (int pp = 0; pp < PP; ++pp)
#pragma unroll
            for (int p = 0; p < KREL; ++p)
              mbar_arrive(&empty[(box + pp * BPP + p) % RING]);
          // the unit's last Q read
          if (!QF32 && j + PP >= np) mbar_arrive(&q_empty);
        }

        // ---- (codes: each row's affine,) scale, mask, the column max over
        //      the step's 64 PP rows (a pad page past np: -inf at every
        //      row, so that it adds exactly nothing)
        float mx[NCOL];
#pragma unroll
        for (int i = 0; i < NCOL; ++i) {
          const int nt = i >> 1, e = i & 1;
          float qsum = 0.f;
          if constexpr (QUANT) qsum = qs[8 * nt + 2 * tq4 + e];
#pragma unroll
          for (int pp = 0; pp < PP; ++pp) {
            const int kp = (j + pp) * PAGE + row;
            const bool live = PP == 1 || j + pp < np;
            const float masked = live ? NEG_INF : NEG_INFTY;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float x = s[pp][4 * nt + 2 * h + e];
              if constexpr (QUANT) x = kz[pp][h].x * x + kz[pp][h].y * qsum;
              x = live && kp + 8 * h <= hz[i] ? x * P.scale : masked;
              if (amla) x *= LOG2E;        // log2 domain
              s[pp][4 * nt + 2 * h + e] = x;
            }
            const float m2 = fmaxf(s[pp][4 * nt + e], s[pp][4 * nt + 2 + e]);
            mx[i] = pp == 0 ? m2 : fmaxf(mx[i], m2);
          }
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
        }
        if (g == 0) {
#pragma unroll
          for (int i = 0; i < NCOL; ++i)
            rd[w][8 * (i >> 1) + 2 * tq4 + (i & 1)] = mx[i];
        }
        named_bar_sync(1 + cw, 128);

        // ---- the new stats, p = exp(x - m), l's (and Z's) partial sums,
        //      O^T's rescale (a column's corr is in the threads holding
        //      it); over codes s keeps scale_r p for P V
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
          float sum, zs;
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
          if constexpr (QUANT) z[i] = z[i] * corr[i] + zs;
        }
#pragma unroll
        for (int mt = 0; mt < NM; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              o[mt][4 * nt + e] *= corr[2 * nt + (e & 1)];

        // ---- P^T in NPT bf16 terms (hi, [mid,] lo), stored transposed
        //      into each page's tiles
#pragma unroll
        for (int pp = 0; pp < PP; ++pp)
#pragma unroll
          for (int k = 0; k < CW / 16; ++k) {
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
            const uint32_t tile = st_p + pp * NPT * CW * BOX * 2 + st_off[k];
            stmatrix_x4_trans(tile, hi);
            if constexpr (NPT == 3) {
              stmatrix_x4_trans(tile + CW * BOX * 2, mid);
              stmatrix_x4_trans(tile + 2 * CW * BOX * 2, lo);
            } else {
              stmatrix_x4_trans(tile + CW * BOX * 2, lo);
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
              mbar_wait(&full[READY + nb % RING], (nb / RING) & 1);
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
                  p_hi + (pp * NPT + x) * CW * BOX + 16 * kk, 16, 1024);
#pragma unroll
              for (int mt = 0; mt < NM; ++mt) {
                const bf16* vt =
                    ring + ((box + pp * BPP + KREL + mt) % RING) * BOX_ELEMS;
                mma<CW, false, true>(
                    o[mt], desc_sw128(vt + 16 * kk * BOX, BOX_BYTES, 1024),
                    dp);
              }
            }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int mt = 0; mt < NM; ++mt) fence_regs(o[mt]);
        __syncwarp();
        if (lane == 0) {                   // the V boxes
#pragma unroll
          for (int pp = 0; pp < PP; ++pp)
#pragma unroll
            for (int p = KREL; p < BPP; ++p)
              mbar_arrive(&empty[(box + pp * BPP + p) % RING]);
        }
        if constexpr (QUANT) {
          if (j + PP < np) {
#pragma unroll
            for (int pp = 0; pp < PP; ++pp)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                kz[pp][h] = kn[pp][h];
                if constexpr (SEPV) vz[pp][h] = vn[pp][h];
              }
          }
        }
      }

      // ---- epilogue: l (and Z) over the 64 rows, then out = (O^T [+ Z])
      //      / l in q's type
#pragma unroll
      for (int i = 0; i < NCOL; ++i) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
          if constexpr (QUANT) z[i] += __shfl_xor_sync(0xffffffffu, z[i], off);
        }
      }
      named_bar_sync(1 + cw, 128);         // rd's last readers are done
      if (g == 0) {
#pragma unroll
        for (int i = 0; i < NCOL; ++i) {
          rd[w][8 * (i >> 1) + 2 * tq4 + (i & 1)] = l[i];
          if constexpr (QUANT) rd[4 + w][8 * (i >> 1) + 2 * tq4 + (i & 1)] = z[i];
        }
      }
      named_bar_sync(1 + cw, 128);
#pragma unroll
      for (int i = 0; i < NCOL; ++i) {
        const int col = 8 * (i >> 1) + 2 * tq4 + (i & 1);
        l[i] = (rd[0][col] + rd[1][col]) + (rd[2][col] + rd[3][col]);
        if constexpr (QUANT)
          z[i] = (rd[4][col] + rd[5][col]) + (rd[6][col] + rd[7][col]);
      }
      named_bar_sync(1 + cw, 128);         // before the next unit's rd
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
            float a0 = o[mt][4 * nt + 2 * h], a1 = o[mt][4 * nt + 2 * h + 1];
            if constexpr (QUANT) {
              a0 += z[2 * nt];
              a1 += z[2 * nt + 1];
            }
            const float v0 = a0 / l[2 * nt];
            const float v1 = a1 / l[2 * nt + 1];
            const float y = __shfl_xor_sync(0xffffffffu, odd ? v0 : v1, 4);
            const int dv = 64 * mt + row + 8 * h - (odd ? 1 : 0);
            if (col < P.C) {
              const size_t at = ((size_t)b * P.C + col) * DV + dv;
              if constexpr (QF32)
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
}

// The unit width for B rows of C columns: 64, or 32 where 64-column
// units would leave SMs idle.
int unit_cols(int B, int C, int sms) {
  return static_cast<long long>(B) * ((C + 63) / 64) < sms ? 32 : 64;
}

// The operands of one launch: q (bf16, or fp32 with QF32), the K and V
// pools (bf16 rows, or codes with QUANT; V null when fused).
struct Operands {
  const void* q;
  const void* k_pool;
  const void* v_pool;
};

template <int DK, int DV, bool SEPV, int CW, bool QUANT, bool QF32>
int launch_cols(const Operands& a, Params p, int B, int dev, int sms,
                void* stream) {
  using Cf = Cfg<DK, DV, SEPV, CW, QUANT, QF32>;
  p.ntile = (p.C + Cf::NC - 1) / Cf::NC;
  p.units = B * p.ntile;
  const auto pool_map = QUANT ? code_rows_map : bf16_rows_map;
  CUtensorMap tq, tk, tv;
  int err = pool_map(&tk, a.k_pool, DK, 1, PAGE, MAX_POOL_BLOCKS, DK, DK,
                     static_cast<long long>(PAGE) * DK, PAGE);
  if (err == 0 && !QF32)
    err = bf16_rows_map(&tq, a.q, DK, 1, p.C, B, DK, DK,
                        static_cast<long long>(p.C) * DK, Cf::NC);
  if (err == 0 && SEPV)
    err = pool_map(&tv, a.v_pool, DV, 1, PAGE, MAX_POOL_BLOCKS, DV, DV,
                   static_cast<long long>(PAGE) * DV, PAGE);
  if (err != 0) return err;
  if (QF32) tq = tk;                       // no Q map: the consumers split q
  if (!SEPV) tv = tk;                      // the fused kernel reads no tv
  auto kernel = etap_prefill_kernel<DK, DV, SEPV, CW, QUANT, QF32>;
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

// Launch at the unit width the grid picks (always 32 columns with fp32 q).
template <int DK, int DV, bool SEPV, bool QUANT>
int launch(const Operands& a, Params p, int B, int qf32, void* stream) {
  if (B <= 0 || p.C <= 0 || p.H <= 0 || p.nbt <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dev = current_device();
  const int sms = dev < 0 ? 0 : sm_count(dev);
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  if constexpr (QUANT) {
    if (qf32)
      return launch_cols<DK, DV, SEPV, 16, true, true>(a, p, B, dev, sms,
                                                       stream);
  }
  if (unit_cols(B, p.C, sms) == 32)
    return launch_cols<DK, DV, SEPV, 16, QUANT, false>(a, p, B, dev, sms,
                                                       stream);
  return launch_cols<DK, DV, SEPV, 32, QUANT, false>(a, p, B, dev, sms,
                                                     stream);
}

Params make_params(const int* table, const int* start, const int* qpos,
                   void* out, int C, int H, int nbt, float scale, int amla) {
  Params p{};
  p.table = table;
  p.start = start;
  p.qpos = qpos;
  p.out = out;
  p.C = C;
  p.H = H;
  p.nbt = nbt;
  p.scale = scale;
  p.amla = amla;
  return p;
}

// K4q's parameters beyond K4's: the pairs, the code type and fp32 q.
int quant_params(Params& p, const void* q, const float* k_sz,
                 const float* v_sz, int code, int qf32) {
  if ((code != 0 && code != 1) || (qf32 != 0 && qf32 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  p.q = qf32 ? static_cast<const float*>(q) : nullptr;
  p.ksz = k_sz;
  p.vsz = v_sz;
  p.code = code;
  return 0;
}

template <int DK, int DV, bool SEPV, int CW, bool QUANT, bool QF32>
int attrs_cols(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, etap_prefill_kernel<DK, DV, SEPV, CW, QUANT, QF32>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = Cfg<DK, DV, SEPV, CW, QUANT, QF32>::SMEM;
  out[2] = static_cast<int>(a.localSizeBytes);
  return 0;
}

// The attributes of the instance at (dk, dv), fused (sepv 0: the latent
// only) or over separate pools, with units of `cols` columns.
template <bool QUANT, bool QF32>
int attrs(int dk, int dv, int sepv, int cols, int* out) {
  if (cols != 64 && cols != 32) return static_cast<int>(cudaErrorInvalidValue);
  if (QF32 && cols != 32) return static_cast<int>(cudaErrorInvalidValue);
  if (!sepv) {
    if (dk != LATENT_DK || dv != LATENT_DV)
      return static_cast<int>(cudaErrorInvalidValue);
    if constexpr (QF32)
      return attrs_cols<LATENT_DK, LATENT_DV, false, 16, true, true>(out);
    else
      return cols == 64
                 ? attrs_cols<LATENT_DK, LATENT_DV, false, 32, QUANT, false>(
                       out)
                 : attrs_cols<LATENT_DK, LATENT_DV, false, 16, QUANT, false>(
                       out);
  }
  return with_widths<PagedSepWidths>(dk, dv, [&](auto DK, auto DV) {
    constexpr int KD = decltype(DK)::value, VD = decltype(DV)::value;
    if constexpr (QF32)
      return attrs_cols<KD, VD, true, 16, true, true>(out);
    else
      return cols == 64 ? attrs_cols<KD, VD, true, 32, QUANT, false>(out)
                        : attrs_cols<KD, VD, true, 16, QUANT, false>(out);
  });
}

}  // namespace

extern "C" {

// K4: q [B, Cq*H, DK]; pool [N, PAGE, DK]; table [B, nbt]; start [B];
// qpos [B, Cq*H] or null; out [B, Cq*H, DV] — bf16 / int32, contiguous,
// 16-byte aligned.
int etap_prefill_mla_paged(const void* q, const void* pool, const int* table,
                           const int* start, const int* qpos, void* out,
                           int B, int C, int H, int nbt, float scale,
                           int amla, void* stream) {
  return launch<LATENT_DK, LATENT_DV, false, false>(
      {q, pool, nullptr},
      make_params(table, start, qpos, out, C, H, nbt, scale, amla), B, 0,
      stream);
}

// K4, separate V: q [B, Cq*H, dk]; k_pool [N, PAGE, dk], v_pool [N, PAGE,
// dv]; start [B]; qpos [B, Cq*H] or null; out [B, Cq*H, dv]; (dk, dv) one
// of PagedSepWidths.
int etap_prefill_paged(const void* q, const void* k_pool, const void* v_pool,
                       const int* table, const int* start, const int* qpos,
                       void* out, int B, int C, int H, int nbt, int dk,
                       int dv, float scale, int amla, void* stream) {
  const Params p = make_params(table, start, qpos, out, C, H, nbt, scale,
                               amla);
  return with_widths<PagedSepWidths>(dk, dv, [&](auto DK, auto DV) {
    return launch<decltype(DK)::value, decltype(DV)::value, true, false>(
        {q, k_pool, v_pool}, p, B, 0, stream);
  });
}

// K4q: as K4 over an int8 (code 0) or e4m3 (code 1) pool [N, PAGE, DK]
// with its (scale, zp) pool sz [N, PAGE, 2] fp32; q bf16, or fp32 with
// qf32 set, and out in q's type.
int etap_prefill_mla_paged_quant(const void* q, const void* pool,
                                 const float* sz, const int* table,
                                 const int* start, const int* qpos, void* out,
                                 int B, int C, int H, int nbt, float scale,
                                 int amla, int code, int qf32, void* stream) {
  Params p = make_params(table, start, qpos, out, C, H, nbt, scale, amla);
  const int err = quant_params(p, q, sz, sz, code, qf32);
  if (err != 0) return err;
  return launch<LATENT_DK, LATENT_DV, false, true>({q, pool, nullptr}, p, B,
                                                   qf32, stream);
}

// K4q, separate V: as K4, separate V over int8 (code 0) or e4m3 (code 1)
// pools, K's and V's codes each with its own (scale, zp) pool [N, PAGE, 2]
// fp32; q bf16, or fp32 with qf32 set, and out in q's type.
int etap_prefill_paged_quant(const void* q, const void* k_pool,
                             const float* k_sz, const void* v_pool,
                             const float* v_sz, const int* table,
                             const int* start, const int* qpos, void* out,
                             int B, int C, int H, int nbt, int dk, int dv,
                             float scale, int amla, int code, int qf32,
                             void* stream) {
  Params p = make_params(table, start, qpos, out, C, H, nbt, scale, amla);
  const int err = quant_params(p, q, k_sz, v_sz, code, qf32);
  if (err != 0) return err;
  return with_widths<PagedSepWidths>(dk, dv, [&](auto DK, auto DV) {
    return launch<decltype(DK)::value, decltype(DV)::value, true, true>(
        {q, k_pool, v_pool}, p, B, qf32, stream);
  });
}

// The registers, dynamic shared memory and local memory (spills) of K4 at
// (dk, dv), fused (sepv 0: the latent only) or over separate pools, with
// units of `cols` (64 or 32) columns, into out[0..2].  The registers are
// the launch's (168 a thread for 384 threads); setmaxnreg moves them to
// 40 in the producer and 232 in the consumers.
int etap_prefill_attrs(int dk, int dv, int sepv, int cols, int* out) {
  return attrs<false, false>(dk, dv, sepv, cols, out);
}

// The same for K4q's instance (the code type is a run-time choice), with
// fp32 q (qf32 set: units of 32 columns only) or bf16 q.
int etap_prefill_quant_attrs(int dk, int dv, int sepv, int cols, int qf32,
                             int* out) {
  return qf32 ? attrs<true, true>(dk, dv, sepv, cols, out)
              : attrs<true, false>(dk, dv, sepv, cols, out);
}

}  // extern "C"
