// K4, the chunked paged ETAP prefill and draft verify over bf16 pools, for
// Hopper (sm_90a): wgmma on the page's 64 rows, a TMA ring of 64 x 64
// boxes, one producer warp and two consumer warpgroups, a persistent grid.
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
//
// Built at three instances: DeepSeek's latent (576, 512) with V the page's
// first 512 columns (fused), the latent with V in a pool of its own, and
// Granite-20B's MQA head (128, 128) over separate K and V pools
// (mma_tile.cuh's PagedSepWidths).  The fused and separate-V instances are
// one template that differs only in where V's boxes come from, so over a V
// pool that holds the fused pool's first 512 columns they give the fused
// kernel's bits.  K4 over int8 / e4m3 code pools (K4q) stays on
// etap_body.cuh (etap_quant.cu, etap_sepv.cu).
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
// The design (hopper.cuh holds the building blocks).  A work unit is NC
// columns of one batch row (NC = 64, or 32 where B ceil(C / 64) units
// would leave SMs idle); units run on a persistent grid of min(units,
// SMs) CTAs, CTA i taking units i, i + grid, ..., each row's tiles last
// first (in a prefill chunk the later columns walk further).  A CTA is
// three warpgroups.  One warp of the first (the producer; setmaxnreg 40)
// issues every load with TMA: the unit's Q tile (NC rows, one 64-column
// box per 64 of Dk) and the pages' boxes, each page's K boxes in the
// score product's k order (the latent's rope box 8 first, then 0-7) and,
// with a separate V, its V boxes after them, into a ring of RING boxes of
// 64 rows x 128 bytes, each with a full barrier (the bytes landed) and an
// empty one (both consumers done with it).  Each consumer warpgroup
// (setmaxnreg 232) owns CW = NC / 2 of the unit's columns outright and
// takes PP pages a step (2 at Granite's 128, whose ring holds several
// steps; 1 at the latent):
//   S^T [64, CW] a page: Dk / 16 SS wgmmas m64nCWk16, A = the K page, B =
//     its Q columns, both K-major; the first k-step writes S^T only;
//   the per-column max over the step's 64 PP rows: a thread's rows, a
//     shuffle over the warp's 8 row groups, and the 4 warps' maxima
//     exchanged through 512 bytes of shared memory under a named barrier
//     (the transposed form's own cost); l stays a per-thread partial sum
//     until the unit's end; a column's corr is in the registers of the
//     threads that hold its O^T columns (S^T and O^T share the n layout);
//   P^T: the fragments of p_hi and p_lo stored transposed (stmatrix) into
//     a 128-byte-swizzled K-major [CW][64] tile each a page, a proxy fence
//     and a named barrier;
//   O^T += V^T P^T: per page, k16 step and m-tile of Dv, an SS wgmma with
//     A = V's box read MN-major (the transpose-A bit) and B = P^T, hi
//     then lo.
// A step whose last page lies past the walk (an odd page count at PP 2)
// takes the null block there, masked whole with -inf whatever the
// horizons (a horizon may lie past the table), so it adds exactly
// nothing.  The boxes a page is done with go back to the producer as soon
// as their product has finished: the K boxes outside V after the score
// product, the V boxes after P V.  So the latent's fused ring of 17 boxes
// holds the next page's 9 while P V reads this page's 8, and the
// separate-V latent's 17 boxes (one page, K then V) load the next page's
// K during this page's P V and its V during the next score product.
//
// Shared memory (bytes) at NC = 64: Q NC x 1152 = 73,728 at the latent
// (16,384 at 128), P^T hi + lo 2 x 2 x 32 x 128 = 16,384 a page of a step,
// the ring 17 boxes (139,264) at the latent, fused or not, 22 at 128; with
// the barriers and the max exchange 231,792 of the 232,448 a CTA may use
// at the latent.  Registers: O^T [Dv, 32] fp32 is 128 a consumer thread at
// the latent (8 m-tiles of 16), S^T 16.
//
// What bounds it on the H100.  The bound chip_smoke.py states is the
// operations: a column c attends over horizon + 1 keys, 2 (Dk + Dv) FLOPs
// each.  The kernel's tensor work is whole pages for whole tiles, and P's
// lo term repeats the P V product once more (13.1 MFLOP a latent page of
// a 64-column unit, against 7.2 for the bound's count); wgmma at N = 32
// reads 3 KB of operands from shared memory for 65.5 KFLOP.  What held it
// on the card (variant builds, PERF.md): a consumer's score product,
// softmax and P V run in series, the two consumers in phase, so the
// tensor cores wait out each page's softmax chain (the chain alone sets
// Granite's pace, hence its page pairs); and each unit reads its pages
// from L2 again, 72 KB a latent page for 64 columns.  A ring that lets
// the next page's score product run beside this page's softmax needs room
// for two pages beside Q and P, which the latent's 64-column Q tile
// leaves no room for.
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
constexpr int NCONS = 2;                   // consumer warpgroups
constexpr int NTHREAD = 128 * (NCONS + 1);
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int SMEM_LIMIT = 232448;         // a CTA's shared memory on the H100
constexpr int MAX_POOL_BLOCKS = INT_MAX;   // a pool map's block extent
static_assert(128 * PRODUCER_REGS + 128 * NCONS * CONSUMER_REGS <= 65536,
              "the register file");

template <int DK, int DV, bool SEPV, int CW>
struct Cfg {
  static_assert(DK % BOX == 0 && DV % BOX == 0 && DV <= DK, "whole boxes");
  static_assert(CW == 32 || CW == 16, "32 or 16 columns a consumer");
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
  static constexpr int QBYTES = NBK * NC * BOX * 2;
  static constexpr int PBYTES = NCONS * PP * 2 * CW * BOX * 2;
  // the static shared memory beside: the barriers (2 + 2 x at most
  // MAX_RING) and the consumers' max exchange
  static constexpr int MAX_RING = 24;
  static constexpr int STATIC = (2 + 2 * MAX_RING) * 8 + NCONS * 4 * CW * 4;
  static constexpr int FIT =
      (SMEM_LIMIT - 1024 - STATIC - QBYTES - PBYTES) / BOX_BYTES;
  static constexpr int RING = FIT < MAX_RING ? FIT : MAX_RING;
  static_assert(RING >= PP * BPP, "a step's boxes fit the ring");
  static constexpr int SMEM = 1024 + QBYTES + PBYTES + RING * BOX_BYTES;
};

struct Params {
  const int* table;    // [B, nbt] pool block ids
  const int* start;    // [B] rows before the chunk
  const int* qpos;     // [B, C] explicit horizons (verify), or null
  bf16* out;           // [B, C, DV], contiguous
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

template <int DK, int DV, bool SEPV, int CW>
__global__ void __launch_bounds__(NTHREAD, 1) etap_prefill_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const Params P) {
  using Cf = Cfg<DK, DV, SEPV, CW>;
  constexpr int NC = Cf::NC, NBK = Cf::NBK, NBV = Cf::NBV, NM = Cf::NM;
  constexpr int BPP = Cf::BPP, KREL = Cf::KREL, RING = Cf::RING;
  constexpr int PP = Cf::PP;
  constexpr int NT = CW / 8;               // n8 tiles of a consumer
  constexpr int NCOL = CW / 4;             // columns a thread holds
  extern __shared__ unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* sp = sq + NBK * NC * BOX;          // [NCONS][PP][hi, lo][CW][64]
  bf16* ring = sp + NCONS * PP * 2 * CW * BOX;   // [RING][64][64]
  __shared__ uint64_t q_full, q_empty;
  __shared__ uint64_t full[RING], empty[RING];
  __shared__ float red[NCONS][4][CW];      // the 4 warps' column values

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&q_full, 1);
    mbar_init(&q_empty, NCONS * 4);        // each consumer warp arrives
    for (int s = 0; s < RING; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCONS * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid >= 32) return;
    const int lane = tid;
    if (lane == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      if constexpr (SEPV) tma_prefetch_map(&tv);
    }
    uint32_t box = 0;                      // boxes issued, all units
    uint32_t n = 0;                        // units begun
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
            mbar_expect_tx(&full[slot], BOX_BYTES);
            bf16* dst = ring + slot * BOX_ELEMS;
            if (p < NBK)                   // K box (p + NBV) % NBK
              tma_load_4d(dst, &tk, &full[slot], ((p + NBV) % NBK) * BOX, 0,
                          0, blk);
            else
              tma_load_4d(dst, &tv, &full[slot], (p - NBK) * BOX, 0, 0, blk);
          }
          if (j == 0) {                    // Q behind the first page
            mbar_wait(&q_empty, (n & 1) ^ 1);
            mbar_expect_tx(&q_full, Cf::QBYTES);
#pragma unroll 1
            for (int x = 0; x < NBK; ++x)
              tma_load_4d(sq + x * NC * BOX, &tq, &q_full, x * BOX, 0, c0, b);
          }
        }
        __syncwarp();
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
    // page pp of a step: hi at p_hi + pp 2 CW 64, lo CW 64 after it
    const bf16* p_hi = sp + cw * PP * 2 * CW * BOX;
    float (*rd)[CW] = red[cw];
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
    const uint32_t st_hi = smem_u32(p_hi), st_lo = st_hi + CW * BOX * 2;


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
      float m[NCOL], l[NCOL];
#pragma unroll
      for (int i = 0; i < NCOL; ++i) {
        hz[i] = horizon(P, b, cbase + 8 * (i >> 1) + (i & 1));
        m[i] = NEG_INF;
        l[i] = 0.f;
      }
      float o[NM][CW / 2];
#pragma unroll
      for (int mt = 0; mt < NM; ++mt)
#pragma unroll
        for (int e = 0; e < CW / 2; ++e) o[mt][e] = 0.f;
      mbar_wait(&q_full, n & 1);            // np >= 1: nbt > 0

      for (int j = 0; j < np; j += PP, box += PP * BPP) {
        // ---- S^T = K Q^T for each page of the step: Dk / 16 k16 steps,
        //      4 to a box
        float s[PP][CW / 2];
        wgmma_fence();
#pragma unroll
        for (int pp = 0; pp < PP; ++pp)
#pragma unroll
          for (int p = 0; p < NBK; ++p) {
            const uint32_t nb = box + pp * BPP + p;
            mbar_wait(&full[nb % RING], (nb / RING) & 1);
            const bf16* kt = ring + (nb % RING) * BOX_ELEMS;
            const bf16* qt = qc + ((p + NBV) % NBK) * NC * BOX;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const uint64_t da = desc_sw128(kt + 16 * kk, 16, 1024);
              const uint64_t db = desc_sw128(qt + 16 * kk, 16, 1024);
              if (p == 0 && kk == 0)
                mma<CW, true, false>(s[pp], da, db);
              else
                mma<CW, false, false>(s[pp], da, db);
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
          if (j + PP >= np) mbar_arrive(&q_empty);  // the unit's last Q read
        }

        // ---- scale, mask, the column max over the step's 64 PP rows (a
        //      pad page past np: -inf at every row, so that it adds
        //      exactly nothing)
        float mx[NCOL];
#pragma unroll
        for (int i = 0; i < NCOL; ++i) {
          const int nt = i >> 1, e = i & 1;
#pragma unroll
          for (int pp = 0; pp < PP; ++pp) {
            const int kp = (j + pp) * PAGE + row;
            const bool live = PP == 1 || j + pp < np;
            const float masked = live ? NEG_INF : NEG_INFTY;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float x = live && kp + 8 * h <= hz[i]
                            ? s[pp][4 * nt + 2 * h + e] * P.scale
                            : masked;
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

        // ---- the new stats, p = exp(x - m), l's partial sums, O^T's
        //      rescale (a column's corr is in the threads holding it)
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
#pragma unroll
          for (int pp = 0; pp < PP; ++pp) {
            const float p0 = prob_exp(s[pp][4 * nt + e] - m_new, amla);
            const float p1 = prob_exp(s[pp][4 * nt + 2 + e] - m_new, amla);
            s[pp][4 * nt + e] = p0;
            s[pp][4 * nt + 2 + e] = p1;
            sum = pp == 0 ? p0 + p1 : sum + (p0 + p1);
          }
          l[i] = l[i] * corr[i] + sum;
        }
#pragma unroll
        for (int mt = 0; mt < NM; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              o[mt][4 * nt + e] *= corr[2 * nt + (e & 1)];

        // ---- P^T, hi and lo, stored transposed into each page's tiles
#pragma unroll
        for (int pp = 0; pp < PP; ++pp)
#pragma unroll
          for (int k = 0; k < CW / 16; ++k) {
            uint32_t hi[4], lo[4];
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const float* f = &s[pp][4 * (2 * k + (x >> 1)) + 2 * (x & 1)];
              const __nv_bfloat162 h2 = __floats2bfloat162_rn(f[0], f[1]);
              const float2 back = __bfloat1622float2(h2);
              const __nv_bfloat162 l2 =
                  __floats2bfloat162_rn(f[0] - back.x, f[1] - back.y);
              hi[x] = *reinterpret_cast<const uint32_t*>(&h2);
              lo[x] = *reinterpret_cast<const uint32_t*>(&l2);
            }
            const uint32_t tile = pp * 2 * CW * BOX * 2;
            stmatrix_x4_trans(st_hi + tile + st_off[k], hi);
            stmatrix_x4_trans(st_lo + tile + st_off[k], lo);
          }
        fence_proxy_async();
        named_bar_sync(1 + cw, 128);

        // ---- O^T += V^T P^T: V box mt of page pp at position KREL + mt,
        //      MN-major
        if constexpr (SEPV) {
#pragma unroll
          for (int pp = 0; pp < PP; ++pp)
#pragma unroll
            for (int v = 0; v < NBV; ++v) {
              const uint32_t nb = box + pp * BPP + KREL + v;
              mbar_wait(&full[nb % RING], (nb / RING) & 1);
            }
        }
        wgmma_fence();
#pragma unroll
        for (int pp = 0; pp < PP; ++pp)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const bf16* ph = p_hi + pp * 2 * CW * BOX + 16 * kk;
            const uint64_t dh = desc_sw128(ph, 16, 1024);
            const uint64_t dl = desc_sw128(ph + CW * BOX, 16, 1024);
#pragma unroll
            for (int mt = 0; mt < NM; ++mt) {
              const bf16* vt =
                  ring + ((box + pp * BPP + KREL + mt) % RING) * BOX_ELEMS;
              mma<CW, false, true>(
                  o[mt], desc_sw128(vt + 16 * kk * BOX, BOX_BYTES, 1024), dh);
            }
#pragma unroll
            for (int mt = 0; mt < NM; ++mt) {
              const bf16* vt =
                  ring + ((box + pp * BPP + KREL + mt) % RING) * BOX_ELEMS;
              mma<CW, false, true>(
                  o[mt], desc_sw128(vt + 16 * kk * BOX, BOX_BYTES, 1024), dl);
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
      }

      // ---- epilogue: l over the 64 rows, then out = O^T / l in bf16
#pragma unroll
      for (int i = 0; i < NCOL; ++i) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
      }
      named_bar_sync(1 + cw, 128);         // rd's last readers are done
      if (g == 0) {
#pragma unroll
        for (int i = 0; i < NCOL; ++i)
          rd[w][8 * (i >> 1) + 2 * tq4 + (i & 1)] = l[i];
      }
      named_bar_sync(1 + cw, 128);
#pragma unroll
      for (int i = 0; i < NCOL; ++i) {
        const int col = 8 * (i >> 1) + 2 * tq4 + (i & 1);
        l[i] = (rd[0][col] + rd[1][col]) + (rd[2][col] + rd[3][col]);
      }
      named_bar_sync(1 + cw, 128);         // before the next unit's rd
      // a pair of adjacent Dv rows per 4-byte store: the lanes of row
      // groups g and g ^ 1 trade one column's value each
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
            if (col < P.C)
              *reinterpret_cast<__nv_bfloat162*>(
                  &P.out[((size_t)b * P.C + col) * DV + dv]) =
                  odd ? __floats2bfloat162_rn(y, v1)
                      : __floats2bfloat162_rn(v0, y);
          }
      }
    }
  }
}

constexpr int MAX_DEVICES = 64;

// The current device, or -1.
int current_device() {
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess && dev >= 0 &&
                 dev < MAX_DEVICES
             ? dev
             : -1;
}

// The SM count of device dev, asked once a device.
int sm_count(int dev) {
  static std::atomic<int> cached[MAX_DEVICES];
  int n = cached[dev].load(std::memory_order_relaxed);
  if (n > 0) return n;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  cached[dev].store(n, std::memory_order_relaxed);
  return n;
}

// The unit width for B rows of C columns: 64, or 32 where 64-column
// units would leave SMs idle.
int unit_cols(int B, int C, int sms) {
  return static_cast<long long>(B) * ((C + 63) / 64) < sms ? 32 : 64;
}

template <int DK, int DV, bool SEPV, int CW>
int launch_cols(const void* q, const void* k_pool, const void* v_pool,
                Params p, int B, int dev, int sms, void* stream) {
  using Cf = Cfg<DK, DV, SEPV, CW>;
  p.ntile = (p.C + Cf::NC - 1) / Cf::NC;
  p.units = B * p.ntile;
  CUtensorMap tq, tk, tv;
  int err = bf16_rows_map(&tq, q, DK, 1, p.C, B, DK, DK,
                          static_cast<long long>(p.C) * DK, Cf::NC);
  if (err == 0)
    err = bf16_rows_map(&tk, k_pool, DK, 1, PAGE, MAX_POOL_BLOCKS, DK, DK,
                        static_cast<long long>(PAGE) * DK, PAGE);
  if (err == 0 && SEPV)
    err = bf16_rows_map(&tv, v_pool, DV, 1, PAGE, MAX_POOL_BLOCKS, DV, DV,
                        static_cast<long long>(PAGE) * DV, PAGE);
  if (err != 0) return err;
  if (!SEPV) tv = tk;                      // the fused kernel reads no tv
  auto kernel = etap_prefill_kernel<DK, DV, SEPV, CW>;
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

template <int DK, int DV, bool SEPV>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* table, const int* start, const int* qpos, void* out,
           int B, int C, int H, int nbt, float scale, int amla,
           void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || nbt <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dev = current_device();
  const int sms = dev < 0 ? 0 : sm_count(dev);
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  Params p{};
  p.table = table;
  p.start = start;
  p.qpos = qpos;
  p.out = static_cast<bf16*>(out);
  p.C = C;
  p.H = H;
  p.nbt = nbt;
  p.scale = scale;
  p.amla = amla;
  if (unit_cols(B, C, sms) == 32)
    return launch_cols<DK, DV, SEPV, 16>(q, k_pool, v_pool, p, B, dev, sms,
                                         stream);
  return launch_cols<DK, DV, SEPV, 32>(q, k_pool, v_pool, p, B, dev, sms,
                                       stream);
}

template <int DK, int DV, bool SEPV, int CW>
int attrs_cols(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err =
      cudaFuncGetAttributes(&a, etap_prefill_kernel<DK, DV, SEPV, CW>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = Cfg<DK, DV, SEPV, CW>::SMEM;
  out[2] = static_cast<int>(a.localSizeBytes);
  return 0;
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
  return launch<LATENT_DK, LATENT_DV, false>(q, pool, nullptr, table, start,
                                             qpos, out, B, C, H, nbt, scale,
                                             amla, stream);
}

// K4, separate V: q [B, Cq*H, dk]; k_pool [N, PAGE, dk], v_pool [N, PAGE,
// dv]; start [B]; qpos [B, Cq*H] or null; out [B, Cq*H, dv]; (dk, dv) one
// of PagedSepWidths.
int etap_prefill_paged(const void* q, const void* k_pool, const void* v_pool,
                       const int* table, const int* start, const int* qpos,
                       void* out, int B, int C, int H, int nbt, int dk,
                       int dv, float scale, int amla, void* stream) {
  return with_widths<PagedSepWidths>(dk, dv, [&](auto DK, auto DV) {
    return launch<decltype(DK)::value, decltype(DV)::value, true>(
        q, k_pool, v_pool, table, start, qpos, out, B, C, H, nbt, scale,
        amla, stream);
  });
}

// The registers, dynamic shared memory and local memory (spills) of K4 at
// (dk, dv), fused (sepv 0: the latent only) or over separate pools, with
// units of `cols` (64 or 32) columns, into out[0..2].  The registers are
// the launch's (168 a thread for 384 threads); setmaxnreg moves them to
// 40 in the producer and 232 in the consumers.
int etap_prefill_attrs(int dk, int dv, int sepv, int cols, int* out) {
  if (cols != 64 && cols != 32) return static_cast<int>(cudaErrorInvalidValue);
  if (!sepv) {
    if (dk != LATENT_DK || dv != LATENT_DV)
      return static_cast<int>(cudaErrorInvalidValue);
    return cols == 64 ? attrs_cols<LATENT_DK, LATENT_DV, false, 32>(out)
                      : attrs_cols<LATENT_DK, LATENT_DV, false, 16>(out);
  }
  return with_widths<PagedSepWidths>(dk, dv, [&](auto DK, auto DV) {
    constexpr int KD = decltype(DK)::value, VD = decltype(DV)::value;
    return cols == 64 ? attrs_cols<KD, VD, true, 32>(out)
                      : attrs_cols<KD, VD, true, 16>(out);
  });
}

}  // extern "C"
