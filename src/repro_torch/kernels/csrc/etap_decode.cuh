// The bf16 ETAP decode kernels for Hopper (sm_90a): wgmma on the page's 64
// rows, a TMA ring of 64 x 64 boxes, one producer warp and two consumer
// warpgroups, a persistent grid.  One template serves the single pass
// (STATS false: K3 paged, K5 dense) and the split-KV partial (STATS true:
// K1 paged, K6 dense) at every width and address mode they are built at;
// etap_decode.cu instantiates the paged kernels and etap.cu the dense ones
// (separate sources, so the two compile in parallel).  Each source's
// header says which pallas_call bodies it replaces.  The quantized twins
// (K3q, K1q, K5q, K6q) stay on etap_body.cuh's mma.sync body; K4 / K4q, the
// chunked prefill and verify, are etap_prefill.cu's kernel on the same
// design.
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
// Address modes (template parameters DENSE and SEPV).  Paged: page j of
// row b is pool block table[b, j] (a 4-D map (width, 1, 64, blocks)); V is
// the block's first Dv columns (the MLA latent, fused: its V boxes are K
// boxes 0-7) or the same block of a V pool of its own (SEPV).  Dense: page
// j of row b is rows [64 j, 64 j + 64) of a [B, S, K, hd] cache read in
// place through its strides, row b = bo K + kh (the reference's
// gqa_to_grouped order) at coordinates (x, kh, 64 j, bo) of a map (width,
// K, S, B / K); rows at or past S read as TMA's zeros, so the caller never
// pads.  A dense V is the latent's first 512 columns (fused) or rows of
// its own (SEPV; a V that is K itself at another width is read through a
// second map over K's rows).  The paged and dense kernels at the same
// widths, columns and split count run the same units in the same order,
// so over the same rows they give the same bits (K3 == K5, K1 == K6).
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
// holds those only once the score product has released K's).  The two
// consumer warpgroups (setmaxnreg 232) split the unit's pages, not its
// columns: each holds all NC columns and takes every other step of PP
// pages (2 where Dk <= 128, 1 at the latent and 256), with an online
// softmax state of its own:
//   S^T [64, NC] a page: Dk / 16 SS wgmmas m64nNCk16, A = the K box, B =
//     the Q tile, both K-major; the first k-step writes S^T only;
//   the per-column max over the step's 64 PP rows: a thread's rows, a
//     shuffle over the warp's row groups, the 4 warps' maxima exchanged
//     through shared memory under a named barrier; l stays a per-thread
//     partial sum until the unit's end; a column's corr is in the
//     registers of the threads holding its O^T columns;
//   P^T: p_hi and p_lo stored transposed (stmatrix) into 128-byte-swizzled
//     K-major [NC][64] tiles, a proxy fence and a named barrier;
//   O^T += V^T P^T: per page, k16 step and 64-row m-tile of Dv, an SS
//     wgmma with A = V's box read MN-major (the transpose-A bit) and B =
//     P^T, hi then lo.
// At the unit's end the second consumer's (m, l, O^T) is merged into the
// first's thread by thread (both hold the same fragments), as the combine
// kernel merges two splits (softmax_state.cuh: stat_weight), and the first
// writes the unit.  A step whose last page lies past the walk (an odd
// page count at PP 2) takes a pad page there (the null block, or the dense
// rows that follow), masked whole with -inf, so it adds exactly nothing.
//
// Why pages and not columns.  A page costs Dk / 16 + 8 Dv / 64 wgmmas (hi
// and lo), each reading its 2 KB A box from shared memory, and a wgmma's
// time hardly falls with N below 64 (PERF.md: units of 16 columns, two
// consumers of 8, took 5.0 µs a latent page; split by pages, 3.0).  Two
// consumers on one page's columns issue its wgmmas twice; split by pages,
// each page is issued once, and two pages' chains run side by side.
//
// The unit width.  Chosen on the host from (B, C, n_splits), the widths
// and the SM count only (decode_unit_cols), so K3 and K5, and K1 at n = 1
// and K3, run the same units over the same rows and give the same bits:
// the narrowest of 16, 32 and 64 columns whose units fit one wave of the
// grid, else the narrowest that holds C (at most 32 where Dk >= 256).  A
// unit's pages take longer at a wider N, so while SMs are idle, narrower
// units that each re-read the row's pages from L2 finish sooner (K3 at B
// 8, H 128: 64 units of 16); once units fill the card, the widest unit
// reads each page for the most columns.  A cluster multicasting each page
// to a row's units would cut the L2 reads, not a unit's own page time,
// and is not taken.
//
// Numerics against the mma.sync body this kernel replaces: the same
// arithmetic in another order (S^T k-steps, l summed per thread and then
// across warps), so outputs agree within the bf16 tolerance, not bitwise.
//
// What bounds it on the H100.  The K and V bytes over 3.35 TB/s: 1152 B a
// fused latent row, 2176 B with a separate V, 512 B a row at 128.  A
// single pass brings a row's whole page stream into every unit of the row
// (one SM's intake, not the device's bandwidth, then sets its time); the
// split plans are the route to the byte bound.
#pragma once

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

// NC: the unit's columns, every one of them held by each consumer.
template <int DK, int DV, bool SEPV, int NC>
struct Cfg {
  static_assert(DK % BOX == 0 && DV % BOX == 0 && DV <= DK, "whole boxes");
  static_assert(NC == 64 || NC == 32 || NC == 16, "16, 32 or 64 columns");
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
  static constexpr int QBYTES = NBK * NC * BOX * 2;
  static constexpr int PBYTES = NCONS * PP * 2 * NC * BOX * 2;
  // the merge of the two consumers' states: NC / 2 floats a thread
  static constexpr int MBYTES = 128 * (NC / 2) * 4;
  // the barriers (2 + 2 x at most MAX_RING) and the 4 warps' column values
  static constexpr int MAX_RING = 24;
  static constexpr int STATIC = (2 + 2 * MAX_RING) * 8 + NCONS * 4 * NC * 4;
  static constexpr int FIT =
      (SMEM_LIMIT - 1024 - STATIC - QBYTES - PBYTES - MBYTES) / BOX_BYTES;
  static constexpr int RING = FIT < MAX_RING ? FIT : MAX_RING;
  // a step's score product holds its pages' K boxes (and the V boxes
  // issued between them), its P V their V boxes
  static_assert(RING >= (PP - 1) * BPP + NBK && RING >= PP * NBV &&
                    RING >= (PP - 1) * BPP + NBV,
                "a step's boxes fit the ring");
  static constexpr int SMEM =
      1024 + QBYTES + PBYTES + MBYTES + RING * BOX_BYTES;
};

struct Params {
  const int* table;    // paged: [B, nbt] pool block ids; dense: null
  const int* lengths;  // [B]: every column attends to rows < lengths[b]
  void* out;           // single pass: [B, C, DV] bf16
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

template <bool STATS, bool DENSE, int DK, int DV, bool SEPV, int NC>
__global__ void __launch_bounds__(NTHREAD, 1) etap_decode_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const Params P) {
  using Cf = Cfg<DK, DV, SEPV, NC>;
  constexpr int NBK = Cf::NBK, NBV = Cf::NBV, NM = Cf::NM;
  constexpr int BPP = Cf::BPP, KREL = Cf::KREL, RING = Cf::RING;
  constexpr int PP = Cf::PP;
  constexpr int NT = NC / 8;               // n8 tiles of the unit
  constexpr int NCOL = NC / 4;             // columns a thread holds
  constexpr int NST = NC / 16;             // stmatrix stores a page
  extern __shared__ unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* sp = sq + NBK * NC * BOX;          // [NCONS][PP][2][NC][64]
  float* sm = reinterpret_cast<float*>(sp + NCONS * PP * 2 * NC * BOX);
  bf16* ring = reinterpret_cast<bf16*>(sm + 128 * (NC / 2));  // [RING][64][64]
  __shared__ uint64_t q_full, q_empty;
  __shared__ uint64_t full[RING], empty[RING];
  __shared__ float red[NCONS][4][NC];      // the 4 warps' column values

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&q_full, 1);
    mbar_init(&q_empty, NCONS * 4);        // each consumer warp arrives
    for (int s = 0; s < RING; ++s) {
      mbar_init(&full[s], 1);              // the producer's TMA
      mbar_init(&empty[s], 4);             // the step's consumer's warps
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {
    // -------------------------------------------------------- producer
    setmaxnreg_dec<PRODUCER_REGS>();
    const int warp = tid >> 5, lane = tid & 31;
    if (warp != 0) return;
    if (lane == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      if constexpr (SEPV) tma_prefetch_map(&tv);
    }
    uint32_t box = 0;                      // boxes issued, all units
    uint32_t n = 0;                        // units begun
    for (int u = blockIdx.x; u < P.units; u += gridDim.x, ++n) {
      const Unit U = unit_of<NC>(P, u);
      // whole steps of PP pages: a last page past np is a pad page
      const int steps = (U.np + PP - 1) / PP;
      int c1 = 0, c3 = 0;                  // dense: (kh, bo)
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
        } else {                           // the null block for a pad page
          if ((j & 31) == 0) ids = j + lane < U.np ? trow[U.j0 + j + lane] : 0;
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
            mbar_expect_tx(&full[slot], BOX_BYTES);
            tma_load_4d(ring + slot * BOX_ELEMS, map, &full[slot], x, c1, c2,
                        c3);
            // Q behind the first page's K boxes, before its V boxes
            if (j == 0 && p == NBK - 1) {
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
    return;
  }

  // ----------------------------------------------------------- consumers
  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = tid / 128 - 1;            // steps cw, cw + 2, ... of a unit
  const int t = tid % 128;
  const int w = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq4 = lane & 3;   // fragment coordinates
  const int row = 16 * w + g;              // page rows row, row + 8
  const bool amla = P.amla != 0;
  const float NEG_INFTY = __int_as_float(0xff800000);   // -inf
  // page pp of a step: p_hi at p_cw + 2 pp NC 64, p_lo NC 64 after it
  const bf16* p_cw = sp + cw * PP * 2 * NC * BOX;
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
#pragma unroll
    for (int i = 0; i < NCOL; ++i) {
      m[i] = NEG_INF;
      l[i] = 0.f;
    }
    float o[NM][NC / 2];
#pragma unroll
    for (int mt = 0; mt < NM; ++mt)
#pragma unroll
      for (int e = 0; e < NC / 2; ++e) o[mt][e] = 0.f;
    mbar_wait(&q_full, n & 1);
    // a unit of one step leaves the second consumer no page: its Q read
    // ends here
    if (cw >= steps) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&q_empty);
    }

    for (int step = cw; step < steps; step += 2) {
      const int js = step * PP;            // the step's first page
      const uint32_t box = box0 + step * PP * BPP;
      // ---- S^T = K Q^T for each page of the step: Dk / 16 k16 steps, 4
      //      to a box
      float s[PP][NC / 2];
      wgmma_fence();
#pragma unroll
      for (int pp = 0; pp < PP; ++pp)
#pragma unroll
        for (int p = 0; p < NBK; ++p) {
          const uint32_t nb = box + pp * BPP + p;
          mbar_wait(&full[nb % RING], (nb / RING) & 1);
          const bf16* kt = ring + (nb % RING) * BOX_ELEMS;
          const bf16* qt = sq + ((p + NBV) % NBK) * NC * BOX;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t da = desc_sw128(kt + 16 * kk, 16, 1024);
            const uint64_t db = desc_sw128(qt + 16 * kk, 16, 1024);
            if (p == 0 && kk == 0)
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
        if (step + 2 >= steps) mbar_arrive(&q_empty);   // its last S
      }

      // ---- scale, mask, the column max over the step's 64 PP rows (a pad
      //      page past np: -inf at every row, so that it adds nothing)
      float mx[NCOL];
#pragma unroll
      for (int i = 0; i < NCOL; ++i) {
        const int nt = i >> 1, e = i & 1;
        // a padding column (past C) is masked whole
        const bool col = cbase + 8 * nt + e < P.C;
#pragma unroll
        for (int pp = 0; pp < PP; ++pp) {
          const int kp = (U.j0 + js + pp) * PAGE + row;
          const bool live = PP == 1 || js + pp < U.np;
          const float masked = live ? NEG_INF : NEG_INFTY;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float x = s[pp][4 * nt + 2 * h + e];
            x = live && col && kp + 8 * h <= hb ? x * P.scale : masked;
            if (amla) x *= LOG2E;          // log2 domain
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

      // ---- P^T as bf16 hi + lo, stored transposed into each page's tiles
#pragma unroll
      for (int pp = 0; pp < PP; ++pp)
#pragma unroll
        for (int k = 0; k < NST; ++k) {
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const float* f = &s[pp][4 * (2 * k + (x >> 1)) + 2 * (x & 1)];
            const __nv_bfloat162 h2 = __floats2bfloat162_rn(f[0], f[1]);
            const float2 back = __bfloat1622float2(h2);
            const __nv_bfloat162 l2 =       // the remainders are exact
                __floats2bfloat162_rn(f[0] - back.x, f[1] - back.y);
            hi[x] = *reinterpret_cast<const uint32_t*>(&h2);
            lo[x] = *reinterpret_cast<const uint32_t*>(&l2);
          }
          const uint32_t tile = st_p + pp * 2 * NC * BOX * 2 + st_off[k];
          stmatrix_x4_trans(tile, hi);
          stmatrix_x4_trans(tile + NC * BOX * 2, lo);
        }
      fence_proxy_async();
      named_bar_sync(1 + cw, 128);

      // ---- O^T += V^T P^T: V box mt of page pp at position KREL + mt,
      //      MN-major, hi then lo
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
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const uint64_t dp = desc_sw128(
                p_cw + (pp * 2 + x) * NC * BOX + 16 * kk, 16, 1024);
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
    //      thread (both hold the same fragments): m and l's partial sums,
    //      then O^T an m-tile at a time, through NC / 2 floats a thread
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

    // ---- epilogue: l over the 64 rows, then out = O^T / l in bf16, or the
    //      split's raw (m, l, O^T)
#pragma unroll
    for (int i = 0; i < NCOL; ++i) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    }
    named_bar_sync(1, 128);                // rd's last readers are done
    if (g == 0) {
#pragma unroll
      for (int i = 0; i < NCOL; ++i)
        rd[w][8 * (i >> 1) + 2 * tq4 + (i & 1)] = l[i];
    }
    named_bar_sync(1, 128);
#pragma unroll
    for (int i = 0; i < NCOL; ++i) {
      const int col = 8 * (i >> 1) + 2 * tq4 + (i & 1);
      l[i] = (rd[0][col] + rd[1][col]) + (rd[2][col] + rd[3][col]);
    }
    named_bar_sync(1, 128);                // before the next unit's rd
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
            if (col < P.C)
              *reinterpret_cast<__nv_bfloat162*>(
                  static_cast<bf16*>(P.out) + ((size_t)U.b * P.C + col) * DV +
                  dv) = odd ? __floats2bfloat162_rn(y, v1)
                            : __floats2bfloat162_rn(v0, y);
          }
      }
    }
  }
}

// The unit width (columns) for `rows` = B n_splits row splits of C
// columns at Dk = dk on `sms` SMs: the narrowest of 16, 32 and 64 whose
// units fit one wave of the grid, else the narrowest that holds C; at most
// 32 where Dk >= 256, whose O^T [Dv, 64] would take more registers than a
// consumer thread has (see the header).
inline int decode_unit_cols(int dk, long long rows, int C, int sms) {
  const int cap = dk >= 256 ? 32 : 64;
  int nc = 16;
  while (nc < C && nc < cap && rows * ((C + nc - 1) / nc) > sms) nc *= 2;
  return nc;
}

// The operands of one launch: q [B, C, DK] bf16 and the K and V rows
// (paged: pools [N, 64, D*]; dense: a cache read through its strides, in
// elements, with kvh kv heads a cache row; v null when V is K's first DV
// columns).
struct Operands {
  const void* q;
  const void* k;
  const void* v;
  long long kb, kh, vb, vh;
  int ldk, ldv, S, kvh;
};

template <bool STATS, bool DENSE, int DK, int DV, bool SEPV, int NC>
int launch_cols(const Operands& a, Params p, int B, int dev, int sms,
                void* stream) {
  using Cf = Cfg<DK, DV, SEPV, NC>;
  p.ntile = (p.C + NC - 1) / NC;
  p.units = B * p.n_splits * p.ntile;
  CUtensorMap tq, tk, tv;
  int err;
  if constexpr (DENSE) {
    const int Bo = B / a.kvh;
    err = bf16_rows_map(&tk, a.k, DK, a.kvh, a.S, Bo, a.kh, a.ldk, a.kb,
                        PAGE);
    // a V of its own, or K's rows read again at DV (V is K at this width)
    if (err == 0 && SEPV)
      err = a.v ? bf16_rows_map(&tv, a.v, DV, a.kvh, a.S, Bo, a.vh, a.ldv,
                                a.vb, PAGE)
                : bf16_rows_map(&tv, a.k, DV, a.kvh, a.S, Bo, a.kh, a.ldk,
                                a.kb, PAGE);
  } else {
    err = bf16_rows_map(&tk, a.k, DK, 1, PAGE, MAX_POOL_BLOCKS, DK, DK,
                        static_cast<long long>(PAGE) * DK, PAGE);
    if (err == 0 && SEPV)
      err = bf16_rows_map(&tv, a.v, DV, 1, PAGE, MAX_POOL_BLOCKS, DV, DV,
                          static_cast<long long>(PAGE) * DV, PAGE);
  }
  if (err == 0)
    err = bf16_rows_map(&tq, a.q, DK, 1, p.C, B, DK, DK,
                        static_cast<long long>(p.C) * DK, NC);
  if (err != 0) return err;
  if (!SEPV) tv = tk;                      // the fused kernel reads no tv
  auto kernel = etap_decode_kernel<STATS, DENSE, DK, DV, SEPV, NC>;
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
template <bool STATS, bool DENSE, int DK, int DV, bool SEPV>
int launch_decode(const Operands& a, Params p, int B, void* stream) {
  if (B <= 0 || p.C <= 0 || p.nbt <= 0 || p.n_splits <= 0 || p.npb <= 0 ||
      a.kvh <= 0 || B % a.kvh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dev = current_device();
  const int sms = dev < 0 ? 0 : sm_count(dev);
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  switch (decode_unit_cols(DK, static_cast<long long>(B) * p.n_splits, p.C,
                           sms)) {
    case 16:
      return launch_cols<STATS, DENSE, DK, DV, SEPV, 16>(a, p, B, dev, sms,
                                                         stream);
    case 32:
      return launch_cols<STATS, DENSE, DK, DV, SEPV, 32>(a, p, B, dev, sms,
                                                         stream);
    default:
      if constexpr (DK >= 256)
        return static_cast<int>(cudaErrorInvalidValue);
      else
        return launch_cols<STATS, DENSE, DK, DV, SEPV, 64>(a, p, B, dev, sms,
                                                           stream);
  }
}

template <bool STATS, bool DENSE, int DK, int DV, bool SEPV, int NC>
int attrs_cols(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, etap_decode_kernel<STATS, DENSE, DK, DV, SEPV, NC>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = Cfg<DK, DV, SEPV, NC>::SMEM;
  out[2] = static_cast<int>(a.localSizeBytes);
  return 0;
}

// The attributes of an instance at units of `cols` columns (16, 32, and
// 64 where Dk < 256).
template <bool STATS, bool DENSE, int DK, int DV, bool SEPV>
int attrs_decode(int cols, int* out) {
  switch (cols) {
    case 16: return attrs_cols<STATS, DENSE, DK, DV, SEPV, 16>(out);
    case 32: return attrs_cols<STATS, DENSE, DK, DV, SEPV, 32>(out);
    case 64:
      if constexpr (DK < 256)
        return attrs_cols<STATS, DENSE, DK, DV, SEPV, 64>(out);
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

}  // namespace
