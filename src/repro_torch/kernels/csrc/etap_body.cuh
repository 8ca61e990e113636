// The mma.sync body of the quantized ETAP decode kernels for Hopper
// (sm_90a): one template serving three pallas_call sites of the JAX
// package over int8 / e4m3 codes.  etap_quant.cu instantiates K3q, K1q
// over the paged latent code pool and K5q, K6q over dense GQA code rows;
// etap_sepv.cu K3q, K1q over separate K and V code pools; each source's
// header says which pallas_call bodies it replaces.  The bf16 decode
// kernels (K3, K1, K5, K6) are etap_decode.cuh's kernel (wgmma on the
// page's 64 rows, a TMA ring, warp-specialised), and K4 / K4q, the chunked
// prefill and verify over bf16 and code pools, etap_prefill.cu's, on the
// same design; this body is the next to move there.
//
// What they compute.  A CTA owns NT = 16 query columns (heads) of one
// batch row and walks that row's KV rows in 64-row tiles (pages).  Per
// tile:
//     S^T = K Q^T * scale          [64, 16]   mma.sync, page rows on M
//     mask kpos > horizon(column) to -1e30
//     online-softmax update per column (m, l in shared memory)
//     O^T += V^T P^T               [Dv, 16]   mma.sync, Dv on M
// The widths (Dk, Dv) are template parameters: the MLA latent (576, 512),
// where V is the first 512 columns of the same latent page (read once for
// both products) or, paged, a pool of its own; the GQA heads (128, 128)
// and (64, 64) for the dense kernels K5q/K6q, with K and V in their own
// caches; and (128, 128) for the paged kernels over separate K and V pools
// (mma_tile.cuh's width lists say which kernel takes which).
//
// Dv 64.  Acc^T [64, 16] is the grid of eight 16 x 8 tiles that S^T
// [64, 16] is, so each of the 8 warps takes the Acc^T tile at its S^T
// tile's coordinates (m-tile warp & 3, n-tile warp >> 2) instead of whole
// m-tiles: the same 256 threads, launch bounds and shared-memory layout as
// every other width, and one instantiation of one body, so the bitwise
// contracts (split(n = 1) + K2 == single pass; a GQA cache read in place ==
// gqa_to_grouped's copy) hold by construction.  Each Acc^T element sums
// its products in the same order (one mma per 16 KV rows, hi then mid
// then lo), so no width changes the numerics.
//
// Address modes (template parameters: DENSE, and CODE, the element type of
// K and V: int8 or e4m3 codes).  Paged (K1, K3): tile j of row
// b is pool block table[b, j]; V is the block's first Dv columns (the MLA
// latent), or, in the separate-V instances (template parameter SEPV, so
// the fused ones carry none of its code), block table[b, j] of its own
// pool [N, 64, Dv] (the same entry, rows Dv wide), loaded over the K
// tile's first Dv columns once the score product is done, as a dense
// separate V is; null blocks and idle rows read block 0 of both pools,
// masked.  Dense (K5, K6): tile j of row b is rows
// [64 j, 64 j + 64) of k + b * kb with row stride ldk; rows at or past S
// are zero-filled, so the caller never pads the cache (the reference pads
// with zeros, and the horizon masks those rows either way).  Row b may also
// address a GQA cache [B, S, K, hd] in place: with kvh = K heads, row
// b = bo * K + kh (the reference's gqa_to_grouped order) starts at
// k + bo * kb + kh * kh_stride, row stride K * hd, so no grouped copy is
// made.  A dense V is
// either the first 512 columns of the K tile (v null: the MLA latent, V =
// cache[..., :512], read in place with no copy) or its own rows at v + b *
// vb, stride ldv, loaded over the K tile's first 512 columns once the score
// product is done.  Quantized paged (K1q, K3q): the page holds int8
// or e4m3 codes [64, 576] (1 byte each) and the sz pool its rows' (scale,
// zp) [64, 2] fp32.  Quantized dense (K5q, K6q): the dense address over
// code rows, each operand with its own (scale, zp) rows addressed as its
// codes are, through (batch, kv-head, row) strides in floats (a GQA pair
// cache [B, S, K, 2] read in place); a separate V brings its own pairs
// (szv), loaded with K's at the top of the tile so that the V codes can
// replace the K tile's first Dv columns after the score product, as the
// bf16 V does.  Quantized paged with a separate V: the V code pool [N, 64,
// Dv] and its own (scale, zp) pool, both at block table[b, j], loaded as
// the dense separate V's; the tile update weighs P by V's scales (szv).
//
// Column c is live for key position kpos iff kpos <= lengths[b] - 1, and
// a padding column (c >= C) for none.
// K3/K5 end with O = (Acc^T / l)^T in bf16 (the quantized ones in q's
// type, bf16 or fp32); K1/K6 write the raw fp32 (m, l, Acc^T) of their
// split for the combine kernel (combine.cu).  The split and single-pass
// kernels are the same body, so partial(n_splits=1) + combine is bitwise
// the single pass, and over the same rows the dense kernels are bitwise the
// paged ones; the same holds within each quantized code type.
//
// Numerics.  Scores, m, l and Acc are fp32.  The scores come from bf16
// inputs with fp32 accumulation.  The probabilities enter the second product
// as two bf16 terms, p_hi = bf16(p) and p_lo = bf16(p - p_hi), which carry
// about 16 significant bits of p; l sums the fp32 p.  amla mode builds its
// rescale 2^(m_old - m_new) from the exponent (softmax_state.cuh).
//
// Numerics of the quantized bodies.  The reference dequantizes each row to
// fp32 (codes * scale + zp), takes q in fp32 and forms both products in
// fp32; rounding the dequantized rows to bf16 would add about 2^-9 per
// element on top of the quantization error.  Every int8 code (-127..127)
// and every e4m3 code is exact in bf16, so the codes go into mma.sync as
// they are and the affine is applied around the products:
//     S_r  = scale_r * (codes_r . q) + zp_r * sum(q)
//     O^T += sum_r codes_r (scale_r p_r) + sum_r zp_r p_r
// scale_r folds into p before its split into three bf16 terms (mma_tile.cuh:
// tile_update<true>), and the zp term is one fp32 number per column and
// tile, added to every Dv row on the CUDA cores.  sum(q) is taken in fp32
// from q as given.  q is bf16 on DeepSeek's serve path (exact in one
// term); an fp32 q (the GQA serve path, which casts q to fp32 as the
// reference does, and the accuracy gate against the fp64 oracle) enters as
// three bf16 tiles hi + mid + lo, which carry its 24 bits (mma_tile.cuh:
// load_q_tile), three products into one fp32 accumulator; two tiles (16
// bits) would leave a score up to 2^-18 sum|q k| off the fp32 product.
// P * scale is three terms too (mma_tile.cuh: tile_update).  The codes
// are read with 16-byte loads and widened to bf16 into the page buffer
// (e4m3 -> f16 -> bf16 is exact), so the products and the online softmax
// are the fp kernels' own (mma_tile.cuh: load_code_tile).  The other
// design, dequantizing to fp32 and splitting each element into bf16
// terms, multiplies the products on both sides; this one adds one mma to
// the fp kernels' second product (the mid term of P * scale) and two to
// the first for fp32 q.  Null blocks and
// rows past the length hold finite codes with scale 1 / zp 0 or their
// written pairs, so V never carries a NaN into the masked p = 0.
//
// The walk.  Pages past the last live position of the tile are not read:
// for a column whose running max is already set, a fully masked page is an
// exact no-op of the recurrence (p = 0, rescale = 1).  The walk is cut by
// positions only, never by block ids: a padded table entry (the null block
// 0) inside the walk is read and masked like any other page.  A split with
// no live position at all walks all of its pages, as the reference does, so
// its stats are the reference's.
//
// What bounds it on the H100.  Decode reads each code page once per head
// tile (128 heads = 8 tiles, the re-reads mostly hit L2); its floor is the
// code bytes over 3.35 TB/s (584 B a latent row with its pair; a separate
// V pool reads its Dv columns again: 1104 B a latent row, 272 B at
// Granite's 128 with both pairs).  A GQA group (G = 4 heads of Qwen3-8B)
// fills 4 of the 16 columns: 12 are padding, masked.  This version is
// simple: mma.sync fragments loaded from shared memory with 32/16-bit
// loads, one page in flight (plain 16-byte code loads, no double buffer),
// 16 columns per CTA so the [Dv, 16] fp32 accumulator fits in registers
// (Dv / 16 per thread: 32 at the latent, 4 at Dv 64).  G = 1 (an MHA head)
// leaves 15 of the 16 columns as padding and G = 3 (SmolLM) 13, masked
// like any padding column (horizon INT_MIN).
#pragma once

#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include "mma_tile.cuh"

namespace {

using namespace etap;

constexpr int NT = 16;         // query columns per CTA
constexpr int NWARP = 8;
constexpr int NTHREAD = NWARP * 32;
constexpr int PSTR = PAGE + 8; // padded P^T row (bf16)
constexpr int SSTR = NT + 1;   // padded score row (fp32)

template <int DK>
struct Smem {
  static constexpr int KSTR = DK + 8;  // padded row (bf16): conflict-free
  alignas(16) bf16 k[PAGE * KSTR];   // the current page / tile (bf16)
  alignas(16) bf16 q[NT * KSTR];     // the CTA's query columns (hi)
  alignas(16) float s[PAGE * SSTR];  // scaled, masked scores S^T
  alignas(16) bf16 p_hi[NT * PSTR];  // P (column-major: [column][row])
  alignas(16) bf16 p_lo[NT * PSTR];
  float m[NT];
  float l[NT];
  float corr[NT];
  int hz[NT];                        // per-column horizon
};

// The quantized bodies' shared memory: Smem's fields plus the tile's
// (scale, zp) rows (K's, and a separate V's), the middle term of P * scale,
// and for fp32 q (QLO) the mid and lo tiles of q.
template <int DK, bool QLO>
struct SmemQuant : Smem<DK> {
  alignas(16) bf16 p_mid[NT * PSTR]; // P * scale: hi, mid (here), lo
  alignas(16) float2 sz[PAGE];       // the tile's K (scale, zp)
  alignas(16) float2 szv[PAGE];      // a separate V's (scale, zp)
  float qsum[NT];                    // sum of each column's q
  float zc[NT];                      // sum_r zp_r p_r of the tile
  alignas(16) bf16 q_mid[QLO ? NT * Smem<DK>::KSTR : 8];
  alignas(16) bf16 q_lo[QLO ? NT * Smem<DK>::KSTR : 8];
};

struct Params {
  const void* q;      // [B, C, DK] bf16, or fp32 (quantized bodies)
  const void* k;      // paged: pool [N, PAGE, DK]; dense: rows
                      // (b / kvh)*kb + (b % kvh)*kh + s*ldk
  const float* sz;    // quantized: K's (scale, zp): paged pool [N, PAGE, 2];
                      // dense rows (b / kvh)*zb + (b % kvh)*zh + s*ldz
  long long zb;       // dense quantized: the pairs' strides (floats)
  long long zh;
  int ldz;
  int qf32;           // quantized: q is fp32
  const int* table;   // [B, nbt] (paged) or null (dense)
  long long kb;       // dense batch stride (elements)
  long long kh;       // dense kv-head stride (elements; GQA cache in place)
  int kvh;            // dense: kv heads per batch row (1: plain [B, S, D])
  int ldk;            // dense row stride (elements)
  int S;              // dense rows per batch row (rows >= S read as zero)
  const void* v;      // a separate V, or null (the first DV columns of K):
                      // paged, a pool [N, PAGE, DV] read through the
                      // table; dense, rows as K's with strides vb, vh, ldv
  long long vb;
  long long vh;
  int ldv;
  const float* vsz;   // quantized separate V: its pairs, as K's (paged,
                      // a pool [N, PAGE, 2]; dense, strides vzb, vzh, ldvz)
  long long vzb;
  long long vzh;
  int ldvz;
  const int* base;    // [B] lengths: column c attends to rows < base[b]
  int C;              // query columns per batch row
  int nbt;            // tiles per batch row (a multiple of npb)
  int npb;            // pages per split
  float scale;
  int amla;
  void* out;          // [B, C, DV] bf16, or fp32 (see OUT_F32)
  float* m_out;       // [B, n_splits, C]           (split partial)
  float* l_out;       // [B, n_splits, C]
  float* acc_out;     // [B, n_splits, DV, C]
};

// Row b's offset in a dense operand of batch stride sb and kv-head stride
// sh: kv head b % kvh of batch row b / kvh (a GQA cache), or row b.
__device__ __forceinline__ size_t dense_row(int b, int kvh, long long sb,
                                           long long sh) {
  const int bo = b / kvh;
  return (size_t)bo * sb + (size_t)(b - bo * kvh) * sh;
}

// Whether the paged bodies are built at (DK, DV): a constexpr scalar, so
// the kernel's static check reads its value without calling host code.
template <int DK, int DV>
constexpr bool kPagedWidths = has_widths<PagedSepWidths>(DK, DV);

// DENSE selects the address mode and CODE the element type of K and V at
// compile time, so each kernel carries only its own mode's code; QF32
// (quantized bodies only) takes fp32 q; DK and DV are the widths (the
// paged bodies are built at PagedSepWidths': the latent's, fused or with a
// separate V, and 128 with a separate V).  O is fp32 for fp32 q and for
// the dense quantized kernels, bf16 otherwise.
template <bool STATS, bool DENSE, int CODE, bool QF32, int DK, int DV,
          bool SEPV = false>
__global__ void __launch_bounds__(NTHREAD, 2) etap_kernel(Params P) {
  constexpr bool OUT_F32 = QF32 || DENSE;
  static_assert(CODE != kBf16, "the bf16 bodies are etap_decode.cuh's");
  static_assert(DENSE || kPagedWidths<DK, DV>,
                "the paged bodies take PagedSepWidths");
  static_assert(!(DENSE && SEPV), "SEPV is the paged separate-V address");
  // V has rows of its own: a dense V passed beside K, or a paged V pool
  // (a compile-time choice, so the fused paged kernels carry none of it)
  const bool own_v = DENSE ? P.v != nullptr : SEPV;
  static_assert(DK % 16 == 0 && DV <= DK &&
                    (DV % (16 * NWARP) == 0 || 2 * DV == 16 * NWARP),
                "DK a multiple of 16; DV of 128, or 64, within the K tile");
  constexpr int KSTR = Smem<DK>::KSTR;
  // O^T [DV, 16] is DV / 16 m-tiles by 2 n-tiles of 16 x 8.  From DV 128
  // on, each warp owns MT = DV / 128 whole m-tiles, both n-tiles; at DV 64
  // the 8 tiles go one to a warp, the same (m, n) tile as its S^T tile.
  constexpr int NN = DV >= 16 * NWARP ? 2 : 1; // O^T n-tiles per warp
  constexpr int MT = 2 * DV / (16 * NWARP * NN); // O^T m-tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemQuant<DK, QF32>& sm =
      *reinterpret_cast<SmemQuant<DK, QF32>*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;       // mma fragment coordinates
  const int c0 = blockIdx.x * NT;
  const int split = blockIdx.y;
  const int n_splits = gridDim.y;
  const int b = blockIdx.z;
  const bool amla = P.amla != 0;

  if (tid < NT) {
    const int c = c0 + tid;
    // a padding column is all masked
    sm.hz[tid] = c < P.C ? P.base[b] - 1 : INT_MIN;
    sm.m[tid] = NEG_INF;
    sm.l[tid] = 0.f;
  }
  // fp32 q -> bf16 hi + mid + lo
  load_q_tile<QF32, true, NT, NTHREAD, DK>(sm.q, sm.q_mid, sm.q_lo, KSTR,
                                           sm.qsum, P.q, b, P.C, c0);
  __syncthreads();

  // the split's page range, cut after the last page holding a live position
  const int j0 = split * P.npb;
  const int j1 = min(j0 + P.npb, P.nbt);
  int hmax = INT_MIN;
  for (int i = 0; i < NT; ++i) hmax = max(hmax, sm.hz[i]);
  int j_end = j1;
  if (hmax >= j0 * PAGE) j_end = min(j1, hmax / PAGE + 1);

  float acc[MT][NN][4];                        // [m-tile][n-tile][fragment]
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NN; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // a dense row's K and V: (bo, kh) of a GQA cache, or row b (kvh = 1)
  size_t kbase = 0, vbase = 0;
  if constexpr (DENSE) {
    kbase = dense_row(b, P.kvh, P.kb, P.kh);
    vbase = dense_row(b, P.kvh, P.vb, P.vh);
  }

  const int smi = warp & 3, sni = warp >> 2;   // this warp's S^T tile
  // this warp's O^T tiles: m-tiles [MT wm, +MT), n-tiles [wn, +NN)
  const int wm = NN == 2 ? warp : smi, wn = NN == 2 ? 0 : sni;
  for (int j = j0; j < j_end; ++j) {
    int rows = PAGE;
    if constexpr (DENSE) rows = min(PAGE, P.S - j * PAGE);
    if constexpr (DENSE) {
      load_code_tile<CODE, NTHREAD>(
          sm.k, KSTR,
          static_cast<const uint8_t*>(P.k) + kbase +
              (size_t)j * PAGE * P.ldk,
          P.ldk, rows, DK);
      load_sz_tile(sm.sz,
                   P.sz + dense_row(b, P.kvh, P.zb, P.zh) +
                       (size_t)j * PAGE * P.ldz,
                   P.ldz, rows);
      if (own_v)                             // V's own pairs
        load_sz_tile(sm.szv,
                     P.vsz + dense_row(b, P.kvh, P.vzb, P.vzh) +
                         (size_t)j * PAGE * P.ldvz,
                     P.ldvz, rows);
    } else {
      const size_t blk = P.table[(size_t)b * P.nbt + j];
      load_code_tile<CODE, NTHREAD>(
          sm.k, KSTR, static_cast<const uint8_t*>(P.k) + blk * PAGE * DK,
          DK, PAGE, DK);
      load_sz_tile(sm.sz, P.sz + blk * PAGE * 2, 2, PAGE);
      if constexpr (SEPV)                    // V's own pairs
        load_sz_tile(sm.szv, P.vsz + blk * PAGE * 2, 2, PAGE);
    }
    __syncthreads();

    // ---- S^T = K Q^T: warp tile rows [16 smi, +16), columns [8 sni, +8)
    {
      float sacc[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* ka = &sm.k[(16 * smi) * KSTR];
      const bf16* qb = &sm.q[(8 * sni) * KSTR];
#pragma unroll 4
      for (int k0 = 0; k0 < DK; k0 += 16) {
        const uint32_t a0 = ld32(&ka[g * KSTR + k0 + 2 * t]);
        const uint32_t a1 = ld32(&ka[(g + 8) * KSTR + k0 + 2 * t]);
        const uint32_t a2 = ld32(&ka[g * KSTR + k0 + 8 + 2 * t]);
        const uint32_t a3 = ld32(&ka[(g + 8) * KSTR + k0 + 8 + 2 * t]);
        mma16816(sacc, a0, a1, a2, a3, ld32(&qb[g * KSTR + k0 + 2 * t]),
                 ld32(&qb[g * KSTR + k0 + 8 + 2 * t]));
        if constexpr (QF32) {
          const bf16* qmb = &sm.q_mid[(8 * sni) * KSTR];
          const bf16* qlb = &sm.q_lo[(8 * sni) * KSTR];
          mma16816(sacc, a0, a1, a2, a3, ld32(&qmb[g * KSTR + k0 + 2 * t]),
                   ld32(&qmb[g * KSTR + k0 + 8 + 2 * t]));
          mma16816(sacc, a0, a1, a2, a3, ld32(&qlb[g * KSTR + k0 + 2 * t]),
                   ld32(&qlb[g * KSTR + k0 + 8 + 2 * t]));
        }
      }
      const int r0 = 16 * smi + g;
      const int ca = 8 * sni + 2 * t;
      {                                        // the affine of each row
        const float2 z0 = sm.sz[r0], z1 = sm.sz[r0 + 8];
        const float qs0 = sm.qsum[ca], qs1 = sm.qsum[ca + 1];
        sacc[0] = z0.x * sacc[0] + z0.y * qs0;
        sacc[1] = z0.x * sacc[1] + z0.y * qs1;
        sacc[2] = z1.x * sacc[2] + z1.y * qs0;
        sacc[3] = z1.x * sacc[3] + z1.y * qs1;
      }
      const int kp0 = j * PAGE + r0, kp1 = kp0 + 8;
      sm.s[r0 * SSTR + ca] = kp0 <= sm.hz[ca] ? sacc[0] * P.scale : NEG_INF;
      sm.s[r0 * SSTR + ca + 1] =
          kp0 <= sm.hz[ca + 1] ? sacc[1] * P.scale : NEG_INF;
      sm.s[(r0 + 8) * SSTR + ca] =
          kp1 <= sm.hz[ca] ? sacc[2] * P.scale : NEG_INF;
      sm.s[(r0 + 8) * SSTR + ca + 1] =
          kp1 <= sm.hz[ca + 1] ? sacc[3] * P.scale : NEG_INF;
    }
    __syncthreads();

    // ---- a separate V replaces the K tile's first DV columns (rows past
    //      S stay zero from the K load): dense rows, or the V pool's block
    //      at the same table entry
    if (own_v) {
      size_t voff, ldv;
      if constexpr (DENSE) {
        voff = vbase + (size_t)j * PAGE * P.ldv;
        ldv = P.ldv;
      } else {
        voff = (size_t)P.table[(size_t)b * P.nbt + j] * PAGE * DV;
        ldv = DV;
      }
      load_code_tile<CODE, NTHREAD>(
          sm.k, KSTR, static_cast<const uint8_t*>(P.v) + voff, ldv, rows, DV);
    }

    // ---- online-softmax update: 16 lanes per column, 4 rows per lane
    {
      const int col = tid >> 4, r = tid & 15;
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = sm.s[(r + 16 * i) * SSTR + col];
      tile_update<true>(sv, r, amla, &sm.p_hi[col * PSTR],
                        &sm.p_lo[col * PSTR], &sm.m[col], &sm.l[col],
                        &sm.corr[col], own_v ? sm.szv : sm.sz, &sm.zc[col],
                        &sm.p_mid[col * PSTR]);
    }
    __syncthreads();

    // ---- O^T = O^T * corr + V^T P^T: warp owns Dv rows [16 MT wm,
    //      +16 MT) of columns [8 wn, +8 NN); a code tile adds sum_r zp_r
    //      p_r to every row of its column
#pragma unroll
    for (int ni = 0; ni < NN; ++ni) {
      const int c = 8 * (wn + ni) + 2 * t;
      const float ca = sm.corr[c];
      const float cb = sm.corr[c + 1];
      const float za = sm.zc[c];
      const float zb = sm.zc[c + 1];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        acc[mi][ni][0] *= ca;
        acc[mi][ni][1] *= cb;
        acc[mi][ni][2] *= ca;
        acc[mi][ni][3] *= cb;
        acc[mi][ni][0] += za;
        acc[mi][ni][1] += zb;
        acc[mi][ni][2] += za;
        acc[mi][ni][3] += zb;
      }
    }
#pragma unroll
    for (int k0 = 0; k0 < PAGE; k0 += 16) {
      const bf16* r0 = &sm.k[(k0 + 2 * t) * KSTR];    // rows of pos k0+2t..
      const bf16* r1 = r0 + KSTR;
      const bf16* r8 = r0 + 8 * KSTR;
      const bf16* r9 = r8 + KSTR;
      uint32_t bh[NN][2], bl[NN][2], bm[NN][2];
#pragma unroll
      for (int ni = 0; ni < NN; ++ni) {
        const int pc = (8 * (wn + ni) + g) * PSTR + k0 + 2 * t;
        bh[ni][0] = ld32(&sm.p_hi[pc]);
        bh[ni][1] = ld32(&sm.p_hi[pc + 8]);
        bl[ni][0] = ld32(&sm.p_lo[pc]);
        bl[ni][1] = ld32(&sm.p_lo[pc + 8]);
        bm[ni][0] = ld32(&sm.p_mid[pc]);
        bm[ni][1] = ld32(&sm.p_mid[pc + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int dv = 16 * (MT * wm + mi) + g;
        const uint32_t a0 = pack(r0[dv], r1[dv]);
        const uint32_t a1 = pack(r0[dv + 8], r1[dv + 8]);
        const uint32_t a2 = pack(r8[dv], r9[dv]);
        const uint32_t a3 = pack(r8[dv + 8], r9[dv + 8]);
#pragma unroll
        for (int ni = 0; ni < NN; ++ni) {
          mma16816(acc[mi][ni], a0, a1, a2, a3, bh[ni][0], bh[ni][1]);
          mma16816(acc[mi][ni], a0, a1, a2, a3, bm[ni][0], bm[ni][1]);
          mma16816(acc[mi][ni], a0, a1, a2, a3, bl[ni][0], bl[ni][1]);
        }
      }
    }
    __syncthreads();                           // page buffer is reused
  }

// ---- epilogue
#pragma unroll
  for (int ni = 0; ni < NN; ++ni) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * (wn + ni) + 2 * t + e;
      const int c = c0 + col;
      if (c >= P.C) continue;
      if (STATS) {
        const size_t row = ((size_t)b * n_splits + split);
        if (wm == 0 && g == 0) {             // one writer per column
          P.m_out[row * P.C + c] = sm.m[col];
          P.l_out[row * P.C + c] = sm.l[col];
        }
        float* a = P.acc_out + row * DV * P.C + c;
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const int dv = 16 * (MT * wm + mi) + g;
          a[(size_t)dv * P.C] = acc[mi][ni][e];
          a[(size_t)(dv + 8) * P.C] = acc[mi][ni][e + 2];
        }
      } else {
        const float l = sm.l[col];
        using OT = typename std::conditional<OUT_F32, float, bf16>::type;
        OT* o = static_cast<OT*>(P.out) + ((size_t)b * P.C + c) * DV;
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const int dv = 16 * (MT * wm + mi) + g;
          if constexpr (OUT_F32) {
            o[dv] = acc[mi][ni][e] / l;
            o[dv + 8] = acc[mi][ni][e + 2] / l;
          } else {
            o[dv] = __float2bfloat16_rn(acc[mi][ni][e] / l);
            o[dv + 8] = __float2bfloat16_rn(acc[mi][ni][e + 2] / l);
          }
        }
      }
    }
  }
}

template <bool STATS, bool DENSE, int CODE, bool QF32, int DK = LATENT_DK,
          int DV = LATENT_DV, bool SEPV = false>
int launch_mode(const Params& p, int B, int n_splits, void* stream) {
  const int smem = static_cast<int>(sizeof(SmemQuant<DK, QF32>));
  cudaError_t err = cudaFuncSetAttribute(
      etap_kernel<STATS, DENSE, CODE, QF32, DK, DV, SEPV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.C + NT - 1) / NT, n_splits, B);
  etap_kernel<STATS, DENSE, CODE, QF32, DK, DV, SEPV><<<
      grid, NTHREAD, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The instance's registers per thread, dynamic shared memory (bytes) and
// local memory per thread (bytes; spills) into out[0..2].
template <bool STATS, bool DENSE, int CODE, bool QF32, int DK, int DV,
          bool SEPV = false>
int attrs_of(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, etap_kernel<STATS, DENSE, CODE, QF32, DK, DV, SEPV>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(sizeof(SmemQuant<DK, QF32>));
  out[2] = static_cast<int>(a.localSizeBytes);
  return 0;
}

Params make_params(const void* q, const void* pool, const int* table,
                   int C, int nbt, float scale, int amla) {
  Params p{};
  p.q = q;
  p.k = pool;
  p.table = table;
  p.C = C;
  p.nbt = nbt;
  p.npb = nbt;
  p.scale = scale;
  p.amla = amla;
  return p;
}

// Dense decode (K5 / K6, and K5q / K6q): one split per npb tiles of nbt;
// row b of the grid reads K at k + (b / kvh)*kb + (b % kvh)*kh (V alike).
Params dense_params(const void* q, const void* k, long long kb, int ldk,
                    const void* v, long long vb, int ldv, int S,
                    const int* lengths, int kvh, long long kh, long long vh,
                    int H, int nbt, float scale, int amla) {
  Params p = make_params(q, k, nullptr, H, nbt, scale, amla);
  p.kb = kb;
  p.kh = kh;
  p.kvh = kvh;
  p.ldk = ldk;
  p.S = S;
  p.v = v;
  p.vb = vb;
  p.vh = vh;
  p.ldv = ldv;
  p.base = lengths;
  return p;
}

}  // namespace
