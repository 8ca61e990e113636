// The untransposed decode baseline over int8 / e4m3 code rows for Hopper
// (sm_90a), on mma.sync: FlashMLA without ETAP over a quantized cache.
//
//   K7q, K8q  K7 and K8 over dense code rows with per-row (scale, zp): the
//       reference gathers a quantized pool, dequantizes it to fp32 and
//       runs K7 / K8 on the fp32 rows (repro/core/etap.py:311-327, :391-394
//       for DeepSeek's latent in --mode standard; repro/models/
//       attention.py:249-260 for a GQA pool), the same pallas_call sites:
//         K7  repro/kernels/flash_decode/flash_decode.py:83
//             (flash_decode_pallas :58)
//         K8  repro/kernels/flash_decode/flash_decode.py:168
//             (flash_decode_partial_pallas :136)
//       Built at mma_tile.cuh's QuantDenseWidths: the latent with V its
//       first 512 columns, and the 128- and 64-wide GQA heads with V in
//       their own rows.
//
// K7 / K8 over bf16 rows are flash_decode_wgmma.cu's Hopper kernel (wgmma,
// TMA, warp-specialised); this body is the mma.sync one they ran on before,
// kept for the code rows until they follow onto that kernel.
//
// What they compute.  A CTA owns NH = 16 heads of one batch row and walks
// that row's dense KV rows in 64-row tiles.  Per tile:
//     S = Q K^T * scale            [16, 64]   mma.sync, heads on M
//     mask kpos > length - 1 to -1e30
//     online-softmax update per head row (m, l in shared memory)
//     O += P V                     [16, Dv]   mma.sync, heads on M
// This is the orientation the paper measures ETAP against: the thin head
// axis rides the M side of both products (a GQA group of G = 4 heads
// leaves 12 of the 16 M rows empty).  (Dk, Dv) is a template parameter,
// one instantiation per pair of QuantDenseWidths: Acc [16, Dv] gives each
// of the 8 warps Dv / 64 n-tiles of 8 columns (1 at Dv 64), and every load
// loop steps over its width in 16-byte pieces, so no width needs code of
// its own.  The address modes (dense rows with a zero-filled tail, a GQA
// cache [B, S, K, hd] read in place through its kv-head stride; V the first
// Dv K columns or its own strided rows), horizon mask, tile skipping past
// the horizon, online-softmax update (mma_tile.cuh: tile_update) and exact
// AMLA are the ETAP kernels'.  K7q ends with O = Acc / l in fp32; K8q
// writes the raw fp32 (m, l, Acc) of its split in the [n, H, Dv]
// orientation for combine.cu's second entry.  K7q and K8q are the same
// body, so K8q(n_splits=1) + combine is bitwise K7q.
//
// The code numerics are the ETAP decode kernels' (etap_decode.cuh, "Over
// codes") on mma.sync: the codes widen to exact bf16 in the tile buffer
// (mma_tile.cuh: load_code_tile), S = scale_r * (q . codes_r) + zp_r *
// sum(q) per row, scale_r folds into P before its split into three bf16
// terms (hi, mid, lo) and sum_r zp_r p_r joins each head's O row; fp32 q
// (the GQA path) enters the score product as three bf16 tiles hi + mid +
// lo.  They write fp32 O, as the reference's K7 / K8 write V's fp32 type
// after its dequantization.
//
// What bounds it on the H100: the codes' bytes plus 8 per row and granule
// (the (scale, zp) pairs) over 3.35 TB/s (the multiply-adds are 2 * H *
// (Dk + Dv) per row).  Acc [16, Dv] fp32 is spread over the 8 warps, Dv / 8
// columns each (Dv / 16 registers per thread: 32 at the latent, 4 at Dv
// 64); an MHA head (G = 1) leaves 15 of the 16 M rows empty (horizon
// INT_MIN: all masked); 128 heads take 8 CTAs, each re-reading the row's
// tiles (the re-reads mostly hit L2).  The fragments come from shared
// memory with 32/16-bit loads and one tile is in flight.
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_tile.cuh"

namespace {

using namespace etap;

constexpr int NH = 16;         // heads per CTA
constexpr int NWARP = 8;
constexpr int NTHREAD = NWARP * 32;
constexpr int PSTR = PAGE + 8; // padded P row (bf16)
constexpr int SSTR = PAGE + 4; // padded score row (fp32)

template <int DK>
struct Smem {
  static constexpr int KSTR = DK + 8;  // padded row (bf16)
  alignas(16) bf16 k[PAGE * KSTR];     // the current KV tile (V: first DV
                                       // columns)
  alignas(16) bf16 q[NH * KSTR];       // the CTA's heads (hi)
  float s[NH * SSTR];          // scaled, masked scores S [head][row]
  bf16 p_hi[NH * PSTR];        // P [head][row]
  bf16 p_lo[NH * PSTR];
  float m[NH];
  float l[NH];
  float corr[NH];
  int hz[NH];                  // per-head horizon (length - 1)
};

// The shared memory over code rows: the tile buffers of Smem (the widened
// tile, q, the scores and P) plus the tile's (scale, zp) rows (K's, and a
// separate V's) and, for fp32 q (QLO), the mid and lo tiles of q.
template <int DK, bool QLO>
struct SmemQuant : Smem<DK> {
  alignas(16) bf16 p_mid[NH * PSTR];  // P * scale: hi, mid (here), lo
  alignas(16) float2 sz[PAGE];
  alignas(16) float2 szv[PAGE];
  float qsum[NH];              // sum of each head's q
  float zc[NH];                // sum_r zp_r p_r of the tile, per head
  alignas(16) bf16 q_mid[QLO ? NH * Smem<DK>::KSTR : 8];
  alignas(16) bf16 q_lo[QLO ? NH * Smem<DK>::KSTR : 8];
};

struct Params {
  const void* q;      // [B, H, DK] bf16, or fp32 (quantized kernels)
  const void* k;      // rows (b / kvh)*kb + (b % kvh)*kh + s*ldk, s < S
  long long kb;
  long long kh;       // kv-head stride (a GQA cache read in place)
  int kvh;            // kv heads per batch row (1: plain [B, S, D])
  int ldk;
  int S;
  const void* v;      // separate V rows as K's, or null (V in K)
  long long vb;
  long long vh;
  int ldv;
  const float* sz;    // quantized: K's (scale, zp) rows, strides in floats
  long long zb;
  long long zh;
  int ldz;
  const float* vsz;   // quantized separate V: its pairs, as K's
  long long vzb;
  long long vzh;
  int ldvz;
  const int* lengths; // [B]
  int H;
  int nbt;            // 64-row tiles per batch row (a multiple of npb)
  int npb;            // tiles per split
  float scale;
  int amla;
  void* out;          // [B, H, DV] bf16, or fp32 (quantized)  (single pass)
  float* m_out;       // [B, n_splits, H]           (split partial)
  float* l_out;       // [B, n_splits, H]
  float* acc_out;     // [B, n_splits, H, DV]
};

// Row b's first element in a dense K or V operand: kv head b % kvh of
// batch row b / kvh of a GQA cache, or row b (kvh = 1).  The walk computes
// it per tile: holding the two 64-bit offsets across the walk costs the
// latent instantiation 3 more registers.
__device__ __forceinline__ size_t row_base(int b, int kvh, long long sb,
                                           long long sh) {
  return (size_t)(b / kvh) * sb + (size_t)(b % kvh) * sh;
}

// CODE: the element type of K and V (int8 or e4m3 codes); QF32: q is fp32.
template <bool STATS, int CODE, bool QF32, int DK, int DV>
__global__ void __launch_bounds__(NTHREAD, 2) flash_decode_kernel(Params P) {
  static_assert(CODE != kBf16, "bf16 rows: flash_decode_wgmma.cu");
  static_assert(DK % 16 == 0 && DV % (8 * NWARP) == 0 && DV <= DK,
                "DK a multiple of 16; DV of 64, within the K tile");
  constexpr int KSTR = Smem<DK>::KSTR;
  constexpr int NI = DV / (8 * NWARP);         // O n-tiles per warp
  constexpr int WCOLS = DV / NWARP;            // O columns per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemQuant<DK, QF32>& sm =
      *reinterpret_cast<SmemQuant<DK, QF32>*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;       // mma fragment coordinates
  const int h0 = blockIdx.x * NH;
  const int split = blockIdx.y;
  const int n_splits = gridDim.y;
  const int b = blockIdx.z;
  const bool amla = P.amla != 0;

  if (tid < NH) {
    sm.hz[tid] = h0 + tid < P.H ? P.lengths[b] - 1 : INT_MIN;
    sm.m[tid] = NEG_INF;
    sm.l[tid] = 0.f;
  }
  load_q_tile<QF32, NH, NTHREAD, DK>(sm.q, sm.q_mid, sm.q_lo, KSTR, sm.qsum,
                                     P.q, b, P.H, h0);
  __syncthreads();

  // the split's tile range, cut after the last tile holding a live position
  const int j0 = split * P.npb;
  const int j1 = min(j0 + P.npb, P.nbt);
  int hmax = INT_MIN;
  for (int i = 0; i < NH; ++i) hmax = max(hmax, sm.hz[i]);
  int j_end = j1;
  if (hmax >= j0 * PAGE) j_end = min(j1, hmax / PAGE + 1);

  float acc[NI][4];                            // [Dv n-tile][fragment]
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;

  for (int j = j0; j < j_end; ++j) {
    const int rows = min(PAGE, P.S - j * PAGE);
    load_code_tile<CODE, NTHREAD>(
        sm.k, KSTR,
        static_cast<const uint8_t*>(P.k) + row_base(b, P.kvh, P.kb, P.kh) +
            (size_t)j * PAGE * P.ldk,
        P.ldk, rows, DK);
    load_sz_tile(sm.sz,
                 P.sz + row_base(b, P.kvh, P.zb, P.zh) +
                     (size_t)j * PAGE * P.ldz,
                 P.ldz, rows);
    if (P.v)
      load_sz_tile(sm.szv,
                   P.vsz + row_base(b, P.kvh, P.vzb, P.vzh) +
                       (size_t)j * PAGE * P.ldvz,
                   P.ldvz, rows);
    __syncthreads();

    // ---- S = Q K^T: warp tile heads [0, 16), rows [8 warp, +8)
    {
      float sacc[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* kb = &sm.k[(8 * warp + g) * KSTR];
#pragma unroll 4
      for (int k0 = 0; k0 < DK; k0 += 16) {
        const uint32_t b0 = ld32(&kb[k0 + 2 * t]);
        const uint32_t b1 = ld32(&kb[k0 + 8 + 2 * t]);
        mma16816(sacc,
                 ld32(&sm.q[g * KSTR + k0 + 2 * t]),
                 ld32(&sm.q[(g + 8) * KSTR + k0 + 2 * t]),
                 ld32(&sm.q[g * KSTR + k0 + 8 + 2 * t]),
                 ld32(&sm.q[(g + 8) * KSTR + k0 + 8 + 2 * t]), b0, b1);
        if constexpr (QF32) {
          mma16816(sacc,
                   ld32(&sm.q_mid[g * KSTR + k0 + 2 * t]),
                   ld32(&sm.q_mid[(g + 8) * KSTR + k0 + 2 * t]),
                   ld32(&sm.q_mid[g * KSTR + k0 + 8 + 2 * t]),
                   ld32(&sm.q_mid[(g + 8) * KSTR + k0 + 8 + 2 * t]), b0, b1);
          mma16816(sacc,
                   ld32(&sm.q_lo[g * KSTR + k0 + 2 * t]),
                   ld32(&sm.q_lo[(g + 8) * KSTR + k0 + 2 * t]),
                   ld32(&sm.q_lo[g * KSTR + k0 + 8 + 2 * t]),
                   ld32(&sm.q_lo[(g + 8) * KSTR + k0 + 8 + 2 * t]), b0, b1);
        }
      }
      const int ca = 8 * warp + 2 * t;          // tile row of sacc[0]
      {                                         // the affine of each row
        const float2 z0 = sm.sz[ca], z1 = sm.sz[ca + 1];
        const float qs0 = sm.qsum[g], qs8 = sm.qsum[g + 8];
        sacc[0] = z0.x * sacc[0] + z0.y * qs0;
        sacc[1] = z1.x * sacc[1] + z1.y * qs0;
        sacc[2] = z0.x * sacc[2] + z0.y * qs8;
        sacc[3] = z1.x * sacc[3] + z1.y * qs8;
      }
      const int kp = j * PAGE + ca;
      sm.s[g * SSTR + ca] = kp <= sm.hz[g] ? sacc[0] * P.scale : NEG_INF;
      sm.s[g * SSTR + ca + 1] =
          kp + 1 <= sm.hz[g] ? sacc[1] * P.scale : NEG_INF;
      sm.s[(g + 8) * SSTR + ca] =
          kp <= sm.hz[g + 8] ? sacc[2] * P.scale : NEG_INF;
      sm.s[(g + 8) * SSTR + ca + 1] =
          kp + 1 <= sm.hz[g + 8] ? sacc[3] * P.scale : NEG_INF;
    }
    __syncthreads();

    // ---- a separate V replaces the K tile's first DV columns
    if (P.v)
      load_code_tile<CODE, NTHREAD>(
          sm.k, KSTR,
          static_cast<const uint8_t*>(P.v) +
              row_base(b, P.kvh, P.vb, P.vh) + (size_t)j * PAGE * P.ldv,
          P.ldv, rows, DV);

    // ---- online-softmax update: 16 lanes per head row, 4 rows per lane
    {
      const int h = tid >> 4, r = tid & 15;
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = sm.s[h * SSTR + r + 16 * i];
      tile_update(sv, r, amla, &sm.p_hi[h * PSTR], &sm.p_lo[h * PSTR],
                  &sm.m[h], &sm.l[h], &sm.corr[h], P.v ? sm.szv : sm.sz,
                  &sm.zc[h], &sm.p_mid[h * PSTR]);
    }
    __syncthreads();

    // ---- O = O * corr + P V: warp owns Dv columns [WCOLS warp, +WCOLS); a
    //      code tile adds sum_r zp_r p_r to every column of its head's row
    {
      const float c_lo = sm.corr[g], c_hi = sm.corr[g + 8];
      const float z_lo = sm.zc[g], z_hi = sm.zc[g + 8];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        acc[ni][0] *= c_lo;
        acc[ni][1] *= c_lo;
        acc[ni][2] *= c_hi;
        acc[ni][3] *= c_hi;
        acc[ni][0] += z_lo;
        acc[ni][1] += z_lo;
        acc[ni][2] += z_hi;
        acc[ni][3] += z_hi;
      }
    }
#pragma unroll
    for (int k0 = 0; k0 < PAGE; k0 += 16) {
      const int pa = g * PSTR + k0 + 2 * t, pb = (g + 8) * PSTR + k0 + 2 * t;
      const bf16* hi = sm.p_hi;
      const bf16* lo = sm.p_lo;
      const uint32_t ah0 = ld32(&hi[pa]), ah1 = ld32(&hi[pb]);
      const uint32_t ah2 = ld32(&hi[pa + 8]), ah3 = ld32(&hi[pb + 8]);
      const uint32_t al0 = ld32(&lo[pa]), al1 = ld32(&lo[pb]);
      const uint32_t al2 = ld32(&lo[pa + 8]), al3 = ld32(&lo[pb + 8]);
      const bf16* mid = sm.p_mid;
      const uint32_t am0 = ld32(&mid[pa]), am1 = ld32(&mid[pb]);
      const uint32_t am2 = ld32(&mid[pa + 8]), am3 = ld32(&mid[pb + 8]);
      const bf16* r0 = &sm.k[(k0 + 2 * t) * KSTR];    // V rows k0+2t, +1
      const bf16* r1 = r0 + KSTR;
      const bf16* r8 = r0 + 8 * KSTR;                 // V rows k0+2t+8, +9
      const bf16* r9 = r8 + KSTR;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int dv = WCOLS * warp + 8 * ni + g;
        const uint32_t b0 = pack(r0[dv], r1[dv]);
        const uint32_t b1 = pack(r8[dv], r9[dv]);
        mma16816(acc[ni], ah0, ah1, ah2, ah3, b0, b1);
        mma16816(acc[ni], am0, am1, am2, am3, b0, b1);
        mma16816(acc[ni], al0, al1, al2, al3, b0, b1);
      }
    }
    __syncthreads();                           // the tile buffer is reused
  }

  // ---- epilogue: thread holds heads g and g + 8, Dv columns 2t, 2t + 1 of
  //      each of its NI n-tiles
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = g + 8 * half;
    const int h = h0 + row;
    if (h >= P.H) continue;
    if (STATS) {
      const size_t sr = (size_t)b * n_splits + split;
      if (warp == 0 && t == 0) {
        P.m_out[sr * P.H + h] = sm.m[row];
        P.l_out[sr * P.H + h] = sm.l[row];
      }
      float* a = P.acc_out + (sr * P.H + h) * DV;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int dv = WCOLS * warp + 8 * ni + 2 * t;
        *reinterpret_cast<float2*>(&a[dv]) =
            make_float2(acc[ni][2 * half], acc[ni][2 * half + 1]);
      }
    } else {
      const float l = sm.l[row];
      float* o = static_cast<float*>(P.out) + ((size_t)b * P.H + h) * DV;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int dv = WCOLS * warp + 8 * ni + 2 * t;
        *reinterpret_cast<float2*>(&o[dv]) = make_float2(
            acc[ni][2 * half] / l, acc[ni][2 * half + 1] / l);
      }
    }
  }
}

template <bool STATS, int CODE, bool QF32, int DK, int DV>
int launch_widths(const Params& p, int B, int n_splits, void* stream) {
  const int smem = static_cast<int>(sizeof(SmemQuant<DK, QF32>));
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<STATS, CODE, QF32, DK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.H + NH - 1) / NH, n_splits, B);
  flash_decode_kernel<STATS, CODE, QF32, DK, DV><<<
      grid, NTHREAD, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool STATS, int CODE, int DK, int DV>
int launch_q(const Params& p, int qf32, int B, int n_splits, void* stream) {
  return qf32 ? launch_widths<STATS, CODE, true, DK, DV>(p, B, n_splits,
                                                         stream)
              : launch_widths<STATS, CODE, false, DK, DV>(p, B, n_splits,
                                                          stream);
}

template <bool STATS>
int launch_quant(const Params& p, int code, int qf32, int dk, int dv, int B,
                 int n_splits, void* stream) {
  return with_widths<QuantDenseWidths>(dk, dv, [&](auto DK, auto DV) {
    constexpr int K = decltype(DK)::value, V = decltype(DV)::value;
    return code ? launch_q<STATS, kE4m3, K, V>(p, qf32, B, n_splits, stream)
                : launch_q<STATS, kInt8, K, V>(p, qf32, B, n_splits, stream);
  });
}

// The instance's registers per thread, dynamic shared memory (bytes) and
// local memory per thread (bytes; spills) into out[0..2].
template <bool STATS, int CODE, bool QF32, int DK, int DV>
int attrs_of(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, flash_decode_kernel<STATS, CODE, QF32, DK, DV>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(sizeof(SmemQuant<DK, QF32>));
  out[2] = static_cast<int>(a.localSizeBytes);
  return 0;
}

Params make_params(const void* q, const void* k, long long kb, int ldk,
                   const void* v, long long vb, int ldv, int S,
                   const int* lengths, int kvh, long long kh, long long vh,
                   int H, int nbt, float scale, int amla) {
  Params p{};
  p.q = q;
  p.k = k;
  p.kb = kb;
  p.kh = kh;
  p.kvh = kvh;
  p.ldk = ldk;
  p.S = S;
  p.v = v;
  p.vb = vb;
  p.vh = vh;
  p.ldv = ldv;
  p.lengths = lengths;
  p.H = H;
  p.nbt = nbt;
  p.npb = nbt;
  p.scale = scale;
  p.amla = amla;
  return p;
}

// The quantized kernels' pairs: K's at kz (strides zb, zh, ldz in floats),
// a separate V's at vz (null with v).
void set_pairs(Params& p, const float* kz, long long zb, long long zh,
               int ldz, const float* vz, long long vzb, long long vzh,
               int ldvz) {
  p.sz = kz;
  p.zb = zb;
  p.zh = zh;
  p.ldz = ldz;
  p.vsz = vz;
  p.vzb = vzb;
  p.vzh = vzh;
  p.ldvz = ldvz;
}

}  // namespace

extern "C" {

// The (Dk, Dv) pairs K7q / K8q take (written to out as dk, dv, ...; returns
// their number).
int flash_decode_quant_widths(int* out, int cap) {
  return write_widths<QuantDenseWidths>(out, cap);
}

// The registers, dynamic shared memory and local memory of K7q (stats 0)
// or K8q (stats 1) at (dk, dv) over int8 (code 0) or e4m3 (code 1) rows,
// with fp32 q when qf32 is set, into out[0..2].
int flash_decode_quant_attrs(int dk, int dv, int stats, int code, int qf32,
                             int* out) {
  return with_widths<QuantDenseWidths>(dk, dv, [&](auto DK, auto DV) {
    constexpr int K = decltype(DK)::value, V = decltype(DV)::value;
    auto pick = [&](auto S, auto C) {
      constexpr bool ST = decltype(S)::value;
      constexpr int CD = decltype(C)::value;
      return qf32 ? attrs_of<ST, CD, true, K, V>(out)
                  : attrs_of<ST, CD, false, K, V>(out);
    };
    using T = std::true_type;
    using F = std::false_type;
    using I8 = std::integral_constant<int, kInt8>;
    using E4 = std::integral_constant<int, kE4m3>;
    return stats ? (code ? pick(T{}, E4{}) : pick(T{}, I8{}))
                 : (code ? pick(F{}, E4{}) : pick(F{}, I8{}));
  });
}

// K7q: K7 (flash_decode_wgmma.cu: flash_decode) over int8 (code 0) or
// e4m3 (code 1) rows addressed as K7's (strides in bytes), K's (scale, zp)
// pairs at kz + (b / kvh)*zb + (b % kvh)*zh + s*ldz (floats); V null (its
// codes and pairs are K's) or codes at v with pairs at vz.  q bf16, or
// fp32 with qf32 set; out [B,H,dv] fp32; (dk, dv) one of
// flash_decode_quant_widths.
int flash_decode_quant(const void* q, const void* k, long long kb, int ldk,
                       const void* v, long long vb, int ldv, int S,
                       const int* lengths, int kvh, long long kh,
                       long long vh, int dk, int dv, const float* kz,
                       long long zb, long long zh, int ldz, const float* vz,
                       long long vzb, long long vzh, int ldvz, int code,
                       int qf32, void* out, int B, int H, float scale,
                       int amla, void* stream) {
  Params p = make_params(q, k, kb, ldk, v, vb, ldv, S, lengths, kvh, kh, vh,
                         H, (S + PAGE - 1) / PAGE, scale, amla);
  set_pairs(p, kz, zb, zh, ldz, vz, vzb, vzh, ldvz);
  p.out = out;
  return launch_quant<false>(p, code, qf32, dk, dv, B, 1, stream);
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
  Params p = make_params(q, k, kb, ldk, v, vb, ldv, S, lengths, kvh, kh, vh,
                         H, n_splits * tps, scale, amla);
  set_pairs(p, kz, zb, zh, ldz, vz, vzb, vzh, ldvz);
  p.npb = tps;
  p.m_out = m_out;
  p.l_out = l_out;
  p.acc_out = acc_out;
  return launch_quant<true>(p, code, qf32, dk, dv, B, n_splits, stream);
}

}  // extern "C"
