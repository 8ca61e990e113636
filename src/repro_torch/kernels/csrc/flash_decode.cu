// The untransposed decode baseline for Hopper (sm_90a): FlashMLA without
// ETAP.  One body serving two kernels of the JAX package:
//
//   K7  single-pass decode         replaces repro/kernels/flash_decode/
//       (flash_decode_pallas :58)  flash_decode.py:83
//   K8  split-KV phase 1           replaces repro/kernels/flash_decode/
//       (flash_decode_partial_pallas :136)  flash_decode.py:168
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
// one instantiation per pair of mma_tile.cuh's DENSE_WIDTHS: the MLA latent
// (576, 512) and the 128-wide GQA head (128, 128).  Everything else is the
// ETAP body's K5 — the same 64-row tiles, address modes (dense rows with a
// zero-filled tail, a GQA cache [B, S, K, hd] read in place through its
// kv-head stride; V the first Dv K columns or its own strided rows),
// horizon mask, tile skipping past the horizon, online-softmax update
// (mma_tile.cuh: tile_update), exact AMLA and P as bf16 hi + lo — so the
// orientation of the products is the only difference.  K7 ends with
// O = Acc / l in bf16; K8 writes the raw fp32 (m, l, Acc) of its split in
// the [n, H, Dv] orientation for combine.cu's second entry.  K7 and K8 are
// the same body, so K8(n_splits=1) + combine is bitwise K7.
//
// What bounds it on the H100: like K3/K5, the KV bytes over 3.35 TB/s (the
// multiply-adds are 2 * H * (Dk + Dv) per row).  Acc [16, Dv] fp32 is
// spread over the 8 warps, Dv / 8 columns each (Dv / 16 registers per
// thread: 32 at the latent);
// 128 heads take 8 CTAs, each re-reading the row's tiles (the re-reads
// mostly hit L2), as K3 does for its column tiles.  First version: the
// fragments come from shared memory with 32/16-bit loads and one tile is in
// flight.
#include <climits>
#include <cstdint>

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
  bf16 k[PAGE * KSTR];         // the current KV tile (V: first DV columns)
  bf16 q[NH * KSTR];           // the CTA's heads
  float s[NH * SSTR];          // scaled, masked scores S [head][row]
  bf16 p_hi[NH * PSTR];        // P [head][row]
  bf16 p_lo[NH * PSTR];
  float m[NH];
  float l[NH];
  float corr[NH];
  int hz[NH];                  // per-head horizon (length - 1)
};

struct Params {
  const bf16* q;      // [B, H, DK]
  const bf16* k;      // rows (b / kvh)*kb + (b % kvh)*kh + s*ldk, s < S
  long long kb;
  long long kh;       // kv-head stride (a GQA cache read in place)
  int kvh;            // kv heads per batch row (1: plain [B, S, D])
  int ldk;
  int S;
  const bf16* v;      // separate V rows as K's, or null (V in K)
  long long vb;
  long long vh;
  int ldv;
  const int* lengths; // [B]
  int H;
  int nbt;            // 64-row tiles per batch row (a multiple of npb)
  int npb;            // tiles per split
  float scale;
  int amla;
  bf16* out;          // [B, H, DV]                 (single pass)
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

template <bool STATS, int DK, int DV>
__global__ void __launch_bounds__(NTHREAD, 2) flash_decode_kernel(Params P) {
  static_assert(DK % 16 == 0 && DV % (8 * NWARP) == 0 && DV <= DK,
                "DK a multiple of 16; DV of 64, within the K tile");
  constexpr int KSTR = Smem<DK>::KSTR;
  constexpr int NI = DV / (8 * NWARP);         // O n-tiles per warp
  constexpr int WCOLS = DV / NWARP;            // O columns per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DK>& sm = *reinterpret_cast<Smem<DK>*>(smem_raw);
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
  for (int i = tid; i < NH * (DK / 8); i += NTHREAD) {
    const int r = i / (DK / 8), cc = i % (DK / 8);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (h0 + r < P.H)
      v = reinterpret_cast<const uint4*>(
          P.q + ((size_t)b * P.H + h0 + r) * DK)[cc];
    *reinterpret_cast<uint4*>(&sm.q[r * KSTR + cc * 8]) = v;
  }
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
    load_tile<NTHREAD>(sm.k, KSTR,
                       P.k + row_base(b, P.kvh, P.kb, P.kh) +
                           (size_t)j * PAGE * P.ldk,
                       P.ldk, rows, DK, true);
    cp_async_wait_all();
    __syncthreads();

    // ---- S = Q K^T: warp tile heads [0, 16), rows [8 warp, +8)
    {
      float sacc[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* kb = &sm.k[(8 * warp + g) * KSTR];
#pragma unroll 4
      for (int k0 = 0; k0 < DK; k0 += 16) {
        mma16816(sacc,
                 ld32(&sm.q[g * KSTR + k0 + 2 * t]),
                 ld32(&sm.q[(g + 8) * KSTR + k0 + 2 * t]),
                 ld32(&sm.q[g * KSTR + k0 + 8 + 2 * t]),
                 ld32(&sm.q[(g + 8) * KSTR + k0 + 8 + 2 * t]),
                 ld32(&kb[k0 + 2 * t]),
                 ld32(&kb[k0 + 8 + 2 * t]));
      }
      const int ca = 8 * warp + 2 * t;          // tile row of sacc[0]
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
      load_tile<NTHREAD>(sm.k, KSTR,
                         P.v + row_base(b, P.kvh, P.vb, P.vh) +
                             (size_t)j * PAGE * P.ldv,
                         P.ldv, rows, DV, false);

    // ---- online-softmax update: 16 lanes per head row, 4 rows per lane
    {
      const int h = tid >> 4, r = tid & 15;
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = sm.s[h * SSTR + r + 16 * i];
      tile_update(sv, r, amla, &sm.p_hi[h * PSTR], &sm.p_lo[h * PSTR],
                  &sm.m[h], &sm.l[h], &sm.corr[h]);
    }
    cp_async_wait_all();
    __syncthreads();

    // ---- O = O * corr + P V: warp owns Dv columns [WCOLS warp, +WCOLS)
    {
      const float c_lo = sm.corr[g], c_hi = sm.corr[g + 8];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        acc[ni][0] *= c_lo;
        acc[ni][1] *= c_lo;
        acc[ni][2] *= c_hi;
        acc[ni][3] *= c_hi;
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
      bf16* o = P.out + ((size_t)b * P.H + h) * DV;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int dv = WCOLS * warp + 8 * ni + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(&o[dv]) = __halves2bfloat162(
            __float2bfloat16_rn(acc[ni][2 * half] / l),
            __float2bfloat16_rn(acc[ni][2 * half + 1] / l));
      }
    }
  }
}

template <bool STATS, int DK, int DV>
int launch_widths(const Params& p, int B, int n_splits, void* stream) {
  const int smem = static_cast<int>(sizeof(Smem<DK>));
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<STATS, DK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.H + NH - 1) / NH, n_splits, B);
  flash_decode_kernel<STATS, DK, DV><<<grid, NTHREAD, smem,
                                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool STATS>
int launch(const Params& p, int dk, int dv, int B, int n_splits,
           void* stream) {
  return with_dense_widths(dk, dv, [&](auto DK, auto DV) {
    return launch_widths<STATS, decltype(DK)::value, decltype(DV)::value>(
        p, B, n_splits, stream);
  });
}

Params make_params(const void* q, const void* k, long long kb, int ldk,
                   const void* v, long long vb, int ldv, int S,
                   const int* lengths, int kvh, long long kh, long long vh,
                   int H, int nbt, float scale, int amla) {
  Params p{};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.kb = kb;
  p.kh = kh;
  p.kvh = kvh;
  p.ldk = ldk;
  p.S = S;
  p.v = static_cast<const bf16*>(v);
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

}  // namespace

extern "C" {

// The (Dk, Dv) pairs K7 / K8 take (written to out as dk, dv, ...; returns
// their number).
int flash_decode_widths(int* out, int cap) {
  return write_dense_widths(out, cap);
}

// K7: q [B,H,dk]; K rows k + (b / kvh)*kb + (b % kvh)*kh + s*ldk for s < S
// (dk wide); V null (the first dv columns of K) or rows at v with strides
// vb, vh, ldv (dv wide); lengths [B]; out [B,H,dv] bf16.  Strides in
// elements; (dk, dv) one of flash_decode_widths.
int flash_decode(const void* q, const void* k, long long kb, int ldk,
                 const void* v, long long vb, int ldv, int S,
                 const int* lengths, int kvh, long long kh, long long vh,
                 int dk, int dv, void* out, int B, int H, float scale,
                 int amla, void* stream) {
  Params p = make_params(q, k, kb, ldk, v, vb, ldv, S, lengths, kvh, kh, vh,
                         H, (S + PAGE - 1) / PAGE, scale, amla);
  p.out = static_cast<bf16*>(out);
  return launch<false>(p, dk, dv, B, 1, stream);
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
  Params p = make_params(q, k, kb, ldk, v, vb, ldv, S, lengths, kvh, kh, vh,
                         H, n_splits * tps, scale, amla);
  p.npb = tps;
  p.m_out = m_out;
  p.l_out = l_out;
  p.acc_out = acc_out;
  return launch<true>(p, dk, dv, B, n_splits, stream);
}

}  // extern "C"
