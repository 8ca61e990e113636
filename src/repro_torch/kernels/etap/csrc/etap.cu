// Paged MLA-fused ETAP attention for Hopper (sm_90a): one templated body
// serving three kernels of the JAX package.
//
//   K3  single-pass paged decode   replaces repro/kernels/etap/etap.py:237
//       (_paged_call, reached from etap_decode_mla_paged_pallas :259)
//   K1  split-KV phase 1           replaces repro/kernels/etap/etap.py:713
//       (etap_paged_partial_pallas :646, body _etap_partial_body :506)
//   K4  chunked paged prefill /    replaces repro/kernels/etap/etap.py:430
//       draft verify               (_prefill_call :373, reached from
//                                   etap_prefill_mla_paged_pallas :456 and
//                                   etap_verify_mla_paged_pallas :493)
//
// What they compute.  A CTA owns NT = 16 query columns of one batch row (16
// heads of a decode query, or 16 of the Cq*H columns of a prefill chunk)
// and walks that row's pool pages through the block table.  Per 64-row page:
//     S^T = K Q^T * scale          [64, 16]   mma.sync, page rows on M
//     mask kpos > horizon(column) to -1e30
//     online-softmax update per column (m, l in shared memory)
//     O^T += V^T P^T               [512, 16]  mma.sync, Dv on M
// V is the first 512 columns of the same 576-wide latent page: the page is
// read once for both products.  Column c is live for key position kpos iff
// kpos <= horizon(c), with horizon = lengths[b] - 1 (decode), start[b] +
// c / H (prefill), or qpos[b, c] (verify) — so decode, prefill and verify
// share the mask code, and verify with a linear qpos is bitwise prefill.
// K3/K4 end with O = (Acc^T / l)^T in the pool dtype; K1 writes the raw
// fp32 (m, l, Acc^T) of its split for the combine kernel (combine.cu).  K1
// and K3 are the same body, so partial(n_splits=1) + combine is bitwise K3.
//
// Numerics.  Scores, m, l and Acc are fp32.  The scores come from bf16
// inputs with fp32 accumulation.  The probabilities enter the second product
// as two bf16 terms, p_hi = bf16(p) and p_lo = bf16(p - p_hi), which carry
// about 16 significant bits of p; l sums the fp32 p.  amla mode builds its
// rescale 2^(m_old - m_new) from the exponent (softmax_state.cuh).
//
// The walk.  Pages past the last live position of the tile are not read:
// for a column whose running max is already set, a fully masked page is an
// exact no-op of the recurrence (p = 0, rescale = 1).  The walk is cut by
// positions only, never by block ids: a padded table entry (the null block
// 0) inside the walk is read and masked like any other page.  A split with
// no live position at all walks all of its pages, as the reference does, so
// its stats are the reference's.
//
// What bounds it on the H100.  Decode reads each latent page once per head
// tile (128 heads = 8 tiles, the re-reads mostly hit L2); its floor is the
// pool bytes over 3.35 TB/s.  Prefill at 128 heads is compute-bound
// (Cq*H*kpos*(576 + 512) multiply-adds).  This first version is simple:
// mma.sync fragments loaded from shared memory with 32/16-bit loads, one
// page in flight (cp.async, no double buffer), 16 columns per CTA so the
// [512, 16] fp32 accumulator fits in registers (32 per thread).  Removing
// the per-tile re-read of the pool (wider tiles, wgmma, TMA, a pipelined
// ring of pages) is the work of a later version.
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "softmax_state.cuh"

namespace {

using bf16 = __nv_bfloat16;
using etap::LOG2E;
using etap::NEG_INF;

constexpr int DK = 576;        // latent width: kv_lora 512 + rope 64
constexpr int DV = 512;        // V = the first DV latent columns
constexpr int PAGE = 64;       // pool rows per block (page)
constexpr int NT = 16;         // query columns per CTA
constexpr int NWARP = 8;
constexpr int NTHREAD = NWARP * 32;
constexpr int KSTR = DK + 8;   // padded smem row (bf16): conflict-free loads
constexpr int PSTR = PAGE + 8; // padded P^T row (bf16)
constexpr int SSTR = NT + 1;   // padded score row (fp32)

struct Smem {
  bf16 k[PAGE * KSTR];         // the current latent page
  bf16 q[NT * KSTR];           // the CTA's query columns
  float s[PAGE * SSTR];        // scaled, masked scores S^T
  bf16 p_hi[NT * PSTR];        // P (column-major: [column][row])
  bf16 p_lo[NT * PSTR];
  float m[NT];
  float l[NT];
  float corr[NT];
  int hz[NT];                  // per-column horizon
};

struct Params {
  const bf16* q;      // [B, C, DK]
  const bf16* pool;   // [N, PAGE, DK]
  const int* table;   // [B, nbt]
  const int* base;    // [B] horizon base: lengths (decode) or start (prefill)
  const int* qpos;    // [B, C] explicit horizons (verify), or null
  int hz_off;         // -1 for decode (pos < length), 0 for prefill
  int heads;          // column c belongs to query row c / heads
  int C;              // query columns per batch row
  int nbt;            // table width (a multiple of npb)
  int npb;            // pages per split
  float scale;
  int amla;
  bf16* out;          // [B, C, DV]                 (single pass)
  float* m_out;       // [B, n_splits, C]           (split partial)
  float* l_out;       // [B, n_splits, C]
  float* acc_out;     // [B, n_splits, DV, C]
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D += A(16x16, row) * B(16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma16816(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

template <bool STATS>
__global__ void __launch_bounds__(NTHREAD, 2) etap_paged_kernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
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
    int h = INT_MIN;                           // padding column: all masked
    if (c < P.C)
      h = P.qpos ? P.qpos[(size_t)b * P.C + c]
                 : P.base[b] + c / P.heads + P.hz_off;
    sm.hz[tid] = h;
    sm.m[tid] = NEG_INF;
    sm.l[tid] = 0.f;
  }
  for (int i = tid; i < NT * (DK / 8); i += NTHREAD) {
    const int r = i / (DK / 8), cc = i % (DK / 8);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (c0 + r < P.C)
      v = reinterpret_cast<const uint4*>(
          P.q + ((size_t)b * P.C + c0 + r) * DK)[cc];
    *reinterpret_cast<uint4*>(&sm.q[r * KSTR + cc * 8]) = v;
  }
  __syncthreads();

  // the split's page range, cut after the last page holding a live position
  const int j0 = split * P.npb;
  const int j1 = min(j0 + P.npb, P.nbt);
  int hmax = INT_MIN;
  for (int i = 0; i < NT; ++i) hmax = max(hmax, sm.hz[i]);
  int j_end = j1;
  if (hmax >= j0 * PAGE) j_end = min(j1, hmax / PAGE + 1);

  float acc[4][2][4];                          // [m-tile][n-tile][fragment]
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int smi = warp & 3, sni = warp >> 2;   // this warp's S^T tile
  for (int j = j0; j < j_end; ++j) {
    const int blk = P.table[(size_t)b * P.nbt + j];
    const bf16* src = P.pool + (size_t)blk * PAGE * DK;
    for (int i = tid; i < PAGE * (DK / 8); i += NTHREAD) {
      const int r = i / (DK / 8), cc = i % (DK / 8);
      cp_async16(&sm.k[r * KSTR + cc * 8], src + (size_t)r * DK + cc * 8);
    }
    cp_async_wait_all();
    __syncthreads();

    // ---- S^T = K Q^T: warp tile rows [16 smi, +16), columns [8 sni, +8)
    {
      float sacc[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* ka = &sm.k[(16 * smi) * KSTR];
      const bf16* qb = &sm.q[(8 * sni) * KSTR];
#pragma unroll 4
      for (int k0 = 0; k0 < DK; k0 += 16) {
        mma16816(sacc,
                 ld32(&ka[g * KSTR + k0 + 2 * t]),
                 ld32(&ka[(g + 8) * KSTR + k0 + 2 * t]),
                 ld32(&ka[g * KSTR + k0 + 8 + 2 * t]),
                 ld32(&ka[(g + 8) * KSTR + k0 + 8 + 2 * t]),
                 ld32(&qb[g * KSTR + k0 + 2 * t]),
                 ld32(&qb[g * KSTR + k0 + 8 + 2 * t]));
      }
      const int r0 = 16 * smi + g;
      const int ca = 8 * sni + 2 * t;
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

    // ---- online-softmax update: 16 lanes per column, 4 rows per lane
    {
      const int col = tid >> 4, r = tid & 15;
      float sv[4];
      float mx = NEG_INF * LOG2E;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = sm.s[(r + 16 * i) * SSTR + col];
        if (amla) x = x * LOG2E;               // log2 domain
        sv[i] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float block_m = amla ? ceilf(mx) : mx;
      const float m_old = sm.m[col];
      const float m_new = fmaxf(m_old, block_m);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = etap::prob_exp(sv[i] - m_new, amla);
        sum += p;
        const bf16 hi = __float2bfloat16_rn(p);
        sm.p_hi[col * PSTR + r + 16 * i] = hi;
        sm.p_lo[col * PSTR + r + 16 * i] =
            __float2bfloat16_rn(p - __bfloat162float(hi));
      }
#pragma unroll
      for (int off = 8; off; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (r == 0) {
        const float corr = etap::stat_weight(m_old - m_new, amla);
        sm.corr[col] = corr;
        sm.l[col] = sm.l[col] * corr + sum;
        sm.m[col] = m_new;
      }
    }
    __syncthreads();

    // ---- O^T = O^T * corr + V^T P^T: warp owns Dv rows [64 warp, +64)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      const float ca = sm.corr[8 * ni + 2 * t];
      const float cb = sm.corr[8 * ni + 2 * t + 1];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        acc[mi][ni][0] *= ca;
        acc[mi][ni][1] *= cb;
        acc[mi][ni][2] *= ca;
        acc[mi][ni][3] *= cb;
      }
    }
#pragma unroll
    for (int k0 = 0; k0 < PAGE; k0 += 16) {
      const bf16* r0 = &sm.k[(k0 + 2 * t) * KSTR];    // rows of pos k0+2t..
      const bf16* r1 = r0 + KSTR;
      const bf16* r8 = r0 + 8 * KSTR;
      const bf16* r9 = r8 + KSTR;
      uint32_t bh[2][2], bl[2][2];
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const int pc = (8 * ni + g) * PSTR + k0 + 2 * t;
        bh[ni][0] = ld32(&sm.p_hi[pc]);
        bh[ni][1] = ld32(&sm.p_hi[pc + 8]);
        bl[ni][0] = ld32(&sm.p_lo[pc]);
        bl[ni][1] = ld32(&sm.p_lo[pc + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int dv = 64 * warp + 16 * mi + g;
        const uint32_t a0 = pack(r0[dv], r1[dv]);
        const uint32_t a1 = pack(r0[dv + 8], r1[dv + 8]);
        const uint32_t a2 = pack(r8[dv], r9[dv]);
        const uint32_t a3 = pack(r8[dv + 8], r9[dv + 8]);
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          mma16816(acc[mi][ni], a0, a1, a2, a3, bh[ni][0], bh[ni][1]);
          mma16816(acc[mi][ni], a0, a1, a2, a3, bl[ni][0], bl[ni][1]);
        }
      }
    }
    __syncthreads();                           // page buffer is reused
  }

  // ---- epilogue
#pragma unroll
  for (int ni = 0; ni < 2; ++ni) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * ni + 2 * t + e;
      const int c = c0 + col;
      if (c >= P.C) continue;
      if (STATS) {
        const size_t row = ((size_t)b * n_splits + split);
        if (warp == 0 && g == 0) {
          P.m_out[row * P.C + c] = sm.m[col];
          P.l_out[row * P.C + c] = sm.l[col];
        }
        float* a = P.acc_out + row * DV * P.C + c;
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const int dv = 64 * warp + 16 * mi + g;
          a[(size_t)dv * P.C] = acc[mi][ni][e];
          a[(size_t)(dv + 8) * P.C] = acc[mi][ni][e + 2];
        }
      } else {
        const float l = sm.l[col];
        bf16* o = P.out + ((size_t)b * P.C + c) * DV;
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const int dv = 64 * warp + 16 * mi + g;
          o[dv] = __float2bfloat16_rn(acc[mi][ni][e] / l);
          o[dv + 8] = __float2bfloat16_rn(acc[mi][ni][e + 2] / l);
        }
      }
    }
  }
}

template <bool STATS>
int launch(const Params& p, int B, int n_splits, void* stream) {
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      etap_paged_kernel<STATS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.C + NT - 1) / NT, n_splits, B);
  etap_paged_kernel<STATS><<<grid, NTHREAD, smem,
                             static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

Params make_params(const void* q, const void* pool, const int* table,
                   int C, int nbt, float scale, int amla) {
  Params p{};
  p.q = static_cast<const bf16*>(q);
  p.pool = static_cast<const bf16*>(pool);
  p.table = table;
  p.C = C;
  p.nbt = nbt;
  p.npb = nbt;
  p.scale = scale;
  p.amla = amla;
  return p;
}

}  // namespace

extern "C" {

// Shape constants the Python wrappers check their operands against.
int etap_dk() { return DK; }
int etap_dv() { return DV; }
int etap_page() { return PAGE; }

// K3: q [B,H,DK]; pool [N,PAGE,DK]; table [B,nbt]; lengths [B];
// out [B,H,DV] — all bf16 / int32, contiguous.
int etap_decode_mla_paged(const void* q, const void* pool, const int* table,
                          const int* lengths, void* out, int B, int H,
                          int nbt, float scale, int amla, void* stream) {
  Params p = make_params(q, pool, table, H, nbt, scale, amla);
  p.base = lengths;
  p.hz_off = -1;
  p.heads = H;
  p.out = static_cast<bf16*>(out);
  return launch<false>(p, B, 1, stream);
}

// K1: as K3, with the table padded to n_splits * npb columns; writes fp32
// m, l [B,n,H] and acc [B,n,DV,H].
int etap_paged_partial(const void* q, const void* pool, const int* table,
                       const int* lengths, float* m_out, float* l_out,
                       float* acc_out, int B, int H, int nbt, int n_splits,
                       float scale, int amla, void* stream) {
  Params p = make_params(q, pool, table, H, nbt, scale, amla);
  p.npb = nbt / n_splits;
  p.base = lengths;
  p.hz_off = -1;
  p.heads = H;
  p.m_out = m_out;
  p.l_out = l_out;
  p.acc_out = acc_out;
  return launch<true>(p, B, n_splits, stream);
}

// K4: q [B, Cq*H, DK]; start [B]; qpos [B, Cq*H] or null; out [B,Cq*H,DV].
int etap_prefill_mla_paged(const void* q, const void* pool, const int* table,
                           const int* start, const int* qpos, void* out,
                           int B, int C, int H, int nbt, float scale,
                           int amla, void* stream) {
  Params p = make_params(q, pool, table, C, nbt, scale, amla);
  p.base = start;
  p.qpos = qpos;
  p.hz_off = 0;
  p.heads = H;
  p.out = static_cast<bf16*>(out);
  return launch<false>(p, B, 1, stream);
}

}  // extern "C"
